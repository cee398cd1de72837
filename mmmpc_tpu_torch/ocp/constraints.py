"""Constraint building blocks (counterpart of ``mmmpc_tpu/ocp/constraints.py``).

Each function returns constraint values with ``g <= 0`` satisfied, for states
with a trailing feature axis; any leading batch axes broadcast.
"""

import torch

from mmmpc_tpu_torch.utils.math import safe_dist, safe_norm

# "Satisfied by a wide margin": disables masked rows without +-inf, which
# would poison Hessians.
NEG_BIG = -1e9

# Endpoint self-collision sphere radius.
SELF_COLLISION_RADIUS = 0.05
# Half-plane obstacles are pushed out by this margin (link radius not
# modelled).
OBSTACLE_EXPAND_DIST = 0.03


def ground_circle_g(xy_x, xy_y, obstacles, body_radius):
    """(r_obs + r_body) - dist((x, y), obs) for each ground obstacle:
    (...,) positions, obstacles (n_obs, 3) rows [x, y, r] -> (..., n_obs)."""
    return (obstacles[:, 2] + body_radius) - safe_dist(
        xy_x[..., None] - obstacles[:, 0], xy_y[..., None] - obstacles[:, 1])


def manipulator_sample_points(ee, j2, j3):
    """The six sampled link points [j2/2, j2, (j2+j3)/2, j3, (j3+ee)/2, ee]
    (world frame, the quirky j2/2 kept for parity) -> (..., 6, 3)."""
    return torch.stack([j2 / 2, j2, (j2 + j3) / 2, j3, (j3 + ee) / 2, ee],
                       dim=-2)


def self_collision_g(ee, j2, j3, radius=SELF_COLLISION_RADIUS):
    """radius - ||p_check - ee|| for the check points [world origin, j2/2,
    j2, (j2+j3)/2] -> (..., 4)."""
    checks = torch.stack([torch.zeros_like(ee), j2 / 2, j2, (j2 + j3) / 2],
                         dim=-2)
    return radius - safe_norm(checks - ee[..., None, :], dim=-1)


def halfplane_union_g(points, hp_points, hp_normals, hp_mask,
                      expand=OBSTACLE_EXPAND_DIST):
    """Union-of-half-planes values: a point is safe if it lies outside at
    least one live face, g_i = -max_j n_j . (o_j - p_i) with o_j the face
    point pushed out by ``expand``.  points (..., n_p, 3) -> (..., n_p);
    NEG_BIG everywhere when no face is live."""
    o = hp_points - expand * hp_normals                        # (n_hp, 3)
    d = torch.sum(hp_normals * (o - points[..., :, None, :]), dim=-1)
    d = torch.where(hp_mask > 0, d, NEG_BIG)                  # (..., n_p, n_hp)
    any_live = torch.sum(hp_mask) > 0
    return torch.where(any_live, -torch.amax(d, dim=-1), NEG_BIG)


def box_g(v, lower, upper, finite_mask_lo, finite_mask_hi):
    """Two-sided box constraints [v - upper; lower - v] as g <= 0; rows with
    an infinite bound (mask False) are NEG_BIG."""
    kw = dict(dtype=v.dtype, device=v.device)
    upper = torch.as_tensor(upper, **kw)
    lower = torch.as_tensor(lower, **kw)
    mhi = torch.as_tensor(finite_mask_hi, dtype=torch.bool, device=v.device)
    mlo = torch.as_tensor(finite_mask_lo, dtype=torch.bool, device=v.device)
    g_hi = torch.where(mhi, v - upper, NEG_BIG)
    g_lo = torch.where(mlo, lower - v, NEG_BIG)
    return torch.cat([g_hi, g_lo], dim=-1)


def relu_max(g):
    """relu(max over the last axis); an empty group contributes 0."""
    if g.shape[-1] == 0:
        return torch.zeros(g.shape[:-1], dtype=g.dtype, device=g.device)
    return torch.clamp(torch.max(g, dim=-1).values, min=0.0)

"""Constraint building blocks (counterpart of ``mmmpc_tpu/ocp/constraints.py``).

Each function returns constraint values with ``g <= 0`` satisfied, for states
with a trailing feature axis; any leading batch axes broadcast.  The
``*_grad`` forms also return closed-form gradients, with the even tie split
of the VJP of ``jnp.max`` wherever a max is taken, for the controllers'
structured AL expansions.
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


def relu_max_penalty(g, weight):
    """The exact slack-block equivalent: weight * relu(max g)^2."""
    smax = relu_max(g)
    return weight * smax * smax


def relu_max_grad(vals, grads):
    """(relu(max vals), its gradient) for vals (..., G) with gradients
    grads (..., G, n): the even tie split of the VJPs of jnp.max and
    jnp.maximum(0, .) (half a gradient at exactly 0); an empty group gives
    0 and a zero gradient."""
    if vals.shape[-1] == 0:
        return (vals.new_zeros(vals.shape[:-1]),
                grads.new_zeros(grads.shape[:-2] + grads.shape[-1:]))
    gmax = torch.amax(vals, dim=-1)
    tie = (vals == gmax[..., None]).to(vals.dtype)
    live = torch.where(gmax > 0, 1.0,
                       torch.where(gmax == 0, 0.5, 0.0)).to(vals.dtype)
    live = live / torch.sum(tie, dim=-1)
    sgrad = torch.einsum("...g,...gn->...n", tie, grads) * live[..., None]
    return torch.clamp(gmax, min=0.0), sgrad


def ground_circle_g_grad(xy_x, xy_y, obstacles, body_radius):
    """``ground_circle_g`` (..., n_obs) and its gradient in (x, y)
    (..., n_obs, 2)."""
    dx = xy_x[..., None] - obstacles[:, 0]
    dy = xy_y[..., None] - obstacles[:, 1]
    d = safe_dist(dx, dy)
    return ((obstacles[:, 2] + body_radius) - d,
            torch.stack([-dx / d, -dy / d], dim=-1))


def sphere_g_grad(v, jac, radius=SELF_COLLISION_RADIUS):
    """radius - ||v|| for offsets v (..., n_r, 3) (``self_collision_g``'s
    rows with v = check - ee), and its gradient through jac = dv/dz
    (..., n_r, 3, n)."""
    n = safe_norm(v, dim=-1)
    return radius - n, -torch.einsum("...rc,...rcj->...rj", v / n[..., None],
                                     jac)


def halfplane_union_g_grad(points, jac, hp_points, hp_normals, hp_mask,
                           expand=OBSTACLE_EXPAND_DIST):
    """``halfplane_union_g`` (..., n_p) and its gradient through
    jac = d points / dz (..., n_p, 3, n): d(-max_f d_f)/dp is the tie-split
    mean of the maximal faces' normals; zero when no face is live."""
    o = hp_points - expand * hp_normals
    d = torch.sum(hp_normals * (o - points[..., :, None, :]), dim=-1)
    d = torch.where(hp_mask > 0, d, NEG_BIG)                  # (..., n_p, n_hp)
    dmax = torch.amax(d, dim=-1)
    live = torch.sum(hp_mask) > 0
    tie = (d == dmax[..., None]).to(points.dtype)
    n_eff = (tie / torch.sum(tie, dim=-1, keepdim=True)) @ hp_normals
    return (torch.where(live, -dmax, NEG_BIG),
            torch.where(live, torch.einsum("...rc,...rcj->...rj", n_eff, jac),
                        0.0))

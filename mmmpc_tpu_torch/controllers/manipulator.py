"""3-DoF arm MPC with self-collision and a convex obstacle (counterpart of
``mmmpc_tpu/controllers/manipulator.py``).

As in the reference: the self-collision spheres are HARD constraints (AL
rows, no slack); the convex obstacle (a union of half-planes through one
point) has its own per-stage slack with weight 1e6, folded as
1e6 * relu(max_i -maxc_i)^2 over the six sampled link points; there is no
obstacle expansion margin; positions are in the ARM frame; M is the
input-rate weight.  The reference tracks the joints, or with
``is_cartesian_ref`` the end point: X_ref then holds arm-frame end-point
positions (N+1, 3), and the tracking error is FK(q)_ee - ref.  Its fused
iLQR kernels are the generic ones with the formulation of
``csrc/generic_arm.cu``: ``gen::Arm<false>`` (entries ``*_arm``) for the
joints, ``gen::Arm<true>`` (``*_arm_cart``) for the end point.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mmmpc_tpu_torch.controllers.common import (
    GENERIC_PER_SCENARIO_KEYS, ControllerBase, as_weight_matrix, mv, no_rows,
    outer, quad, ref_rows, weight, wmv, wquad,
)
from mmmpc_tpu_torch.models.arm import (
    arm_fk, arm_fk_partials, arm_step, ee_jacobian,
)
from mmmpc_tpu_torch.ocp.constraints import (
    halfplane_union_g, halfplane_union_g_grad, manipulator_sample_points,
    relu_max_grad, relu_max_penalty, self_collision_g, sphere_g_grad,
)
from mmmpc_tpu_torch.ocp.spec import OCP
from mmmpc_tpu_torch.ops.generic_bwd import GenericBwdFused
from mmmpc_tpu_torch.ops.generic_fwd import Formulation, GenericFwdLinesearch
from mmmpc_tpu_torch.utils.configs import SolverConfig

PI = math.pi
SLACK_WEIGHT = 1e6   # reference WEIGHT (mpc_manipulator_3DoF.py:5)

# Rows of coefficients over the arm points (j2, j3, ee): the six sampled
# link points, and each self-collision check point minus ee.
_HP_POINTS = ((0.5, 0.0, 0.0), (1.0, 0.0, 0.0), (0.5, 0.5, 0.0),
              (0.0, 1.0, 0.0), (0.0, 0.5, 0.5), (0.0, 0.0, 1.0))
_SELF_DIFF = ((0.0, 0.0, -1.0), (0.5, 0.0, -1.0), (1.0, 0.0, -1.0),
              (0.5, 0.5, -1.0))


def _arm_points(q, coefs):
    """Arm-frame points sum_p coefs[r, p] (j2, j3, ee)_p as (..., R, 3)
    (y == 0) and their q-Jacobians (..., R, 3, 3)."""
    ax, az, ax_q, az_q = arm_fk_partials(q)
    C = torch.tensor(coefs, dtype=q.dtype, device=q.device)
    x, z = ax @ C.T, az @ C.T
    jx = torch.einsum("rp,...pq->...rq", C, ax_q)
    jz = torch.einsum("rp,...pq->...rq", C, az_q)
    return (torch.stack([x, torch.zeros_like(x), z], dim=-1),
            torch.stack([jx, torch.zeros_like(jx), jz], dim=-2))


class MPCManipulator3DoF(ControllerBase):
    NX, NU = 3, 3

    def __init__(self, robot, obstacle_surfaces_manipulation,
                 obstacle_point_manipulation, N=10,
                 Q=np.diag([1, 1.0, 1]), P=np.diag([1, 1.0, 1]),
                 R=np.diag([0.1, 0.1, 0.1]),
                 M=np.diag([1e-2, 1e-2, 1e-2]),
                 qlim=(np.array([-PI / 2, -PI, 0]), np.array([PI / 2, 0, PI])),
                 dqlim=(np.array([-1, -1, -1.0]), np.array([1, 1, 1.0])),
                 ddqlim=(np.array([-0.5] * 3), np.array([0.5] * 3)),
                 is_cartesian_ref: bool = False,
                 solver_config: SolverConfig | None = None, device=None):
        self.dt = robot.dt
        self.is_cartesian_ref = is_cartesian_ref
        self.qlim = tuple(np.asarray(v, dtype=float).reshape(-1) for v in qlim)
        self.dqlim = tuple(np.asarray(v, dtype=float).reshape(-1)
                           for v in dqlim)
        self.ddqlim = tuple(np.asarray(v, dtype=float).reshape(-1)
                            for v in ddqlim)
        self.Q_value = as_weight_matrix(Q, self.NX)
        self.P_value = as_weight_matrix(P, self.NX)
        self.R_value = as_weight_matrix(R, self.NU)
        self.M_value = as_weight_matrix(M, self.NU)

        # one half-plane union through one point (arm frame, no expansion)
        point = np.asarray(obstacle_point_manipulation, dtype=float)
        normals = ([np.asarray(n, dtype=float).reshape(3)
                    for n in obstacle_surfaces_manipulation]
                   if point.size else [])
        self.n_hp = max(len(normals), 1)
        self.hp_points_value = np.zeros((self.n_hp, 3))
        self.hp_normals_value = np.zeros((self.n_hp, 3))
        self.hp_mask_value = np.zeros((self.n_hp,))
        for j, nvec in enumerate(normals):
            self.hp_points_value[j] = point.reshape(3)
            self.hp_normals_value[j] = nvec
            self.hp_mask_value[j] = 1.0
        super().__init__(self._build_ocp(N), solver_config or SolverConfig(),
                         device)

    def _build_ocp(self, N):
        dt = self.dt
        (qlo, qhi), (ddlo, ddhi) = self.qlim, self.ddqlim
        cartesian = self.is_cartesian_ref

        def wedge(q, p):
            ee, j2, j3 = arm_fk(q)
            return halfplane_union_g(manipulator_sample_points(ee, j2, j3),
                                     p["hp_points"], p["hp_normals"],
                                     p["hp_mask"], expand=0.0)

        def selfcol(q):
            return self_collision_g(*arm_fk(q))

        def state_error(q, ref):
            return arm_fk(q)[0] - ref if cartesian else q - ref

        def stage_cost(q, dq, k, p):
            c = (wquad(state_error(q, ref_rows(p, "X_ref", k)),
                       weight(p, "Q", k))
                 + quad(dq - ref_rows(p, "U_ref", k), p["R"])
                 + quad(dq - ref_rows(p, "U_last", k), p["M"]))
            return c + relu_max_penalty(wedge(q, p), SLACK_WEIGHT)

        def terminal_cost(q, p):
            return (wquad(state_error(q, ref_rows(p, "X_ref", N)),
                          weight(p, "P"))
                    + relu_max_penalty(wedge(q, p), SLACK_WEIGHT))

        def box(v, lo, hi):
            kw = dict(dtype=v.dtype, device=v.device)
            return torch.cat([v - torch.as_tensor(hi, **kw),
                              torch.as_tensor(lo, **kw) - v], dim=-1)

        def stage_ineq(q, dq, k, p):
            return torch.cat([box(q, qlo, qhi),
                              box(dq - ref_rows(p, "U_last", k), ddlo, ddhi),
                              selfcol(q)], dim=-1)

        def terminal_ineq(q, p):
            return torch.cat([box(q, qlo, qhi), selfcol(q)], dim=-1)

        # structured AL expansion: joint-space tracking has the weight as its
        # Hessian (Cartesian: Je^T W Je through the closed-form end-point
        # Jacobian), the wedge slack is one rank-1 term, the boxes are
        # diagonal, the four hard self-collision rows a Gauss-Newton product
        # through their closed-form q-Jacobian
        def track(q, ref, W):
            """(Je^T W e, Je^T W Je) of the tracking error e."""
            if not cartesian:
                return wmv(W, q - ref), W
            Je = ee_jacobian(q)
            return ((Je.mT @ wmv(W, state_error(q, ref))[..., None])[..., 0],
                    Je.mT @ W @ Je)

        def tracking(q, p, ref, W):
            smax, sq = relu_max_grad(*halfplane_union_g_grad(
                *_arm_points(q, _HP_POINTS), p["hp_points"], p["hp_normals"],
                p["hp_mask"], expand=0.0))
            g, H = track(q, ref, W)
            return (g + (SLACK_WEIGHT * smax)[..., None] * sq,
                    H + SLACK_WEIGHT * outer(sq, sq))

        def q_rows(q, t, act, mu):
            """q-box rows t[0:6] and self-collision rows t[6:10]."""
            _, Jsc = sphere_g_grad(*_arm_points(q, _SELF_DIFF))
            g = t[..., 0:3] - t[..., 3:6] + (Jsc.mT @ t[..., 6:10, None])[..., 0]
            H = (torch.diag_embed(mu * (act[..., 0:3] + act[..., 3:6]))
                 + mu * (Jsc.mT * act[..., None, 6:10]) @ Jsc)
            return g, H

        def stage_al_expansion(q, dq, k, p, lam_k, mu, inv_scale):
            two_s = 2.0 * inv_scale
            gq, Hqq = tracking(q, p, ref_rows(p, "X_ref", k),
                               weight(p, "Q", k))
            t = torch.clamp(lam_k + mu * stage_ineq(q, dq, k, p), min=0.0)
            act = (t > 0).to(q.dtype)
            g, H = q_rows(q, torch.cat([t[..., :6], t[..., 12:]], -1),
                          torch.cat([act[..., :6], act[..., 12:]], -1), mu)
            gu = (two_s * (mv(p["R"], dq - ref_rows(p, "U_ref", k))
                           + mv(p["M"], dq - ref_rows(p, "U_last", k)))
                  + t[..., 6:9] - t[..., 9:12])
            Huu = two_s * (p["R"] + p["M"]) + torch.diag_embed(
                mu * (act[..., 6:9] + act[..., 9:12]))
            return (two_s * gq + g, gu, two_s * Hqq + H, Huu,
                    q.new_zeros(gu.shape + (3,)))

        def terminal_al_expansion(q, p, lam_t, lam_e, mu, inv_scale):
            two_s = 2.0 * inv_scale
            gq, Hqq = tracking(q, p, ref_rows(p, "X_ref", N), weight(p, "P"))
            t = torch.clamp(lam_t + mu * terminal_ineq(q, p), min=0.0)
            g, H = q_rows(q, t, (t > 0).to(q.dtype), mu)
            return two_s * gq + g, two_s * Hqq + H

        def dynamics_jacobians(q, dq):
            eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(
                q.shape + (3,))
            return eye, dt * eye

        form = Formulation(
            "arm_cart" if cartesian else "arm", self._packed_shapes(N),
            np.concatenate([[SLACK_WEIGHT], qlo, qhi, ddlo, ddhi]), dt,
            u_clamp=self.dqlim, nc=16, nct=10, n_hp=self.n_hp)

        def lanes_fwd_factory(cfg, params):
            alphas = [cfg.alpha_decay ** i for i in range(cfg.n_alpha)]
            return GenericFwdLinesearch(form, self.ocp, params, alphas=alphas,
                                        inv_scale=1.0 / cfg.cost_scale)

        def lanes_bwd_factory(cfg, params):
            return GenericBwdFused(form, self.ocp, params,
                                   inv_scale=1.0 / cfg.cost_scale)

        return OCP(
            nx=self.NX, nu=self.NU, N=N,
            dynamics=lambda q, dq: arm_step(q, dq, dt),
            stage_cost=stage_cost, terminal_cost=terminal_cost,
            stage_ineq=stage_ineq, terminal_ineq=terminal_ineq,
            terminal_eq=no_rows,
            u_lower=self.dqlim[0], u_upper=self.dqlim[1],
            lanes_fwd_factory=lanes_fwd_factory,
            lanes_bwd_factory=lanes_bwd_factory,
            stage_al_expansion=stage_al_expansion,
            terminal_al_expansion=terminal_al_expansion,
            dynamics_jacobians=dynamics_jacobians,
            per_scenario_keys=GENERIC_PER_SCENARIO_KEYS | {"U_last"})

    def _packed_shapes(self, N):
        """The kernels' packed buffer (``csrc/generic_arm.cu::Arm::layout``)."""
        return {"Q": (3, 3), "R": (3, 3), "P": (3, 3), "M": (3, 3),
                "X_ref": (N + 1, 3), "U_ref": (N, 3), "U_last": (N, 3),
                "hp_points": (self.n_hp, 3), "hp_normals": (self.n_hp, 3),
                "hp_mask": (self.n_hp,)}

    def reset(self):
        """Clear the warm start."""
        self.reset_warmstart()

    def make_params(self, traj_ref, u_ref) -> dict[str, np.ndarray]:
        """The per-problem data as host arrays (``U_last`` is added by the
        caller, as in the JAX package)."""
        return {"X_ref": np.asarray(traj_ref, dtype=float),
                "U_ref": np.asarray(u_ref, dtype=float),
                "Q": self.Q_value, "R": self.R_value, "P": self.P_value,
                "M": self.M_value, "hp_points": self.hp_points_value,
                "hp_normals": self.hp_normals_value,
                "hp_mask": self.hp_mask_value}

    def solve(self, x_init, traj_ref, u_ref):
        """One receding-horizon tick on the controller's device: ``x_init``
        clamped into the joint box (infeasible sensor feedback), then
        q2 <= 0 and q3 >= 0 required; returns u[0] as a numpy (3,) array."""
        x_init = np.clip(np.asarray(x_init, dtype=float), *self.qlim)
        if not (x_init[1] <= 0 and x_init[2] >= 0):
            raise ValueError(f"arm joints q2 = {x_init[1]} > 0 or "
                             f"q3 = {x_init[2]} < 0 after the clamp")
        return self._solve_impl(x_init, self.make_params(traj_ref, u_ref))

"""Whole-body MPC tracking a Cartesian end-point pose reference
(counterpart of ``mmmpc_tpu/controllers/wholebody_endpoint.py``).

The 9-state / 5-input model of the qref controller, but the tracking error
is the world end-effector pose [x, y, z, psi] against a (N+1, 4) reference.
Ground obstacles with slack only (the reference's 3-D manipulator obstacles
were a TODO there, and are absent here too), input-rate cost and limits,
and the tighter arm bounds q2 in [-3pi/4, 0], q3 in [0, pi].  Its fused
iLQR kernels are the generic ones with the formulation of
``csrc/generic_endpoint.cu``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mmmpc_tpu_torch.controllers.common import (
    ControllerBase, as_weight_matrix, finite_bound_masks, mv, no_rows, outer,
    quad, scalar_weight,
)
from mmmpc_tpu_torch.models.mobile_manipulator import (
    wholebody_fk, wholebody_jacobians, wholebody_pose_jacobian,
    wholebody_step,
)
from mmmpc_tpu_torch.models.obstacles import ground_obstacle_array
from mmmpc_tpu_torch.ocp.constraints import (
    box_g, ground_circle_g, ground_circle_g_grad, relu_max_grad,
    relu_max_penalty,
)
from mmmpc_tpu_torch.ocp.spec import OCP
from mmmpc_tpu_torch.ops.generic_bwd import GenericBwdFused
from mmmpc_tpu_torch.ops.generic_fwd import Formulation, GenericFwdLinesearch
from mmmpc_tpu_torch.utils.configs import SolverConfig

PI = math.pi

_DEFAULT_XLIM = np.array([
    [-100, -100, -np.inf, -2, -2, -PI, -PI / 2, -PI * 3 / 4, 0],
    [100, 100, np.inf, 2, 2, PI, PI / 2, 0, PI],
])


class MPCWholeBodyEndpoint(ControllerBase):
    NX, NU = 9, 5

    def __init__(self, robot, obstacle_list, N=10,
                 Q=5 * np.diag([1, 1, 1, 1.0]),
                 P=50 * np.diag([1, 1, 1, 1.0]),
                 R=np.diag([0.1, 0.1, 0.0, 0.0, 0.0]),
                 S=np.diag([1e5]),
                 W=np.diag([0, 0, 1e-1, 1e-1, 1e-1]),
                 ulim=np.array([[-2, -PI, -1, -1, -1], [2, PI, 1, 1, 1.0]]),
                 xlim=_DEFAULT_XLIM,
                 dulim=np.array([[-np.inf, -np.inf, -0.5, -0.5, -0.5],
                                 [np.inf, np.inf, 0.5, 0.5, 0.5]]),
                 solver_config: SolverConfig | None = None, device=None):
        self.dt = robot.dt
        self.base_radius = robot.base.base_radius()
        self.obstacle_list = obstacle_list
        self.Q_value = as_weight_matrix(Q, 4)
        self.P_value = as_weight_matrix(P, 4)
        self.R_value = as_weight_matrix(R, self.NU)
        self.W_value = as_weight_matrix(W, self.NU)
        self.S_value = scalar_weight(S)
        self.ulim = np.asarray(ulim, dtype=float)
        self.xlim = np.asarray(xlim, dtype=float)
        self.dulim = np.asarray(dulim, dtype=float)
        self.obstacles_value = ground_obstacle_array(obstacle_list)
        self.x_bounds = finite_bound_masks(self.xlim)
        self.du_bounds = finite_bound_masks(self.dulim)
        super().__init__(self._build_ocp(N), solver_config or SolverConfig(),
                         device)

    def _build_ocp(self, N):
        dt, radius = self.dt, self.base_radius
        nx, nu = self.NX, self.NU
        x_lo, x_hi, x_mlo, x_mhi = self.x_bounds
        du_lo, du_hi, du_mlo, du_mhi = self.du_bounds

        def slack_pen(x, p):
            return relu_max_penalty(ground_circle_g(
                x[..., 0], x[..., 1], p["obstacles"], radius), p["S"])

        def pose_error(x, ref):
            return wholebody_fk(x)[0] - ref

        def stage_cost(x, u, k, p):
            return (quad(pose_error(x, p["X_ref"][k]), p["Q"])
                    + quad(u - p["U_ref"][k], p["R"])
                    + quad(u - p["U_last"][k], p["W"]) + slack_pen(x, p))

        def terminal_cost(x, p):
            return quad(pose_error(x, p["X_ref"][N]), p["P"]) + slack_pen(x, p)

        def stage_ineq(x, u, k, p):
            return torch.cat([box_g(x, x_lo, x_hi, x_mlo, x_mhi),
                              box_g(u - p["U_last"][k], du_lo, du_hi, du_mlo,
                                    du_mhi)], dim=-1)

        def terminal_ineq(x, p):
            return box_g(x, x_lo, x_hi, x_mlo, x_mhi)

        # structured AL expansion: the pose tracking's Gauss-Newton block is
        # Jp^T W Jp with the closed-form pose Jacobian, the ground slack one
        # rank-1 term, and all hard rows boxes (diagonal; masked rows
        # self-deactivate through the PHR max)
        def tracking(x, p, ref, Wt):
            Jp = wholebody_pose_jacobian(x)                     # (..., 4, 9)
            vals, g2 = ground_circle_g_grad(x[..., 0], x[..., 1],
                                            p["obstacles"], radius)
            smax, sxy = relu_max_grad(vals, g2)
            sx = torch.nn.functional.pad(sxy, (0, nx - 2))
            S = p["S"]
            gx = ((Jp.mT @ mv(Wt, pose_error(x, ref))[..., None])[..., 0]
                  + (S * smax)[..., None] * sx)
            return gx, Jp.mT @ Wt @ Jp + S * outer(sx, sx)

        def box_rows(t, mu, n):
            act = (t > 0).to(t.dtype)
            return (t[..., :n] - t[..., n:],
                    torch.diag_embed(mu * (act[..., :n] + act[..., n:])))

        def stage_al_expansion(x, u, k, p, lam_k, mu, inv_scale):
            two_s = 2.0 * inv_scale
            gx, Hxx = tracking(x, p, p["X_ref"][k], p["Q"])
            t = torch.clamp(lam_k + mu * stage_ineq(x, u, k, p), min=0.0)
            g, H = box_rows(t[..., :2 * nx], mu, nx)
            gdu, Hdu = box_rows(t[..., 2 * nx:], mu, nu)
            gu = two_s * (mv(p["R"], u - p["U_ref"][k])
                          + mv(p["W"], u - p["U_last"][k])) + gdu
            return (two_s * gx + g, gu, two_s * Hxx + H,
                    two_s * (p["R"] + p["W"]) + Hdu,
                    x.new_zeros(gu.shape + (nx,)))

        def terminal_al_expansion(x, p, lam_t, lam_e, mu, inv_scale):
            two_s = 2.0 * inv_scale
            gx, Hxx = tracking(x, p, p["X_ref"][N], p["P"])
            t = torch.clamp(lam_t + mu * terminal_ineq(x, p), min=0.0)
            g, H = box_rows(t, mu, nx)
            return two_s * gx + g, two_s * Hxx + H

        form = Formulation(
            "endpoint", self._packed_shapes(N),
            np.concatenate([[radius], *self.x_bounds, *self.du_bounds]), dt,
            u_clamp=(self.ulim[0], self.ulim[1]), nc=2 * nx + 2 * nu,
            nct=2 * nx, n_obs=len(self.obstacles_value))

        def lanes_fwd_factory(cfg, params):
            alphas = [cfg.alpha_decay ** i for i in range(cfg.n_alpha)]
            return GenericFwdLinesearch(form, self.ocp, params, alphas=alphas,
                                        inv_scale=1.0 / cfg.cost_scale)

        def lanes_bwd_factory(cfg, params):
            return GenericBwdFused(form, self.ocp, params,
                                   inv_scale=1.0 / cfg.cost_scale)

        return OCP(
            nx=nx, nu=nu, N=N, dynamics=lambda x, u: wholebody_step(x, u, dt),
            stage_cost=stage_cost, terminal_cost=terminal_cost,
            stage_ineq=stage_ineq, terminal_ineq=terminal_ineq,
            terminal_eq=no_rows,
            u_lower=self.ulim[0], u_upper=self.ulim[1],
            lanes_fwd_factory=lanes_fwd_factory,
            lanes_bwd_factory=lanes_bwd_factory,
            stage_al_expansion=stage_al_expansion,
            terminal_al_expansion=terminal_al_expansion,
            dynamics_jacobians=lambda x, u: wholebody_jacobians(x, u, dt))

    def _packed_shapes(self, N):
        """The kernels' packed buffer (``csrc/generic_endpoint.cu::Endpoint::
        layout``)."""
        return {"Q": (4, 4), "R": (5, 5), "P": (4, 4), "S": (), "W": (5, 5),
                "X_ref": (N + 1, 4), "U_ref": (N, 5), "U_last": (N, 5),
                "obstacles": (len(self.obstacles_value), 3)}

    def reset(self):
        """Clear the warm start."""
        self.reset_warmstart()

    def make_params(self, traj_ref, u_ref) -> dict[str, np.ndarray]:
        """The per-problem data as host arrays (``U_last`` is added by the
        caller, as in the JAX package)."""
        return {"X_ref": np.asarray(traj_ref, dtype=float),
                "U_ref": np.asarray(u_ref, dtype=float),
                "Q": self.Q_value, "R": self.R_value, "P": self.P_value,
                "S": np.asarray(self.S_value), "W": self.W_value,
                "obstacles": self.obstacles_value}

    def solve(self, x_init, traj_ref, u_ref):
        """One receding-horizon tick on the controller's device: ``x_init``
        clamped into the state box, then the arm's q2 <= 0 and q3 >= 0
        required; returns u[0] as a numpy (5,) array."""
        x_init = np.clip(np.asarray(x_init, dtype=float), self.xlim[0],
                         self.xlim[1])
        if not (x_init[7] <= 0 and x_init[8] >= 0):
            raise ValueError(f"arm joints q2 = {x_init[7]} > 0 or "
                             f"q3 = {x_init[8]} < 0 after the clamp")
        return self._solve_impl(x_init, self.make_params(traj_ref, u_ref))

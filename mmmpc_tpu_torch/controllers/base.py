"""Diff-drive base point-tracking MPC with ground-obstacle avoidance
(counterpart of ``mmmpc_tpu/controllers/base.py``).

As in the reference: the yaw tracking error is the wrapped angle
difference, the 5-wide xlim boxes (x, y) and (dx, dy, dpsi) with the yaw
unbounded, the obstacle circles share one slack per stage with weight M,
i.e. the exact penalty M * relu(max g)^2, and there is no input-rate term.
The yaw error is wrapped as ``a - 2 pi floor((a + pi) / 2 pi)``, written the
same way in the kernels (``csrc/generic_common.cuh::wrap_pi``).  Its fused
iLQR kernels are the generic ones with the formulation of
``csrc/generic_base.cu``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mmmpc_tpu_torch.controllers.common import (
    GENERIC_PER_SCENARIO_KEYS, ControllerBase, as_weight_matrix, mv, no_rows,
    outer, quad, ref_rows, scalar_weight, weight, wmv, wquad,
)
from mmmpc_tpu_torch.models.base import base_jacobians, base_step
from mmmpc_tpu_torch.models.obstacles import ground_obstacle_array
from mmmpc_tpu_torch.ocp.constraints import (
    ground_circle_g, ground_circle_g_grad, relu_max_grad, relu_max_penalty,
)
from mmmpc_tpu_torch.ocp.spec import OCP
from mmmpc_tpu_torch.ops.generic_bwd import GenericBwdFused
from mmmpc_tpu_torch.ops.generic_fwd import Formulation, GenericFwdLinesearch
from mmmpc_tpu_torch.utils.configs import SolverConfig

PI = math.pi
_BOX = (0, 1, 3, 4, 5)      # state indices of the xlim columns


def _yaw_error(a):
    """a wrapped into [-pi, pi) with a floored modulo."""
    return a - 2.0 * PI * torch.floor((a + PI) / (2.0 * PI))


class MPCBase(ControllerBase):
    NX, NU = 6, 2

    def __init__(self, robot, obstacle_list, N=10,
                 Q=np.diag([5.0, 5.0, 0.0, 0, 0, 1.0]),
                 P=np.diag([5.0, 5.0, 0.0, 0, 0, 1.0]),
                 R=np.diag([1.0, 1.0]),
                 M=np.diag([1e5]),
                 ulim=np.array([[-2, -PI], [2, PI]]),
                 xlim=np.array([[-100, -100, -2, -2, -PI],
                                [100, 100, 2, 2, PI]]),
                 solver_config: SolverConfig | None = None, device=None):
        self.dt = robot.dt
        self.base_radius = robot.base_radius()
        self.obstacle_list = obstacle_list
        self.Q_value = as_weight_matrix(Q, self.NX)
        self.P_value = as_weight_matrix(P, self.NX)
        self.R_value = as_weight_matrix(R, self.NU)
        self.M_value = scalar_weight(M)
        self.ulim = np.asarray(ulim, dtype=float)
        self.xlim = np.asarray(xlim, dtype=float)
        self.obstacles_value = ground_obstacle_array(obstacle_list)
        super().__init__(self._build_ocp(N), solver_config or SolverConfig(),
                         device)

    def _build_ocp(self, N):
        dt, radius = self.dt, self.base_radius
        box = list(_BOX)

        def state_error(x, ref):
            e = x - ref
            return torch.cat([e[..., :2], _yaw_error(e[..., 2:3]),
                              e[..., 3:]], dim=-1)

        def slack(x, p):
            return ground_circle_g(x[..., 0], x[..., 1], p["obstacles"],
                                   radius)

        def stage_cost(x, u, k, p):
            return (wquad(state_error(x, ref_rows(p, "X_ref", k)),
                          weight(p, "Q", k))
                    + quad(u - ref_rows(p, "U_ref", k), p["R"])
                    + relu_max_penalty(slack(x, p), p["M"]))

        def terminal_cost(x, p):
            return (wquad(state_error(x, ref_rows(p, "X_ref", N)),
                          weight(p, "P"))
                    + relu_max_penalty(slack(x, p), p["M"]))

        def box6(x, *_):
            kw = dict(dtype=x.dtype, device=x.device)
            v = x[..., box]
            return torch.cat([v - torch.as_tensor(self.xlim[1], **kw),
                              torch.as_tensor(self.xlim[0], **kw) - v], dim=-1)

        # structured AL expansion: the wrapped yaw error has unit slope a.e.,
        # so the tracking Hessian is the weight itself; the slack is one
        # rank-1 term; the box rows are diagonal
        def tracking(x, p, ref, W):
            vals, g2 = ground_circle_g_grad(x[..., 0], x[..., 1],
                                            p["obstacles"], radius)
            smax, sxy = relu_max_grad(vals, g2)
            sx = torch.nn.functional.pad(sxy, (0, 4))
            return (wmv(W, state_error(x, ref))
                    + (p["M"] * smax)[..., None] * sx,
                    W + p["M"] * outer(sx, sx))

        def box_rows(x, lam, mu):
            t = torch.clamp(lam + mu * box6(x), min=0.0)
            act = (t > 0).to(x.dtype)
            g = torch.zeros_like(x)
            h = torch.zeros_like(x)
            g[..., box] = t[..., :5] - t[..., 5:]
            h[..., box] = mu * (act[..., :5] + act[..., 5:])
            return g, torch.diag_embed(h)

        def stage_al_expansion(x, u, k, p, lam_k, mu, inv_scale):
            two_s = 2.0 * inv_scale
            gx, Hxx = tracking(x, p, ref_rows(p, "X_ref", k),
                               weight(p, "Q", k))
            g, H = box_rows(x, lam_k, mu)
            gu = two_s * mv(p["R"], u - ref_rows(p, "U_ref", k))
            return (two_s * gx + g, gu, two_s * Hxx + H,
                    (two_s * p["R"]).expand(gu.shape + (2,)),
                    x.new_zeros(gu.shape + (6,)))

        def terminal_al_expansion(x, p, lam_t, lam_e, mu, inv_scale):
            two_s = 2.0 * inv_scale
            gx, Hxx = tracking(x, p, ref_rows(p, "X_ref", N), weight(p, "P"))
            g, H = box_rows(x, lam_t, mu)
            return two_s * gx + g, two_s * Hxx + H

        form = Formulation(
            "base", self._packed_shapes(N),
            np.concatenate([[radius], self.xlim[0], self.xlim[1]]), dt,
            u_clamp=(self.ulim[0], self.ulim[1]), nc=10, nct=10,
            n_obs=len(self.obstacles_value))

        def lanes_fwd_factory(cfg, params):
            alphas = [cfg.alpha_decay ** i for i in range(cfg.n_alpha)]
            return GenericFwdLinesearch(form, self.ocp, params, alphas=alphas,
                                        inv_scale=1.0 / cfg.cost_scale)

        def lanes_bwd_factory(cfg, params):
            return GenericBwdFused(form, self.ocp, params,
                                   inv_scale=1.0 / cfg.cost_scale)

        return OCP(
            nx=self.NX, nu=self.NU, N=N,
            dynamics=lambda x, u: base_step(x, u, dt),
            stage_cost=stage_cost, terminal_cost=terminal_cost,
            stage_ineq=box6, terminal_ineq=box6, terminal_eq=no_rows,
            u_lower=self.ulim[0], u_upper=self.ulim[1],
            lanes_fwd_factory=lanes_fwd_factory,
            lanes_bwd_factory=lanes_bwd_factory,
            stage_al_expansion=stage_al_expansion,
            terminal_al_expansion=terminal_al_expansion,
            dynamics_jacobians=lambda x, u: base_jacobians(x, u, dt),
            per_scenario_keys=GENERIC_PER_SCENARIO_KEYS)

    def _packed_shapes(self, N):
        """The kernels' packed buffer (``csrc/generic_base.cu::Base::
        layout``)."""
        return {"Q": (6, 6), "R": (2, 2), "P": (6, 6), "M": (),
                "X_ref": (N + 1, 6), "U_ref": (N, 2),
                "obstacles": (len(self.obstacles_value), 3)}

    def reset(self):
        """Clear the warm start."""
        self.reset_warmstart()

    def setWeight(self, Q=None, R=None, P=None, M=None):
        """Runtime weight mutation (takes effect at the next make_params)."""
        if Q is not None:
            self.Q_value = as_weight_matrix(Q, self.NX)
        if R is not None:
            self.R_value = as_weight_matrix(R, self.NU)
        if P is not None:
            self.P_value = as_weight_matrix(P, self.NX)
        if M is not None:
            self.M_value = scalar_weight(M)

    def angleDiff(self, a, b):
        from mmmpc_tpu_torch.utils.math import angle_diff
        return angle_diff(a, b)

    def make_params(self, traj_ref, u_ref) -> dict[str, np.ndarray]:
        """The per-problem data as host arrays."""
        return {"X_ref": np.asarray(traj_ref, dtype=float),
                "U_ref": np.asarray(u_ref, dtype=float),
                "Q": self.Q_value, "R": self.R_value, "P": self.P_value,
                "M": np.asarray(self.M_value),
                "obstacles": self.obstacles_value}

    def solve(self, x_init, traj_ref, u_ref):
        """One receding-horizon tick on the controller's device; returns u[0]
        as a numpy (2,) array."""
        return self._solve_impl(np.asarray(x_init, dtype=float),
                                self.make_params(traj_ref, u_ref))

"""1-D point-mass demo MPC, the simplest instance of the controller pattern
(counterpart of ``mmmpc_tpu/controllers/demo.py``).

Double integrator, position / velocity tracking, an acceleration input box,
a hard velocity box on the running states (the terminal state is
unbounded, as in the reference).  Its fused iLQR kernels are the generic
ones (``ops/generic_fwd.py``, ``ops/generic_bwd.py``) with the formulation
of ``csrc/generic_demo.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from mmmpc_tpu_torch.controllers.common import (
    GENERIC_PER_SCENARIO_KEYS, ControllerBase, as_weight_matrix, mv, no_rows,
    quad, ref_rows, weight, wmv, wquad,
)
from mmmpc_tpu_torch.models.point_mass import point_mass_step
from mmmpc_tpu_torch.ocp.spec import OCP
from mmmpc_tpu_torch.ops.generic_bwd import GenericBwdFused
from mmmpc_tpu_torch.ops.generic_fwd import Formulation, GenericFwdLinesearch
from mmmpc_tpu_torch.utils.configs import SolverConfig


class MPC(ControllerBase):
    NX, NU = 2, 1

    def __init__(self, robot, N=10, Q=np.diag([1.0, 0.0]),
                 P=np.diag([1.0, 0.0]), R=np.diag([0.1]),
                 vlim=(-1, 1), alim=(-5, 5),
                 solver_config: SolverConfig | None = None, device=None):
        self.dt = robot.dt
        self.vlim = (float(vlim[0]), float(vlim[1]))
        self.alim = (float(alim[0]), float(alim[1]))
        self.Q_value = as_weight_matrix(Q, self.NX)
        self.P_value = as_weight_matrix(P, self.NX)
        self.R_value = as_weight_matrix(R, self.NU)
        super().__init__(self._build_ocp(N), solver_config or SolverConfig(),
                         device)

    def _build_ocp(self, N):
        dt = self.dt
        vlo, vhi = self.vlim

        def stage_cost(x, u, k, p):
            return (wquad(x - ref_rows(p, "X_ref", k), weight(p, "Q", k))
                    + quad(u - ref_rows(p, "U_ref", k), p["R"]))

        def terminal_cost(x, p):
            return wquad(x - ref_rows(p, "X_ref", N), weight(p, "P"))

        def stage_ineq(x, u, k, p):
            return torch.stack([x[..., 1] - vhi, vlo - x[..., 1]], dim=-1)

        # structured AL expansion: everything is quadratic or diagonal
        def stage_al_expansion(x, u, k, p, lam_k, mu, inv_scale):
            two_s = 2.0 * inv_scale
            t = torch.clamp(lam_k + mu * stage_ineq(x, u, k, p), min=0.0)
            act = (t > 0).to(x.dtype)
            zero = torch.zeros_like(t[..., 0])
            gx = (two_s * wmv(weight(p, "Q", k), x - ref_rows(p, "X_ref", k))
                  + torch.stack([zero, t[..., 0] - t[..., 1]], dim=-1))
            gu = two_s * mv(p["R"], u - ref_rows(p, "U_ref", k))
            Hxx = two_s * weight(p, "Q", k) + torch.diag_embed(torch.stack(
                [zero, mu * (act[..., 0] + act[..., 1])], dim=-1))
            Huu = (two_s * p["R"]).expand(gu.shape + (1,))
            Hux = x.new_zeros(gu.shape + (2,))
            return gx, gu, Hxx, Huu, Hux

        def terminal_al_expansion(x, p, lam_t, lam_e, mu, inv_scale):
            two_s = 2.0 * inv_scale
            P = weight(p, "P")
            return (two_s * wmv(P, x - ref_rows(p, "X_ref", N)),
                    (two_s * P).expand(x.shape + (2,)))

        def dynamics_jacobians(x, u):
            kw = dict(dtype=x.dtype, device=x.device)
            A = torch.tensor([[1.0, dt], [0.0, 1.0]], **kw)
            Bm = torch.tensor([[0.0], [dt]], **kw)
            return (A.expand(x.shape[:-1] + (2, 2)),
                    Bm.expand(x.shape[:-1] + (2, 1)))

        form = Formulation(
            "demo", self._packed_shapes(N),
            np.array([vlo, vhi]), dt, u_clamp=([self.alim[0]], [self.alim[1]]),
            nc=2, nct=0)

        def lanes_fwd_factory(cfg, params):
            alphas = [cfg.alpha_decay ** i for i in range(cfg.n_alpha)]
            return GenericFwdLinesearch(form, self.ocp, params, alphas=alphas,
                                        inv_scale=1.0 / cfg.cost_scale)

        def lanes_bwd_factory(cfg, params):
            return GenericBwdFused(form, self.ocp, params,
                                   inv_scale=1.0 / cfg.cost_scale)

        return OCP(
            nx=self.NX, nu=self.NU, N=N,
            dynamics=lambda x, u: point_mass_step(x, u, dt),
            stage_cost=stage_cost, terminal_cost=terminal_cost,
            stage_ineq=stage_ineq, terminal_ineq=no_rows, terminal_eq=no_rows,
            u_lower=np.array([self.alim[0]]), u_upper=np.array([self.alim[1]]),
            lanes_fwd_factory=lanes_fwd_factory,
            lanes_bwd_factory=lanes_bwd_factory,
            stage_al_expansion=stage_al_expansion,
            terminal_al_expansion=terminal_al_expansion,
            dynamics_jacobians=dynamics_jacobians,
            per_scenario_keys=GENERIC_PER_SCENARIO_KEYS)

    def _packed_shapes(self, N):
        """The kernels' packed buffer (``csrc/generic_demo.cu::Demo::
        layout``)."""
        return {"Q": (2, 2), "R": (1, 1), "P": (2, 2), "X_ref": (N + 1, 2),
                "U_ref": (N, 1)}

    def reset(self):
        """Clear the warm start."""
        self.reset_warmstart()

    def make_params(self, traj_ref, u_ref) -> dict[str, np.ndarray]:
        """The per-problem data as host arrays."""
        return {"X_ref": np.asarray(traj_ref, dtype=float),
                "U_ref": np.asarray(u_ref, dtype=float),
                "Q": self.Q_value, "R": self.R_value, "P": self.P_value}

    def solve(self, x_init, traj_ref, u_ref):
        """One receding-horizon tick on the controller's device (``u_ref``
        reshaped to (N, 1)); returns u[0] as a numpy (1,) array."""
        u_ref = np.asarray(u_ref, dtype=float).reshape(self.N, self.NU)
        return self._solve_impl(np.asarray(x_init, dtype=float),
                                self.make_params(traj_ref, u_ref))

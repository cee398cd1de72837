"""Batched closed-loop scenario engine: a batch of closed-loop rollouts on
the device (counterpart of ``mmmpc_tpu/sim/batch_engine.py``).

The reference runs exactly one closed-loop scenario per process
(interface_wholebody_qref.py).  Here each tick takes every scenario's local
reference window (a batched nearest-point search, the tensor twin of
``runtime/reference.py``), solves the batch of MPCs in one batched solve
with per-robot X_ref, U_ref and U_last (kernels A and B read them per
scenario), warm-started from the previous tick, and applies u[0] through
the model plant.  The ticks are a Python loop over batched tensor ops: no
loop over robots, and nothing inside a tick waits for the device.

Failure handling: a scenario whose solve comes back non-finite or grossly
infeasible (max violation >= ``fallback_violation``) does not poison the
batch -- its command falls back to its previous control sequence shifted by
one step, it keeps its old multipliers, and the log's ``fallback`` marks
the tick.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mmmpc_tpu_torch.controllers.common import constraint_dims
from mmmpc_tpu_torch.solver.al_ilqr import shift_multipliers
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.utils.configs import SolverConfig


class RolloutLog(NamedTuple):
    X: torch.Tensor           # (B, T+1, nx) closed-loop state trajectories
    U: torch.Tensor           # (B, T, nu) applied commands
    cost: torch.Tensor        # (B, T) per-tick MPC objective
    violation: torch.Tensor   # (B, T) per-tick max constraint violation
    fallback: torch.Tensor    # (B, T) bool: tick used the shifted fallback


def _local_window(traj_ref, u_ref, x, distance_index, N):
    """Each scenario's reference window from its nearest point (the first
    of equal distances): traj_ref (..., T+1, nx), u_ref (..., T, nu),
    x (..., nx) -> (..., N+1, nx), (..., N, nu); rows past the end repeat
    the last."""
    idx_d = torch.as_tensor(distance_index, device=x.device)
    d = traj_ref[..., idx_d] - x[..., None, idx_d]
    min_idx = torch.argmin(torch.sum(d * d, dim=-1), dim=-1)[..., None]
    ks = torch.arange(N + 1, device=x.device)
    idx = torch.clamp(min_idx + ks, max=traj_ref.shape[-2] - 1)
    idx_u = torch.clamp(min_idx + ks[:N], max=u_ref.shape[-2] - 1)
    return (torch.take_along_dim(traj_ref, idx[..., None], dim=-2),
            torch.take_along_dim(u_ref, idx_u[..., None], dim=-2))


def zero_multipliers(ocp, shared_params, B, like):
    """Zero multipliers of a batch, batch-major: lam_stage (B, N, nc),
    lam_term (B, nct), lam_eq (B, ne), in the dtype and on the device of
    ``like``; their widths probed on ``shared_params`` with zero
    references, weights and mask."""
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    z = like.new_zeros
    probe = dict(shared_params, X_ref=z(N + 1, nx), U_ref=z(N, nu),
                 U_last=z(N, nu), Q=z(nx, nx), P=z(nx, nx), eq_mask=z(()))
    nc, nct, ne = constraint_dims(ocp, probe)
    return z(B, N, nc), z(B, nct), z(B, ne)


def post_solve(U_warm, lams, res, fallback_violation):
    """Each robot's command after its solve: the solve's inputs where they
    are finite with max violation below ``fallback_violation``, else the
    warm inputs shifted by a step; the shifted, damped multipliers of a
    solve that passed, the old ones of one that did not.  Returns
    (U_applied (B, N, nu), lams, ok (B,))."""
    ok = (torch.isfinite(res.U).all(dim=-1).all(dim=-1)
          & (res.max_violation < fallback_violation))
    u_shift = torch.cat([U_warm[:, 1:], U_warm[:, -1:]], dim=1)
    U_applied = torch.where(ok[:, None, None], res.U, u_shift)
    lam_new = shift_multipliers(res.lam_stage, res.lam_term, res.lam_eq)
    lams = tuple(torch.where(ok.reshape((-1,) + (1,) * (old.dim() - 1)),
                             new, old) for new, old in zip(lam_new, lams))
    return U_applied, lams, ok


def make_batch_closed_loop(ocp, cfg: SolverConfig, shared_params,
                           distance_index, n_ticks: int,
                           fallback_violation: float = 1.0):
    """Build a batched closed-loop rollout.

    ocp: the controller's OCP (e.g. ``MPCWholeBody(...).ocp``);
    shared_params: the controller's params as tensors on the device,
    without X_ref / U_ref / U_last, which each tick computes per scenario;
    distance_index: the state components of the nearest-point search
    (e.g. [0, 1] for the move phase, [6, 7, 8] for manipulation).

    Returns run(x0_b (B, nx), traj_ref_b (B, T_ref+1, nx),
    u_ref_b (B, T_ref, nu)) -> RolloutLog.
    """
    N = ocp.N

    def run(x0_b, traj_ref_b, u_ref_b):
        B = x0_b.shape[0]
        # the search's components on the device once, not at every tick
        dist_idx = torch.as_tensor(distance_index, device=x0_b.device)
        x = x0_b
        U = x0_b.new_zeros(B, N, ocp.nu)
        lams = zero_multipliers(ocp, shared_params, B, x0_b)
        Xs, Us, costs, viols, fbs = [], [], [], [], []
        for _ in range(n_ticks):
            X_ref, U_ref = _local_window(traj_ref_b, u_ref_b, x, dist_idx,
                                         N)
            params_b = dict(shared_params, X_ref=X_ref.permute(1, 2, 0),
                            U_ref=U_ref.permute(1, 2, 0),
                            U_last=U.permute(1, 2, 0))
            res = al_ilqr_solve_batched(ocp, x, U, params_b, cfg,
                                        lam0_b=lams)
            U, lams, ok = post_solve(U, lams, res, fallback_violation)
            x = ocp.dynamics(x, U[:, 0])
            Xs.append(x)
            Us.append(U[:, 0])
            costs.append(res.cost)
            viols.append(res.max_violation)
            fbs.append(~ok)
        return RolloutLog(
            X=torch.cat([x0_b[:, None], *(v[:, None] for v in Xs)], dim=1),
            U=torch.stack(Us, dim=1), cost=torch.stack(costs, dim=1),
            violation=torch.stack(viols, dim=1),
            fallback=torch.stack(fbs, dim=1))

    return run


def run_with_failure_report(run, *args, constraint_tol: float,
                            top_k: int = 3, file=None):
    """Run an engine's ``run(*args)`` and dump the top-k worst scenarios to
    stderr (or ``file``) whenever a tick violated ``constraint_tol`` or fell
    back to the shifted command (the batched analogue of the reference's
    failure dump).  Returns the log."""
    from mmmpc_tpu_torch.utils.debugging import report_rollout_failures

    log = run(*args)
    report_rollout_failures(log, constraint_tol=constraint_tol, top_k=top_k,
                            file=file)
    return log

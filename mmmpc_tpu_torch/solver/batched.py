"""Natively batched AL-iLQR with the batch on the last axis (counterpart of
``mmmpc_tpu/solver/batched.py::_solve_batched_lanes``, the JAX package's
fastest path, and of its vmapped per-scenario route; its batch-major
kernel path is not ported).

Every array of the inner loop is batch-last — X (N+1, nx, B), U (N, nu, B),
multipliers (N, nc, B) — which is the layout the kernels read with coalesced
loads.  Each iLQR iteration is one backward pass, one call of the fused
rollout + line search over all step sizes (``ops/wholebody_fwd.py``,
``ops/generic_fwd.py``), then the per-scenario argmin over step sizes and
the accept / reject merge.  The backward pass takes one of two routes, as
in the JAX solver (``mmmpc_tpu/solver/batched.py:98-119``):

- fused: one call of the OCP's fused AL-expansion + Riccati kernel
  (``ops/wholebody_bwd.py``, ``ops/generic_bwd.py``), when
  ``cfg.use_fused_backward`` is set, the OCP has a ``lanes_bwd_factory``,
  the assoc sweep is not picked, and every per-scenario entry of the params
  is one the fused kernels read (``ocp.fused_per_scenario_keys``);
- the expansion (otherwise): the OCP's structured AL expansion and dynamics
  Jacobians in plain PyTorch (``solver/al_ilqr.py::stage_al_blocks``,
  ``terminal_al_blocks``: the JAX ``core.stage_derivs`` /
  ``core.terminal_derivs``) on the batch-first view of the params, then the
  Riccati sweep kernel on those blocks (``ops/riccati.py``), or, where
  ``resolve_assoc_scan`` picks it for the batch, the horizon and the device
  (``cfg.use_assoc_scan``), the parallel-prefix sweep of
  ``ops/assoc_riccati.py``.  It takes per-scenario params as shared ones:
  this is the route of the JAX package's vmapped per-scenario solve (the
  fleet's ``host_parity_solver``, the generic controllers with per-robot
  targets).  A per-scenario weight of which the line search reads the
  diagonal only (``ocp.diagonal_per_scenario_keys``: the qref
  controller's Q and P, which A's fleet instance takes as diagonals)
  raises there when it has an entry off its diagonal: the callables would
  score it whole and the line search without those entries.

Per-scenario params (an entry of ``ocp.per_scenario_keys`` with a trailing
batch axis, ``ocp/spec.py``; any other entry with one raises) are read per
scenario by the line search's kernel on every route (A's and C's
per-scenario instances), by the fused backward on its route, and by the
OCP's callables on their batch-first view everywhere else: the AL
objective, the constraints, the rollout, the expansion and the final
objective, as the JAX solver's ``al_total_p`` / ``eval_con_p`` and its
vmap do.

On CUDA tensors the calls launch the hand-written kernels; on CPU tensors
they run their plain PyTorch versions.  Any batch size is taken.
"""

from __future__ import annotations

import torch

from mmmpc_tpu_torch.ocp.spec import OCP, batch_first, per_scenario_keys
from mmmpc_tpu_torch.ops.assoc_riccati import assoc_riccati_backward_bm
from mmmpc_tpu_torch.ops.riccati import riccati_backward_bm
from mmmpc_tpu_torch.solver.al_ilqr import (
    SolveResult, _objective, build_core, resolve_assoc_scan, rollout,
    run_al_rounds, stage_al_blocks, terminal_al_blocks,
)
from mmmpc_tpu_torch.utils.configs import SolverConfig


def _pick(cand, best):
    """cand (..., n_alpha, d, B) at the step size ``best`` (B,) of each
    scenario -> (..., d, B)."""
    idx = best.expand(cand.shape[:-3] + (1,) + cand.shape[-2:])
    return torch.gather(cand, -3, idx).squeeze(-3)


def _refuse_off_diagonal(params, keys):
    """Raise where a per-scenario weight of ``keys`` ((n, n, B)) has an
    entry off its diagonal."""
    for k in sorted(keys):
        W = params[k]
        off = ~torch.eye(W.shape[0], dtype=torch.bool, device=W.device)
        if bool(torch.any(W[off] != 0)):
            raise ValueError(
                f"params[{k!r}] carries entries off the diagonal, but the "
                f"line search reads the diagonal of a per-scenario {k} "
                f"only: take the fused backward, or give each scenario a "
                f"diagonal {k}")


def accept_step(cfg: SolverConfig, candidates, X, U, cost, reg):
    """The end of an iLQR iteration: each scenario's best step size of the
    line search's ``candidates`` (Xc (N, n_alpha, nx, B), Uc, xlast
    (n_alpha, nx, B), cc (n_alpha, B)), taken where it lowers the AL cost,
    and the regularisation moved down where it did and up where not.
    Returns the new (X, U, cost, reg)."""
    Xc, Uc, xlast, cc = candidates
    best = torch.argmin(cc, dim=0, keepdim=True)               # (1, B)
    best_cost = torch.gather(cc, 0, best)[0]
    X_best = torch.cat([_pick(Xc, best), _pick(xlast, best)[None]])
    U_best = _pick(Uc, best)

    improved = best_cost < cost - 1e-12                        # (B,)
    X = torch.where(improved, X_best, X)
    U = torch.where(improved, U_best, U)
    cost = torch.where(improved, best_cost, cost)
    reg = torch.where(improved,
                      torch.clamp(reg / cfg.reg_scale, min=cfg.reg_init),
                      torch.clamp(reg * cfg.reg_scale, max=cfg.reg_max))
    return X, U, cost, reg


def update_multipliers(core, X, U, lams, mu):
    """The end of an AL round: the constraints at (X, U), the multipliers
    moved by the penalty ``mu`` (inequalities clamped at 0) and each
    scenario's worst violation: (lam_stage, lam_term, lam_eq, viol)."""
    lam_stage, lam_term, lam_eq = lams
    cs, ct, he = core.eval_constraints(X, U)
    lam_stage = torch.clamp(lam_stage + mu * cs, min=0.0)
    lam_term = torch.clamp(lam_term + mu * ct, min=0.0)
    lam_eq = lam_eq + mu * he
    return lam_stage, lam_term, lam_eq, core.violation(cs, ct, he)


def al_ilqr_solve_batched(ocp: OCP, x0_b, U0_b, params,
                          cfg: SolverConfig = SolverConfig(),
                          lam0_b=None) -> SolveResult:
    """Solve a batch of scenarios sharing ``params`` (but for its
    per-scenario entries, batch-last), on the route the module's docstring
    names.

    x0_b (B, nx), U0_b (B, N, nu); lam0_b: optional batch-major multiplier
    warm start (lam_stage (B, N, nc), lam_term (B, nct), lam_eq (B, ne)).
    Returns a SolveResult with a leading batch axis on every field.
    """
    B = x0_b.shape[0]
    dtype, device = x0_b.dtype, x0_b.device
    per_scenario = set(per_scenario_keys(params))
    unknown = per_scenario - ocp.per_scenario_keys
    if unknown:
        raise ValueError(f"params {sorted(unknown)} carry a batch axis, but "
                         f"the OCP takes them shared only")
    assoc = resolve_assoc_scan(cfg, B, ocp.N, device=device)
    fused = (cfg.use_fused_backward and ocp.lanes_bwd_factory is not None
             and not assoc and per_scenario <= ocp.fused_per_scenario_keys)
    if not fused:
        _refuse_off_diagonal(params, per_scenario
                             & ocp.diagonal_per_scenario_keys)
    # the OCP callables' view (per-scenario entries batch-first); the
    # kernels' factories take the params as given
    cparams = batch_first(params)
    core = build_core(ocp, cparams, cfg)
    N, nc, nct, ne = core.N, core.nc, core.nct, core.ne
    fwd_ls = ocp.lanes_fwd_factory(cfg, params)
    bwd_fused = ocp.lanes_bwd_factory(cfg, params) if fused else None
    inv_scale = 1.0 / cfg.cost_scale

    sweep = assoc_riccati_backward_bm if assoc else riccati_backward_bm

    def backward(X, U, lams, mu, reg):
        if bwd_fused is not None:
            return bwd_fused(X, U, *lams, mu, reg)
        return sweep(
            *stage_al_blocks(ocp, cparams, inv_scale, X[:-1], U, lams[0], mu),
            *terminal_al_blocks(ocp, cparams, inv_scale, X[-1], lams[1],
                                lams[2], mu), reg)

    def ilqr_iter(X, U, cost, reg, lams, mu):
        kffs, Ks = backward(X, U, lams, mu, reg)
        return accept_step(cfg, fwd_ls(X[:-1], U, kffs, Ks, *lams, mu),
                           X, U, cost, reg)

    def al_round(carry, i, inner_iters):
        # X is U applied open-loop from x0 (every accepted candidate is a
        # rollout), so only the AL cost is re-based under the new (lams, mu)
        X, U, lam_stage, lam_term, lam_eq, _ = carry
        mu = core.mu_at(i)
        lams = (lam_stage, lam_term, lam_eq)
        cost = core.al_total(X, U, lams, mu)
        reg = torch.full((B,), cfg.reg_init, dtype=dtype, device=device)
        for _ in range(inner_iters):
            X, U, cost, reg = ilqr_iter(X, U, cost, reg, lams, mu)
        return X, U, *update_multipliers(core, X, U, lams, mu)

    kw = dict(dtype=dtype, device=device)
    if lam0_b is None:
        lam0_bm = (torch.zeros(N, nc, B, **kw), torch.zeros(nct, B, **kw),
                   torch.zeros(ne, B, **kw))
    else:
        lam0_bm = (lam0_b[0].permute(1, 2, 0).contiguous(),
                   lam0_b[1].T.contiguous(), lam0_b[2].T.contiguous())
    X0, Uc0 = rollout(ocp, x0_b.T, U0_b.permute(1, 2, 0), cparams)
    carry0 = (X0, Uc0, *lam0_bm, torch.full((B,), float("inf"), **kw))
    X_fin, U_fin, lam_stage, lam_term, lam_eq, viol = run_al_rounds(
        al_round, carry0, cfg)

    # back to the batch-major result contract
    return SolveResult(
        X=X_fin.permute(2, 0, 1), U=U_fin.permute(2, 0, 1),
        cost=_objective(ocp, X_fin, U_fin, cparams), max_violation=viol,
        lam_stage=lam_stage.permute(2, 0, 1), lam_term=lam_term.T,
        lam_eq=lam_eq.T, converged=viol < cfg.constraint_tol)

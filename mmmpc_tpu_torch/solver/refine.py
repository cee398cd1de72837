"""Two-stage straggler refinement (counterpart of
``mmmpc_tpu/solver/refine.py``).

Stage 1 solves the whole batch at a cheap schedule; stage 2 gathers the
``refine_size`` worst scenarios by hard-constraint violation (with their
per-scenario params entries), re-solves them
warm-started from their stage-1 primal / dual state with the AL penalty
schedule continued where stage 1 stopped, and keeps each re-solve only where
it strictly lowered the violation.  A NaN violation ranks as +inf both in the
selection and in the merge, so a scenario that went NaN in stage 1 is
re-solved first and replaced by any finite result (the JAX version ranks NaN
low and keeps it).
"""

from __future__ import annotations

import dataclasses

import torch

from mmmpc_tpu_torch.ocp.spec import OCP, per_scenario_keys
from mmmpc_tpu_torch.solver.al_ilqr import SolveResult
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.utils.configs import SolverConfig

# Stage-2 batch when none is given: the JAX package's one lane tile.
DEFAULT_REFINE_SIZE = 1024


def continue_mu(cfg: SolverConfig, al_rounds_done: int,
                **overrides) -> SolverConfig:
    """A config whose AL penalty schedule continues after ``al_rounds_done``
    rounds of ``cfg`` (mu_at(0) of the result is mu_at(al_rounds_done) of
    ``cfg``, capped at mu_max)."""
    mu0 = min(cfg.mu_init * cfg.mu_scale ** al_rounds_done, cfg.mu_max)
    return dataclasses.replace(cfg, mu_init=mu0, **overrides)


def default_refine_config(cfg: SolverConfig) -> SolverConfig:
    """Stage-2 default: three more AL rounds x 12 sweeps, mu continued."""
    return continue_mu(cfg, cfg.al_iters, al_iters=3, ilqr_iters=12,
                       ilqr_iters_later=12, ilqr_iters_final=None)


def _nan_as_inf(v):
    return torch.where(torch.isnan(v), float("inf"), v)


def al_ilqr_solve_refined(ocp: OCP, x0_b, U0_b, params,
                          cfg: SolverConfig = SolverConfig(),
                          refine_cfg: SolverConfig | None = None,
                          refine_size: int | None = None,
                          lam0_b=None) -> SolveResult:
    """Batched solve with straggler refinement; returns a SolveResult shaped
    like ``al_ilqr_solve_batched``'s."""
    B = x0_b.shape[0]
    refine_size = min(DEFAULT_REFINE_SIZE if refine_size is None
                      else refine_size, B)
    if refine_cfg is None:
        refine_cfg = default_refine_config(cfg)

    res1 = al_ilqr_solve_batched(ocp, x0_b, U0_b, params, cfg, lam0_b)
    if refine_size <= 0 or refine_cfg.al_iters <= 0:
        return res1

    # the refine_size worst; a stable sort keeps lax.top_k's tie order
    viol1 = _nan_as_inf(res1.max_violation)
    idx = torch.sort(viol1, descending=True, stable=True).indices[:refine_size]

    # the re-solved scenarios' own per-scenario entries (batch-last)
    params_r = dict(params)
    for k in per_scenario_keys(params):
        params_r[k] = params[k][..., idx]

    res2 = al_ilqr_solve_batched(
        ocp, x0_b[idx], res1.U[idx], params_r, refine_cfg,
        lam0_b=(res1.lam_stage[idx], res1.lam_term[idx], res1.lam_eq[idx]))

    # violation-monotone merge
    better = _nan_as_inf(res2.max_violation) < viol1[idx]

    def merge(a, b):
        sel = better.reshape((-1,) + (1,) * (b.dim() - 1))
        return a.index_copy(0, idx, torch.where(sel, b, a[idx]))

    merged = SolveResult(*(merge(a, b) for a, b in zip(res1, res2)))
    return merged._replace(converged=merged.max_violation < cfg.constraint_tol)

"""Natively batched AL-iLQR with the batch on the last axis (counterpart of
``mmmpc_tpu/solver/batched.py::_solve_batched_lanes``, the JAX package's
fastest path; its batch-major and vmap fallbacks are not ported).

Every array of the inner loop is batch-last — X (N+1, nx, B), U (N, nu, B),
multipliers (N, nc, B) — which is the layout the kernels read with coalesced
loads.  Each iLQR iteration is one backward pass, one call of the fused
rollout + line search over all step sizes (``ops/wholebody_fwd.py``,
``ops/generic_fwd.py``), then the per-scenario argmin over step sizes and
the accept / reject merge.  The backward pass is one of two, as in the JAX
solver:

- fused (``cfg.use_fused_backward`` and an OCP with a ``lanes_bwd_factory``):
  one call of the OCP's fused AL-expansion + Riccati kernel
  (``ops/wholebody_bwd.py``, ``ops/generic_bwd.py``);
- unfused (otherwise): the OCP's structured AL expansion and dynamics
  Jacobians in plain PyTorch (``solver/al_ilqr.py::stage_al_blocks``,
  ``terminal_al_blocks``: the JAX ``core.stage_derivs`` /
  ``core.terminal_derivs``), then the Riccati sweep kernel on those blocks
  (``ops/riccati.py``).  It takes shared params only, as the JAX solver's;
- and where ``resolve_assoc_scan`` picks it for the batch, the horizon
  and the device (``cfg.use_assoc_scan``), the same expansion followed by the
  parallel-prefix sweep of ``ops/assoc_riccati.py`` in place of either, as
  the JAX solver's assoc sweep serves the routes that run no Riccati
  kernel.  Per-scenario params take the fused backward: "auto" resolves to
  the sequential sweep for them and True raises (the JAX solver would
  vmap a per-scenario solve instead; the port's expansion takes shared
  params only).

Per-scenario params (the fleet's: an entry of ``ocp.per_scenario_keys``
with a trailing batch axis, ``ocp/spec.py``) need the fused backward: the
kernels read them per scenario, and the AL objective, the constraints, the
rollout and the final objective evaluate the OCP's callables on their
batch-first view, as the JAX solver's ``al_total_p`` / ``eval_con_p`` do.

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


def al_ilqr_solve_batched(ocp: OCP, x0_b, U0_b, params,
                          cfg: SolverConfig = SolverConfig(),
                          lam0_b=None) -> SolveResult:
    """Solve a batch of scenarios sharing ``params`` (but for its
    per-scenario entries, batch-last).

    x0_b (B, nx), U0_b (B, N, nu); lam0_b: optional batch-major multiplier
    warm start (lam_stage (B, N, nc), lam_term (B, nct), lam_eq (B, ne)).
    Returns a SolveResult with a leading batch axis on every field.
    """
    B = x0_b.shape[0]
    dtype, device = x0_b.dtype, x0_b.device
    per_scenario = per_scenario_keys(params)
    assoc = resolve_assoc_scan(cfg, B, ocp.N, warn=not per_scenario,
                               device=device)
    if per_scenario and assoc:
        if cfg.use_assoc_scan != "auto":
            raise ValueError(f"per-scenario params {list(per_scenario)} "
                             f"need the fused backward: use_assoc_scan="
                             f"{cfg.use_assoc_scan!r} runs the expansion, "
                             f"which takes shared params only")
        assoc = False
    fused = (cfg.use_fused_backward and ocp.lanes_bwd_factory is not None
             and not assoc)
    if per_scenario and not fused:
        raise ValueError(f"per-scenario params {list(per_scenario)} need the "
                         f"fused backward: the unfused path's expansion takes "
                         f"shared params only")
    unknown = set(per_scenario) - ocp.per_scenario_keys
    if unknown:
        raise ValueError(f"params {sorted(unknown)} carry a batch axis, but "
                         f"the OCP takes them shared only")
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
            *stage_al_blocks(ocp, params, inv_scale, X[:-1], U, lams[0], mu),
            *terminal_al_blocks(ocp, params, inv_scale, X[-1], lams[1],
                                lams[2], mu), reg)

    def ilqr_iter(X, U, cost, reg, lams, mu):
        kffs, Ks = backward(X, U, lams, mu, reg)
        Xc, Uc, xlast, cc = fwd_ls(X[:-1], U, kffs, Ks, *lams, mu)
        # Xc (N, n_alpha, nx, B), xlast (n_alpha, nx, B), cc (n_alpha, B)
        best = torch.argmin(cc, dim=0, keepdim=True)           # (1, B)
        best_cost = torch.gather(cc, 0, best)[0]
        X_best = torch.cat([_pick(Xc, best), _pick(xlast, best)[None]])
        U_best = _pick(Uc, best)

        improved = best_cost < cost - 1e-12                    # (B,)
        X = torch.where(improved, X_best, X)
        U = torch.where(improved, U_best, U)
        cost = torch.where(improved, best_cost, cost)
        reg = torch.where(improved,
                          torch.clamp(reg / cfg.reg_scale, min=cfg.reg_init),
                          torch.clamp(reg * cfg.reg_scale, max=cfg.reg_max))
        return X, U, cost, reg

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
        cs, ct, he = core.eval_constraints(X, U)
        lam_stage = torch.clamp(lam_stage + mu * cs, min=0.0)
        lam_term = torch.clamp(lam_term + mu * ct, min=0.0)
        lam_eq = lam_eq + mu * he
        return X, U, lam_stage, lam_term, lam_eq, core.violation(cs, ct, he)

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

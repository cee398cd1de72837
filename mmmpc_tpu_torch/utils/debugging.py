"""Failure reports of batched solves and rollouts (counterpart of
``mmmpc_tpu/utils/debugging.py``).

The reference prints its diagnostics in the solve's exception path
(mpc_wholebody_qref.py:318-326).  Here the solver never raises -- results
carry convergence flags and violation maxima -- and these helpers print the
batched analogue: the worst scenarios of a solve or of a closed-loop
rollout.  Host-side; the tensors may live on any device.  The JAX
package's ``nan_checks`` (a switch of JAX's NaN debugging) has no
counterpart.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mmmpc_tpu_torch.ocp.spec import per_scenario_keys


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def assert_finite_result(result, what="solve"):
    """Host-side sanity check of a SolveResult (raises AssertionError)."""
    for name in ("X", "U", "cost"):
        v = getattr(result, name)
        assert bool(torch.all(torch.isfinite(torch.as_tensor(v)))), \
            f"{what}: non-finite {name}"


def describe_result(result):
    """One-line human-readable summary of a SolveResult."""
    cost = _np(result.cost)
    viol = _np(result.max_violation)
    conv = _np(result.converged)
    if cost.ndim == 0:
        return (f"cost={float(cost):.4f} viol={float(viol):.2e} "
                f"converged={bool(conv)}")
    return (f"batch={cost.shape[0]} mean_cost={cost.mean():.4f} "
            f"max_viol={viol.max():.2e} converged={conv.mean()*100:.1f}%")


def report_unconverged(ocp, result, params, *, top_k: int = 3, file=None):
    """The batched failure dump whenever part of a batch failed to converge
    (the wiring the reference gets from its try/except print block).
    Returns True when the report fired: only when ``result.converged`` is
    not all True."""
    conv = _np(result.converged)
    if conv.ndim == 0 or bool(conv.all()):
        return False
    out = file if file is not None else sys.stderr
    n_bad = int((~conv).sum())
    print(f"[worst-scenario report] {n_bad}/{conv.size} scenarios "
          f"unconverged:", file=out)
    print(worst_scenario_report(ocp, result, params,
                                top_k=min(top_k, n_bad)), file=out)
    return True


def report_rollout_failures(log, *, constraint_tol: float, top_k: int = 3,
                            file=None):
    """Closed-loop twin of :func:`report_unconverged` for the batched
    engines' RolloutLog / TaskRolloutLog: fires when any scenario's worst
    tick violates ``constraint_tol`` or used the shifted-fallback command,
    and dumps the top-k worst scenarios with the tick, the closed-loop state
    at that tick and the fallback count.  Returns True when it fired."""
    viol = _np(log.violation)                   # (B, T)
    fb = (_np(log.fallback).astype(bool)
          if getattr(log, "fallback", None) is not None
          else np.zeros_like(viol, dtype=bool))
    worst = viol.max(axis=1)
    bad = (worst > constraint_tol) | fb.any(axis=1)
    if not bad.any():
        return False
    out = file if file is not None else sys.stderr
    order = np.argsort(-worst)[:top_k]
    print(f"[worst-scenario report] {int(bad.sum())}/{viol.shape[0]} "
          f"rollouts exceeded tol {constraint_tol:g} or used the fallback:",
          file=out)
    X = _np(log.X)
    for b in order:
        if not bad[b]:
            continue
        t = int(viol[b].argmax())
        print(f"-- scenario {int(b)}: max violation {worst[b]:.3e} at tick "
              f"{t} (fallback ticks: {int(fb[b].sum())})", file=out)
        print(f"   x[tick]={X[b, min(t, X.shape[1] - 1)].round(4)}",
              file=out)
    return True


def scenario_params(params, b: int) -> dict:
    """Scenario ``b``'s params: each per-scenario (batch-last) entry at
    ``b``, the shared ones as they are."""
    keys = per_scenario_keys(params)
    return {k: v[..., b] if k in keys else v for k, v in params.items()}


def worst_scenario_report(ocp, result, params, top_k: int = 1):
    """Batched failure forensics: the argmax-violation scenario(s) of a
    batched SolveResult with their violation broken down by constraint
    group (the batched analogue of the reference's failure dump).  Returns
    the report string.  ``params``: those the batch was solved with."""
    viol = _np(result.max_violation)
    if viol.ndim == 0:
        raise ValueError("worst_scenario_report expects a batched result")
    order = np.argsort(-viol)[:top_k]
    lines = [describe_result(result)]
    for b in order:
        p = scenario_params(params, int(b))
        X, U = result.X[b], result.U[b]
        ks = torch.arange(ocp.N, device=X.device)
        cs = _np(ocp.stage_ineq(X[:-1], U, ks, p))
        ct = _np(ocp.terminal_ineq(X[-1], p))
        he = _np(ocp.terminal_eq(X[-1], p))
        lines.append(
            f"-- scenario {int(b)}: viol={viol[b]:.3e} "
            f"cost={float(_np(result.cost[b])):.4f} "
            f"converged={bool(_np(result.converged[b]))}")
        if cs.size:
            stage_idx, row_idx = np.unravel_index(np.argmax(cs), cs.shape)
            lines.append(
                f"   stage ineq: worst row {int(row_idx)} at stage "
                f"{int(stage_idx)} -> {cs.max():.3e} "
                f"(rows>0: {(cs > 0).sum()} of {cs.size})")
            row_max = cs.max(axis=0)
            for r in np.flatnonzero(row_max > 0)[:10]:
                lines.append(f"     row {int(r)}: max over horizon "
                             f"{row_max[r]:.3e}")
        if ct.size:
            lines.append(f"   terminal ineq: max {ct.max():.3e} "
                         f"(rows>0: {(ct > 0).sum()} of {ct.size})")
        if he.size:
            lines.append(f"   terminal eq: max |h| {np.abs(he).max():.3e}")
        lines.append(f"   x0={_np(result.X[b, 0]).round(4)}")
        lines.append(f"   u0={_np(result.U[b, 0]).round(4)}")
    return "\n".join(lines)

"""Augmented-Lagrangian iLQR building blocks (counterpart of the parts of
``mmmpc_tpu/solver/al_ilqr.py`` that the batched solve uses, and of its
``shift_multipliers``, the closed loop's dual warm start).

Outer loop: Powell-Hestenes-Rockafellar augmented Lagrangian over the hard
constraints, multipliers updated per round, penalty grown geometrically.
Inner loop (``solver/batched.py``): iLQR sweeps with a parallel line search.

Every function here takes batch-last arrays — X (N+1, nx, B), U (N, nu, B),
lam_stage (N, nc, B), lam_term (nct, B), lam_eq (ne, B) — and evaluates all
stages at once by handing the OCP callables (B, N, nx) views with
``k = arange(N)``.
"""

from __future__ import annotations

import types
from typing import NamedTuple

import torch

from mmmpc_tpu_torch.ocp.spec import OCP, per_scenario_keys
from mmmpc_tpu_torch.utils.configs import SolverConfig


# The crossover of the parallel-prefix Riccati sweep against the sequential
# one, as the JAX package measured it on a TPU v5e (its BASELINE.md
# long-horizon table): the associative scan won only where the sweep is
# latency-bound, batch <= 8 and N >= 100.  Kept as the JAX package's for the
# plain versions; on the card "auto" keeps the sequential sweep (kernel B),
# which won at every shape bench_longhorizon measured on the H100 (PERF.md),
# until a measured crossover of the card's own replaces it.
ASSOC_SCAN_MAX_BATCH = 8
ASSOC_SCAN_MIN_HORIZON = 100


def resolve_assoc_scan(cfg: SolverConfig, batch: int, N: int,
                       warn: bool = True, device=None) -> bool:
    """Whether a solve of ``batch`` scenarios at horizon ``N`` on
    ``device`` (None: the JAX package's rule) runs the parallel-prefix
    Riccati sweep.

    ``cfg.use_assoc_scan``: "auto" picks from the crossover (assoc iff
    batch <= ASSOC_SCAN_MAX_BATCH and N >= ASSOC_SCAN_MIN_HORIZON, and the
    device is not a CUDA one); True forces assoc, with a UserWarning
    (``warn``) outside that quadrant; False forces the sequential sweep.
    Any other string is an error (a typo such as "Auto" must not force
    assoc)."""
    mode = cfg.use_assoc_scan
    if isinstance(mode, str) and mode != "auto":
        raise ValueError(
            f"use_assoc_scan={mode!r}: expected True, False, or 'auto'")
    in_sweet_spot = (batch <= ASSOC_SCAN_MAX_BATCH
                     and N >= ASSOC_SCAN_MIN_HORIZON)
    if mode == "auto":
        return in_sweet_spot and (device is None
                                  or torch.device(device).type != "cuda")
    if warn and mode and not in_sweet_spot:
        import warnings
        warnings.warn(
            f"use_assoc_scan=True at batch={batch}, N={N}: the associative-"
            f"scan Riccati is only faster when batch <= "
            f"{ASSOC_SCAN_MAX_BATCH} and N >= {ASSOC_SCAN_MIN_HORIZON} "
            f"(the JAX package's crossover); use "
            f'"auto" to select per shape.', UserWarning, stacklevel=2)
    return bool(mode)


class SolveResult(NamedTuple):
    X: torch.Tensor              # state trajectories
    U: torch.Tensor              # inputs
    cost: torch.Tensor           # original (non-AL) objective
    max_violation: torch.Tensor  # max over hard constraints (<= 0 ok)
    lam_stage: torch.Tensor      # inequality multipliers
    lam_term: torch.Tensor
    lam_eq: torch.Tensor
    converged: torch.Tensor      # viol < tol at exit


def _stages(X, U):
    """Batch-last (N+1, nx, B), (N, nu, B) -> (B, N, nx), (B, N, nu), (B, nx)
    views for the OCP callables."""
    Xb = X.permute(2, 0, 1)
    return Xb[:, :-1], U.permute(2, 0, 1), Xb[:, -1]


def rollout(ocp: OCP, x0, U, params):
    """Roll the dynamics forward under clamped inputs.
    x0 (nx, B), U (N, nu, B) -> (X (N+1, nx, B), Uc (N, nu, B))."""
    x = x0.T
    Xs, Us = [x], []
    for k in range(ocp.N):
        uc = ocp.clamp_u(U[k].T)
        x = ocp.dynamics(x, uc)
        Xs.append(x)
        Us.append(uc)
    return (torch.stack(Xs).permute(0, 2, 1).contiguous(),
            torch.stack(Us).permute(0, 2, 1).contiguous())


def _objective(ocp: OCP, X, U, params):
    """Original objective of each scenario: (B,)."""
    xs, us, xN = _stages(X, U)
    ks = torch.arange(ocp.N, dtype=torch.long, device=X.device)
    return (torch.sum(ocp.stage_cost(xs, us, ks, params), dim=-1)
            + ocp.terminal_cost(xN, params))


def _al_penalty_ineq(c, lam, mu):
    """PHR penalty for c <= 0 with multiplier lam >= 0 (over the last axis)."""
    t = torch.clamp(lam + mu * c, min=0.0)
    return (torch.sum(t * t, dim=-1) - torch.sum(lam * lam, dim=-1)) / (2.0 * mu)


def _al_penalty_eq(h, lam, mu):
    return torch.sum(lam * h, dim=-1) + 0.5 * mu * torch.sum(h * h, dim=-1)


def _batch_last(t, shape):
    """A batch-first (B, ...) block of the OCP callables, broadcast to
    ``shape`` = (B, ...) -> a contiguous (..., B) tensor."""
    return t.expand(shape).movedim(0, -1).contiguous()


def stage_al_blocks(ocp: OCP, params, inv_scale, X, U, lam_stage, mu):
    """The scaled AL expansion of every stage and the dynamics Jacobians,
    batch-last (the JAX ``stage_derivs_al_exp`` over the batch and the
    stages).  X (N, nx, B) stage states, U (N, nu, B), lam_stage (N, nc, B)
    -> lx (N, nx, B), lu (N, nu, B), lxx (N, nx, nx, B), luu (N, nu, nu, B),
    lux (N, nu, nx, B), A (N, nx, nx, B), Bm (N, nx, nu, B)."""
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    xs, us = X.permute(2, 0, 1), U.permute(2, 0, 1)        # (B, N, .)
    ks = torch.arange(N, dtype=torch.long, device=X.device)
    blocks = (*ocp.stage_al_expansion(xs, us, ks, params,
                                      lam_stage.permute(2, 0, 1), mu,
                                      inv_scale),
              *ocp.dynamics_jacobians(xs, us))
    lead = xs.shape[:2]
    shapes = ((nx,), (nu,), (nx, nx), (nu, nu), (nu, nx), (nx, nx), (nx, nu))
    return tuple(_batch_last(t, lead + s) for t, s in zip(blocks, shapes))


def terminal_al_blocks(ocp: OCP, params, inv_scale, xN, lam_term, lam_eq,
                       mu):
    """The scaled terminal AL expansion, batch-last: xN (nx, B),
    lam_term (nct, B), lam_eq (ne, B) -> term_g (nx, B), term_H (nx, nx, B)."""
    nx, B = ocp.nx, xN.shape[-1]
    g, H = ocp.terminal_al_expansion(xN.T, params, lam_term.T, lam_eq.T, mu,
                                     inv_scale)
    return _batch_last(g, (B, nx)), _batch_last(H, (B, nx, nx))


def build_core(ocp: OCP, params, cfg: SolverConfig):
    """Batched AL building blocks of one problem (its params as the
    callables take them: per-scenario entries batch-first)."""
    N = ocp.N
    # probe the widths at one scenario, or at the per-scenario batch
    probe_b = next((params[k].shape[0] for k in per_scenario_keys(params)), 1)
    probe = torch.zeros(probe_b, ocp.nx, dtype=params["X_ref"].dtype,
                        device=params["X_ref"].device)
    probe_u = probe[..., :ocp.nu]
    nc = ocp.stage_ineq(probe, probe_u, 0, params).shape[-1]
    nct = ocp.terminal_ineq(probe, params).shape[-1]
    ne = ocp.terminal_eq(probe, params).shape[-1]
    inv_scale = 1.0 / cfg.cost_scale

    def al_total(X, U, lams, mu):
        """Scaled AL objective of each scenario: (B,)."""
        lam_stage, lam_term, lam_eq = lams
        xs, us, xN = _stages(X, U)
        ks = torch.arange(N, dtype=torch.long, device=X.device)
        stage = (ocp.stage_cost(xs, us, ks, params) * inv_scale
                 + _al_penalty_ineq(ocp.stage_ineq(xs, us, ks, params),
                                    lam_stage.permute(2, 0, 1), mu))
        term = (ocp.terminal_cost(xN, params) * inv_scale
                + _al_penalty_ineq(ocp.terminal_ineq(xN, params),
                                   lam_term.T, mu)
                + _al_penalty_eq(ocp.terminal_eq(xN, params), lam_eq.T, mu))
        return torch.sum(stage, dim=-1) + term

    def eval_constraints(X, U):
        """(cs (N, nc, B), ct (nct, B), he (ne, B))."""
        xs, us, xN = _stages(X, U)
        ks = torch.arange(N, dtype=torch.long, device=X.device)
        cs = ocp.stage_ineq(xs, us, ks, params).permute(1, 2, 0)
        return (cs.contiguous(), ocp.terminal_ineq(xN, params).T.contiguous(),
                ocp.terminal_eq(xN, params).T.contiguous())

    def violation(cs, ct, he):
        """Worst hard-constraint value of each scenario, at least 0 (the
        equality residual enters as max |h| with an initial 0); an empty
        group is skipped: (B,)."""
        viol = torch.zeros(cs.shape[-1], dtype=cs.dtype, device=cs.device)
        for c in (cs.flatten(0, -2), ct, he.abs()):
            if c.shape[0]:
                viol = torch.maximum(viol, torch.amax(c, dim=0))
        return viol

    def mu_at(i):
        return min(cfg.mu_init * cfg.mu_scale ** i, cfg.mu_max)

    return types.SimpleNamespace(
        N=N, nc=nc, nct=nct, ne=ne, al_total=al_total,
        eval_constraints=eval_constraints, violation=violation, mu_at=mu_at)


def _schedule(cfg: SolverConfig):
    """(round index, inner sweeps) of each AL round: the first round solves
    from scratch, middle rounds track the multiplier updates, the last round
    polishes."""
    later = (cfg.ilqr_iters_later if cfg.ilqr_iters_later is not None
             else cfg.ilqr_iters)
    final = (cfg.ilqr_iters_final if cfg.ilqr_iters_final is not None
             else later)
    last = cfg.al_iters - 1
    return [(0, cfg.ilqr_iters)] + [(i, final if i == last else later)
                                    for i in range(1, last + 1)]


def run_al_rounds(al_round, carry0, cfg: SolverConfig):
    """Drive the AL outer loop over the round schedule."""
    carry = carry0
    for i, inner_iters in _schedule(cfg):
        carry = al_round(carry, i, inner_iters)
    return carry


def iteration_count(cfg: SolverConfig) -> int:
    """iLQR iterations one solve runs under ``cfg`` (one launch of each
    fused kernel per iteration)."""
    return sum(n for _, n in _schedule(cfg))


def shift_multipliers(lam_stage, lam_term, lam_eq, decay: float = 0.5):
    """Receding-horizon warm start of the AL multipliers: the stage
    multipliers shifted forward one control period (the last stage
    repeated), the terminal groups kept, everything damped by ``decay``.

    The stage axis is the second to last of ``lam_stage``: (N, nc) for one
    scenario, (B, N, nc) batch-major.  The damping keeps the tick-over-tick
    dual loop a leaky integrator: a solve's multipliers include one final
    update at the largest penalty, which overshoots whenever the inner
    solve is inexact, and carried in full that overshoot winds up."""
    axis = lam_stage.dim() - 2 if lam_stage.dim() >= 2 else 0
    n = lam_stage.shape[axis]
    shifted = torch.cat([lam_stage.narrow(axis, 1, n - 1),
                         lam_stage.narrow(axis, n - 1, 1)], dim=axis)
    return decay * shifted, decay * lam_term, decay * lam_eq

"""Declarative optimal-control-problem spec (counterpart of
``mmmpc_tpu/ocp/spec.py``).

An OCP is a bundle of functions of (state, input, stage index, params).
States and inputs carry their feature axis LAST — ``x (..., nx)``,
``u (..., nu)`` — and any leading axes are batch axes.  The stage index ``k``
is a Python int or an integer tensor that broadcasts against the batch axes
(``arange(N)`` with ``x (B, N, nx)`` evaluates every stage at once).

- ``dynamics(x, u) -> x_next``
- ``stage_cost(x, u, k, params) -> (...)``, including the reference's slack
  blocks folded in as exact ``S * relu(max g)^2`` penalties
- ``terminal_cost(x, params)``
- ``stage_ineq / terminal_ineq / terminal_eq`` -> (..., nc) / (..., nct) /
  (..., ne), hard constraints c <= 0 and h == 0 for the AL outer loop
- ``u_lower / u_upper``: the static input box clamped in every rollout
- ``dynamics_jacobians``: the hand Jacobians (A, B) of ``dynamics``
- ``*_residuals``, ``*_gn``, ``*_jac`` (optional, the qref controller's):
  the Gauss-Newton factorisation and hand constraint Jacobians
- ``stage_al_expansion / terminal_al_expansion``: the complete gradient and
  Gauss-Newton Hessian blocks of the scaled AL stage / terminal cost
- ``lanes_fwd_factory(cfg, params)``: builds the fused line-search callable
  for one solve (``ops/wholebody_fwd.py`` or ``ops/generic_fwd.py``)
- ``lanes_bwd_factory(cfg, params)`` (optional): builds the fused
  backward-sweep callable (``ops/wholebody_bwd.py`` or
  ``ops/generic_bwd.py``); without one the solver runs the structured AL
  expansion and the Riccati sweep kernel (``ops/riccati.py``)
- ``per_scenario_keys``: the params entries that may carry one value per
  scenario, which the callables and the line search then read per scenario
  (the entries the JAX package's vmapped solve maps: the qref controller's
  references, weights, equality mask and previous inputs, the fleet's; the
  generic controllers' references and weights, and the arm's and the
  endpoint's previous inputs)
- ``fused_per_scenario_keys``: those of them that the fused backward kernel
  reads per scenario too (the JAX package's ``lanes_per_scenario_keys``):
  a solve whose per-scenario entries are all among them may take the fused
  backward; any other runs the structured expansion and the Riccati sweep
- ``diagonal_per_scenario_keys``: the per-scenario weights of which the
  line-search kernel reads the diagonal only (the qref controller's Q and
  P: A's fleet instance).  Off the fused route the callables read them
  whole, so the solver refuses one with an entry off its diagonal there

Per-scenario params.  In a batched solve's params such an entry carries a
trailing batch axis, the JAX package's convention: U_last / U_ref
(N, nu, B), X_ref (N+1, nx, B), Q / P (nx, nx, B), eq_mask (B,).  The
callables take them batch-first (``batch_first``): (B, N, nu), (B, N+1, nx),
(B, nx, nx), (B,); the batch axis of x is then the one just before the
stage index's axes (``x (B, N, nx)`` with ``k = arange(N)``, or
``(n_alpha, B, nx)`` with an int ``k``).  Q and P are full matrices there,
as the JAX package's vmap keeps them; the kernels of the qref controller
take their diagonals.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mmmpc_tpu_torch.utils.convert import device_constant


# the entries that may carry a trailing per-scenario batch axis, and their
# rank then
PER_SCENARIO_RANK = {"U_last": 3, "X_ref": 3, "U_ref": 3, "Q": 3, "P": 3,
                     "eq_mask": 1}


def per_scenario_keys(params) -> tuple[str, ...]:
    """The entries of ``params`` that carry a per-scenario batch axis, in the
    order of ``PER_SCENARIO_RANK``."""
    return tuple(k for k, rank in PER_SCENARIO_RANK.items()
                 if k in params and params[k].dim() == rank)


def batch_first(params) -> dict:
    """The callables' view of ``params``: each per-scenario entry with its
    batch axis moved from last to first, the others as they are."""
    keys = per_scenario_keys(params)
    return {k: v.movedim(-1, 0) if k in keys else v
            for k, v in params.items()}


@dataclasses.dataclass(frozen=True)
class OCP:
    """A fixed-shape optimal control problem over horizon N."""

    nx: int
    nu: int
    N: int
    dynamics: Callable
    stage_cost: Callable
    terminal_cost: Callable
    stage_ineq: Callable
    terminal_ineq: Callable
    terminal_eq: Callable
    u_lower: np.ndarray
    u_upper: np.ndarray
    lanes_fwd_factory: Callable
    stage_al_expansion: Callable
    terminal_al_expansion: Callable
    dynamics_jacobians: Callable
    lanes_bwd_factory: Callable | None = None
    stage_residuals: Callable | None = None
    terminal_residuals: Callable | None = None
    stage_gn: Callable | None = None
    terminal_gn: Callable | None = None
    stage_ineq_jac: Callable | None = None
    terminal_ineq_jac: Callable | None = None
    terminal_eq_jac: Callable | None = None
    per_scenario_keys: frozenset = frozenset()
    fused_per_scenario_keys: frozenset = frozenset()
    diagonal_per_scenario_keys: frozenset = frozenset()

    def clamp_u(self, u: torch.Tensor) -> torch.Tensor:
        return torch.clamp(u, device_constant(self.u_lower, u.dtype, u.device),
                           device_constant(self.u_upper, u.dtype, u.device))

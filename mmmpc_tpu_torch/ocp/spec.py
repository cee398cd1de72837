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
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


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

    def clamp_u(self, u: torch.Tensor) -> torch.Tensor:
        kw = dict(dtype=u.dtype, device=u.device)
        return torch.clamp(u, torch.as_tensor(self.u_lower, **kw),
                           torch.as_tensor(self.u_upper, **kw))

"""Small numeric helpers (counterpart of ``mmmpc_tpu/utils/math.py``).

All functions are elementwise on tensors and keep the input's dtype;
``angle_diff`` also takes Python or numpy floats (as float64), as the task
state machine passes them.
"""

import math

import torch


def wrap_to_pi(a: torch.Tensor) -> torch.Tensor:
    """Wrap an angle (any range) into [-pi, pi) with a floored modulo."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def angle_diff(a, b) -> torch.Tensor:
    """Closest signed difference a - b, in [-pi, pi)."""
    a, b = (v if torch.is_tensor(v) else torch.as_tensor(v, dtype=torch.float64)
            for v in (a, b))
    return wrap_to_pi(a - b)


def safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-9) -> torch.Tensor:
    """Euclidean norm with a tiny epsilon under the root (finite gradient
    at 0; the value shifts by < sqrt(eps))."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def safe_dist(dx: torch.Tensor, dy: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """2-D distance sqrt(dx^2 + dy^2 + eps)."""
    return torch.sqrt(dx * dx + dy * dy + eps)

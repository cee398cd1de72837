"""1-D double integrator, the demo robot (counterpart of
``mmmpc_tpu/models/point_mass.py``).  x = [p, v], u = [a]."""

import torch


def point_mass_step(x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    """One Euler step: (..., 2), (..., 1) -> (..., 2)."""
    return torch.stack([x[..., 0] + dt * x[..., 1],
                        x[..., 1] + dt * u[..., 0]], dim=-1)

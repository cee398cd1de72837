"""Differential-drive base (counterpart of ``mmmpc_tpu/models/base.py``).

state  x = [px, py, psi, dx, dy, dpsi]      (world-frame velocities)
input  u = [dV, dw]                          (accelerations)
"""

import torch

from mmmpc_tpu_torch.utils.math import wrap_to_pi

BASE_LENGTH = 2 * (0.7 / 2 + 0.157)
BASE_WIDTH = 0.52
BASE_RADIUS = 0.4


def base_step(x: torch.Tensor, u: torch.Tensor, dt: float,
              limited_yaw: bool = False) -> torch.Tensor:
    """Euler-integrated 6-state base model, with the world-frame
    cross-coupling terms -dy*dpsi / +dx*dpsi as the reference writes them."""
    px, py, psi, dx, dy, dpsi = (x[..., i] for i in range(6))
    dV, dw = u[..., 0], u[..., 1]
    psi_next = psi + dt * dpsi
    if limited_yaw:
        psi_next = wrap_to_pi(psi_next)
    return torch.stack(
        [
            px + dt * dx,
            py + dt * dy,
            psi_next,
            dx + dt * (dV * torch.cos(psi) - dy * dpsi),
            dy + dt * (dV * torch.sin(psi) + dx * dpsi),
            dpsi + dt * dw,
        ],
        dim=-1,
    )

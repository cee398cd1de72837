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


def base_jacobians(x: torch.Tensor, u: torch.Tensor, dt: float):
    """Closed-form (A (..., 6, 6), B (..., 6, 2)) of base_step."""
    psi, dx, dy, dpsi = x[..., 2], x[..., 3], x[..., 4], x[..., 5]
    dV = u[..., 0]
    c, s = torch.cos(psi), torch.sin(psi)
    batch = x.shape[:-1]
    A = torch.eye(6, dtype=x.dtype, device=x.device).expand(
        *batch, 6, 6).clone()
    A[..., 0, 3] = dt
    A[..., 1, 4] = dt
    A[..., 2, 5] = dt
    A[..., 3, 2] = -dt * dV * s
    A[..., 3, 4] = -dt * dpsi
    A[..., 3, 5] = -dt * dy
    A[..., 4, 2] = dt * dV * c
    A[..., 4, 3] = dt * dpsi
    A[..., 4, 5] = dt * dx
    B = torch.zeros(*batch, 6, 2, dtype=x.dtype, device=x.device)
    B[..., 3, 0] = dt * c
    B[..., 4, 0] = dt * s
    B[..., 5, 1] = dt
    return A, B

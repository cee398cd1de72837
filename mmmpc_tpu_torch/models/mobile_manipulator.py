"""Whole-body model: diff-drive base + Panda-3DoF arm.

Counterpart of ``mmmpc_tpu/models/mobile_manipulator.py``.

state x = [px, py, psi, dx, dy, dpsi, q1, q2, q3]   (..., 9)
input u = [dV, dw, dq1, dq2, dq3]                    (..., 5)
"""

import torch

from mmmpc_tpu_torch.models.arm import arm_fk, arm_step, ee_jacobian
from mmmpc_tpu_torch.models.base import base_step
from mmmpc_tpu_torch.utils.configs import BASELINK2JOINT1_X, BASELINK2JOINT1_Z


def _lift_to_world(p_arm, px, py, cpsi, spsi):
    """Arm-frame point (x, 0, z) -> world frame: rotate the arm's x-axis by
    the base yaw and add the base-link -> joint-1 offsets."""
    r = p_arm[..., 0] + BASELINK2JOINT1_X
    return torch.stack([px + r * cpsi, py + r * spsi,
                        p_arm[..., 2] + BASELINK2JOINT1_Z], dim=-1)


def wholebody_fk(state: torch.Tensor):
    """(pose_ee (..., 4) = [x, y, z, psi], joint2 (..., 3), joint3 (..., 3))
    in the world frame; the end-effector yaw is the base yaw."""
    px, py, psi = state[..., 0], state[..., 1], state[..., 2]
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    ee, j2, j3 = arm_fk(state[..., 6:9])
    ee_w = _lift_to_world(ee, px, py, cpsi, spsi)
    j2_w = _lift_to_world(j2, px, py, cpsi, spsi)
    j3_w = _lift_to_world(j3, px, py, cpsi, spsi)
    pose_ee = torch.cat([ee_w, psi[..., None]], dim=-1)
    return pose_ee, j2_w, j3_w


def wholebody_pose_jacobian(state: torch.Tensor) -> torch.Tensor:
    """(..., 4, 9) Jacobian of the end-effector world pose [x, y, z, psi]
    w.r.t. the state, closed form: the x / y rows rotate the arm-frame
    x-Jacobian by the base yaw and pick up the lever arm -r sin / r cos psi,
    the z row is the arm-frame z-Jacobian, the yaw row picks psi."""
    psi = state[..., 2]
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    ee, _, _ = arm_fk(state[..., 6:9])
    r = ee[..., 0] + BASELINK2JOINT1_X
    Ja = ee_jacobian(state[..., 6:9])          # rows [x, 0, z] w.r.t. q
    z, one = torch.zeros_like(psi), torch.ones_like(psi)
    return torch.stack([
        torch.cat([torch.stack([one, z, -r * spsi, z, z, z], -1),
                   cpsi[..., None] * Ja[..., 0, :]], -1),
        torch.cat([torch.stack([z, one, r * cpsi, z, z, z], -1),
                   spsi[..., None] * Ja[..., 0, :]], -1),
        torch.cat([torch.stack([z] * 6, -1), Ja[..., 2, :]], -1),
        torch.stack([z, z, one, z, z, z, z, z, z], -1),
    ], dim=-2)


def wholebody_step(x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    """One Euler step of the composed base + arm kinematics."""
    x_base = base_step(x[..., :6], u[..., :2], dt)
    q_next = arm_step(x[..., 6:9], u[..., 2:5], dt)
    return torch.cat([x_base, q_next], dim=-1)


def wholebody_jacobians(x: torch.Tensor, u: torch.Tensor, dt: float):
    """Closed-form (A (..., 9, 9), B (..., 9, 5)) of wholebody_step."""
    psi, dx, dy, dpsi = x[..., 2], x[..., 3], x[..., 4], x[..., 5]
    dV = u[..., 0]
    c, s = torch.cos(psi), torch.sin(psi)
    batch = x.shape[:-1]
    A = torch.eye(9, dtype=x.dtype, device=x.device).expand(
        *batch, 9, 9).clone()
    A[..., 0, 3] = dt
    A[..., 1, 4] = dt
    A[..., 2, 5] = dt
    A[..., 3, 2] = -dt * dV * s
    A[..., 3, 4] = -dt * dpsi
    A[..., 3, 5] = -dt * dy
    A[..., 4, 2] = dt * dV * c
    A[..., 4, 3] = dt * dpsi
    A[..., 4, 5] = dt * dx

    B = torch.zeros(*batch, 9, 5, dtype=x.dtype, device=x.device)
    B[..., 3, 0] = dt * c
    B[..., 4, 0] = dt * s
    B[..., 5, 1] = dt
    B[..., 6, 2] = dt
    B[..., 7, 3] = dt
    B[..., 8, 4] = dt
    return A, B

"""Panda-3DoF arm: closed-form FK, end-point Jacobian and IK.

Counterpart of ``mmmpc_tpu/models/arm.py``, plus ``arm_fk_partials``, the
closed-form q-partials of the joint and end points that the controllers'
structured expansions use (and the IK its Jacobian).  Angle-sum form:
theta = q1 - q2, beta = theta - q3; the arm moves in its local x-z plane
(y == 0).  ``q`` has the joint axis last: (..., 3).
"""

import math

import numpy as np
import torch

from mmmpc_tpu_torch.utils.convert import device_constant

# DH constants (Franka Panda DH table).
A2 = 0.316
A3 = 0.0825
A5 = 0.384
A6 = 0.088
A7 = 0.107

# IK joint bounds (they differ from the MPC's joint bounds on q).
ARM_IK_LOWER = (-math.pi / 2, -3 * math.pi / 4, 0.0)
ARM_IK_UPPER = (math.pi / 2, 0.0, 3 * math.pi / 2)
# the step sizes of each IK iteration, the best one kept
IK_ALPHAS = (1.0, 0.5, 0.25, 0.05)


def arm_fk(q: torch.Tensor):
    """Positions of (ee, joint2, joint3) in the arm base frame, each
    (..., 3) with y == 0."""
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    theta = q1 - q2
    st, ct = torch.sin(theta), torch.cos(theta)
    beta = theta - q3
    sb, cb = torch.sin(beta), torch.cos(beta)

    zero = torch.zeros_like(q1)
    x2 = A2 * s1 + A3 * c1
    z2 = A2 * c1 - A3 * s1
    x3 = x2 - A3 * ct + A5 * st
    z3 = z2 + A3 * st + A5 * ct
    xe = x3 + A6 * cb - A7 * sb
    ze = z3 - A6 * sb - A7 * cb

    joint2 = torch.stack([x2, zero, z2], dim=-1)
    joint3 = torch.stack([x3, zero, z3], dim=-1)
    ee = torch.stack([xe, zero, ze], dim=-1)
    return ee, joint2, joint3


def arm_fk_np(q):
    """Numpy twin of :func:`arm_fk` for one (3,) q, for host-side consumers
    (the 3-D scene) that must not touch the device per call: (ee, joint2,
    joint3), each a (3,) float64 array."""
    q1, q2, q3 = float(q[0]), float(q[1]), float(q[2])
    s1, c1 = np.sin(q1), np.cos(q1)
    theta = q1 - q2
    st, ct = np.sin(theta), np.cos(theta)
    beta = theta - q3
    sb, cb = np.sin(beta), np.cos(beta)
    x2 = A2 * s1 + A3 * c1
    z2 = A2 * c1 - A3 * s1
    x3 = x2 - A3 * ct + A5 * st
    z3 = z2 + A3 * st + A5 * ct
    xe = x3 + A6 * cb - A7 * sb
    ze = z3 - A6 * sb - A7 * cb
    return (np.array([xe, 0.0, ze]), np.array([x2, 0.0, z2]),
            np.array([x3, 0.0, z3]))


def arm_fk_partials(q: torch.Tensor):
    """Arm-frame x and z of (joint2, joint3, ee) as (..., 3) each, and their
    q-partials (..., point, q) each: the angle-sum FK differentiated in
    closed form (the arm-frame part of ``csrc/wholebody_common.cuh::arm_fk``)."""
    q1 = q[..., 0]
    th = q1 - q[..., 1]
    be = th - q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    st, ct = torch.sin(th), torch.cos(th)
    sb, cb = torch.sin(be), torch.cos(be)

    ax2 = A2 * s1 + A3 * c1
    az2 = A2 * c1 - A3 * s1
    D3 = A3 * st + A5 * ct              # d(-A3 ct + A5 st)/d th
    E3 = A3 * ct - A5 * st              # d( A3 st + A5 ct)/d th
    ax3 = ax2 - A3 * ct + A5 * st
    az3 = az2 + A3 * st + A5 * ct
    P6 = -A6 * sb - A7 * cb             # d( A6 cb - A7 sb)/d be
    Q6 = -A6 * cb + A7 * sb             # d(-A6 sb - A7 cb)/d be
    axe = ax3 + A6 * cb - A7 * sb
    aze = az3 - A6 * sb - A7 * cb

    z = torch.zeros_like(q1)
    ax = torch.stack([ax2, ax3, axe], dim=-1)
    az = torch.stack([az2, az3, aze], dim=-1)
    ax_q = torch.stack([torch.stack([az2, z, z], -1),
                        torch.stack([az2 + D3, -D3, z], -1),
                        torch.stack([az2 + D3 + P6, -(D3 + P6), -P6], -1)], -2)
    az_q = torch.stack([torch.stack([-ax2, z, z], -1),
                        torch.stack([-ax2 + E3, -E3, z], -1),
                        torch.stack([-ax2 + E3 + Q6, -(E3 + Q6), -Q6], -1)], -2)
    return ax, az, ax_q, az_q


def arm_step(q: torch.Tensor, dq: torch.Tensor, dt: float) -> torch.Tensor:
    """Euler joint integrator."""
    return q + dq * dt


def ee_jacobian(q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) Jacobian of the end-point position w.r.t. q, closed form
    (chain rule on theta and beta)."""
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    theta = q1 - q2
    st, ct = torch.sin(theta), torch.cos(theta)
    beta = theta - q3
    sb, cb = torch.sin(beta), torch.cos(beta)

    xt = A3 * st + A5 * ct
    zt = A3 * ct - A5 * st
    xb = -A6 * sb - A7 * cb
    zb = -A6 * cb + A7 * sb
    dx1 = A2 * c1 - A3 * s1
    dz1 = -A2 * s1 - A3 * c1

    zero = torch.zeros_like(q1)
    return torch.stack([
        torch.stack([dx1 + xt + xb, -(xt + xb), -xb], dim=-1),
        torch.stack([zero, zero, zero], dim=-1),
        torch.stack([dz1 + zt + zb, -(zt + zb), -zb], dim=-1),
    ], dim=-2)


def arm_ik(q_init: torch.Tensor, x_target: torch.Tensor, iters: int = 300,
           lm_lambda: float = 1e-6) -> torch.Tensor:
    """Joint angles (..., 3) with FK(q) == [x, 0, z] of ``x_target``
    (..., 3) (its y is ignored), inside the IK bounds, from ``q_init``
    (..., 3), for each robot of the leading batch axes: projected
    Levenberg-Marquardt, dq = -(J^T J + lm_lambda I)^-1 J^T r, each
    iteration trying the step sizes ``IK_ALPHAS`` clipped into the bounds
    and keeping, robot by robot, the one of least squared residual, for a
    fixed ``iters`` iterations (the JAX package's ``arm_ik``, vmapped over
    the batch).  The Jacobian is ``arm_fk_partials``' end-point row.  Runs
    in the dtype and on the device of ``q_init`` and never waits for the
    device (no host data copied, the solve's result unchecked: J^T J +
    lm_lambda I is positive definite)."""
    kw = dict(dtype=q_init.dtype, device=q_init.device)
    lo = device_constant(ARM_IK_LOWER, **kw)
    hi = device_constant(ARM_IK_UPPER, **kw)
    alphas = device_constant(IK_ALPHAS, **kw)[:, None]      # (4, 1)
    target = x_target.to(**kw)[..., None, 0:3:2]            # (..., 1, 2)
    H_reg = lm_lambda * torch.eye(3, **kw)

    def residual(q):                                        # (..., c, 3)
        ee, _, _ = arm_fk(q)
        return ee[..., 0:3:2] - target

    q = torch.clamp(q_init, lo, hi)
    for _ in range(iters):
        _, _, ax_q, az_q = arm_fk_partials(q)
        J = torch.stack([ax_q[..., 2, :], az_q[..., 2, :]], dim=-2)  # (..., 2, 3)
        r = residual(q[..., None, :])[..., 0, :]            # (..., 2)
        dq = -torch.linalg.solve_ex(J.mT @ J + H_reg,
                                    (J.mT @ r[..., None])[..., 0])[0]
        cands = torch.clamp(q[..., None, :] + alphas * dq[..., None, :],
                            lo, hi)                         # (..., 4, 3)
        best = torch.argmin(torch.sum(residual(cands) ** 2, dim=-1), dim=-1)
        q = torch.gather(cands, -2, best[..., None, None].expand(
            best.shape + (1, 3)))[..., 0, :]
    return q

"""Robot objects (counterpart of ``mmmpc_tpu/models/robots.py``): the
attributes the controllers read (``dt``, the base geometry) and the
kinematics methods the closed loop calls, over the tensor functions of
``mmmpc_tpu_torch.models``.

The methods take tensors or array-likes; an array-like becomes a float64
CPU tensor, as the host-side task state machine and model plant use them.
"""

import torch

from mmmpc_tpu_torch.models import arm, base, mobile_manipulator


def _tensor(v):
    return v if torch.is_tensor(v) else torch.as_tensor(v, dtype=torch.float64)


class RobotDemo:
    """1-D double integrator."""

    nx, nu = 2, 1

    def __init__(self, dt):
        self.dt = dt


class Base:
    """Differential-drive base."""

    nx, nu = 6, 2

    def __init__(self, dt):
        self.dt = dt
        self.base_length = base.BASE_LENGTH
        self.base_width = base.BASE_WIDTH

    def base_radius(self):
        return base.BASE_RADIUS

    def f_kinematics(self, x, u, limited_yaw=False):
        return base.base_step(_tensor(x), _tensor(u), self.dt,
                              limited_yaw=limited_yaw)


class ManipulatorPanda3DoF:
    """Reduced Panda arm."""

    nx, nu = 3, 3

    def __init__(self, dt):
        self.dt = dt

    def forward_tranformation(self, q):  # the reference's spelling
        """(ee, joint2, joint3) in the arm base frame."""
        return arm.arm_fk(_tensor(q))

    def inverse_transformation(self, q_initial_guess, x_target):
        """Joint angles reaching the arm-frame point ``x_target``."""
        return arm.arm_ik(_tensor(q_initial_guess), _tensor(x_target))

    def f_kinematics(self, q, q_dot):
        return arm.arm_step(_tensor(q), _tensor(q_dot), self.dt)


class MobileManipulator:
    """Base + arm composition."""

    nx, nu = 9, 5

    def __init__(self, dt):
        self.dt = dt
        self.base = Base(dt)
        self.manipulator = ManipulatorPanda3DoF(dt)

    def forward_tranformation(self, state):
        """(pose_ee [x, y, z, psi], joint2, joint3) in the world frame."""
        return mobile_manipulator.wholebody_fk(_tensor(state))

    def f_kinematics(self, x, u):
        return mobile_manipulator.wholebody_step(_tensor(x), _tensor(u),
                                                 self.dt)

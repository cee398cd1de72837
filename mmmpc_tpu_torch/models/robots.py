"""Robot objects the controllers are built from (counterpart of
``mmmpc_tpu/models/robots.py``, with the attributes the controllers read:
``dt`` and the base geometry; the reference's kinematics methods are not
ported)."""

from mmmpc_tpu_torch.models import base


class RobotDemo:
    """1-D double integrator."""

    nx, nu = 2, 1

    def __init__(self, dt):
        self.dt = dt


class Base:
    """Differential-drive base geometry."""

    nx, nu = 6, 2

    def __init__(self, dt):
        self.dt = dt
        self.base_length = base.BASE_LENGTH
        self.base_width = base.BASE_WIDTH

    def base_radius(self):
        return base.BASE_RADIUS


class ManipulatorPanda3DoF:
    """Reduced Panda arm."""

    nx, nu = 3, 3

    def __init__(self, dt):
        self.dt = dt


class MobileManipulator:
    """Base + arm composition."""

    nx, nu = 9, 5

    def __init__(self, dt):
        self.dt = dt
        self.base = Base(dt)

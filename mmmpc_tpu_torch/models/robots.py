"""Robot objects the controllers are built from (counterpart of
``mmmpc_tpu/models/robots.py``; only the whole-body robot is ported so far,
with the attributes the controller reads: ``dt`` and the base geometry)."""

from mmmpc_tpu_torch.models import base


class Base:
    """Differential-drive base geometry."""

    nx, nu = 6, 2

    def __init__(self, dt):
        self.dt = dt
        self.base_length = base.BASE_LENGTH
        self.base_width = base.BASE_WIDTH

    def base_radius(self):
        return base.BASE_RADIUS


class MobileManipulator:
    """Base + arm composition."""

    nx, nu = 9, 5

    def __init__(self, dt):
        self.dt = dt
        self.base = Base(dt)

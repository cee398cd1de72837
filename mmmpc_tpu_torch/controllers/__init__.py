"""Controllers (counterpart of ``mmmpc_tpu/controllers``; the moving-obstacle
variant is not ported yet)."""

from mmmpc_tpu_torch.controllers.base import MPCBase  # noqa: F401
from mmmpc_tpu_torch.controllers.demo import MPC  # noqa: F401
from mmmpc_tpu_torch.controllers.manipulator import MPCManipulator3DoF  # noqa: F401
from mmmpc_tpu_torch.controllers.wholebody_endpoint import MPCWholeBodyEndpoint  # noqa: F401
from mmmpc_tpu_torch.controllers.wholebody_qref import MPCWholeBody  # noqa: F401

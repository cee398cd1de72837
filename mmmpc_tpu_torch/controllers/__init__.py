"""Controllers (counterpart of ``mmmpc_tpu/controllers``)."""

from mmmpc_tpu_torch.controllers.wholebody_qref import MPCWholeBody  # noqa: F401

"""The native host runtime (counterpart of ``mmmpc_tpu/native``): float64
kinematics, plant, reference windowing and command integration in C++,
bound with ctypes (``bindings.py``)."""

from mmmpc_tpu_torch.native.bindings import (  # noqa: F401
    available, arm_fk, wholebody_fk, wholebody_step, plant_step,
    plant_observation, nearest_index, local_ref_window, integrate_command,
)

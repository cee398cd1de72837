"""mmmpc_tpu_torch — the whole-body MPC framework in PyTorch, with CUDA
kernels for NVIDIA Hopper (sm_90a).

Port of ``mmmpc_tpu`` (the JAX/Pallas package, kept beside it as the
reference).  Module names mirror the JAX package so each module's counterpart
is found by path.  The package imports torch and numpy, never jax.

- ``models``       dynamics and kinematics on tensors with a trailing
                   feature axis (``x[..., 0:9]``).
- ``ocp``          the OCP bundle of callables and constraint blocks.
- ``controllers``  ``MPCWholeBody`` (joint-space reference), the main
                   controller.
- ``solver``       batched AL-iLQR with the batch on the last axis, straggler
                   refinement.
- ``ops``          the two fused iLQR kernels (CUDA C++ in ``csrc/``), each
                   beside its plain PyTorch version.
- ``parallel``     batch statistics.

Float32 matmuls are pinned to full precision here, on import: TF32 keeps
about three decimal digits, and the JAX package measured that low-precision
matmuls, while still passing the solve tolerance, turn closed-loop
regulation into a ~1 m limit cycle (``mmmpc_tpu/utils/configs.py``
``matmul_precision``).
"""

import torch

__version__ = "0.1.0"


def pin_fp32_matmul() -> None:
    """Full-precision float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


pin_fp32_matmul()

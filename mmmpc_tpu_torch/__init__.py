"""mmmpc_tpu_torch — the whole-body MPC framework in PyTorch, with CUDA
kernels for NVIDIA Hopper (sm_90a).

Port of ``mmmpc_tpu`` (the JAX/Pallas package, kept beside it as the
reference).  Module names mirror the JAX package so each module's counterpart
is found by path.  The package imports torch and numpy, never jax.

- ``models``       dynamics and kinematics on tensors with a trailing
                   feature axis (``x[..., 0:9]``), the robots and obstacles.
- ``ocp``          the OCP bundle of callables and constraint blocks.
- ``controllers``  the controllers: ``MPCWholeBody`` (joint-space
                   reference, the bench's), ``MPCWholeBodyMovingObs``,
                   ``MPCWholeBodyEndpoint``, ``MPCManipulator3DoF``,
                   ``MPCBase`` and ``MPC`` (the 1-D demo).
- ``solver``       batched AL-iLQR with the batch on the last axis, straggler
                   refinement, small dense linear algebra.
- ``ops``          the kernel wrappers, each beside its plain PyTorch
                   version: the whole-body line search and fused backward,
                   the generic formulations' pair, the Riccati sweep (CUDA
                   C++ in ``csrc/``), the associative-scan sweep.
- ``parallel``     batch statistics and the data-parallel scale-out over
                   ``torch.distributed``.
- ``runtime``      the closed loop: the task state machine, the local
                   references, metrics, checkpoints, the 3-D scene.
- ``sim``          the kinematic plant, the batched closed loops (fleet),
                   the simulation's obstacles.
- ``native``       the host runtime in C++ (``csrc/mmrt.cpp``, built with
                   g++ on first use), bound with ctypes.
- ``verify``       the scipy oracles of the controllers' OCPs.
- ``utils``        configs, conversions, failure reports, profiling, and
                   the sympy DH derivation (``dh_codegen``, tests only).

The entry modules at the package root (``bench``, ``bench_*``, the demos,
the sweeps, the profilers, the tools) run as ``python -m
mmmpc_tpu_torch.<name>``, on the card by default.

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

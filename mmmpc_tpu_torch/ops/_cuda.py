"""Build and load the hand-written CUDA kernels of ``mmmpc_tpu_torch/csrc``.

The kernels have a plain C interface and are bound with ctypes (no PyTorch
headers, so the build takes seconds).  The library is compiled on first use
by ``nvcc`` for ``sm_90a`` (NVIDIA Hopper) into ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the sources, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("wholebody_fwd.cu", "wholebody_bwd.cu")
HEADERS = ("wholebody_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class LaunchCounter:
    """Dispatches of one kernel wrapper: ``cuda`` counts launches of the
    CUDA kernel, ``plain`` counts calls of the plain version (CPU tensors)."""
    cuda: int = 0
    plain: int = 0

    def reset(self) -> None:
        self.cuda = 0
        self.plain = 0


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float        # 0.0 when an up-to-date library was found
    log: str              # nvcc / ptxas output (register and spill report)


_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# C signatures (see csrc/*.cu).  Launches: host statics, device pointers,
# mu, N, B, then the stream.  Layout sizes: the statics block, and the packed
# params for (N, n_obs, n_hp).
SIGNATURES = {
    "wb_fwd_launch": [_VOID] * 13 + [_FLOAT, _INT, _INT, _VOID],
    "wb_bwd_launch": [_VOID] * 10 + [_FLOAT, _INT, _INT, _VOID],
    "wb_statics_size": [],
    "wb_params_size": [_INT, _INT, _INT],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernel library unless an up-to-date one exists."""
    path = BUILD_DIR / f"libmmmpc_kernels_{_source_hash()}.so"
    log_path = path.with_suffix(".log")
    if path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(path, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, path)
    return BuildInfo(path, seconds, log)


class _Library:
    """The loaded kernel library (one per process, loaded on first launch)."""

    def __init__(self):
        self.lib = None
        self.info = None

    def get(self):
        if self.lib is None:
            self.info = build()
            lib = ctypes.CDLL(str(self.info.path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _INT
            self.lib = lib
        return self.lib


LIBRARY = _Library()


def check_layout(lib, statics, flat: torch.Tensor, N: int, n_obs: int,
                 n_hp: int) -> None:
    """Raise unless the host statics block and the packed params have the
    sizes the library's C layouts (``csrc/wholebody_common.cuh``) expect."""
    want = (lib.wb_statics_size(), lib.wb_params_size(N, n_obs, n_hp))
    if (statics.size, flat.numel()) != want:
        raise RuntimeError(f"layout mismatch: statics / params sizes "
                           f"{statics.size} / {flat.numel()}, the kernel "
                           f"library expects {want[0]} / {want[1]}")


def check_launch(name: str, err: int) -> None:
    """Raise on the ``cudaGetLastError()`` a C entry returned."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 device: torch.device) -> int:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on the
    CUDA ``device``; return its data pointer."""
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()

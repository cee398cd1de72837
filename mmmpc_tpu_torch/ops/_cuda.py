"""Build and load the hand-written CUDA kernels of ``mmmpc_tpu_torch/csrc``.

The kernels have a plain C interface and are bound with ctypes (no PyTorch
headers, so the build takes seconds).  The library is compiled on first use
by ``nvcc`` for ``sm_90a`` (NVIDIA Hopper) into ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the sources, so an edited source is
rebuilt and an unchanged one is loaded as it is: one ``nvcc -c`` per source,
all started together, then one link.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# The formulations of the generic kernels (csrc/generic_<name>.cu)
FORMULATIONS = ("demo", "base", "arm", "endpoint")
# The (nx, nu) instances of the Riccati sweep (csrc/riccati.cu), and the
# accumulator counts of the FMA microkernel (csrc/fma_peak.cu)
RICCATI_INSTANCES = ((2, 1), (3, 3), (6, 2), (9, 5))
FMA_NACC = (4, 8, 16, 32)
SOURCES = ("wholebody_fwd.cu", "wholebody_bwd.cu",
           *(f"generic_{name}.cu" for name in FORMULATIONS), "riccati.cu",
           "fma_peak.cu")
HEADERS = ("wholebody_common.cuh", "generic_common.cuh", "generic_fwd.cuh",
           "generic_bwd.cuh", "riccati_step.cuh")
# step sizes the statics blocks hold (MAX_ALPHA of csrc/wholebody_common.cuh)
MAX_ALPHA = 8
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
# C signatures (see csrc/*.cu).  Fused launches: host statics, device
# pointers, mu, N, B, then the stream.  Layout sizes: the statics block, and
# the packed params for (N, n_obs, n_hp).  Riccati sweep: 12 device pointers,
# N, B, the stream.  FMA microkernel: 2 device pointers, the trip count,
# blocks, threads, the stream.
_FWD = [_VOID] * 13 + [_FLOAT, _INT, _INT, _VOID]
_BWD = [_VOID] * 10 + [_FLOAT, _INT, _INT, _VOID]
SIGNATURES = {
    "wb_fwd_launch": _FWD, "wb_bwd_launch": _BWD,
    "wb_statics_size": [], "wb_params_size": [_INT, _INT, _INT],
    **{k: v for name in FORMULATIONS for k, v in (
        (f"gen_fwd_{name}", _FWD), (f"gen_bwd_{name}", _BWD),
        (f"gen_statics_size_{name}", []),
        (f"gen_params_size_{name}", [_INT, _INT, _INT]))},
    **{f"ric_bwd_{nx}x{nu}": [_VOID] * 12 + [_INT, _INT, _VOID]
       for nx, nu in RICCATI_INSTANCES},
    **{f"fma_peak_{n}": [_VOID, _VOID, _INT, _INT, _INT, _VOID]
       for n in FMA_NACC},
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
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(CSRC / src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        out = proc.communicate()[0]
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    tmp = path.with_name(f"{tag}.so.tmp")
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
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


def pack_buffer(shapes: dict, params) -> torch.Tensor:
    """The per-problem tensors ``params[k]`` of ``shapes`` (key -> shape, in
    the order of the kernel's layout) as one contiguous buffer, in the dtype
    and on the device of ``params``.  Per-scenario entries are not
    supported."""
    for k, shape in shapes.items():
        if tuple(params[k].shape) != tuple(shape):
            raise ValueError(f"params[{k!r}]: expected shape {tuple(shape)}, "
                             f"got {tuple(params[k].shape)}")
    return torch.cat([params[k].reshape(-1) for k in shapes])


def unpack_buffer(shapes: dict, flat: torch.Tensor) -> dict[str, torch.Tensor]:
    """Views of a ``pack_buffer`` result under the keys of ``shapes``."""
    sizes = [math.prod(s) for s in shapes.values()]
    return {k: v.reshape(s) for (k, s), v in
            zip(shapes.items(), torch.split(flat, sizes))}


def check_layout(lib, statics, flat: torch.Tensor, N: int, n_obs: int,
                 n_hp: int, formulation: str | None = None) -> None:
    """Raise unless the host statics block and the packed params have the
    sizes the library's C layouts expect: ``csrc/wholebody_common.cuh``'s, or
    with ``formulation`` those of ``csrc/generic_<formulation>.cu``."""
    if formulation is None:
        want = (lib.wb_statics_size(), lib.wb_params_size(N, n_obs, n_hp))
    else:
        want = (getattr(lib, f"gen_statics_size_{formulation}")(),
                getattr(lib, f"gen_params_size_{formulation}")(N, n_obs, n_hp))
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

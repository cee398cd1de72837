"""Build and load the hand-written CUDA kernels of ``mmmpc_tpu_torch/csrc``.

The kernels have a plain C interface and are bound with ctypes (no PyTorch
headers, so the build takes seconds).  The library is compiled on first use
by ``nvcc`` for ``sm_90a`` (NVIDIA Hopper) into ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the sources, so an edited source is
rebuilt and an unchanged one is loaded as it is: one ``nvcc -c`` per source,
all started together, then one link.  Kernel E at an (nx, nu) that the
library does not hold gets a library of its own, built the same way on the
pair's first use (``RICCATI``).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# The formulations of the generic kernels: each one's C entries
# gen_*_<name> and the source that instantiates them (the arm's joint-space
# and Cartesian references are two instances of generic_arm.cu)
FORMULATION_SOURCES = {"demo": "generic_demo.cu", "base": "generic_base.cu",
                       "arm": "generic_arm.cu", "arm_cart": "generic_arm.cu",
                       "endpoint": "generic_endpoint.cu"}
FORMULATIONS = tuple(FORMULATION_SOURCES)
# The (nx, nu) instances of the Riccati sweep (csrc/riccati.cu) that the
# kernel library holds (any other pair: build_riccati_pair on first use),
# and the accumulator counts of the FMA microkernel (csrc/fma_peak.cu)
RICCATI_INSTANCES = ((2, 1), (3, 3), (6, 2), (9, 5))
FMA_NACC = (4, 8, 16, 32)
SOURCES = ("wholebody_fwd.cu", "wholebody_bwd.cu",
           *dict.fromkeys(FORMULATION_SOURCES.values()), "riccati.cu",
           "fma_peak.cu")
HEADERS = ("wholebody_common.cuh", "cp_async.cuh", "generic_common.cuh",
           "generic_fwd.cuh", "generic_bwd.cuh", "riccati_step.cuh",
           "riccati_team.cuh")
# step sizes the statics blocks hold (MAX_ALPHA of csrc/wholebody_common.cuh)
MAX_ALPHA = 8
_INCLUDE = re.compile(r'\s*#\s*include\s+"([^"]+)"')
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
# N, B, the stream; its geometry (B) writes five ints (team, threads,
# blocks, shared-memory bytes, blocks an SM).  FMA microkernel: 2 device
# pointers, the trip count, blocks, threads, the stream.  The backwards'
# geometries (N, n_obs, n_hp, B) and the forwards' (N, n_obs, n_hp,
# n_alpha, B), whole-body and generic, write four ints (team, threads,
# blocks, shared-memory bytes); the whole-body ones, and the whole-body
# params size, also take ``moving`` after n_hp (1: an obstacle row a
# stage), and the whole-body geometries then the per-scenario mask (the
# statics' ``per_scenario``); their occupancies (the same sizes, then the
# statics' ``bug_compat``, no batch) write the blocks an SM holds.  The
# whole-body launches take the six per-scenario operands (U_last, X_ref,
# U_ref, the Q and P diagonals, eq_mask; null where the mask has no bit)
# after the multipliers.
_FWD = [_VOID] * 13 + [_FLOAT, _INT, _INT, _VOID]
_BWD = [_VOID] * 10 + [_FLOAT, _INT, _INT, _VOID]
_WB_FWD = [_VOID] * 19 + [_FLOAT, _INT, _INT, _VOID]
_WB_BWD = [_VOID] * 16 + [_FLOAT, _INT, _INT, _VOID]
_RIC = [_VOID] * 12 + [_INT, _INT, _VOID]
_RIC_GEOMETRY = [_INT, _VOID]
SIGNATURES = {
    "wb_fwd_launch": _WB_FWD,
    "wb_bwd_launch": _WB_BWD,
    "wb_bwd_geometry": [_INT] * 6 + [_VOID],
    "wb_fwd_geometry": [_INT] * 7 + [_VOID],
    "wb_bwd_occupancy": [_INT] * 6 + [_VOID],
    "wb_fwd_occupancy": [_INT] * 7 + [_VOID],
    "wb_statics_size": [], "wb_params_size": [_INT] * 4,
    **{k: v for name in FORMULATIONS for k, v in (
        (f"gen_fwd_{name}", _FWD), (f"gen_bwd_{name}", _BWD),
        (f"gen_fwd_geometry_{name}", [_INT] * 5 + [_VOID]),
        (f"gen_bwd_geometry_{name}", [_INT] * 4 + [_VOID]),
        (f"gen_statics_size_{name}", []),
        (f"gen_params_size_{name}", [_INT, _INT, _INT]))},
    **{f"ric_bwd_{nx}x{nu}": _RIC for nx, nu in RICCATI_INSTANCES},
    **{f"ric_geometry_{nx}x{nu}": _RIC_GEOMETRY
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


def includes(source: str) -> tuple[str, ...]:
    """``source`` and every file of ``csrc`` that it includes with
    ``#include "..."``, followed transitively, in the order first met."""
    found, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in found:
            continue
        found.append(name)
        for line in (CSRC / name).read_text().splitlines():
            m = _INCLUDE.match(line)
            if m:
                todo.append(m.group(1))
    return tuple(found)


def _source_hash(names=HEADERS + SOURCES, defines=()) -> str:
    h = hashlib.sha256()
    for name in names:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernel library unless an up-to-date one exists."""
    return _build(BUILD_DIR / f"libmmmpc_kernels_{_source_hash()}.so",
                  SOURCES)


def build_riccati_pair(nx: int, nu: int) -> BuildInfo:
    """Compile ``csrc/riccati.cu`` for the one pair (nx, nu), whose entry is
    ``ric_bwd_<nx>x<nu>``, unless an up-to-date library exists.  The kernel
    library holds the pairs of ``RICCATI_INSTANCES``; any other pair is
    built by this on its first use."""
    if (nx, nu) in RICCATI_INSTANCES or min(nx, nu) < 1:
        raise ValueError(f"no pair library for (nx, nu) = {(nx, nu)}")
    defines = (f"-DRIC_PAIR_NX={nx}", f"-DRIC_PAIR_NU={nu}")
    digest = _source_hash(includes("riccati.cu"), defines)
    return _build(BUILD_DIR / f"libmmmpc_riccati_{digest}_{nx}x{nu}.so",
                  ("riccati.cu",), defines)


def _build(path: Path, sources, defines=()) -> BuildInfo:
    """Compile ``sources`` (one ``nvcc -c`` each, all started together, with
    ``defines``) and link them into the shared library ``path``, unless it
    exists; raise with nvcc's output if a step fails."""
    log_path = path.with_suffix(".log")
    if path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(path, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, *defines, "-c", "-o",
                               str(obj), str(CSRC / src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
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


class RiccatiEntries:
    """The C entries of kernel E for any (nx, nu): ``ric_bwd_<nx>x<nu>``
    (``get``) and ``ric_geometry_<nx>x<nu>`` (``geometry``), from the kernel
    library for a pair of ``RICCATI_INSTANCES``, else from the pair's own
    library, built by ``build`` on the pair's first use and loaded by
    ``load`` once a process.  A failed build raises."""

    def __init__(self, library=LIBRARY, build=build_riccati_pair,
                 load=ctypes.CDLL):
        self.library, self.build, self.load = library, build, load
        self.libs = {}
        self.info = {}      # (nx, nu) -> BuildInfo of each pair built here

    def _lib(self, nx: int, nu: int):
        if (nx, nu) in RICCATI_INSTANCES:
            return self.library.get()
        if (nx, nu) not in self.libs:
            info = self.build(nx, nu)
            lib = self.load(str(info.path))
            for name, argtypes in ((f"ric_bwd_{nx}x{nu}", _RIC),
                                   (f"ric_geometry_{nx}x{nu}", _RIC_GEOMETRY)):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _INT
            self.info[(nx, nu)] = info
            self.libs[(nx, nu)] = lib
        return self.libs[(nx, nu)]

    def get(self, nx: int, nu: int):
        return getattr(self._lib(nx, nu), f"ric_bwd_{nx}x{nu}")

    def geometry(self, nx: int, nu: int):
        return getattr(self._lib(nx, nu), f"ric_geometry_{nx}x{nu}")


RICCATI = RiccatiEntries()


def pack_buffer(shapes: dict, params, per_scenario=()) -> torch.Tensor:
    """The per-problem tensors ``params[k]`` of ``shapes`` (key -> shape, in
    the order of the kernel's layout) as one contiguous buffer, in the dtype
    and on the device of ``params``.  An entry named in ``per_scenario``
    carries a trailing batch axis, ``shape + (B,)``; the kernel reads it
    from an operand of its own, and its slot here is kept, filled with
    zeros.  Raises on an entry of another shape."""
    parts = []
    for k, shape in shapes.items():
        t, shape, ps = params[k], tuple(shape), k in per_scenario
        want = shape + (t.shape[-1],) if ps and t.dim() else shape
        if tuple(t.shape) != want or (ps and not t.dim()):
            raise ValueError(f"params[{k!r}]: expected shape {shape}"
                             f"{' + (B,)' if ps else ''}, got "
                             f"{tuple(t.shape)}")
        parts.append(t.new_zeros(math.prod(shape)) if ps else t.reshape(-1))
    return torch.cat(parts)


def unpack_buffer(shapes: dict, flat: torch.Tensor) -> dict[str, torch.Tensor]:
    """Views of a ``pack_buffer`` result under the keys of ``shapes``."""
    sizes = [math.prod(s) for s in shapes.values()]
    return {k: v.reshape(s) for (k, s), v in
            zip(shapes.items(), torch.split(flat, sizes))}


def check_layout(lib, statics, flat: torch.Tensor, N: int, n_obs: int,
                 n_hp: int, formulation: str | None = None,
                 moving: bool = False) -> None:
    """Raise unless the host statics block and the packed params have the
    sizes the library's C layouts expect: ``csrc/wholebody_common.cuh``'s
    (``moving``: an obstacle row a stage), or with ``formulation`` those of
    ``csrc/generic_<formulation>.cu``."""
    if formulation is None:
        want = (lib.wb_statics_size(),
                lib.wb_params_size(N, n_obs, n_hp, int(moving)))
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


@functools.lru_cache(maxsize=None)
def shared_memory_optin(index: int) -> int:
    """The most dynamic shared memory a block may take on CUDA device
    ``index`` once a kernel opts in (bytes)."""
    props = torch.cuda.get_device_properties(index)
    return props.shared_memory_per_block_optin


def check_shared_memory(name: str, N: int, smem_bytes: int,
                        device: torch.device) -> None:
    """Raise a ValueError naming the horizon and the bytes unless a block of
    kernel ``name`` at horizon ``N``, taking ``smem_bytes`` of shared
    memory, fits ``device``: the packed params the whole-body kernels copy
    into shared memory grow with N."""
    limit = shared_memory_optin(device.index if device.index is not None
                                else torch.cuda.current_device())
    if smem_bytes > limit:
        raise ValueError(f"{name}: N={N} needs {smem_bytes} B of shared "
                         f"memory a block, more than the {limit} B the "
                         f"device allows")


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

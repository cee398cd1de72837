"""ctypes bindings to the native host runtime ``csrc/mmrt.cpp`` (counterpart
of ``mmmpc_tpu/native/bindings.py``, name for name).

The library is a host library: ``g++ -O3 -fPIC -std=c++17 -shared`` (the
flags of ``native/Makefile``) compiles it into ``build/torch_kernels/`` at
the root of the checkout on first use, named by a hash of the source and
the flags, apart from the ``nvcc`` build of the CUDA kernels
(``ops/_cuda.py``).  Every function takes and returns float64 numpy
arrays.  A failed build raises in the function that needs the library, and
``available()`` reports it: nothing falls back to another path.  The
closed loop does not call it; ``tests/test_torch_native.py`` holds it
against the port's float64 torch functions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

from mmmpc_tpu_torch.ops._cuda import BUILD_DIR, CSRC

SOURCE = CSRC / "mmrt.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


class _Runtime:
    """The loaded library (one per process, built and loaded on first use);
    ``path`` and ``seconds`` (0.0 when an up-to-date one was found) once
    loaded, ``error`` once a build or load failed."""

    def __init__(self):
        self.lib = None
        self.path: Path | None = None
        self.seconds = 0.0
        self.error: Exception | None = None

    def get(self):
        if self.lib is not None:
            return self.lib
        if self.error is not None:
            raise self.error
        try:
            self.lib = self._load()
        except (OSError, RuntimeError) as e:
            self.error = e
            raise
        return self.lib

    def _load(self):
        digest = hashlib.sha256(SOURCE.read_bytes()
                                + " ".join(CXX_FLAGS).encode()).hexdigest()
        path = BUILD_DIR / f"libmmrt_{digest[:16]}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.so.tmp")
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"g++ could not run: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed on {SOURCE.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            self.seconds = time.perf_counter() - t0
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        D = ctypes.POINTER(ctypes.c_double)
        I = ctypes.POINTER(ctypes.c_int)
        lib.mm_arm_fk.argtypes = [D, D, D, D]
        lib.mm_wholebody_fk.argtypes = [D, D, D, D]
        lib.mm_wholebody_step.argtypes = [D, D, ctypes.c_double, D]
        lib.mm_plant_step.argtypes = [D, D, ctypes.c_double, D]
        lib.mm_plant_observation.argtypes = [D, D, D, D]
        lib.mm_nearest_index.argtypes = [D, ctypes.c_int, ctypes.c_int, D, I,
                                         ctypes.c_int]
        lib.mm_nearest_index.restype = ctypes.c_int
        lib.mm_local_ref_window.argtypes = [D, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, D]
        lib.mm_integrate_command.argtypes = [D, D, ctypes.c_double]
        self.path = path
        return lib


RUNTIME = _Runtime()


def available() -> bool:
    """Whether the library builds and loads (building it if need be)."""
    try:
        RUNTIME.get()
    except (OSError, RuntimeError):
        return False
    return True


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _f64(a, n=None):
    out = np.ascontiguousarray(np.asarray(a, dtype=np.float64))
    if n is not None and out.size != n:
        raise ValueError(f"expected {n} values, got shape {out.shape}")
    return out


def arm_fk(q):
    """(ee, joint2, joint3) of the arm at ``q`` (3,), arm base frame."""
    lib = RUNTIME.get()
    q = _f64(q, 3)
    ee, j2, j3 = (np.empty(3) for _ in range(3))
    lib.mm_arm_fk(_ptr(q), _ptr(ee), _ptr(j2), _ptr(j3))
    return ee, j2, j3


def wholebody_fk(x):
    """(pose_ee (4,), joint2 (3,), joint3 (3,)) in the world frame."""
    lib = RUNTIME.get()
    x = _f64(x, 9)
    pose = np.empty(4)
    j2, j3 = np.empty(3), np.empty(3)
    lib.mm_wholebody_fk(_ptr(x), _ptr(pose), _ptr(j2), _ptr(j3))
    return pose, j2, j3


def wholebody_step(x, u, dt):
    """One Euler step of the whole-body kinematics."""
    lib = RUNTIME.get()
    x, u = _f64(x, 9), _f64(u, 5)
    out = np.empty(9)
    lib.mm_wholebody_step(_ptr(x), _ptr(u), float(dt), _ptr(out))
    return out


def plant_step(s, a, dt):
    """One step of the kinematic plant (``sim/kinematic_plant.py``)."""
    lib = RUNTIME.get()
    s, a = _f64(s, 12), _f64(a, 11)
    out = np.empty(12)
    lib.mm_plant_step(_ptr(s), _ptr(a), float(dt), _ptr(out))
    return out


def plant_observation(s, a):
    """The plant's (position, velocity) observations."""
    lib = RUNTIME.get()
    s, a = _f64(s, 12), _f64(a, 11)
    pos, vel = np.empty(12), np.empty(12)
    lib.mm_plant_observation(_ptr(s), _ptr(a), _ptr(pos), _ptr(vel))
    return pos, vel


def nearest_index(traj, point, distance_index):
    """Row of ``traj`` nearest ``point`` over the ``distance_index``
    components (``runtime/reference.py``)."""
    lib = RUNTIME.get()
    traj = _f64(traj)
    point = _f64(point)
    idx = np.ascontiguousarray(np.asarray(distance_index, dtype=np.int32))
    return int(lib.mm_nearest_index(
        _ptr(traj), traj.shape[0], traj.shape[1], _ptr(point), _iptr(idx),
        idx.size))


def local_ref_window(traj, min_idx, count):
    """``count`` rows of ``traj`` from ``min_idx``, the last row repeated
    past the end."""
    lib = RUNTIME.get()
    traj = _f64(traj)
    out = np.empty((count, traj.shape[1]))
    lib.mm_local_ref_window(_ptr(traj), traj.shape[0], traj.shape[1],
                            int(min_idx), int(count), _ptr(out))
    return out


def integrate_command(vel_cmd, cmd, sim_dt):
    """``vel_cmd`` advanced by the acceleration command over ``sim_dt``,
    the V channel reversed (the sim's convention)."""
    lib = RUNTIME.get()
    vel_cmd = _f64(vel_cmd, 2).copy()
    cmd = _f64(cmd, 2)
    lib.mm_integrate_command(_ptr(vel_cmd), _ptr(cmd), float(sim_dt))
    return vel_cmd

"""The port's native host runtime ``mmmpc_tpu_torch/native`` (its own
build of ``mmmpc_tpu_torch/csrc/mmrt.cpp`` with g++) against the port's
float64 torch functions: ``models/arm.py::arm_fk``,
``models/mobile_manipulator.py::wholebody_fk`` / ``wholebody_step``,
``sim/kinematic_plant.py::plant_step`` / ``plant_observation`` and
``runtime/reference.py``, with ``tests/test_native.py``'s seed, inputs and
tolerances (1e-14; 1e-13 for the whole-body FK).  The source is a byte copy
of ``native/mmrt.cpp``, and a failed build raises.  No JAX.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mmmpc_tpu_torch import native
from mmmpc_tpu_torch.models.arm import arm_fk
from mmmpc_tpu_torch.models.mobile_manipulator import (
    wholebody_fk, wholebody_step,
)
from mmmpc_tpu_torch.native import bindings
from mmmpc_tpu_torch.runtime.reference import local_ref_traj, nearest_index
from mmmpc_tpu_torch.sim.kinematic_plant import plant_observation, plant_step

RNG = np.random.default_rng(21)
ROOT = Path(__file__).resolve().parents[1]


def _close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=atol)


def test_mmrt_is_a_byte_copy():
    assert (bindings.SOURCE.read_bytes()
            == (ROOT / "native" / "mmrt.cpp").read_bytes())
    assert native.available()


def test_native_kinematics_parity():
    for _ in range(50):
        q = RNG.uniform([-1.5, -3.0, 0.0], [1.5, 0.0, 4.5])
        _close(native.arm_fk(q), arm_fk(torch.as_tensor(q)), 1e-14)
    for _ in range(20):
        x = RNG.normal(size=9)
        _close(native.wholebody_fk(x), wholebody_fk(torch.as_tensor(x)),
               1e-13)
    for _ in range(20):
        x, u = RNG.normal(size=9), RNG.normal(size=5)
        _close([native.wholebody_step(x, u, 0.1)],
               [wholebody_step(torch.as_tensor(x), torch.as_tensor(u), 0.1)],
               1e-14)


def test_native_plant_parity():
    for _ in range(20):
        s, a = RNG.normal(size=12), RNG.normal(size=11)
        st, at = torch.as_tensor(s), torch.as_tensor(a)
        _close([native.plant_step(s, a, 0.01)], [plant_step(st, at, 0.01)],
               1e-14)
        _close(native.plant_observation(s, a), plant_observation(st, at),
               1e-14)


def test_native_reference_windowing():
    traj = RNG.normal(size=(40, 9))
    point = traj[17] + 0.01
    idx = np.array([0, 1])
    assert native.nearest_index(traj, point, idx) == nearest_index(
        traj, point, idx) == 17
    win = native.local_ref_window(traj, 35, 9)
    assert win.shape == (9, 9)
    np.testing.assert_allclose(win[:5], traj[35:40], atol=0)
    np.testing.assert_allclose(win[5:], np.tile(traj[-1], (4, 1)), atol=0)
    # the window of runtime/reference.py from the same nearest row
    local, _ = local_ref_traj(traj, np.zeros((39, 5)), traj[35], idx, 8)
    np.testing.assert_array_equal(win, local)
    v = native.integrate_command([0.1, -0.2], [1.0, 2.0], 0.01)
    # reference interface:473: V channel reversed
    np.testing.assert_allclose(v, [0.1 - 0.01, -0.2 + 0.02], atol=1e-15)


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "mmrt.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(bindings, "SOURCE", broken)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(bindings, "RUNTIME", bindings._Runtime())
    assert not native.available()
    for _ in range(2):          # the error is kept, not rebuilt
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.arm_fk([0.0, 0.0, 0.0])
    assert not list((tmp_path / "build").glob("*.so"))

"""Parity of the PyTorch port's configs, math and models with the JAX package.

float64 on random states, atol 1e-10 (the two packages evaluate the same
closed forms; only the order of a few float64 operations differs).  Also
checks that the port never loads JAX and pins float32 matmuls to full
precision.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu.models import arm as arm_j
from mmmpc_tpu.models import base as base_j
from mmmpc_tpu.models import mobile_manipulator as mm_j
from mmmpc_tpu.utils import configs as cfg_j
from mmmpc_tpu.utils import math as math_j
from mmmpc_tpu_torch.models import arm as arm_t
from mmmpc_tpu_torch.models import base as base_t
from mmmpc_tpu_torch.models import mobile_manipulator as mm_t
from mmmpc_tpu_torch.utils import configs as cfg_t
from mmmpc_tpu_torch.utils import math as math_t

ATOL = 1e-10
F64 = jnp.float64


def _states(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, (n, 9))
    u = rng.uniform(-2.0, 2.0, (n, 5))
    return x, u


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("scenario", [0, 1, 2])
def test_configs_match_jax(scenario):
    for name in ("BASELINK2JOINT1_X", "BASELINK2JOINT1_Z", "WORKING_RADIUS"):
        assert getattr(cfg_t, name) == getattr(cfg_j, name)
    for name in ("A2", "A3", "A5", "A6", "A7"):
        assert getattr(arm_t, name) == getattr(arm_j, name)
    for name in ("BASE_LENGTH", "BASE_WIDTH", "BASE_RADIUS"):
        assert getattr(base_t, name) == getattr(base_j, name)
    jax_defaults = dataclasses.asdict(cfg_j.SolverConfig())
    for k, v in dataclasses.asdict(cfg_t.SolverConfig()).items():
        assert jax_defaults[k] == v, k
    sj, st = cfg_j.make_scenario(scenario, N=20), cfg_t.make_scenario(scenario, N=20)
    for f in dataclasses.fields(sj):
        a, b = getattr(sj, f.name), getattr(st, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("fn", ["arm_fk", "ee_jacobian", "base_step",
                                "base_jacobians", "wholebody_fk",
                                "wholebody_step", "wholebody_jacobians",
                                "wholebody_pose_jacobian", "math"])
def test_models_match_jax(fn):
    import jax
    x, u = _states()
    xj, uj = jnp.asarray(x, F64), jnp.asarray(u, F64)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    dt = 0.1
    if fn == "arm_fk":
        for a, b in zip(arm_t.arm_fk(xt[:, 6:]), jax.vmap(arm_j.arm_fk)(xj[:, 6:])):
            _close(a, b)
    elif fn == "ee_jacobian":
        _close(arm_t.ee_jacobian(xt[:, 6:]), jax.vmap(arm_j.ee_jacobian)(xj[:, 6:]))
    elif fn == "base_step":
        for ly in (False, True):
            _close(base_t.base_step(xt[:, :6], ut[:, :2], dt, limited_yaw=ly),
                   jax.vmap(lambda a, b: base_j.base_step(a, b, dt, ly))(
                       xj[:, :6], uj[:, :2]))
    elif fn == "base_jacobians":
        for a, b in zip(base_t.base_jacobians(xt[:, :6], ut[:, :2], dt),
                        jax.vmap(lambda a, b: base_j.base_jacobians(a, b, dt))(
                            xj[:, :6], uj[:, :2])):
            _close(a, b)
    elif fn == "wholebody_pose_jacobian":
        _close(mm_t.wholebody_pose_jacobian(xt),
               jax.vmap(mm_j.wholebody_pose_jacobian)(xj))
    elif fn == "wholebody_fk":
        for a, b in zip(mm_t.wholebody_fk(xt), jax.vmap(mm_j.wholebody_fk)(xj)):
            _close(a, b)
    elif fn == "wholebody_step":
        _close(mm_t.wholebody_step(xt, ut, dt),
               jax.vmap(lambda a, b: mm_j.wholebody_step(a, b, dt))(xj, uj))
    elif fn == "wholebody_jacobians":
        for a, b in zip(mm_t.wholebody_jacobians(xt, ut, dt),
                        jax.vmap(lambda a, b: mm_j.wholebody_jacobians(a, b, dt))(
                            xj, uj)):
            _close(a, b)
    else:
        a = xt[:, :3] * 4.0
        aj = xj[:, :3] * 4.0
        _close(math_t.wrap_to_pi(a), math_j.wrap_to_pi(aj))
        _close(math_t.angle_diff(a, xt[:, 3:6]), math_j.angle_diff(aj, xj[:, 3:6]))
        _close(math_t.safe_norm(a), math_j.safe_norm(aj))
        _close(math_t.safe_dist(a[:, 0], a[:, 1]), math_j.safe_dist(aj[:, 0], aj[:, 1]))


_PROBE = """
import pkgutil, importlib, sys
import torch
torch.backends.cudnn.allow_tf32 = True
torch.set_float32_matmul_precision("high")
import mmmpc_tpu_torch
for m in pkgutil.walk_packages(mmmpc_tpu_torch.__path__, "mmmpc_tpu_torch."):
    importlib.import_module(m.name)
print("jax" in sys.modules, torch.backends.cuda.matmul.allow_tf32,
      torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
print(*sorted(m for m in sys.modules if m.startswith("mmmpc_tpu")))
print("matplotlib" in sys.modules)
"""


@pytest.fixture(scope="module")
def fresh_import():
    """Import every module of the port in a fresh interpreter (the test
    process has JAX loaded by tests/conftest.py): the flags line, the
    names of the modules of both packages that the interpreter loaded, and
    whether it loaded matplotlib."""
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=120, check=True)
    flags, modules, matplotlib = out.stdout.splitlines()
    return flags.split(), modules.split(), matplotlib


def test_port_never_imports_jax(fresh_import):
    flags, modules, matplotlib = fresh_import
    assert flags[0] == "False"
    # the plots import matplotlib when they draw, never at import
    assert matplotlib == "False"
    # the generic formulations', the closed loops', the moving obstacles',
    # the fleet's, the oracle's, the long horizon's, the scale-out's, the
    # profilers', the 3-D scene's and the tools' modules were among those
    # imported, and no module of the JAX package was
    for name in ("bench_controllers", "controllers.demo", "controllers.base",
                 "controllers.manipulator", "controllers.wholebody_endpoint",
                 "models.point_mass", "ops.generic_fwd", "ops.generic_bwd",
                 "ops.riccati", "roofline", "runtime.interface",
                 "runtime.checkpoint", "runtime.metrics", "runtime.reference",
                 "sim.kinematic_plant", "sim.run_simulation",
                 "demo_wholebody_qref", "rt_latency", "controllers.moving_obs",
                 "demo_wholebody_separate", "sim.batch_engine",
                 "sim.batch_task_engine", "utils.debugging",
                 "bench_fleet_tasks", "verify.oracle", "fidelity_dossier",
                 "ops.assoc_riccati", "bench_longhorizon",
                 "parallel.data_parallel", "parallel.multihost",
                 "dryrun_multiprocess", "bench_multihost", "utils.profiling",
                 "profile_solver", "profile_generic", "sim.obstacles",
                 "runtime.scene3d", "sweep_schedule", "sweep_refine",
                 "fleet_diag", "host_fleet_parity", "fidelity_analysis"):
        assert f"mmmpc_tpu_torch.{name}" in modules, name
    assert all(m.startswith("mmmpc_tpu_torch") for m in modules)


def test_fp32_matmul_pinned(fresh_import):
    # the probe turns TF32 on before the import; the import turns it off
    assert fresh_import[0][1:] == ["False", "False", "highest"]

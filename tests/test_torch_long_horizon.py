"""The port's long-horizon path against the JAX package's: the
parallel-prefix Riccati sweep (``ops/assoc_riccati.py``), its selection
(``solver/al_ilqr.py::resolve_assoc_scan``) and route through the batched
solver, and ``bench_longhorizon``.  No JAX solve is compiled here.

- the batch-last sweep against JAX's ``assoc_riccati_backward_batched`` in
  float64 on tests/test_assoc_riccati.py's problems and tolerances: (B 4,
  N 16, 9 x 5) at rtol 1e-6 / atol 1e-7 and (B 2, N 512, 4 x 2) at 1e-5 /
  1e-6; against the port's own plain sequential sweep at the same
  tolerances; the single-scenario form against the batch-last one;
- ``resolve_assoc_scan`` against JAX's on the grid of modes x batch
  {1, 8, 9, 1024} x N {20, 99, 100, 500}, its warnings and its ValueError;
  on a CUDA device, "auto" the sequential sweep and the rest the same;
- the route the counters show: the assoc sweep once an iteration and no
  backward kernel (fused or E) where it is chosen, and none of it where it
  is not;
- an end-to-end assoc solve against the sequential solve on the demo OCP
  at N = 40 (the assertions of tests/test_assoc_riccati.py::
  test_solver_switch_end_to_end: converged, U within 1e-6, cost within
  1e-8), float64;
- per-scenario params: the route picked as for shared params (the fused
  backward on the sequential sweep, the assoc sweep where it is picked);
- the benchmark's problem against the JAX script's, and its rows at a
  small size.
"""

import dataclasses
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from mmmpc_tpu.ops.assoc_riccati import (
    assoc_riccati_backward_batched as assoc_j,
)
from mmmpc_tpu.solver.al_ilqr import resolve_assoc_scan as resolve_j
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu_torch import bench_longhorizon
from mmmpc_tpu_torch.controllers import MPC
from mmmpc_tpu_torch.models.robots import RobotDemo
from mmmpc_tpu_torch.ops import assoc_riccati, generic_bwd, riccati
from mmmpc_tpu_torch.ops.assoc_riccati import (
    assoc_riccati_backward, assoc_riccati_backward_bm,
)
from mmmpc_tpu_torch.ops.riccati import plain_riccati_bm
from mmmpc_tpu_torch.solver.al_ilqr import (
    ASSOC_SCAN_MAX_BATCH, ASSOC_SCAN_MIN_HORIZON, iteration_count,
    resolve_assoc_scan,
)
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.utils.configs import SolverConfig
from mmmpc_tpu_torch.utils.convert import params_from_numpy
from tests.test_assoc_riccati import make_problem

import torch_problems as tp

torch.set_num_threads(1)    # small batches: threads only contend

# tests/test_assoc_riccati.py's problems: (B, N, nx, nu, seed), tolerances
PROBLEMS = {"9x5": ((4, 16, 9, 5, 0), 1e-6, 1e-7),
            "4x2-N512": ((2, 512, 4, 2, 3), 1e-5, 1e-6)}
REG = 1e-8
# XLA's lowest CPU optimisation level: the same operations, less compile
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _blocks(key):
    """The JAX test's problem ``key``: its blocks batch-major (numpy,
    float64) and batch-last (torch)."""
    (B, N, nx, nu, seed), _, _ = PROBLEMS[key]
    bm = tuple(np.asarray(a) for a in make_problem(B, N, nx, nu, seed))
    return bm, tuple(tp.batch_last(a) for a in bm)


def _jax_sweep(key):
    """JAX's assoc sweep on problem ``key``, compiled at FAST_COMPILE."""
    bm, _ = _blocks(key)
    return jax.jit(lambda *a: assoc_j(*a, reg=REG)).lower(
        *bm).compile(FAST_COMPILE)(*bm)


@pytest.fixture(scope="module")
def jax_sweeps():
    """{key: JAX's (kff, K)}, the problems' programs compiled in threads of
    their own."""
    with ThreadPoolExecutor(len(PROBLEMS)) as pool:
        futures = {k: pool.submit(_jax_sweep, k) for k in PROBLEMS}
        return {k: f.result() for k, f in futures.items()}


@pytest.mark.parametrize("key", PROBLEMS)
def test_assoc_matches_jax_f64(key, jax_sweeps):
    _, rtol, atol = PROBLEMS[key]
    _, bl = _blocks(key)
    kff_j, K_j = jax_sweeps[key]
    kff, K = assoc_riccati_backward_bm(*bl, REG)
    assert kff.dtype == torch.float64
    np.testing.assert_allclose(kff.permute(2, 0, 1).numpy(),
                               np.asarray(kff_j), rtol=rtol, atol=atol)
    np.testing.assert_allclose(K.permute(3, 0, 1, 2).numpy(),
                               np.asarray(K_j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("key", PROBLEMS)
def test_assoc_matches_the_sequential_sweep(key):
    """The assoc sweep against the port's plain sequential sweep (kernel
    E's plain version) on the same blocks, at the JAX test's tolerances."""
    _, rtol, atol = PROBLEMS[key]
    _, bl = _blocks(key)
    reg = torch.full((bl[0].shape[-1],), REG, dtype=torch.float64)
    for got, ref in zip(assoc_riccati_backward_bm(*bl, reg),
                        plain_riccati_bm(*bl, reg)):
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)


def test_assoc_single_scenario_form():
    """The single-scenario form, JAX's signature, on tests/
    test_assoc_riccati.py's (3, 2) problem: the batch-last form's result
    at batch 1 (held to JAX's above), to the last bits."""
    bm = tuple(np.array(a[0]) for a in make_problem(1, 8, 3, 2, 5))
    got = assoc_riccati_backward(*(torch.as_tensor(a) for a in bm), reg=REG)
    ref = assoc_riccati_backward_bm(*(tp.batch_last(a[None]) for a in bm),
                                    REG)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r[..., 0], rtol=1e-12, atol=1e-14)


def _resolve(fn, cfg, batch, N):
    """(choice, whether a UserWarning was raised) of ``fn``."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn(cfg, batch, N)
    return out, any(issubclass(x.category, UserWarning) for x in w)


@pytest.mark.parametrize("mode", ["auto", True, False])
def test_resolve_assoc_scan_matches_jax(mode):
    assert (ASSOC_SCAN_MAX_BATCH, ASSOC_SCAN_MIN_HORIZON) == (8, 100)
    for batch in (1, 8, 9, 1024):
        for N in (20, 99, 100, 500):
            got = _resolve(resolve_assoc_scan,
                           SolverConfig(use_assoc_scan=mode), batch, N)
            ref = _resolve(resolve_j, SolverConfigJ(use_assoc_scan=mode),
                           batch, N)
            assert got == ref, (mode, batch, N)
            assert got[0] == (mode is True or (
                mode == "auto" and batch <= 8 and N >= 100))
    with pytest.raises(ValueError, match="use_assoc_scan"):
        resolve_assoc_scan(SolverConfig(use_assoc_scan="Auto"), 1, 500)
    with pytest.raises(ValueError, match="use_assoc_scan"):
        resolve_j(SolverConfigJ(use_assoc_scan="Auto"), 1, 500)
    assert SolverConfig().use_assoc_scan == "auto"


@pytest.mark.parametrize("mode", ["auto", True, False])
def test_resolve_assoc_scan_on_cuda(mode):
    """On a CUDA device "auto" keeps the sequential sweep (kernel B won at
    every shape measured on the card); True and False, their warnings and
    the ValueError are the JAX package's rule there too."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    for batch in (1, 8, 9, 1024):
        for N in (20, 99, 100, 500):
            cfg = SolverConfig(use_assoc_scan=mode)
            got = _resolve(lambda c, b, n: resolve_assoc_scan(
                c, b, n, device=cuda), cfg, batch, N)
            on_cpu = _resolve(lambda c, b, n: resolve_assoc_scan(
                c, b, n, device=cpu), cfg, batch, N)
            assert on_cpu == _resolve(resolve_assoc_scan, cfg, batch, N)
            assert got == ((False, False) if mode == "auto" else on_cpu)
    with pytest.raises(ValueError, match="use_assoc_scan"):
        resolve_assoc_scan(SolverConfig(use_assoc_scan="Auto"), 1, 500,
                           device=cuda)


# ------------------------------------------------------ the solver's route

DEMO_N = 40
DEMO_CFG = dict(al_iters=6, ilqr_iters=10)


@pytest.fixture(scope="module")
def demo_solves():
    """The port's demo MPC at N = 40 (tests/test_assoc_riccati.py's switch
    problem: the position reference 3, from rest) solved at batch 1 in
    float64 by the sequential route (use_assoc_scan=False: the fused
    backward, as its plain version) and by the assoc route (True, which
    warns at N < 100), each with the calls of the assoc sweep, of the fused
    backward and of E."""
    mpc = MPC(RobotDemo(0.1), N=DEMO_N, solver_config=SolverConfig(**DEMO_CFG))
    params = params_from_numpy(mpc.make_params(
        np.tile([3.0, 0.0], (DEMO_N + 1, 1)), np.zeros((DEMO_N, 1))), "cpu",
        torch.float64)
    counters = (assoc_riccati.CALLS, generic_bwd.LAUNCHES["demo"],
                riccati.LAUNCHES[(2, 1)])
    out = {}
    for assoc in (False, True):
        for c in counters:
            c.reset()
        cfg = dataclasses.replace(mpc.solver_config, use_assoc_scan=assoc)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = al_ilqr_solve_batched(
                mpc.ocp, torch.zeros(1, 2, dtype=torch.float64),
                torch.zeros(1, DEMO_N, 1, dtype=torch.float64), params, cfg)
        out[assoc] = (res, [(c.cuda, c.plain) for c in counters],
                      [str(x.message) for x in w])
    return mpc, out


def test_route_is_the_counters(demo_solves):
    mpc, out = demo_solves
    n = iteration_count(mpc.solver_config)
    # sequential: the fused backward once an iteration, no assoc, no E
    assert out[False][1] == [(0, 0), (0, n), (0, 0)]
    # assoc: the assoc sweep once an iteration, no backward kernel
    assert out[True][1] == [(0, n), (0, 0), (0, 0)]
    assert any("use_assoc_scan=True" in m for m in out[True][2])
    assert not out[False][2]


def test_assoc_solve_matches_sequential(demo_solves):
    _, out = demo_solves
    (res_s, _, _), (res_a, _, _) = out[False], out[True]
    assert bool(res_a.converged.all())
    np.testing.assert_allclose(res_a.U.numpy(), res_s.U.numpy(), atol=1e-6)
    np.testing.assert_allclose(res_a.cost.numpy(), res_s.cost.numpy(),
                               rtol=1e-8)


def test_per_scenario_params_take_the_fused_backward():
    """With per-scenario params (the fleet's U_last) the route is picked as
    for shared ones: the sequential sweep (``use_assoc_scan=False``) takes
    the fused backward, and ``True`` or "auto" at a batch and horizon where
    it picks assoc run the assoc sweep on the expansion of each robot's
    entries (the JAX solver's vmapped per-scenario route), no backward
    kernel."""
    from mmmpc_tpu_torch.ops import wholebody_bwd
    horizon = ASSOC_SCAN_MIN_HORIZON
    mpc, x0_b, U0_b, params = tp.selfcol_problem(
        cfg=SolverConfig(al_iters=1, ilqr_iters=1), horizon=horizon, batch=2)
    params = params_from_numpy(tp.fleet_params(params, 2, ("U_last",)),
                               "cpu", torch.float32)
    args = (mpc.ocp, torch.as_tensor(x0_b, dtype=torch.float32),
            torch.as_tensor(U0_b, dtype=torch.float32), params)
    for mode, calls in ((False, (0, 1)), (True, (1, 0)), ("auto", (1, 0))):
        assoc_riccati.CALLS.reset()
        wholebody_bwd.LAUNCHES.reset()
        res = al_ilqr_solve_batched(*args, dataclasses.replace(
            mpc.solver_config, use_assoc_scan=mode))
        assert (assoc_riccati.CALLS.plain,
                wholebody_bwd.LAUNCHES.plain) == calls, mode
        assert torch.isfinite(res.cost).all()


# ------------------------------------------------------------ the bench

def test_bench_problem_matches_jax_script():
    """``bench_longhorizon.build_numpy`` builds the JAX script's problem:
    the same starts and params, its CFG's schedule."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "bench_longhorizon.py"
    spec = importlib.util.spec_from_file_location("bench_longhorizon_j", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    _, x0_j, _, p_j = script.build(100, 8)
    _, x0_t, p_t = bench_longhorizon.build_numpy(100, 8)
    np.testing.assert_allclose(x0_t, np.asarray(x0_j), rtol=0, atol=1e-6)
    assert set(p_t) == set(p_j)
    for k in p_t:
        np.testing.assert_allclose(np.asarray(p_t[k], np.float32),
                                   np.asarray(p_j[k]), rtol=0, atol=0,
                                   err_msg=k)
    for f in ("al_iters", "ilqr_iters", "ilqr_iters_later", "cost_scale",
              "constraint_tol", "n_alpha", "alpha_decay"):
        assert (getattr(bench_longhorizon.CFG, f)
                == getattr(script.CFG, f)), f


def test_bench_rows_on_the_cpu(capsys):
    """Two short horizons at batch 2 on the CPU (the plain versions): a
    printed line and a JSON row each, with both routes' times, converged
    shares and the distance of their mean costs.  (At this budget of 7
    sweeps the two routes need not meet: the assoc sweep regularises the
    input elimination too, and the qref problem's input Hessian, 2e-6 at
    cost_scale 1e5, is of the order of the least reg, 1e-6.)"""
    rows = bench_longhorizon.main(["2", "--device", "cpu", "--horizons",
                                   "6,8", "--reps", "1"])
    out = capsys.readouterr().out
    assert [r["N"] for r in rows] == [6, 8]
    assert out.count("assoc:") == 2 and '"rows"' in out
    for r in rows:
        assert r["scan_ms"] > 0 and r["assoc_ms"] > 0
        assert 0 <= r["scan_converged"] <= 1
        assert 0 <= r["assoc_converged"] <= 1
        assert np.isfinite(r["rel_mean_cost"])

"""Full solves of the generic formulations through the port's batched solver
(both generic fused kernels, as their plain versions on the CPU), and the
port's benchmark problems.

- demo, whole-body endpoint and the arm with its Cartesian reference: the
  port's solve against the JAX package's ``al_ilqr_solve_batched`` on the
  CPU, float64, B=64, N=5, on the problems of
  tests/test_torch_generic_kernels.py, ``SolverConfig(al_iters=2,
  ilqr_iters=4, n_alpha=3, alpha_decay=0.4)``, the JAX side compiled at
  XLA's lowest optimisation level; demo and endpoint held by the quantile
  gate of tests/test_generic_fwd.py (cost and violation within 5e-3
  absolute or relative on 99.5% of the robots, at most 0.5% converged-flag
  flips, max|dU| below 5e-3 on 98% of the robots); the Cartesian arm, whose
  1e6 wedge slack makes its Riccati solves ill-conditioned, by cost and
  feasibility alone (a full solve is never held to |dU|): each robot's cost
  within 5e-3 relative of JAX's, its max violation within 5e-3 absolute or
  relative of JAX's, and the same converged flags (at this schedule 28 of
  the 64 robots converge on both sides, so the flags are asserted to be
  neither all set nor all clear);
- base and arm: the port's solve alone, at the bench schedule's rounds
  (8 rounds of 20, then 12 sweeps): every robot converged, finite costs;
- ``mmmpc_tpu_torch.bench_controllers.problems`` builds the same starts and
  data as ``scripts/bench_controllers.py``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu.solver import al_ilqr_solve_batched
from mmmpc_tpu_torch import bench_controllers
from mmmpc_tpu_torch.ops import generic_bwd, generic_fwd
from mmmpc_tpu_torch.parallel.data_parallel import controller_batched_fn
from mmmpc_tpu_torch.solver.al_ilqr import iteration_count
from mmmpc_tpu_torch.utils.convert import params_from_numpy
from tests.test_torch_generic_kernels import B, make_problem

ROOT = Path(__file__).resolve().parents[1]
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# the bench schedule's rounds without its cost scale (CFG_SMALL)
ROUNDS = (("al_iters", 8), ("ilqr_iters", 20), ("ilqr_iters_later", 12),
          ("constraint_tol", 1e-3), ("n_alpha", 3), ("alpha_decay", 0.35))

torch.set_num_threads(1)    # batch 64: threads only contend with the others


def _port_solve(name, mpc_t, x0_b, U0_b, p_t):
    """The port's batched solve with statistics on the CPU in float64, and
    each generic kernel's (cuda, plain) dispatch counts in it."""
    for c in (generic_fwd.LAUNCHES[name], generic_bwd.LAUNCHES[name]):
        c.reset()
    res, stats = controller_batched_fn(mpc_t)(
        torch.as_tensor(x0_b), torch.as_tensor(U0_b),
        params_from_numpy(p_t, "cpu", torch.float64))
    counts = [(c.cuda, c.plain) for c in (generic_fwd.LAUNCHES[name],
                                          generic_bwd.LAUNCHES[name])]
    return res, stats, counts


@pytest.mark.parametrize("name", ["demo", "endpoint", "arm_cart"])
def test_solve_matches_jax(name):
    mpc_j, mpc_t, x0_b, U0_b, p_j, p_t = make_problem(name)
    args = (jnp.asarray(x0_b), jnp.asarray(U0_b),
            {k: jnp.asarray(v) for k, v in p_j.items()})
    res_j = jax.jit(lambda x0, U0, p: al_ilqr_solve_batched(
        mpc_j.ocp, x0, U0, p, mpc_j.solver_config)).lower(*args).compile(
        FAST_COMPILE)(*args)
    res_t, stats_t, counts = _port_solve(name, mpc_t, x0_b, U0_b, p_t)
    n_iter = iteration_count(mpc_t.solver_config)
    assert counts == [(0, n_iter), (0, n_iter)]
    assert int(stats_t.n_solved) == B
    if name == "arm_cart":
        cost_t, cost_j = res_t.cost.numpy(), np.asarray(res_j.cost)
        rel = np.abs(cost_t - cost_j) / np.maximum(np.abs(cost_j), 1e-12)
        assert rel.max() <= 5e-3, rel.max()
        viol_t = res_t.max_violation.numpy()
        viol_j = np.asarray(res_j.max_violation)
        gap = np.abs(viol_t - viol_j)
        assert ((gap <= 5e-3) | (gap <= 5e-3 * np.abs(viol_j))).all(), \
            gap.max()
        conv = res_t.converged.numpy()
        np.testing.assert_array_equal(conv, np.asarray(res_j.converged))
        assert 0 < conv.sum() < B, conv.sum()
        return

    for field in ("cost", "max_violation"):
        a = getattr(res_t, field).numpy()
        b = np.asarray(getattr(res_j, field))
        tight = (np.abs(a - b) <= 5e-3) | (
            np.abs(a - b) <= 5e-3 * np.maximum(np.abs(b), 1e-3))
        assert tight.mean() >= 0.995, f"{field}: {(~tight).sum()} robots"
    flips = res_t.converged.numpy() != np.asarray(res_j.converged)
    assert flips.mean() <= 0.005, f"{flips.sum()} convergence flips"
    dU = np.abs(res_t.U.numpy() - np.asarray(res_j.U)).max(axis=(1, 2))
    assert (dU < 5e-3).mean() > 0.98, (np.median(dU), dU.max())


@pytest.mark.parametrize("name", ["base", "arm"])
def test_solve_converges(name):
    _, mpc_t, x0_b, U0_b, _, p_t = make_problem(name, B, ROUNDS)
    res, stats, counts = _port_solve(name, mpc_t, x0_b, U0_b, p_t)
    n_iter = iteration_count(mpc_t.solver_config)
    assert n_iter == 20 + 7 * 12
    assert counts == [(0, n_iter), (0, n_iter)]
    assert bool(res.converged.all()), float(res.max_violation.max())
    assert float(stats.max_violation) < mpc_t.solver_config.constraint_tol
    assert torch.isfinite(res.cost).all() and torch.isfinite(res.U).all()
    lo = torch.as_tensor(mpc_t.ocp.u_lower, dtype=res.U.dtype)
    hi = torch.as_tensor(mpc_t.ocp.u_upper, dtype=res.U.dtype)
    assert ((res.U >= lo) & (res.U <= hi)).all()


def test_bench_problems_match_jax_script():
    spec = importlib.util.spec_from_file_location(
        "bench_controllers_jax", ROOT / "scripts" / "bench_controllers.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    names = []
    for port, ref in zip(bench_controllers.problems(8, "cpu"),
                         script.problems(8)):
        name, mpc, x0_b, U0_b, params = port
        assert name == ref[0]
        names.append(name)
        np.testing.assert_array_equal(x0_b.numpy(),
                                      np.asarray(ref[2], np.float32))
        assert tuple(U0_b.shape) == (8, bench_controllers.N, mpc.NU)
        assert not U0_b.any()
        ref_params = ref[3]
        for k, v in params.items():
            if k == "U_last" and k not in ref_params:
                assert not v.any()      # the JAX script adds zeros later
                continue
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(ref_params[k], np.float32), err_msg=k)
    assert names == list(bench_controllers.NAMES)

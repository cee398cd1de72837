"""Full solves through the port's unfused backward path: the OCP's AL
expansion in plain PyTorch followed by the Riccati sweep (kernel E, as its
plain version on the CPU), selected by ``use_fused_backward=False``.

- qref (the problem of tests/test_torch_kernels.py, at one AL round of 8
  sweeps) and demo (the problem of tests/test_torch_generic_kernels.py): the
  port's unfused solve against the JAX package's ``al_ilqr_solve_batched``
  with ``use_fused_backward=False``, float64, B=64, N=5, held by the quantile
  gate of
  tests/test_torch_formulations.py; E's plain version runs once per
  iteration and the fused backward never;
- the port's unfused and fused solves of the same problem agree to 1e-6
  relative in cost and U (they share the expansion and the sweep code);
- the unfused path refuses a per-scenario entry its OCP does not take;
- ``bench_controllers --unfused`` and ``bench.build_problem``'s solver
  config.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu.solver import al_ilqr_solve_batched as solve_j
from mmmpc_tpu_torch import bench, bench_controllers
from mmmpc_tpu_torch.ops import generic_bwd, riccati, wholebody_bwd
from mmmpc_tpu_torch.solver.al_ilqr import iteration_count
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.utils.convert import params_from_numpy
from tests import test_torch_generic_kernels as gk
from tests import test_torch_kernels as wk

torch.set_num_threads(1)    # batch 64: threads only contend with the others


def _problem(name):
    """(JAX controller, port controller, x0_b, U0_b, JAX params, port
    params), float64 numpy data, with the fused backward's counter."""
    if name == "qref":
        mpc_j, mpc_t, x0_b, U0_b, p = wk.make_problem()
        # one AL round of 8 sweeps: half the JAX compile of two rounds
        for mpc in (mpc_j, mpc_t):
            mpc.solver_config = dataclasses.replace(
                mpc.solver_config, al_iters=1, ilqr_iters=8)
        return mpc_j, mpc_t, x0_b, U0_b, p, p, wholebody_bwd.LAUNCHES
    mpc_j, mpc_t, x0_b, U0_b, p_j, p_t = gk.make_problem(name)
    return mpc_j, mpc_t, x0_b, U0_b, p_j, p_t, generic_bwd.LAUNCHES[name]


def _port_solve(mpc_t, x0_b, U0_b, p_t, fused):
    """The port's batched solve on the CPU in float64 -> (result, (cuda,
    plain) calls of E's (nx, nu) instance)."""
    cfg = dataclasses.replace(mpc_t.solver_config, use_fused_backward=fused)
    counter = riccati.LAUNCHES[(mpc_t.ocp.nx, mpc_t.ocp.nu)]
    counter.reset()
    res = al_ilqr_solve_batched(
        mpc_t.ocp, torch.as_tensor(x0_b), torch.as_tensor(U0_b),
        params_from_numpy(p_t, "cpu", torch.float64), cfg)
    return res, (counter.cuda, counter.plain)


@pytest.mark.parametrize("name", ["qref", "demo"])
def test_unfused_solve_matches_jax(name):
    mpc_j, mpc_t, x0_b, U0_b, p_j, p_t, fused_counter = _problem(name)
    cfg_j = dataclasses.replace(mpc_j.solver_config, use_fused_backward=False)
    res_j = jax.jit(lambda x0, U0, p: solve_j(mpc_j.ocp, x0, U0, p, cfg_j))(
        jnp.asarray(x0_b), jnp.asarray(U0_b),
        {k: jnp.asarray(v) for k, v in p_j.items()})
    fused_counter.reset()
    res_t, calls = _port_solve(mpc_t, x0_b, U0_b, p_t, fused=False)
    assert calls == (0, iteration_count(mpc_t.solver_config))
    assert (fused_counter.cuda, fused_counter.plain) == (0, 0)

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


@pytest.mark.parametrize("name", ["qref", "demo"])
def test_unfused_solve_matches_fused(name):
    _, mpc_t, x0_b, U0_b, _, p_t, fused_counter = _problem(name)
    fused_counter.reset()
    res_f, calls_f = _port_solve(mpc_t, x0_b, U0_b, p_t, fused=True)
    n_iter = iteration_count(mpc_t.solver_config)
    assert calls_f == (0, 0) and fused_counter.plain == n_iter
    res_u, calls_u = _port_solve(mpc_t, x0_b, U0_b, p_t, fused=False)
    assert calls_u == (0, n_iter)
    torch.testing.assert_close(res_u.cost, res_f.cost, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(res_u.U, res_f.U, rtol=1e-6,
                               atol=1e-6 * float(res_f.U.abs().max()))


def test_unfused_path_refuses_per_scenario_params():
    """The unfused path takes each robot's entries where the OCP reads them
    per scenario (the JAX solver's vmapped route; tests/test_torch_fleet.py,
    tests/test_torch_per_scenario.py) and refuses one its OCP does not
    take per scenario: an eq_mask with a batch axis, which the endpoint
    does not have."""
    _, mpc_t, x0_b, U0_b, _, p_t, _ = _problem("endpoint")
    params = params_from_numpy(p_t, "cpu", torch.float64)
    params["eq_mask"] = torch.ones(U0_b.shape[0], dtype=torch.float64)
    cfg = dataclasses.replace(mpc_t.solver_config, use_fused_backward=False)
    with pytest.raises(ValueError, match="shared only"):
        al_ilqr_solve_batched(mpc_t.ocp, torch.as_tensor(x0_b),
                              torch.as_tensor(U0_b), params, cfg)


def test_bench_controllers_unfused_row(capsys, monkeypatch):
    # a two-iteration schedule keeps the 11 solves of a row short
    short = dataclasses.replace(bench_controllers.CFG_SMALL, al_iters=1,
                                ilqr_iters=2)
    monkeypatch.setattr(bench_controllers, "CFG_SMALL", short)
    riccati.LAUNCHES[(2, 1)].reset()
    bench_controllers.main(["8", "demo_1d", "--device", "cpu", "--unfused"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["controller"] for r in rows] == ["demo_1d"]
    assert rows[0]["backward"] == "unfused" and rows[0]["device"] == "cpu"
    # a warm-up solve and the timed ones, each through the plain sweep
    n_iter = iteration_count(short)
    assert riccati.LAUNCHES[(2, 1)].plain == (1 + bench_controllers.REPS) * n_iter


def test_bench_problem_takes_the_solver_config():
    cfg = dataclasses.replace(bench.SOLVER_CFG, use_fused_backward=False)
    mpc, x0_b, U0_b, params = bench.build_problem(4, "cpu", cfg)
    assert mpc.solver_config is cfg
    assert bench.build_problem(4, "cpu")[0].solver_config is bench.SOLVER_CFG
    assert tuple(x0_b.shape) == (4, 9) and tuple(U0_b.shape) == (4, bench.N, 5)

"""The port's main path against the JAX package's: the refined batched
whole-body qref solve with batch statistics.

float64, B=64, N=5, on the bench problem (scenario 1, the bench starts and
reference cut to 5 stages), ``SolverConfig(al_iters=2, ilqr_iters=4,
n_alpha=3, alpha_decay=0.4, cost_scale=1e5)``, refine_size 16 re-solved
for one more AL round of 12 sweeps with the penalty continued (one round
keeps the JAX compile short).  The JAX side is ``al_ilqr_solve_refined`` on the
CPU (its vmap fallback), compiled at XLA's lowest optimisation level in a
thread while the port's solve runs; the port runs its one solver path,
whose kernels take their plain versions on CPU tensors.  Gates (ROADMAP queue 3): a float
reassociation can flip a near-tied line-search argmin and part two
trajectories, so |dU| is held by quantiles — median per-robot max|dU| below
1e-4 and fewer than 5% of robots above 5e-3 — and the costs, converged flags
and statistics directly.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu.controllers import MPCWholeBody as MPCWholeBodyJ
from mmmpc_tpu.models.obstacles import Obstacles as ObstaclesJ
from mmmpc_tpu.models.robots import MobileManipulator as MobileManipulatorJ
from mmmpc_tpu.parallel.data_parallel import _with_stats
from mmmpc_tpu.solver.refine import al_ilqr_solve_refined as refined_j
from mmmpc_tpu.solver.refine import continue_mu as continue_mu_j
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu_torch.bench import build_problem_numpy
from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd
from mmmpc_tpu_torch.parallel.data_parallel import with_stats
from mmmpc_tpu_torch.solver.al_ilqr import iteration_count
from mmmpc_tpu_torch.solver.refine import continue_mu
from mmmpc_tpu_torch.utils.configs import SolverConfig
from mmmpc_tpu_torch.utils.convert import params_from_numpy

B, N, REFINE = 64, 5, 16
CFG = dict(al_iters=2, ilqr_iters=4, n_alpha=3, alpha_decay=0.4,
           cost_scale=1e5)
REFINE_CFG = dict(al_iters=1, ilqr_iters=12)

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

torch.set_num_threads(1)    # batch 64: threads only contend with the others


@pytest.fixture(scope="module")
def solves():
    cfg = SolverConfig(**CFG)
    mpc_t, x0_b, params = build_problem_numpy(B, N=N, solver_config=cfg)
    mpc_j = MPCWholeBodyJ(
        MobileManipulatorJ(0.1),
        [ObstaclesJ(*r) for r in mpc_t.obstacles_value],
        [(p, n[None]) for p, n in zip(mpc_t.hp_points_value,
                                      mpc_t.hp_normals_value)],
        N=N, solver_config=SolverConfigJ(**CFG))
    U0_b = np.zeros((B, N, 5))

    pj = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    args_j = (jnp.asarray(x0_b), jnp.asarray(U0_b), pj)
    program_j = jax.jit(_with_stats(
        lambda x0, U0, p: refined_j(mpc_j.ocp, x0, U0, p,
                                    mpc_j.solver_config,
                                    refine_cfg=continue_mu_j(
                                        mpc_j.solver_config, 2, **REFINE_CFG),
                                    refine_size=REFINE)))

    counters = (wholebody_fwd.LAUNCHES, wholebody_bwd.LAUNCHES)
    for c in counters:
        c.reset()
    refine_cfg = continue_mu(cfg, 2, **REFINE_CFG)
    run = with_stats(mpc_t.batch_solve_refined_fn(refine_cfg, REFINE))
    # JAX's program compiles at XLA's lowest level in a thread while the
    # port's solve runs
    with ThreadPoolExecutor(1) as pool:
        compiled = pool.submit(
            lambda: program_j.lower(*args_j).compile(FAST_COMPILE))
        res_t, stats_t = run(torch.as_tensor(x0_b), torch.as_tensor(U0_b),
                             params_from_numpy(params, "cpu", torch.float64))
        res_j, stats_j = compiled.result()(*args_j)
    counts = [(c.cuda, c.plain) for c in counters]
    n_iter = iteration_count(cfg) + iteration_count(refine_cfg)
    return res_j, stats_j, res_t, stats_t, counts, n_iter


def test_slice_inputs_agree(solves):
    res_j, _, res_t, _, _, _ = solves
    dU = np.abs(res_t.U.numpy() - np.asarray(res_j.U)).max(axis=(1, 2))
    assert np.median(dU) < 1e-4
    assert np.mean(dU > 5e-3) < 0.05, f"{np.mean(dU > 5e-3):.1%} above 5e-3"


def test_slice_cost_and_convergence_agree(solves):
    res_j, stats_j, res_t, stats_t, _, _ = solves
    cost_j = np.asarray(res_j.cost)
    rel = np.abs(res_t.cost.numpy() - cost_j) / np.abs(cost_j)
    assert np.median(rel) < 5e-3
    assert abs(float(stats_t.mean_cost) - float(stats_j.mean_cost)) < (
        5e-3 * abs(float(stats_j.mean_cost)))
    same = np.mean(res_t.converged.numpy() == np.asarray(res_j.converged))
    assert same >= 0.95
    assert float(stats_t.n_solved) == float(stats_j.n_solved) == B
    assert abs(float(stats_t.n_converged) - float(stats_j.n_converged)) <= (
        0.05 * B)


def test_slice_result_layout(solves):
    res_j, _, res_t, _, _, _ = solves
    for a, b in zip(res_t, res_j):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert torch.isfinite(a.double()).all()


def test_slice_runs_each_kernel_once_per_iteration(solves):
    *_, counts, n_iter = solves
    assert n_iter == 8 + 12
    assert counts == [(0, n_iter), (0, n_iter)]

"""The port's sweeps, fleet diagnosis, host-loop fleet parity and fidelity
analysis (``mmmpc_tpu_torch/{sweep_schedule,sweep_refine,fleet_diag,
host_fleet_parity,fidelity_analysis}.py``) against the JAX scripts of
``scripts/``, on the CPU (the kernels' plain versions).

- The tables (``SCHEDULES``, ``CONFIGS``, ``CONFIGS_R2``, the fleet
  diagnosis's ``CFG``, the host loop's horizon and draw size) equal the JAX
  scripts', loaded with importlib (that compiles nothing), and each row's
  iterations equal the JAX scripts' formula.
- One row of each sweep at batch 2, N = 2 equals ``with_stats`` of the same
  config called directly (tests/test_torch_slice.py holds that solve
  against JAX).
- ``fleet_diag.diagnose`` gives a completion that matches its phases, on a
  small loop and on made-up phases.
- ``host_fleet_parity``'s starts are the first K of
  ``bench_fleet_tasks.build_fleet``'s, bitwise; a worker run in-process for
  3 ticks (a small budget) returns the JAX keys and the ``Interface``'s own
  flag and step count; ``compare`` reads the fleet bench's ``--dump-done``.
- ``fidelity_analysis._stage_violation`` equals the JAX function on the same
  float64 (x0, U, params) at 1e-12 (eager JAX on N = 10: no solve is
  compiled), and ``arm_case`` with two starts gives the JAX keys.
"""

import collections
import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu.controllers import MPCManipulator3DoF as MPCManipulator3DoFJ
from mmmpc_tpu.models.robots import ManipulatorPanda3DoF as PandaJ
from mmmpc_tpu_torch import (
    bench, fidelity_analysis, fleet_diag, host_fleet_parity, sweep_refine,
    sweep_schedule,
)
from mmmpc_tpu_torch.bench_fleet_tasks import build_fleet
from mmmpc_tpu_torch.controllers import MPCManipulator3DoF
from mmmpc_tpu_torch.models.robots import ManipulatorPanda3DoF
from mmmpc_tpu_torch.parallel.data_parallel import with_stats
from mmmpc_tpu_torch.sim.batch_task_engine import PHASE_DONE, PHASE_ROTATE
from mmmpc_tpu_torch.solver.al_ilqr import iteration_count
from mmmpc_tpu_torch.utils.configs import SolverConfig

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
# a small budget for the loops here: one AL round of 2 sweeps
SMALL = dict(al_iters=1, ilqr_iters=2, cost_scale=1e5, constraint_tol=1e-3,
             n_alpha=3, alpha_decay=0.35)

torch.set_num_threads(1)    # batch 1-4: threads only contend


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_iters(al, first, later, final):
    """The JAX scripts' iteration count of a schedule."""
    return first + (al - 2) * later + (final or later) if al >= 2 else first


# --------------------------------------------------------------- sweeps

def test_sweep_tables_and_iterations_match_jax():
    ss_j, sr_j = _script("sweep_schedule"), _script("sweep_refine")
    assert sweep_schedule.SCHEDULES == ss_j.SCHEDULES
    assert sweep_refine.CONFIGS == sr_j.CONFIGS
    assert sweep_refine.CONFIGS_R2 == sr_j.CONFIGS_R2
    for row in sweep_schedule.SCHEDULES:
        cfg = sweep_schedule.config(row)
        assert iteration_count(cfg) == _jax_iters(*row[:4])
        assert (cfg.n_alpha, cfg.alpha_decay) == row[4:]
    for entry in sweep_refine.CONFIGS + sweep_refine.CONFIGS_R2:
        cfg, rcfg, _ = sweep_refine.configs(entry)
        assert iteration_count(cfg) == _jax_iters(*entry[0])
        if entry[1] is not None:
            assert iteration_count(rcfg) == entry[1][0] * entry[1][1]
            assert rcfg.mu_init == min(cfg.mu_init * cfg.mu_scale
                                       ** entry[0][0], cfg.mu_max)
    # the bench's own schedule is CONFIGS_R2's second row
    cfg, rcfg, size = sweep_refine.configs(sweep_refine.BENCH_ROW)
    assert (cfg, rcfg, size) == (bench.SOLVER_CFG, bench.REFINE_CFG, None)


@pytest.mark.parametrize("sweep, entry", [
    (sweep_schedule, sweep_schedule.SCHEDULES[9]),
    (sweep_refine, sweep_refine.CONFIGS_R2[0])])
def test_sweep_row_equals_a_direct_solve(sweep, entry):
    B, N = 2, 2
    rec, res, stats = sweep.run_row(entry, B, "cpu", reps=1, N=N)
    if sweep is sweep_schedule:
        cfg = sweep.config(entry)
        mpc, *args = bench.build_problem(B, "cpu", solver_config=cfg, N=N)
        ref, ref_stats = with_stats(mpc.batch_solve_fn())(*args)
        assert set(rec) == {"schedule", "iters", "solves_per_s",
                            "converged_frac", "max_violation"}
    else:
        cfg, rcfg, size = sweep.configs(entry)
        mpc, *args = bench.build_problem(B, "cpu", solver_config=cfg, N=N)
        ref, ref_stats = with_stats(mpc.batch_solve_refined_fn(rcfg, size))(
            *args)
        assert rec["refine"] == "2x12@1024"
        assert set(rec) == {"stage1", "iters1", "refine", "solves_per_s",
                            "converged_frac", "max_violation"}
    for a, b in zip(res, ref):
        assert torch.equal(a, b)
    assert rec["max_violation"] == float(ref_stats.max_violation)
    assert rec["converged_frac"] == float(ref_stats.n_converged) / B
    assert rec["solves_per_s"] > 0


# ---------------------------------------------------------- fleet diag

def test_fleet_diag_config_matches_jax():
    fd_j = _script("fleet_diag_cpu")
    shared = {f.name for f in dataclasses.fields(SolverConfig)} & set(
        vars(fd_j.CFG))
    assert {n: getattr(fleet_diag.CFG, n) for n in shared} == {
        n: getattr(fd_j.CFG, n) for n in shared}
    assert (fleet_diag.CHUNKS, fleet_diag.CHUNK, host_fleet_parity.N) == (
        10, 40, fd_j.N)


def test_fleet_diag_completion_matches_phases():
    phase, X = fleet_diag.run(2, False, "cpu", chunks=2, chunk=2,
                              cfg=SolverConfig(**SMALL),
                              report=lambda line: None)
    assert phase.shape == (2, 4) and X.shape == (2, 4, 9)
    assert np.isfinite(X).all()
    d = fleet_diag.diagnose(phase, X)
    assert d["completion"] == np.mean(phase[:, -1] == PHASE_DONE)
    assert sum(d["histogram"].values()) == 2
    # made-up phases: robot 1 done, robots 0 and 2 stalled in rotate
    phase = np.array([[0, 2, 2], [0, 3, PHASE_DONE], [1, 2, 2]])
    X = np.arange(3 * 3 * 9, dtype=float).reshape(3, 3, 9)
    d = fleet_diag.diagnose(phase, X)
    assert d["completion"] == pytest.approx(1 / 3)
    assert d["histogram"] == collections.Counter({PHASE_ROTATE: 2,
                                                  PHASE_DONE: 1})
    assert d["failing"] == [0, 2]
    assert [(b, t) for b, t, _ in d["stalls"]] == [
        (0, {0: 1, 2: 2}), (2, {1: 1, 2: 2})]
    np.testing.assert_array_equal(d["stalls"][1][2], X[2, -1])
    lines = list(fleet_diag.report_lines(d, "parity", 3))
    assert lines[:3] == [
        "mode=parity batch=3",
        "final phase histogram: Counter({2: 2, 4: 1})",
        "completion 0.3333; failing: [0, 2]"]


# --------------------------------------------------- host-loop parity

def test_host_fleet_starts_are_the_fleet_benchs():
    hfp_j = _script("host_fleet_parity")
    assert (host_fleet_parity.N, host_fleet_parity.FLEET_BATCH) == (
        hfp_j.N, hfp_j.FLEET_BATCH)
    x0 = host_fleet_parity.starts(8)
    fleet = build_fleet(host_fleet_parity.FLEET_BATCH, device="cpu")
    assert x0.dtype == np.float64
    np.testing.assert_array_equal(x0, fleet.x0[:8].double().numpy())


def test_host_fleet_worker_runs_the_interface():
    x0 = host_fleet_parity.starts(1)[0]
    row = host_fleet_parity._worker((0, x0, 1, 3, "cpu",
                                     SolverConfig(**SMALL)))
    assert {"idx", "done", "final_flag", "steps", "wall_s"} <= set(row)
    assert (row["idx"], row["done"], row["final_flag"], row["steps"]) == (
        0, False, "move", 3)
    assert row["finite"]
    # the plain versions ran: no launch on the CPU
    assert row["launches"] == {"wholebody_fwd": 0, "wholebody_bwd": 0}
    rec = host_fleet_parity.summary([row], 1, 1, 3, 1.0)
    assert rec == {"scenario": 1, "K": 1, "max_ticks": 3,
                   "host_completion_rate": 0.0, "median_done_steps": None,
                   "final_flag_histogram": {"move": 1}, "wall_s": 1.0}


def test_host_fleet_compare_reads_the_fleet_dump(tmp_path):
    path = tmp_path / "done.npz"
    np.savez(path, done=np.array([True, False, True, False, True]))
    rows = [{"done": d} for d in (True, True, False, False)]
    assert host_fleet_parity.compare(rows, path) == {
        "K": 4, "host_completion_rate": 0.5, "fleet_completion_rate": 0.5,
        "agree": 2, "host_only": [1], "fleet_only": [2]}


# ----------------------------------------------------- fidelity analysis

def test_stage_violation_matches_jax():
    fa_j = _script("fidelity_analysis")
    rng = np.random.default_rng(11)
    q0 = np.array([0.3, -1.2, 1.2])
    traj = np.linspace(q0, np.array([0.0, -0.6, 0.9]), 11)
    arm_j = MPCManipulator3DoFJ(PandaJ(0.1), [], [], N=10)
    arm_t = MPCManipulator3DoF(ManipulatorPanda3DoF(0.1), [], [], N=10,
                               device="cpu")
    params_t = dict(arm_t.make_params(traj, np.zeros((10, 3))),
                    U_last=np.zeros((10, 3)))
    params_j = dict(arm_j.make_params(traj, np.zeros((10, 3))),
                    U_last=jnp.zeros((10, 3)))
    for scale in (0.1, 0.6):
        U = scale * rng.standard_normal((10, 3))
        got = fidelity_analysis._stage_violation(arm_t.ocp, q0, U, params_t)
        want = fa_j._stage_violation(arm_j.ocp, q0, jnp.asarray(U), params_j)
        assert abs(got - want) <= 1e-12, (scale, got, want)


def test_arm_case_gives_the_jax_keys():
    out = fidelity_analysis.arm_case("cpu", torch.float64, n_starts=2)
    assert {"case", "our_cost", "our_viol", "oracle_costs_multistart",
            "oracle_best_cost", "our_solver_from_oracle_best",
            "oracle_from_our_solution", "oracle_best_violation",
            "verdict"} <= set(out)
    assert out["case"] == "arm_only"
    assert len(out["oracle_costs_multistart"]) == 2
    assert out["our_viol"] <= 1e-6
    assert set(out["our_solver_from_oracle_best"]) == {
        "cost", "max_dU_vs_oracle_best"}
    assert set(out["oracle_from_our_solution"]) == {"cost", "max_dU_vs_ours"}
    if "trust_constr" in out:
        # the feasible oracle: our solution within the dossier's arm bound
        assert out["trust_constr"]["max_dU_vs_ours"] < 1e-4
        assert out["verdict"].startswith("oracle artifact")

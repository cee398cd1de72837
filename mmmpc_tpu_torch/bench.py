"""The headline benchmark of the port: whole-body qref MPC solves/s on one
GPU (counterpart of ``bench.py``).

    python -m mmmpc_tpu_torch.bench [--device cpu]

Whole-body qref MPC on scenario 1 (3 ground circles, 3 half-planes, the
self-collision spheres, state / input / input-rate boxes), N=20, a batch of
manipulate-phase starts near the table jittered with numpy
``default_rng(0)``, solved by the two-stage refined schedule: 5 AL rounds of
(16, 10, 10, 10, 12) sweeps, then the 1024 worst re-solved for 3 x 12 with
the penalty continued.  Everything is built from numpy and moved onto the
device in one dtype.

- ``build_problem_numpy`` / ``build_problem``: the problem, as host data or
  on a device in float32.
- ``run``: one warm-up solve, then ``reps`` solves back to back with one
  synchronise at the end (``time_run``, which the sweeps share); returns
  the statistics and the metric.  When a
  robot of the last solve failed, ``utils/debugging.py::report_unconverged``
  prints the worst three on stderr.
- ``main``: prints the statistics as one JSON line on stderr and the metric
  line ``{"metric": "wholebody_qref_solves_per_s", "value", "unit",
  "vs_baseline"}`` alone, last on stdout.  ``vs_baseline`` is solves/s over
  10: the reference solves once a 0.1 s control period on the CPU.  On the
  card unless ``--device cpu`` (the kernels' plain versions).

One process on one card.  Several cards run ``bench_multihost --refined``
under ``torchrun`` (each rank ``BATCH`` robots and its own refinement).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from mmmpc_tpu_torch.controllers import MPCWholeBody
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import MobileManipulator
from mmmpc_tpu_torch.solver.refine import continue_mu
from mmmpc_tpu_torch.utils.configs import SolverConfig, make_scenario
from mmmpc_tpu_torch.utils.convert import params_from_numpy

N = 20
BATCH = 8192
# solves timed back to back after the warm-up
REPS = 10
SOLVER_CFG = SolverConfig(al_iters=5, ilqr_iters=16, ilqr_iters_later=10,
                          ilqr_iters_final=12,
                          cost_scale=1e5, constraint_tol=1e-3, n_alpha=3,
                          alpha_decay=0.35)
REFINE_ROUNDS, REFINE_SWEEPS = 3, 12
REFINE_CFG = continue_mu(SOLVER_CFG, SOLVER_CFG.al_iters,
                         al_iters=REFINE_ROUNDS, ilqr_iters=REFINE_SWEEPS,
                         ilqr_iters_later=REFINE_SWEEPS,
                         ilqr_iters_final=None)


def build_problem_numpy(batch: int, N: int = N,
                        solver_config: SolverConfig = SOLVER_CFG,
                        replicate_terminal_selfcol_bug: bool = True):
    """(mpc, x0_b (batch, 9), params) as host data: the perturbed
    manipulate-phase starts (the hard regime: every constraint family
    active) and the joint-space reference towards q_target;
    ``replicate_terminal_selfcol_bug=False`` builds the controller of the
    fixed terminal formulation."""
    sc = make_scenario(1, N=N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    mpc = MPCWholeBody(MobileManipulator(sc.dt), obstacles, hp, N=N,
                       solver_config=solver_config,
                       replicate_terminal_selfcol_bug=(
                           replicate_terminal_selfcol_bug))

    rng = np.random.default_rng(0)
    x0 = np.array([4.45, 5.06, -np.pi, 0, 0, 0, -np.pi / 4, -np.pi, np.pi])
    jitter = rng.standard_normal((batch, 9)) * np.array(
        [0.05, 0.05, 0.02, 0.01, 0.01, 0.01, 0.05, 0.05, 0.05])
    x0_b = np.clip(x0[None] + jitter, mpc.xlim[0], mpc.xlim[1])
    q_target = np.array([0.3, -1.0, 1.0])
    traj = np.linspace(x0, np.concatenate([x0[:6], q_target]), N + 1)
    params = dict(mpc.make_params(traj, np.zeros((N, 5))),
                  U_last=np.zeros((N, 5)))
    return mpc, x0_b, params


def build_problem(batch: int, device,
                  solver_config: SolverConfig = SOLVER_CFG,
                  replicate_terminal_selfcol_bug: bool = True, N: int = N):
    """(mpc, x0_b (batch, 9), U0_b (batch, N, 5), params) in float32 on
    ``device``, the kernels' dtype; ``solver_config`` is the stage-1
    schedule (``dataclasses.replace(SOLVER_CFG, use_fused_backward=False)``
    for the unfused backward path)."""
    mpc, x0_b, params = build_problem_numpy(
        batch, N=N, solver_config=solver_config,
        replicate_terminal_selfcol_bug=replicate_terminal_selfcol_bug)
    kw = dict(dtype=torch.float32, device=device)
    return (mpc, torch.as_tensor(x0_b, **kw), torch.zeros(batch, N, 5, **kw),
            params_from_numpy(params, device, torch.float32))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_run(run, args, reps, device):
    """One warm-up call of ``run(*args)``, then ``reps`` calls back to back
    with one synchronise after them (``bench.py:112-121``): (the last
    result, seconds of the ``reps`` calls)."""
    out = run(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run(*args)
    sync(device)
    return out, time.perf_counter() - t0


def run(batch: int = BATCH, reps: int = REPS, device="cuda"):
    """(stats, metric) of ``reps`` refined solves of the bench problem at
    ``batch`` on ``device`` (stage 1 ``SOLVER_CFG``, stage 2
    ``REFINE_CFG``), timed back to back after one warm-up solve with one
    synchronise at the end.  The statistics are those of the last
    solve."""
    from mmmpc_tpu_torch.parallel.data_parallel import with_stats
    from mmmpc_tpu_torch.utils.debugging import report_unconverged

    device = torch.device(device)
    mpc, x0_b, U0_b, params = build_problem(batch, device,
                                            solver_config=SOLVER_CFG)
    solve = with_stats(mpc.batch_solve_refined_fn(REFINE_CFG))

    (res, stats), dt = time_run(solve, (x0_b, U0_b, params), reps, device)
    solves_per_s = batch * reps / dt

    n_converged, n_solved = float(stats.n_converged), float(stats.n_solved)
    stats_d = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "n_devices": 1, "batch": batch, "reps": reps, "horizon": mpc.N,
        "batch_latency_s": dt / reps,
        "converged_frac": n_converged / n_solved,
        "max_violation": float(stats.max_violation),
        "mean_cost": float(stats.mean_cost),
    }
    if n_converged < n_solved:
        report_unconverged(mpc.ocp, res, params, top_k=3)
    metric = {"metric": "wholebody_qref_solves_per_s",
              "value": round(solves_per_s, 1), "unit": "solves/s",
              "vs_baseline": round(solves_per_s / 10.0, 1)}
    return stats_d, metric


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mmmpc_tpu_torch.bench",
        description="Refined whole-body qref solves/s at batch "
                    f"{BATCH} on one device.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    stats, metric = run(BATCH, REPS, args.device)
    print(json.dumps(stats), file=sys.stderr, flush=True)
    print(json.dumps(metric), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

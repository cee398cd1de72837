"""Iteration-schedule sweep of the bench problem (counterpart of
``scripts/sweep_schedule.py``).

    python -m mmmpc_tpu_torch.sweep_schedule [batch] [--device cpu]
        [--reps 10]

Each row of ``SCHEDULES`` -- AL rounds, first / later / final sweeps, step
sizes and their decay -- replaces the schedule of the bench's stage-1
``SOLVER_CFG`` and solves ``bench.build_problem(batch)`` through
``parallel.controller_batched_fn`` (the fused kernels A and B, no
refinement): one warm-up solve, then ``reps`` solves back to back with one
synchronise at the end.  The iterations a solve runs multiply its cost, so
the fastest row with converged_frac 1.0 and max_violation under the 1e-3
tolerance is the schedule's frontier.  One JSON line a row (schedule, iters,
solves_per_s, converged_frac, max_violation).  It runs on the card unless
``--device cpu`` is given (the kernels' plain versions; a small batch).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from mmmpc_tpu_torch import bench
from mmmpc_tpu_torch.parallel.data_parallel import controller_batched_fn
from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

REPS = 10

# (al_iters, first, later, final, n_alpha, alpha_decay)
SCHEDULES = [
    (8, 20, 12, None, 3, 0.35),    # the JAX package's round-2 production
    (7, 20, 12, None, 3, 0.35),
    (8, 18, 10, None, 3, 0.35),
    (7, 18, 10, 12, 3, 0.35),
    (6, 20, 12, 16, 3, 0.35),
    (8, 16, 10, None, 3, 0.35),
    (8, 20, 10, 12, 3, 0.35),
    (8, 20, 12, None, 2, 0.3),
    (6, 18, 12, 16, 3, 0.35),
    (7, 16, 10, 14, 3, 0.35),
]


def config(row):
    """The bench's ``SOLVER_CFG`` with the schedule of ``row``."""
    al, first, later, final, n_alpha, decay = row
    return dataclasses.replace(
        bench.SOLVER_CFG, al_iters=al, ilqr_iters=first,
        ilqr_iters_later=later, ilqr_iters_final=final, n_alpha=n_alpha,
        alpha_decay=decay)


def label(row) -> str:
    al, first, later, final, n_alpha, decay = row
    return (f"{al}x({first},{later}{',' + str(final) if final else ''}) "
            f"a{n_alpha}@{decay}")


def run_row(row, batch, device, reps=REPS, N=bench.N):
    """One row on ``bench.build_problem(batch, device, N=N)``: (its JSON
    record, the last SolveResult, its BatchStats)."""
    cfg = config(row)
    mpc, x0_b, U0_b, params = bench.build_problem(batch, device,
                                                  solver_config=cfg, N=N)
    (res, stats), dt = bench.time_run(controller_batched_fn(mpc),
                                      (x0_b, U0_b, params), reps, device)
    rec = {
        "schedule": label(row),
        "iters": iteration_count(cfg),
        "solves_per_s": round(batch * reps / dt, 1),
        "converged_frac": float(stats.n_converged) / float(stats.n_solved),
        "max_violation": float(stats.max_violation),
    }
    return rec, res, stats


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=bench.BATCH)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=REPS)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    recs = []
    for row in SCHEDULES:
        rec = run_row(row, args.batch, args.device, args.reps)[0]
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()

"""Two-stage sweep: a cheap stage-1 schedule plus the straggler refinement
(counterpart of ``scripts/sweep_refine.py``).

    python -m mmmpc_tpu_torch.sweep_refine [batch] [r2] [--device cpu]
        [--reps 10]

``solver/refine.py`` re-solves only the worst ``refine_size`` robots of a
batch (warm-started, the AL penalty continued) and merges them back where
their violation fell; the question is which (stage-1 schedule, refine
budget) pair gives the most solves a second while the merged batch still
converges.  Each row of ``CONFIGS`` (``CONFIGS_R2`` with ``r2``) solves
``bench.build_problem(batch)`` through ``with_stats`` of the controller's
``batch_solve_refined_fn`` (``batch_solve_fn`` for a row with no refine
stage): one warm-up, then ``reps`` solves back to back with one
synchronise.  ``CONFIGS_R2``'s second row is the bench's own schedule
(``bench.SOLVER_CFG`` and ``REFINE_CFG``).  One JSON line a row (stage1,
iters1, refine, solves_per_s, converged_frac, max_violation).  It runs on
the card unless ``--device cpu`` is given (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from mmmpc_tpu_torch import bench
from mmmpc_tpu_torch.parallel.data_parallel import with_stats
from mmmpc_tpu_torch.solver.al_ilqr import iteration_count
from mmmpc_tpu_torch.solver.refine import DEFAULT_REFINE_SIZE, continue_mu
from mmmpc_tpu_torch.sweep_schedule import REPS

# stage 1: (al, first, later, final); stage 2: (al_r, iters_r) or None;
# optionally a third element: refine_size (default one tile of 1024)
CONFIGS = [
    # single-stage baseline
    ((7, 20, 12, None), None),
    # the schedule sweep's stragglers, each with a modest refine budget
    ((7, 16, 10, 14), (2, 12)),
    ((7, 18, 10, 12), (2, 12)),
    ((6, 20, 12, 16), (2, 12)),
    ((6, 18, 12, 16), (2, 12)),
    ((8, 18, 10, None), (2, 12)),
    # cheaper stage 1, bigger refine
    ((6, 16, 10, 12), (3, 12)),
    ((6, 14, 8, 12), (3, 12)),
    ((5, 16, 10, 12), (3, 14)),
    ((5, 14, 8, 12), (4, 12)),
]

# round 2: around round 1's winner 5x(16,10,12) + 3x14
CONFIGS_R2 = [
    ((5, 16, 10, 12), (2, 12)),          # cheaper refine
    ((5, 16, 10, 12), (3, 12)),          # the bench's schedule
    ((5, 16, 8, 12), (3, 14)),           # 52-iteration stage 1
    ((5, 14, 10, 12), (3, 14)),          # 56
    ((4, 18, 10, 12), (4, 14)),          # 50, 4 AL rounds
    ((4, 16, 10, 12), (4, 14)),          # 48
    ((5, 14, 8, 12), (4, 12), 2048),     # 50 + two-tile refine
    ((4, 16, 10, 14), (5, 12), 2048),    # 50 + two-tile refine, more rounds
]

# the row of CONFIGS_R2 that is the bench's schedule
BENCH_ROW = CONFIGS_R2[1]


def configs(entry):
    """(stage-1 config, refine config or None, refine_size or None) of a
    row: the stage-1 schedule on the bench's ``SOLVER_CFG``, the refine
    stage with the penalty continued after stage 1's rounds."""
    (al, first, later, final), refine = entry[0], entry[1]
    refine_size = entry[2] if len(entry) > 2 else None
    cfg = dataclasses.replace(
        bench.SOLVER_CFG, al_iters=al, ilqr_iters=first,
        ilqr_iters_later=later, ilqr_iters_final=final)
    if refine is None:
        return cfg, None, refine_size
    al_r, it_r = refine
    rcfg = continue_mu(cfg, al, al_iters=al_r, ilqr_iters=it_r,
                       ilqr_iters_later=it_r, ilqr_iters_final=None)
    return cfg, rcfg, refine_size


def solve_fn(mpc, entry):
    """The row's batched solve with batch statistics:
    ``(x0_b, U0_b, params) -> (SolveResult, BatchStats)``."""
    _, rcfg, refine_size = configs(entry)
    if rcfg is None:
        return with_stats(mpc.batch_solve_fn())
    return with_stats(mpc.batch_solve_refined_fn(rcfg, refine_size))


def run_row(entry, batch, device, reps=REPS, N=bench.N):
    """One row on ``bench.build_problem(batch, device, N=N)``: (its JSON
    record, the last SolveResult, its BatchStats)."""
    cfg, rcfg, refine_size = configs(entry)
    al, first, later, final = entry[0]
    mpc, x0_b, U0_b, params = bench.build_problem(batch, device,
                                                  solver_config=cfg, N=N)
    (res, stats), dt = bench.time_run(solve_fn(mpc, entry),
                                      (x0_b, U0_b, params), reps, device)
    rec = {
        "stage1": f"{al}x({first},{later}"
                  f"{',' + str(final) if final else ''})",
        "iters1": iteration_count(cfg),
        "refine": ("none" if rcfg is None else
                   f"{entry[1][0]}x{entry[1][1]}"
                   f"@{refine_size or DEFAULT_REFINE_SIZE}"),
        "solves_per_s": round(batch * reps / dt, 1),
        "converged_frac": float(stats.n_converged) / float(stats.n_solved),
        "max_violation": float(stats.max_violation),
    }
    return rec, res, stats


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=bench.BATCH)
    ap.add_argument("table", nargs="?", choices=("r1", "r2"), default="r1",
                    help="r2: CONFIGS_R2 (default: CONFIGS)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=REPS)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    recs = []
    for entry in CONFIGS_R2 if args.table == "r2" else CONFIGS:
        rec = run_row(entry, args.batch, args.device, args.reps)[0]
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()

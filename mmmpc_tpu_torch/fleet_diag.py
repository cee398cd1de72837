"""Fleet-completion diagnosis: where the robots that do not finish stall
(counterpart of ``scripts/fleet_diag_cpu.py``, which ran it on a CPU; the
port runs it on the card).

    python -m mmmpc_tpu_torch.fleet_diag [batch] [--relax] [--lanes]
        [--device cpu]

``batch`` robots of scenario 1 (default 128) at N=20 with the fleet bench's
budget ``CFG`` and its joint jitter (``bench_fleet_tasks.build_fleet``) run
``CHUNKS`` segments of ``CHUNK`` ticks through
``sim/batch_task_engine.py::make_batch_task_loop``, the carry passed on.
``--relax`` is the straggler recovery (aim-at-button rotate target, 5 cm
exit position tolerance) on the fused route; without it the parity mode,
on the host-parity solver (the AL expansion, kernels E and A), the route
the JAX script takes by running on a CPU (its batched solve is the vmapped
per-scenario solve there), or with ``--lanes`` on the fused route (kernels
A and B).  Prints the final phase histogram, the completion and the
failing robots, and for the first 8 failing robots the ticks spent in each
phase and the final state.  It runs on the card unless ``--device cpu`` is
given (the kernels' plain versions; a small batch).
"""

from __future__ import annotations

import argparse
import collections
import sys

import numpy as np
import torch

from mmmpc_tpu_torch.bench_fleet_tasks import (
    CFG, build_fleet, mode_of,
)
from mmmpc_tpu_torch.sim.batch_task_engine import PHASE_DONE

CHUNKS, CHUNK = 10, 40
BATCH = 128


def run(batch=BATCH, relax=False, device="cuda", chunks=CHUNKS, chunk=CHUNK,
        cfg=CFG, report=print, lanes=False):
    """``chunks`` segments of ``chunk`` ticks of the fleet in the mode
    ``bench_fleet_tasks.mode_of(relax, lanes)``: (phase (B, T) after each
    tick, X (B, T, 9) after each tick), numpy."""
    fleet = build_fleet(batch, 1, relax, device, cfg=cfg, chunk=chunk,
                        lanes=lanes)
    carry, phases, Xs = None, [], []
    with torch.inference_mode():
        for i in range(chunks):
            log, carry = fleet.run(fleet.x0, fleet.gpt, carry)
            phases.append(log.phase.cpu().numpy())
            Xs.append(log.X[:, 1:].cpu().numpy())
            report(f"chunk {i} done")
    return np.concatenate(phases, axis=1), np.concatenate(Xs, axis=1)


def diagnose(phase, X, n_shown=8):
    """The final-phase histogram (a Counter), the completion (the share of
    robots whose last phase is done), the failing robots, and for the first
    ``n_shown`` of them (index, ticks in each phase, final state)."""
    final = phase[:, -1]
    bad = np.flatnonzero(final != PHASE_DONE)
    return {
        "histogram": collections.Counter(final.tolist()),
        "completion": 1 - len(bad) / phase.shape[0],
        "failing": bad.tolist(),
        "stalls": [(int(b), dict(collections.Counter(phase[b].tolist())),
                    X[b, -1]) for b in bad[:n_shown]],
    }


def report_lines(d, mode, batch):
    """The JAX script's lines for the result ``d`` of :func:`diagnose`."""
    yield f"mode={mode} batch={batch}"
    yield f"final phase histogram: {d['histogram']}"
    yield f"completion {d['completion']:.4f}; failing: {d['failing']}"
    for b, t_hist, x in d["stalls"]:
        yield f"b={b} phase-time {t_hist} final x={x.round(3)}"


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=BATCH)
    ap.add_argument("--relax", action="store_true")
    ap.add_argument("--lanes", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    phase, X = run(args.batch, args.relax, args.device, lanes=args.lanes)
    d = diagnose(phase, X)
    # the JAX script's names, and the fused route's parity mode
    mode = "relax" if args.relax else mode_of(lanes=args.lanes)
    for line in report_lines(d, mode, args.batch):
        print(line, flush=True)
    return d, phase, X


if __name__ == "__main__":
    main()

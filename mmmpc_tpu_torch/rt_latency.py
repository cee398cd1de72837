"""Real-time receding-horizon latency of one robot (counterpart of the
single-scenario leg of ``scripts/rt_latency.py``).

p50 / p99 wall milliseconds of an MPC tick in a true closed loop: each tick
applies u[0] through the model plant, then re-solves from the advanced state
with the primal (shifted U) and dual (shifted, damped multipliers) warm
starts, waiting for the result.  The problem is robot 0 of the bench
problem (``bench.py``); the first tick is solved cold at the bench's full
schedule, the later ones at ``RT_CFG``, which only has to track the
optimum.  The solve runs the batched path at batch 1, so on the card each
iteration launches kernels A and B once.

    python -m mmmpc_tpu_torch.rt_latency [--ticks 100] [--device cpu]

The JAX script's fleet leg (batch 1024, per-robot U_last) is not ported:
the port's kernels take shared params only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mmmpc_tpu_torch.bench import SOLVER_CFG, build_problem
from mmmpc_tpu_torch.solver.al_ilqr import shift_multipliers
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.utils.configs import SolverConfig

TICKS = 100
RT_CFG = SolverConfig(al_iters=3, ilqr_iters=6, ilqr_iters_later=4,
                      cost_scale=1e5, constraint_tol=1e-3, n_alpha=3,
                      alpha_decay=0.35)


def pct(xs, q):
    """The q-th percentile of seconds ``xs``, in milliseconds."""
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def run_loop(ocp, x0, U0, params, ticks=TICKS):
    """The closed loop from x0 (1, nx), U0 (1, N, nu): the cold tick at
    ``SOLVER_CFG`` on ``params`` as given, then ``ticks`` warm ticks at ``RT_CFG``, with
    U_last = the warm inputs (the input-rate rows are relative to the
    previous commands, as deployed).  Returns (seconds, converged, max
    violation), one entry a warm tick."""
    def wait(t):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    res = al_ilqr_solve_batched(ocp, x0, U0, params, SOLVER_CFG)
    wait(res.U)
    x = x0
    lat, convs, viols = [], [], []
    for _ in range(ticks):
        t0 = time.perf_counter()
        x = ocp.dynamics(x, res.U[:, 0])
        U_warm = torch.cat([res.U[:, 1:], res.U[:, -1:]], dim=1)
        lam = shift_multipliers(res.lam_stage, res.lam_term, res.lam_eq)
        res = al_ilqr_solve_batched(ocp, x, U_warm,
                                    dict(params, U_last=U_warm[0]), RT_CFG,
                                    lam0_b=lam)
        wait(res.U)
        lat.append(time.perf_counter() - t0)
        convs.append(bool(res.converged[0]))
        viols.append(float(res.max_violation[0]))
    return lat, convs, viols


def single_scenario(device, ticks=TICKS):
    """The loop on ``device``: {p50_ms, p99_ms, converged_share,
    max_violation, ticks}."""
    mpc, x0_b, U0_b, params = build_problem(1, device)
    lat, convs, viols = run_loop(mpc.ocp, x0_b, U0_b, params, ticks)
    return {"ticks": ticks, "p50_ms": pct(lat, 50), "p99_ms": pct(lat, 99),
            "converged_share": float(np.mean(convs)),
            "max_violation": max(viols)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=TICKS)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default: the card)")
    args = ap.parse_args(argv)
    r = single_scenario(torch.device(args.device), args.ticks)
    print(f"B=1    p50 {r['p50_ms']:6.1f} ms  p99 {r['p99_ms']:6.1f} ms"
          f"  converged={r['converged_share'] * 100:.1f}%"
          f"  max_viol={r['max_violation']:.2e}")


if __name__ == "__main__":
    main()

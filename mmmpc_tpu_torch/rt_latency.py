"""Real-time receding-horizon latency: one robot, and fleet serving
(counterpart of ``scripts/rt_latency.py``).

p50 / p99 wall milliseconds of an MPC tick in a true closed loop: each tick
applies u[0] through the model plant, then re-solves from the advanced state
with the primal (shifted U) and dual (shifted, damped multipliers) warm
starts and U_last = the warm inputs, waiting for the result.  The first tick
is solved cold at the bench's full schedule, the later ones at ``RT_CFG``,
which only has to track the optimum.  Two shapes, each on the batched solve,
so on the card each iteration launches kernels A and B once:

- one robot: robot 0 of the bench problem (``bench.py``), batch 1;
- the fleet: the bench problem at batch 1024, each robot's U_last its own
  warm inputs, (N, nu, B), which the kernels read per scenario.

    python -m mmmpc_tpu_torch.rt_latency [--ticks 100] [--device cpu]
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
FLEET_BATCH = 1024
RT_CFG = SolverConfig(al_iters=3, ilqr_iters=6, ilqr_iters_later=4,
                      cost_scale=1e5, constraint_tol=1e-3, n_alpha=3,
                      alpha_decay=0.35)


def pct(xs, q):
    """The q-th percentile of seconds ``xs``, in milliseconds."""
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def run_loop(ocp, x0, U0, params, ticks=TICKS):
    """The closed loop from x0 (B, nx), U0 (B, N, nu): the cold tick at
    ``SOLVER_CFG`` on ``params`` as given, then ``ticks`` warm ticks at
    ``RT_CFG``, with U_last = the warm inputs (the input-rate rows are
    relative to the previous commands, as deployed): shared at batch 1,
    each robot's own, (N, nu, B), in a batch.  Returns (seconds, converged
    share, max violation), one entry a warm tick."""
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
        U_last = U_warm[0] if len(x) == 1 else U_warm.permute(1, 2, 0)
        res = al_ilqr_solve_batched(ocp, x, U_warm,
                                    dict(params, U_last=U_last), RT_CFG,
                                    lam0_b=lam)
        wait(res.U)
        lat.append(time.perf_counter() - t0)
        convs.append(float(res.converged.float().mean()))
        viols.append(float(res.max_violation.max()))
    return lat, convs, viols


def single_scenario(device, ticks=TICKS):
    """The loop on ``device``: {p50_ms, p99_ms, converged_share,
    max_violation, ticks}."""
    mpc, x0_b, U0_b, params = build_problem(1, device)
    lat, convs, viols = run_loop(mpc.ocp, x0_b, U0_b, params, ticks)
    return {"ticks": ticks, "p50_ms": pct(lat, 50), "p99_ms": pct(lat, 99),
            "converged_share": float(np.mean(convs)),
            "max_violation": max(viols)}


def fleet(device, ticks=TICKS):
    """The loop of FLEET_BATCH robots of the bench problem on ``device``:
    {p50_ms, p99_ms, mean_converged, min_converged (the shares of a tick's
    robots converged), max_violation, ticks, batch}."""
    mpc, x0_b, U0_b, params = build_problem(FLEET_BATCH, device)
    lat, convs, viols = run_loop(mpc.ocp, x0_b, U0_b, params, ticks)
    return {"ticks": ticks, "batch": FLEET_BATCH, "p50_ms": pct(lat, 50),
            "p99_ms": pct(lat, 99), "mean_converged": float(np.mean(convs)),
            "min_converged": float(np.min(convs)),
            "max_violation": max(viols)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=TICKS)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default: the card)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    r = single_scenario(device, args.ticks)
    print(f"B=1    p50 {r['p50_ms']:6.1f} ms  p99 {r['p99_ms']:6.1f} ms"
          f"  converged={r['converged_share'] * 100:.1f}%"
          f"  max_viol={r['max_violation']:.2e}")
    r = fleet(device, args.ticks)
    print(f"B={r['batch']:<4d} p50 {r['p50_ms']:6.1f} ms  p99 "
          f"{r['p99_ms']:6.1f} ms  mean converged="
          f"{r['mean_converged'] * 100:.2f}%  min tick converged="
          f"{r['min_converged'] * 100:.2f}%  max_viol="
          f"{r['max_violation']:.2e}")


if __name__ == "__main__":
    main()

"""Long-horizon benchmark: the sequential Riccati sweep against the
parallel-prefix (associative-scan) sweep across horizon lengths
(counterpart of ``scripts/bench_longhorizon.py``).

The whole-body qref problem of scenario 1 at horizons N = 20, 100, 500 and
2000, a batch of perturbed manipulate-phase starts, solved by
``al_ilqr_solve_batched`` at the JAX script's ``CFG`` (2 AL rounds of 4
then 3 sweeps, 4 step sizes, cost_scale 1e5, tolerance 1e-3) twice: with
``use_assoc_scan=False`` (the sequential sweep: kernel B fused, A the line
search) and with ``use_assoc_scan=True`` (the AL expansion in plain PyTorch
and ``ops/assoc_riccati.py``; A the line search).  Each row prints the
milliseconds a solve (a warm-up solve, then the median of ``reps`` solves
each timed alone, the device synchronised, with the least and the most),
the converged share of each route and the share of robots whose inputs
left the initial guess: at N = 2000 no robot's does, in either route, in
this port as in the JAX package (``tests/test_torch_assoc_solve.py`` run
as a script), so that row times line searches that are all refused.

    python -m mmmpc_tpu_torch.bench_longhorizon [batch] [--device cpu]
        [--horizons 20,100,500,2000] [--reps 5]

The card by default; ``--device cpu`` runs the kernels' plain versions
(far too slow past N = 100).  One line a row on stdout, then one JSON
object of all rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from mmmpc_tpu_torch.controllers import MPCWholeBody
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import MobileManipulator
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.utils.configs import SolverConfig, make_scenario
from mmmpc_tpu_torch.utils.convert import params_from_numpy

CFG = SolverConfig(al_iters=2, ilqr_iters=4, ilqr_iters_later=3,
                   cost_scale=1e5, constraint_tol=1e-3, n_alpha=4,
                   alpha_decay=0.4)
HORIZONS = (20, 100, 500, 2000)


def build_numpy(N, batch):
    """The JAX script's problem at horizon N as host data: (controller,
    x0_b (batch, 9), params as float64 numpy with U_last = 0)."""
    sc = make_scenario(1, N=N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    mpc = MPCWholeBody(MobileManipulator(sc.dt), obstacles, hp, N=N,
                       solver_config=CFG)
    rng = np.random.default_rng(0)
    x0 = np.array([4.45, 5.06, -np.pi, 0, 0, 0, -np.pi / 4, -np.pi, np.pi])
    x0_b = np.clip(x0[None] + rng.standard_normal((batch, 9)) * np.array(
        [0.05, 0.05, 0.02, 0.01, 0.01, 0.01, 0.05, 0.05, 0.05]),
        mpc.xlim[0], mpc.xlim[1])
    q_target = np.array([0.3, -1.0, 1.0])
    traj = np.linspace(x0, np.concatenate([x0[:6], q_target]), N + 1)
    params = dict(mpc.make_params(traj, np.zeros((N, 5))),
                  U_last=np.zeros((N, 5)))
    return mpc, x0_b, params


def build(N, batch, device):
    """``build_numpy`` in float32 on ``device``: (controller, x0_b, U0_b
    zeros (batch, N, 5), params)."""
    mpc, x0_b, params = build_numpy(N, batch)
    kw = dict(dtype=torch.float32, device=device)
    return (mpc, torch.as_tensor(x0_b, **kw), torch.zeros(batch, N, 5, **kw),
            params_from_numpy(params, device, torch.float32))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_solve(mpc, x0_b, U0_b, params, cfg, reps):
    """(ms of each of ``reps`` solves after a warm-up, each timed alone
    with the device synchronised; the last result)."""
    device = x0_b.device
    out = al_ilqr_solve_batched(mpc.ocp, x0_b, U0_b, params, cfg)
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = al_ilqr_solve_batched(mpc.ocp, x0_b, U0_b, params, cfg)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def run(batch, device, horizons=HORIZONS, reps=5):
    """One row a horizon: {N, batch, and for each route (scan, assoc) its
    ms a solve (the median of ``reps``, ``time_solve``), the least and the
    most, its converged share and the share of robots whose inputs left
    the initial guess (``moved``); rel_mean_cost, the routes' mean costs
    apart, relative; same_converged}."""
    rows = []
    for N in horizons:
        mpc, x0_b, U0_b, params = build(N, batch, device)
        row, res = {"N": N, "batch": batch}, {}
        for name, assoc in (("scan", False), ("assoc", True)):
            cfg = dataclasses.replace(CFG, use_assoc_scan=assoc)
            times, res[name] = time_solve(mpc, x0_b, U0_b, params, cfg, reps)
            row[f"{name}_ms"] = float(np.median(times))
            row[f"{name}_ms_min"] = min(times)
            row[f"{name}_ms_max"] = max(times)
            row[f"{name}_converged"] = float(
                res[name].converged.float().mean())
            row[f"{name}_moved"] = float(
                (res[name].U != U0_b).flatten(1).any(1).float().mean())
        c_s, c_a = (float(res[k].cost.mean()) for k in ("scan", "assoc"))
        row["rel_mean_cost"] = abs(c_a - c_s) / abs(c_s)
        row["same_converged"] = float(
            (res["scan"].converged == res["assoc"].converged).float().mean())
        rows.append(row)
        print(f"N={N:5d}  " + "  ".join(
            f"{k:5s}: {row[f'{k}_ms']:9.1f} ms [{row[f'{k}_ms_min']:.1f}, "
            f"{row[f'{k}_ms_max']:.1f}] (conv "
            f"{row[f'{k}_converged'] * 100:4.0f}%, moved "
            f"{row[f'{k}_moved'] * 100:4.0f}%)" for k in ("scan", "assoc")),
            flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--horizons", default=",".join(map(str, HORIZONS)))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    horizons = tuple(int(n) for n in args.horizons.split(","))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device={name} batch={args.batch} "
          f"iters={CFG.al_iters}x({CFG.ilqr_iters},{CFG.ilqr_iters_later})",
          flush=True)
    with torch.inference_mode():
        rows = run(args.batch, device, horizons, args.reps)
    print(json.dumps({"device": name, "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()

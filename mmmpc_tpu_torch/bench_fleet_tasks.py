"""Fleet task benchmark: thousands of full move -> press-button tasks running
together in one loop on the card (``sim/batch_task_engine.py``; counterpart
of ``scripts/bench_fleet_tasks.py``).

The reference completes one task per process in host-driven control ticks,
one IPOPT solve each (interface_wholebody_qref.py:65-143).  Here the whole
fleet's state machines, solves (per-robot references, weights, equality
mask and previous inputs), IK and plant steps advance together a tick at a
time; the metrics are the task completion rate and the fleet's ticks per
second.

    python -m mmmpc_tpu_torch.bench_fleet_tasks [batch] [scenario]
        [--relax] [--lanes] [--al=N] [--ilqr=N] [--ilqr-later=N]
        [--ticks=N] [--dump-done=FILE.npz] [--device=DEV]

It prints one JSON line (scenario, mode, budget, batch, n_ticks, horizon,
wall_s, completion_rate, median_done_tick, robot_ticks_per_s,
fleet_tick_ms, max_violation).  The modes are the JAX script's:

- ``parity`` (the default): the host loop's exit gates on the host-parity
  solver (``make_batch_task_loop(host_parity_solver=True)``: the AL
  expansion on each robot's entries, kernel E, kernel A's fleet
  instance), the JAX script's vmapped per-scenario route;
- ``parity-lanes`` (``--lanes``): the same gates on the fused route,
  kernels A and B with per-robot entries;
- ``relaxed-exit`` (``--relax``, on the fused route): the straggler
  recovery (aim-at-button rotate target, 5 cm exit position tolerance, the
  stuck detectors; ``make_batch_task_loop``).

``--device`` defaults to the card; ``--device=cpu`` runs the kernels'
plain versions, for a small batch.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from mmmpc_tpu_torch.controllers import MPCWholeBody
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import MobileManipulator
from mmmpc_tpu_torch.sim.batch_task_engine import (
    PHASE_DONE, make_batch_task_loop,
)
from mmmpc_tpu_torch.utils.configs import SolverConfig, make_scenario
from mmmpc_tpu_torch.utils.convert import params_from_numpy
from mmmpc_tpu_torch.utils.debugging import report_rollout_failures

# the host loop's budget: the phase switches (terminal equality from ~1.5 m
# out, the rotate weights) need the full schedule
CFG = SolverConfig(al_iters=6, ilqr_iters=12, cost_scale=1e5,
                   constraint_tol=1e-3, n_alpha=3, alpha_decay=0.35)
# N=20 is the reference demo's horizon; the host loop needs ~192 ticks for
# scenario 1, and 400 leave the jittered stragglers room
N = 20
N_TICKS = 400
CHUNK = 40                    # ticks a segment, the carry between them
BATCH = 1024
# the recovery mode's settings (--relax)
RELAX = dict(rotate_exit_pos_tol=0.05, aim_at_button=True)
IK_ITERS = 40


@dataclasses.dataclass
class Fleet:
    """One fleet problem: the segment loop ``run`` (CHUNK ticks), the
    starts x0 (B, 9) and the buttons' poses gpt (B, 4) on the device."""
    run: object
    x0: torch.Tensor
    gpt: torch.Tensor
    cfg: SolverConfig
    mode: str


def mode_of(relax=False, lanes=False):
    """The JAX script's name of a run's mode: ``relaxed-exit`` (the
    recovery, on the fused route), ``parity-lanes`` (the parity gates on
    the fused route) or ``parity`` (on the host-parity solver)."""
    return ("relaxed-exit" if relax else "parity-lanes" if lanes
            else "parity")


def build_fleet(batch=BATCH, scenario=1, relax=False, device="cuda",
                cfg=CFG, chunk=CHUNK, lanes=False):
    """The fleet of the JAX script: ``batch`` robots of ``scenario`` at
    N=20, their joints jittered by 0.05 rad (``default_rng(0)``), float32
    on ``device``, in the mode ``mode_of(relax, lanes)``: parity mode runs
    the host-parity solver unless ``lanes``."""
    mode = mode_of(relax, lanes)
    sc = make_scenario(scenario, N=N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    mpc = MPCWholeBody(MobileManipulator(sc.dt), obstacles, hp, N=N,
                       solver_config=cfg, device=device)
    shared = mpc.make_params(np.zeros((N + 1, 9)), np.zeros((N, 5)))
    for k in ("X_ref", "U_ref"):
        shared.pop(k)
    shared = params_from_numpy(shared, device, torch.float32)
    run = make_batch_task_loop(
        mpc.ocp, cfg, shared, t_move=sc.t_move, t_manipulate=sc.t_manipulate,
        dt=sc.dt, n_ticks=chunk, ik_iters=IK_ITERS,
        host_parity_solver=mode == "parity", **(RELAX if relax else {}))
    rng = np.random.default_rng(0)
    x0 = np.tile(sc.x_start, (batch, 1)).astype(np.float32)
    # joint-space jitter (a base jitter strands the reference's 1 cm / 0.5
    # deg rotate exit, as on the host loop)
    x0[:, 6:] += (0.05 * rng.standard_normal((batch, 3))).astype(np.float32)
    gpt = np.tile(np.asarray(sc.global_pose_target, np.float32), (batch, 1))
    kw = dict(dtype=torch.float32, device=device)
    return Fleet(run, torch.as_tensor(x0, **kw), torch.as_tensor(gpt, **kw),
                 cfg, mode)


def run_fleet(fleet: Fleet, n_ticks=N_TICKS, tick_hook=None):
    """Run ``n_ticks`` ticks (a multiple of the loop's segment) from the
    start, the carry threaded through the segments, the device waited for
    once a segment (to read its phases and violations).  Returns {phase_t
    (B, n_ticks) numpy, done_at (B,), violation max, fallback ticks,
    finite (every state finite), wall_s, worst_log (the segment of the
    worst violation), carry}."""
    carry, phases, viol_max, worst_log = None, [], 0.0, None
    n_fallback, finite = 0, True
    t0 = time.perf_counter()
    done = 0
    while done < n_ticks:
        log, carry = fleet.run(fleet.x0, fleet.gpt, carry, tick_hook)
        phases.append(log.phase.cpu().numpy())
        chunk_max = float(log.violation.max())
        n_fallback += int(log.fallback.sum())
        finite = finite and bool(torch.isfinite(log.X).all())
        if worst_log is None or chunk_max > viol_max:
            worst_log = log
        viol_max = max(viol_max, chunk_max)
        done += log.phase.shape[1]
    wall = time.perf_counter() - t0
    phase_t = np.concatenate(phases, axis=1)
    done_mask = phase_t == PHASE_DONE
    done_at = np.where(done_mask.any(axis=1), done_mask.argmax(axis=1),
                       phase_t.shape[1]).astype(float)
    return dict(phase_t=phase_t, done_at=done_at, max_violation=viol_max,
                fallback_ticks=n_fallback, finite=finite, wall_s=wall,
                worst_log=worst_log, carry=carry)


def summary(fleet: Fleet, scenario, r) -> dict:
    """The JSON record of a run (the JAX script's keys)."""
    batch, n_ticks = r["phase_t"].shape
    done = r["phase_t"][:, -1] == PHASE_DONE
    cfg = fleet.cfg
    return {
        "scenario": scenario, "mode": fleet.mode,
        "budget": f"al={cfg.al_iters} ilqr={cfg.ilqr_iters}"
                  f"/{cfg.ilqr_iters_later or cfg.ilqr_iters}",
        "batch": batch, "n_ticks": n_ticks, "horizon": N,
        "wall_s": round(r["wall_s"], 3),
        "completion_rate": round(float(done.mean()), 4),
        "median_done_tick": (float(np.median(r["done_at"][done]))
                             if done.any() else None),
        "robot_ticks_per_s": round(batch * n_ticks / r["wall_s"], 1),
        "fleet_tick_ms": round(r["wall_s"] / n_ticks * 1e3, 2),
        "max_violation": r["max_violation"],
    }


def _wait(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    relax, lanes = "--relax" in argv, "--lanes" in argv
    budget, n_ticks, dump_done, device = {}, N_TICKS, None, "cuda"
    flags = {"--al=": "al_iters", "--ilqr=": "ilqr_iters",
             "--ilqr-later=": "ilqr_iters_later"}
    for a in argv:
        if not a.startswith("--") or a in ("--relax", "--lanes"):
            continue
        key = a.split("=", 1)[0] + "="
        if key in flags:
            budget[flags[key]] = int(a.split("=", 1)[1])
        elif key == "--ticks=":
            t = int(a.split("=", 1)[1])
            # up to a multiple of CHUNK, never 0
            n_ticks = max(CHUNK, (t + CHUNK - 1) // CHUNK * CHUNK)
            if n_ticks != t:
                print(f"--ticks={t} rounded to {n_ticks} (multiple of "
                      f"CHUNK={CHUNK})", file=sys.stderr)
        elif key == "--dump-done=":
            dump_done = a.split("=", 1)[1]
        elif key == "--device=":
            device = a.split("=", 1)[1]
        else:
            print(f"bench_fleet_tasks: unknown flag {a}", file=sys.stderr)
            return 2
    cfg = dataclasses.replace(CFG, **budget) if budget else CFG
    args = [a for a in argv if not a.startswith("--")]
    batch = int(args[0]) if args else BATCH
    scenario = int(args[1]) if len(args) > 1 else 1
    fleet = build_fleet(batch, scenario, relax, device, cfg, lanes=lanes)
    fleet.run(fleet.x0, fleet.gpt)      # warm-up: one segment
    _wait(device)
    r = run_fleet(fleet, n_ticks)
    # failure forensics: the worst robots of the worst segment
    if r["max_violation"] > cfg.constraint_tol:
        report_rollout_failures(r["worst_log"],
                                constraint_tol=cfg.constraint_tol, top_k=3)
    if dump_done:
        # per-robot done ticks, for a comparison robot by robot
        np.savez(dump_done, done=r["phase_t"][:, -1] == PHASE_DONE,
                 done_at=r["done_at"], final_phase=r["phase_t"][:, -1])
    print(json.dumps(summary(fleet, scenario, r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

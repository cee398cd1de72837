"""Host-loop fleet parity: the fleet bench's robots driven one at a time
through the host ``Interface`` loop (counterpart of
``scripts/host_fleet_parity.py``).

    python -m mmmpc_tpu_torch.host_fleet_parity [K] [scenario]
        [--ticks=400] [--procs=N] [--dump=FILE.json] [--compare=FILE.npz]
        [--device=cpu]

The fleet task engine (``sim/batch_task_engine.py``) claims a completion
rate for a batch of jittered scenario tasks; this runs the first ``K`` of
the same robots (``FLEET_BATCH`` starts drawn exactly as
``bench_fleet_tasks.build_fleet`` draws them, ``default_rng(0)``) through
the reference's loop, ``runtime/interface.py`` with the model-only plant,
each robot a warm-started ``MPCWholeBody`` solve a tick at batch 1 (kernels
A and B), up to ``--ticks`` ticks, in a ``spawn`` pool of ``--procs``
worker processes.  It prints one JSON line: completion rate, median steps
of the robots done, the histogram of final task flags, wall seconds.
``--dump`` writes the per-robot rows (index, done, final flag, steps,
seconds, the states' finiteness, A's and B's launches), to compare robot by
robot with ``bench_fleet_tasks --dump-done``; ``--compare`` reads that
file and prints a second JSON line, the fleet's completion of the same K
robots and the robots on which the two loops agree.  The workers solve on
the card unless ``--device=cpu`` is given (the kernels' plain versions).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import sys
import time

import numpy as np

N = 20               # the fleet bench's horizon
FLEET_BATCH = 1024   # the jitter's draw size; the first K robots are taken
MAX_TICKS = 400


def starts(K, scenario=1):
    """The first ``K`` of the fleet bench's ``FLEET_BATCH`` starts (K, 9):
    the scenario's start, its joints jittered by 0.05 rad from
    ``default_rng(0)`` in float32, as float64."""
    from mmmpc_tpu_torch.utils.configs import make_scenario
    sc = make_scenario(scenario, N=N)
    rng = np.random.default_rng(0)
    x0 = np.tile(sc.x_start, (FLEET_BATCH, 1)).astype(np.float32)
    x0[:, 6:] += (0.05 * rng.standard_normal((FLEET_BATCH, 3))
                  ).astype(np.float32)
    return x0[:K].astype(float)


def _worker(args):
    """One robot to ``max_ticks`` through the host loop: args (idx, x0,
    scenario, max_ticks, device, solver config or None for the
    controller's default); returns its row."""
    idx, x0, scenario, max_ticks, device, cfg = args
    import torch

    from mmmpc_tpu_torch.controllers import MPCWholeBody
    from mmmpc_tpu_torch.models.obstacles import Obstacles
    from mmmpc_tpu_torch.models.robots import MobileManipulator
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.runtime.interface import Interface
    from mmmpc_tpu_torch.utils.configs import make_scenario

    torch.set_num_threads(1)     # one core a worker
    sc = make_scenario(scenario, N=N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    mpc = MPCWholeBody(MobileManipulator(sc.dt), obstacles, hp, N=N,
                       solver_config=cfg, device=device)
    world = Interface(sc.dt, sc.t_move, sc.t_manipulate, x0,
                      sc.global_pose_target, mpc, physical_sim=False,
                      max_mpc_steps=max_ticks)
    counters = (wholebody_fwd.LAUNCHES, wholebody_bwd.LAUNCHES)
    before = [c.cuda for c in counters]
    t0 = time.perf_counter()
    with torch.inference_mode():
        world.run()
    # "manipulate finish": the end effector within 1 cm of the button, the
    # engine's done check
    return {
        "idx": idx,
        "done": world.task_flag == "manipulate finish",
        "final_flag": world.task_flag,
        "steps": int(world.mpc_step_counter),
        "wall_s": round(time.perf_counter() - t0, 1),
        "finite": bool(np.isfinite(np.asarray(world.x_log)).all()),
        "launches": {name: c.cuda - b for name, c, b in
                     zip(("wholebody_fwd", "wholebody_bwd"), counters,
                         before)},
    }


def run(K=64, scenario=1, max_ticks=MAX_TICKS, procs=None, device="cuda"):
    """Every robot's row (sorted by index) and the summary record."""
    if device == "cuda":
        # build the kernels once, before the workers load them
        from mmmpc_tpu_torch.ops._cuda import LIBRARY
        LIBRARY.get()
    x0 = starts(K, scenario)
    jobs = [(i, x0[i], scenario, max_ticks, device, None) for i in range(K)]
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(procs or os.cpu_count() or 1) as pool:
        results = sorted(pool.imap_unordered(_worker, jobs),
                         key=lambda r: r["idx"])
    return results, summary(results, scenario, K, max_ticks,
                            time.perf_counter() - t0)


def summary(results, scenario, K, max_ticks, wall):
    """The JAX script's record of the rows ``results``."""
    flags = {}
    for r in results:
        flags[r["final_flag"]] = flags.get(r["final_flag"], 0) + 1
    done = [r for r in results if r["done"]]
    return {
        "scenario": scenario, "K": K, "max_ticks": max_ticks,
        "host_completion_rate": round(len(done) / K, 4),
        "median_done_steps": (float(np.median([r["steps"] for r in done]))
                              if done else None),
        "final_flag_histogram": flags,
        "wall_s": round(wall, 1),
    }


def compare(results, done_npz):
    """The host loop's rows beside ``bench_fleet_tasks --dump-done``'s file
    of the same fleet: both completion rates on these robots, the robots on
    which the two agree, and those done in one loop only."""
    fleet = np.load(done_npz)["done"][:len(results)].astype(bool)
    host = np.array([r["done"] for r in results], dtype=bool)
    return {
        "K": len(results),
        "host_completion_rate": round(float(host.mean()), 4),
        "fleet_completion_rate": round(float(fleet.mean()), 4),
        "agree": int((host == fleet).sum()),
        "host_only": np.flatnonzero(host & ~fleet).tolist(),
        "fleet_only": np.flatnonzero(fleet & ~host).tolist(),
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    K = int(args[0]) if args else 64
    scenario = int(args[1]) if len(args) > 1 else 1
    max_ticks, procs, dump, device = MAX_TICKS, None, None, "cuda"
    fleet_dump = None
    for a in argv:
        if a.startswith("--ticks="):
            max_ticks = int(a.split("=", 1)[1])
        elif a.startswith("--procs="):
            procs = int(a.split("=", 1)[1])
        elif a.startswith("--dump="):
            dump = a.split("=", 1)[1]
        elif a.startswith("--compare="):
            fleet_dump = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--"):
            print(f"host_fleet_parity: unknown flag {a}", file=sys.stderr)
            return 2
    results, out = run(K, scenario, max_ticks, procs, device)
    if dump:
        with open(dump, "w") as fh:
            json.dump(results, fh)
    print(json.dumps(out), flush=True)
    if fleet_dump:
        print(json.dumps(compare(results, fleet_dump)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-process run of the scale-out path (counterpart of
``scripts/dryrun_multiprocess.py``): two OS processes, one rank each,
joined by ``torch.distributed`` -- the bootstrap, the host-local data
feeding, the sharded solve with its statistics reduced by collectives, the
gather of the results and the sharded fleet loop that a multi-GPU run uses.

    python -m mmmpc_tpu_torch.dryrun_multiprocess --device cpu     # gloo
    python -m mmmpc_tpu_torch.dryrun_multiprocess --backend gloo   # ranks
        # sharing the card
    python -m mmmpc_tpu_torch.dryrun_multiprocess --device cpu --problem qref \\
        --dtype float64 --robot-loop --fleet-batch 16 --out DIR

Every rank builds the same global problem from its seed and feeds its own
rows (``multihost.host_local_batch``).  Each checks that the reduced
``n_solved`` is the global batch, that the global statistics are those of
the gathered batch, and that its shard equals the solve of the same rows in
one process (``hold``: to the bit, or else at a relative cost of 1e-6 with
the same converged flags -- on the CPU a robot solved in a batch of 4 equals
itself solved alone only to ~1e-6); with ``--robot-loop`` also the sharded
robot-by-robot solve (``batch_impl=None``) against the batched one; with
``--fleet-batch`` the fleet loop, two segments threaded by the carry, each
rank's log and carry against the loop of one process on its robots (phases
exactly).  ``--out DIR`` keeps each rank's results (``rank<r>.pt``); the
store of the group is a file there (a fresh directory under
``build/dryrun/`` by default).  Prints ``PASS``, or ``FAIL`` and exits 1.

Problems: ``base`` the JAX dry run's (``MPCBase``, N=8, 3 x 6 sweeps,
batch 32), ``qref`` the whole-body problem of ``tests/test_parallel.py``
(N=5, 2 x 4 sweeps, batch 16; its fleet scenario 0 at N=5, 3 ticks a
segment), ``bench`` the bench problem (``bench.py``, batch 8192;
``--refined`` its two-stage solve; its fleet ``bench_fleet_tasks``' relaxed
one).  Workers start with ``python -m`` in processes of their own.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NPROC = 2
BATCH = {"base": 32, "qref": 16, "bench": 8192}
# the loop of one process and the sharded one agree to the bit, or else
# to this relative cost with the same converged flags
REL_COST = 1e-6
# the fleet's states where a log is not bitwise (tests/test_parallel.py's)
FLEET_ATOL = 1e-6


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--problem", default="base", choices=tuple(BATCH))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--refined", action="store_true")
    ap.add_argument("--robot-loop", action="store_true")
    ap.add_argument("--fleet-batch", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", type=int, default=None)
    return ap.parse_args(argv)


# ------------------------------------------------------------------ problems

def build_problem(name: str, batch: int, refined: bool):
    """(mpc, x0_g (batch, nx), U0_g (batch, N, nu), params, batch_impl) of
    the global problem, host data from its seed."""
    import numpy as np

    from mmmpc_tpu_torch.models.obstacles import Obstacles
    from mmmpc_tpu_torch.utils.configs import SolverConfig

    if name == "bench":
        from mmmpc_tpu_torch.bench import REFINE_CFG, N, build_problem_numpy
        mpc, x0_g, params = build_problem_numpy(batch)
        impl = (mpc.batch_solve_refined_fn(REFINE_CFG) if refined
                else mpc.batch_solve_fn())
        return mpc, x0_g, np.zeros((batch, N, 5)), params, impl
    if name == "base":
        from mmmpc_tpu_torch.controllers import MPCBase
        from mmmpc_tpu_torch.models.robots import Base
        N = 8
        mpc = MPCBase(Base(0.1), [Obstacles(1.0, 0.05, 0.3)], N=N,
                      solver_config=SolverConfig(al_iters=3, ilqr_iters=6))
        traj = np.linspace(np.zeros(6), np.array([2.0, 0, 0, 0, 0, 0]), N + 1)
        params = dict(mpc.make_params(traj, np.zeros((N, 2))),
                      U_last=np.zeros((N, 2)))
        x0_g = np.random.default_rng(7).standard_normal((batch, 6)) * 0.1
        U0_g = np.zeros((batch, N, 2))
    else:
        mpc = _small_qref()
        N = mpc.N
        rng = np.random.default_rng(3)
        x0 = np.zeros(9)
        x0[6:] = [-np.pi / 4, -np.pi / 2, np.pi / 2]
        x0_g = x0[None] + 0.02 * rng.standard_normal((batch, 9)) * np.array(
            [1, 1, 0.2, 0, 0, 0, 0.1, 0.1, 0.1])
        U0_g = np.zeros((batch, N, 5))
        target = np.concatenate([[0.5, 0.1, 0, 0, 0, 0], x0[6:]])
        params = dict(mpc.make_params(np.linspace(x0, target, N + 1),
                                      np.zeros((N, 5))),
                      U_last=np.zeros((N, 5)))
    impl = (mpc.batch_solve_refined_fn() if refined
            else mpc.batch_solve_fn())
    return mpc, x0_g, U0_g, params, impl


def _small_qref():
    from mmmpc_tpu_torch.controllers import MPCWholeBody
    from mmmpc_tpu_torch.models.obstacles import Obstacles
    from mmmpc_tpu_torch.models.robots import MobileManipulator
    from mmmpc_tpu_torch.utils.configs import SolverConfig
    return MPCWholeBody(MobileManipulator(0.1), [Obstacles(1.0, 0.3, 0.3)], [],
                        N=5, solver_config=SolverConfig(al_iters=2,
                                                        ilqr_iters=4))


def build_fleet(name: str, batch: int, ticks: int, device, dtype):
    """(run, x0_g (batch, 9), gpt_g (batch, 4)) of the global fleet on
    ``device``: the bench fleet (``bench_fleet_tasks``, relaxed, float32)
    or the small one of ``tests/test_parallel.py`` (scenario 0, N=5, one AL
    round of 3 sweeps, 2 step sizes, IK 4 iterations, joints jittered by
    ``default_rng(7)``)."""
    import numpy as np
    import torch

    if name == "bench":
        from mmmpc_tpu_torch.bench_fleet_tasks import build_fleet as bench
        fleet = bench(batch, 1, relax=True, device=device, chunk=ticks)
        return fleet.run, fleet.x0, fleet.gpt
    from mmmpc_tpu_torch.sim.batch_task_engine import make_batch_task_loop
    from mmmpc_tpu_torch.utils.configs import SolverConfig, make_scenario
    from mmmpc_tpu_torch.utils.convert import params_from_numpy
    sc = make_scenario(0, N=5)
    mpc = _small_qref()
    shared = mpc.make_params(np.zeros((6, 9)), np.zeros((5, 5)))
    for k in ("X_ref", "U_ref"):
        shared.pop(k)
    run = make_batch_task_loop(
        mpc.ocp, SolverConfig(al_iters=1, ilqr_iters=3, n_alpha=2),
        params_from_numpy(shared, device, dtype), t_move=sc.t_move,
        t_manipulate=sc.t_manipulate, dt=sc.dt, n_ticks=ticks, ik_iters=4)
    rng = np.random.default_rng(7)
    x0 = np.tile(np.asarray(sc.x_start), (batch, 1))
    x0[:, 6:] += 0.02 * rng.standard_normal((batch, 3))
    gpt = np.tile(np.asarray(sc.global_pose_target), (batch, 1))
    kw = dict(dtype=dtype, device=device)
    return run, torch.as_tensor(x0, **kw), torch.as_tensor(gpt, **kw)


# ------------------------------------------------------------------ checks

def hold(got, ref, what: str) -> str:
    """Hold a SolveResult to its twin: 'bitwise' when every field is equal
    to the bit, else 'rel_cost' when each robot's cost is within REL_COST
    (relative) with the same converged flags; raises otherwise."""
    import torch
    if all(torch.equal(a, b) for a, b in zip(got, ref)):
        return "bitwise"
    rel = ((got.cost - ref.cost).abs() / ref.cost.abs().clamp_min(1e-30))
    worst = float(rel.max())
    if worst <= REL_COST and torch.equal(got.converged, ref.converged):
        return "rel_cost"
    raise AssertionError(f"{what}: worst relative cost {worst:.3e}, same "
                         f"flags {bool(torch.equal(got.converged, ref.converged))}")


def hold_fleet(logs, carry, ref_logs, ref_carry, what: str) -> str:
    """Hold a fleet's segment logs and carry to its twin's: 'bitwise', or
    phases and done ticks exactly with states and inputs within FLEET_ATOL
    ('atol'); raises otherwise."""
    import torch

    from mmmpc_tpu_torch.parallel.data_parallel import tree_leaves
    if all(torch.equal(a, b) for a, b in zip(
            tree_leaves((logs, carry)), tree_leaves((ref_logs, ref_carry)))):
        return "bitwise"
    for log, rlog in zip(logs, ref_logs):
        if not (torch.equal(log.phase, rlog.phase)
                and torch.equal(log.done_at, rlog.done_at)):
            raise AssertionError(f"{what}: phases or done ticks differ")
        for k in ("X", "U"):
            d = float((getattr(log, k) - getattr(rlog, k)).abs().max())
            if d > FLEET_ATOL:
                raise AssertionError(f"{what}: max |d{k}| {d:.3e}")
    return "atol"


def check_stats(stats, gathered, batch: int):
    """The reduced statistics are the gathered global batch's: n_solved the
    batch, n_converged the converged count, max_violation the max (exactly),
    mean_cost the mean within 1e-6 (relative; the mean of the shards' means
    sums in another order)."""
    import torch
    n = float(stats.n_solved)
    if n != batch:
        raise AssertionError(f"n_solved {n} != global batch {batch}")
    conv = float(gathered.converged.sum())
    if float(stats.n_converged) != conv:
        raise AssertionError(f"n_converged {float(stats.n_converged)} != "
                             f"{conv} converged in the gathered batch")
    if not torch.equal(stats.max_violation.to(gathered.max_violation.dtype),
                       gathered.max_violation.max()):
        raise AssertionError("max_violation differs from the gathered max")
    mean = float(gathered.cost.mean())
    if abs(float(stats.mean_cost) - mean) > 1e-6 * abs(mean):
        raise AssertionError(f"mean_cost {float(stats.mean_cost)} != {mean}")


# ------------------------------------------------------------------ ranks

def _launches():
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd
    return {"wholebody_fwd": wholebody_fwd.LAUNCHES.cuda,
            "wholebody_bwd": wholebody_bwd.LAUNCHES.cuda}


def _reset_launches():
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd
    wholebody_fwd.LAUNCHES.reset()
    wholebody_bwd.LAUNCHES.reset()


def build_kernels_once(mesh):
    """On the card, rank 0 builds (or finds) the kernel library while the
    others wait at a barrier, then each loads it."""
    import torch.distributed as dist

    from mmmpc_tpu_torch.ops._cuda import LIBRARY
    if mesh.device.type != "cuda":
        return
    if mesh.rank == 0:
        LIBRARY.get()
    if mesh.world_size > 1:
        dist.barrier()
    LIBRARY.get()


def worker(rank: int, args) -> dict:
    """One rank's run (see the module's docstring); returns its record."""
    import torch
    import torch.distributed as dist

    from mmmpc_tpu_torch.parallel import (
        gather_batch, global_data_mesh, host_local_batch, init_distributed,
        process_batch_slice, sharded_solve_fn, sharded_task_loop_fn,
        with_stats,
    )
    from mmmpc_tpu_torch.utils.convert import params_from_numpy

    dtype = getattr(torch, args.dtype)
    if args.device == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(1)         # the ranks share the host's cores
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    store = Path(args.out) / "store"
    init_distributed(f"file://{store}", NPROC, rank, args.backend, device)
    try:
        mesh = global_data_mesh()
        assert (mesh.rank, mesh.world_size) == (rank, NPROC), mesh
        build_kernels_once(mesh)
        sync = (torch.cuda.synchronize if device.type == "cuda"
                else lambda: None)
        batch = BATCH[args.problem]
        mpc, x0_g, U0_g, params_np, impl = build_problem(
            args.problem, batch, args.refined)
        local, off = process_batch_slice(batch)
        rows = slice(off, off + local)
        x0_s, U0_s = host_local_batch(mesh, (x0_g[rows], U0_g[rows]), dtype)
        params = params_from_numpy(params_np, device, dtype)
        run = sharded_solve_fn(mpc.solve_fn(), mesh, batch_impl=impl)

        _reset_launches()
        t0 = time.perf_counter()
        res, stats = run(x0_s, U0_s, params)
        sync()
        solve_s = time.perf_counter() - t0
        launches = _launches()
        gathered = gather_batch(res, mesh)
        check_stats(stats, gathered, batch)
        # the solve of the same rows in one process (unrefined: of the whole
        # batch, sliced -- the refine stage is batch-global)
        if args.refined:
            twin, _ = with_stats(impl)(x0_s, U0_s, params)
        else:
            x_all, U_all = host_local_batch(mesh, (x0_g, U0_g), dtype)
            twin = type(res)(*(f[rows] for f in impl(x_all, U_all, params)))
        held = {"shard": hold(res, twin, f"rank {rank} shard")}
        rec = dict(rank=rank, world_size=mesh.world_size,
                   backend=mesh.backend, host_staged=mesh.host_staged,
                   device=str(device), offset=off, local=local, x0=x0_s,
                   res=res, gathered=gathered if rank == 0 else None,
                   stats=stats, solve_s=solve_s, launches=launches)
        if args.robot_loop:
            res_l, stats_l = sharded_solve_fn(mpc.solve_fn(), mesh)(
                x0_s, U0_s, params)
            held["robot_loop"] = hold(res_l, res, f"rank {rank} robot loop")
            rec.update(res_loop=res_l, stats_loop=stats_l)
        if args.fleet_batch:
            fl_run, fx0, fgpt = build_fleet(args.problem, args.fleet_batch,
                                            args.ticks, device, dtype)
            flocal, foff = process_batch_slice(args.fleet_batch)
            frows = slice(foff, foff + flocal)
            sh = sharded_task_loop_fn(fl_run, mesh)
            _reset_launches()
            t0 = time.perf_counter()
            log1, c1 = sh(fx0[frows], fgpt[frows])
            log2, c2 = sh(fx0[frows], fgpt[frows], c1)
            sync()
            fleet_s = time.perf_counter() - t0
            fleet_launches = _launches()
            r1, rc1 = fl_run(fx0[frows], fgpt[frows])
            r2, rc2 = fl_run(fx0[frows], fgpt[frows], rc1)
            held["fleet"] = hold_fleet((log1, log2), c2, (r1, r2), rc2,
                                       f"rank {rank} fleet")
            rec.update(fleet_offset=foff, fleet_local=flocal,
                       fleet_logs=(log1, log2),
                       fleet_carry=c2, fleet_s=fleet_s,
                       fleet_launches=fleet_launches)
        rec["held"] = held
        if args.out:
            from mmmpc_tpu_torch.parallel.data_parallel import tree_map
            cpu = tree_map(lambda t: t.detach().cpu() if torch.is_tensor(t)
                           else t, _plain(rec))
            torch.save(cpu, Path(args.out) / f"rank{rank}.pt")
        print(f"rank {rank}/{mesh.world_size}: OK backend={mesh.backend} "
              f"host_staged={mesh.host_staged} n_solved="
              f"{int(stats.n_solved)} converged={int(stats.n_converged)} "
              f"max_violation={float(stats.max_violation):.3e} mean_cost="
              f"{float(stats.mean_cost):.4f} held={held} launches={launches}"
              + (f" fleet_launches={rec['fleet_launches']}"
                 if args.fleet_batch else ""), flush=True)
        return rec
    finally:
        dist.destroy_process_group()


def _plain(tree):
    """NamedTuples as dicts, so a saved record loads without this package's
    classes."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def launch(args) -> int:
    """Start NPROC workers (``python -m`` this module with
    ``--worker``), wait for every one with a time limit, and return 0 when
    all exited 0 (else kill the rest and return 1)."""
    if args.device == "cuda" and args.backend != "gloo":
        import torch
        n = torch.cuda.device_count()
        if NPROC > n:
            print(f"FAIL: {NPROC} ranks on {n} card(s) share a card, "
                  f"which NCCL refuses: pass --backend gloo", flush=True)
            return 1
    if args.out is None:
        base = ROOT / "build" / "dryrun"
        base.mkdir(parents=True, exist_ok=True)
        args.out = tempfile.mkdtemp(dir=base)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "store").unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "mmmpc_tpu_torch.dryrun_multiprocess",
           *_forward(args)]
    procs = [subprocess.Popen([*cmd, "--worker", str(r)], cwd=ROOT)
             for r in range(NPROC)]
    deadline = time.monotonic() + args.timeout
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            rcs.append("timeout")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if any(rc != 0 for rc in rcs):
        print("FAIL", rcs, flush=True)
        return 1
    print(f"PASS: {NPROC} processes, {args.problem} problem, backend "
          f"{args.backend or ('nccl' if args.device == 'cuda' else 'gloo')}"
          f", device {args.device}; results in {args.out}", flush=True)
    return 0


def _forward(args) -> list[str]:
    """The workers' arguments: this run's settings, its output directory."""
    out = ["--device", args.device, "--problem", args.problem,
           "--dtype", args.dtype,
           "--ticks", str(args.ticks), "--fleet-batch", str(args.fleet_batch),
           "--out", str(args.out)]
    if args.backend:
        out += ["--backend", args.backend]
    out += [f for f, on in (("--refined", args.refined),
                            ("--robot-loop", args.robot_loop)) if on]
    return out


def main(argv=None) -> int:
    args = _args(argv)
    if args.worker is not None:
        worker(args.worker, args)
        return 0
    return launch(args)


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())

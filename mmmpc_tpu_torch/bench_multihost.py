"""Multi-GPU benchmark entry point, one process per card (counterpart of
``scripts/bench_multihost.py``).

    torchrun --nproc_per_node=<cards> -m mmmpc_tpu_torch.bench_multihost [--refined]
    python -m mmmpc_tpu_torch.bench_multihost     # one process, no group

The global batch is ``BATCH`` (8192) a rank; every rank builds the same
global problem (``bench.py``'s, from its seed) and feeds its own slice
(``parallel/multihost.py::host_local_batch``).  Its solve is the JAX
script's, the stage-1 ``batch_solve_fn()`` of the bench problem;
``--refined`` runs the refined ``batch_solve_refined_fn(REFINE_CFG)`` on each
shard, as ``bench.py`` does on several devices (each shard refines its own
worst).  The statistics are reduced over the ranks each solve
(``sharded_solve_fn``; on the device under NCCL).  A warm-up solve, then
``REPS`` solves back to back, one synchronise at the end.  Rank 0 prints the
JAX script's JSON keys (metric, value, unit, n_processes, n_devices,
distributed, global_batch, converged_frac, max_violation) and the port's
(mean_cost, refined, backend, device; each rank's launches of A and B a
solve, counted in the warm-up, and its converged count and worst violation
in the last solve).  Before a barrier only rank 0 builds the
kernel library; the others load it.  The backend is NCCL, one rank a card
(NCCL refuses two ranks on one card; ``dryrun_multiprocess --backend
gloo`` runs ranks that share one).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist

REPS = 10


def main(argv=None) -> dict:
    from mmmpc_tpu_torch.bench import BATCH, REFINE_CFG, build_problem_numpy
    from mmmpc_tpu_torch.dryrun_multiprocess import build_kernels_once
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.parallel import (
        gather_batch, global_data_mesh, host_local_batch, init_distributed,
        process_batch_slice, sharded_solve_fn,
    )
    from mmmpc_tpu_torch.utils.convert import params_from_numpy

    ap = argparse.ArgumentParser()
    ap.add_argument("--refined", action="store_true")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_multihost: no CUDA device")

    distributed = init_distributed()
    try:
        mesh = global_data_mesh()
        build_kernels_once(mesh)
        global_batch = BATCH * mesh.world_size
        mpc, x0_all, params_np = build_problem_numpy(global_batch)
        local, lo = process_batch_slice(global_batch)
        x0_b, U0_b = host_local_batch(
            mesh, (x0_all[lo:lo + local],
                   torch.zeros(local, mpc.N, mpc.NU)), torch.float32)
        params = params_from_numpy(params_np, mesh.device, torch.float32)
        impl = (mpc.batch_solve_refined_fn(REFINE_CFG) if args.refined
                else mpc.batch_solve_fn())
        run = sharded_solve_fn(mpc.solve_fn(), mesh, batch_impl=impl)

        counters = {"wholebody_fwd": wholebody_fwd.LAUNCHES,
                    "wholebody_bwd": wholebody_bwd.LAUNCHES}
        for c in counters.values():
            c.reset()
        res, stats = run(x0_b, U0_b, params)
        torch.cuda.synchronize()
        launches = {k: c.cuda for k, c in counters.items()}
        if mesh.world_size > 1:
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(REPS):
            res, stats = run(x0_b, U0_b, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        # each rank's launches a solve, converged count and worst violation
        per_rank = gather_batch(torch.tensor(
            [[*launches.values(), float(res.converged.sum()),
              float(res.max_violation.max())]], dtype=torch.float64,
            device=mesh.device), mesh).tolist()
        record = {
            "metric": "wholebody_qref_solves_per_s",
            "value": round(global_batch * REPS / dt, 1),
            "unit": "solves/s",
            "n_processes": mesh.world_size, "n_devices": mesh.world_size,
            "distributed": distributed, "global_batch": global_batch,
            "converged_frac": float(stats.n_converged) / float(stats.n_solved),
            "max_violation": float(stats.max_violation),
            "mean_cost": float(stats.mean_cost),
            "refined": args.refined, "backend": mesh.backend,
            "host_staged": mesh.host_staged,
            "device": torch.cuda.get_device_name(mesh.device),
            "batch_latency_s": dt / REPS,
            "launches_per_solve": {
                k: [int(r[i]) for r in per_rank]
                for i, k in enumerate(launches)},
            "rank_n_converged": [int(r[-2]) for r in per_rank],
            "rank_max_violation": [r[-1] for r in per_rank],
        }
        if mesh.rank == 0:
            print(json.dumps(record), flush=True)
        return record
    finally:
        if distributed:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

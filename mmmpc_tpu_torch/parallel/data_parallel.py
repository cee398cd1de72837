"""Batch statistics and the data-parallel scale-out (counterpart of
``mmmpc_tpu/parallel/data_parallel.py``).

Robots are independent, so the scaling dimension is the scenario batch: one
process per GPU (``torch.distributed``, ``parallel/multihost.py``), each
solving its own rows with the batched solver on its device, and the batch
statistics reduced between the processes by collectives on the device
(sums of the counts, the max of the violation, the mean of the per-shard
mean costs).  Tensor, pipeline and sequence parallelism are absent for the
JAX package's reason: at nx=9 / nu=5 / N<=20 one solve is far below one
SM's work.

The convention differs from JAX's.  One JAX process sees every device of
the mesh, so its sharded functions take and return global arrays.  A torch
rank owns one device: its sharded functions take the rank's local rows (from
``multihost.host_local_batch``) and return its local results, with the
statistics global; ``gather_batch`` assembles the global batch where a
caller needs it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class BatchStats(NamedTuple):
    """Statistics of one batched solve, as 0-d tensors on the solve's device
    (of the global batch once ``sharded_solve_fn`` reduced them)."""
    n_solved: torch.Tensor        # solves in the batch
    n_converged: torch.Tensor     # solves meeting the constraint tolerance
    max_violation: torch.Tensor   # worst hard-constraint violation anywhere
    mean_cost: torch.Tensor


class DataMesh(NamedTuple):
    """One rank's view of the 1-D data mesh: its rank, the world size, its
    device, the process group (None: the default group, or none at world
    size 1) and the group's backend (None without a group).
    ``host_staged``: the backend is gloo on a CUDA device, so collectives
    run on host copies of their (few) tensors."""
    rank: int
    world_size: int
    device: torch.device
    group: object = None
    backend: str | None = None

    @property
    def host_staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(device=None) -> DataMesh:
    """The data mesh of this process: the initialised group's rank, world
    size and backend on the rank's device (``device``, else the one
    ``multihost.init_distributed`` gave it), or world size 1 on ``device``
    (else the first CUDA device) when no group is initialised."""
    if not dist.is_initialized():
        return DataMesh(0, 1, torch.device("cuda" if device is None
                                           else device))
    if device is None:
        from mmmpc_tpu_torch.parallel.multihost import rank_device
        device = rank_device()
        if device is None:
            raise ValueError("make_mesh: a group made outside "
                             "init_distributed needs its rank's device")
    return DataMesh(dist.get_rank(), dist.get_world_size(),
                    torch.device(device), None, dist.get_backend())


def tree_map(fn, tree):
    """``fn`` over the leaves of nested tuples (named too), lists and dicts;
    None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of ``tree_map``'s kind, in its order."""
    out = []
    tree_map(out.append, tree)
    return out


def with_stats(run_b):
    """Wrap a batched solve ``(x0_b, U0_b, params) -> SolveResult`` so it
    returns ``(result, BatchStats)``."""
    def run(x0_b, U0_b, params):
        res = run_b(x0_b, U0_b, params)
        stats = BatchStats(
            n_solved=torch.tensor(float(x0_b.shape[0]), dtype=torch.float32,
                                  device=x0_b.device),
            n_converged=torch.sum(res.converged.to(torch.float32)),
            max_violation=torch.amax(res.max_violation),
            mean_cost=torch.mean(res.cost),
        )
        return res, stats

    return run


def batched_solve_fn(solve_fn):
    """A single-scenario solve ``solve_fn(x0, U0, params)`` run robot by
    robot over a batch with shared params, its results stacked:
    ``(x0_b, U0_b, params) -> (SolveResult, BatchStats)`` (the JAX
    function's vmap).  One batch-1 solve a robot: for tiny batches only
    (tests, the dry run); a batch solves with ``controller_batched_fn``."""
    def run_b(x0_b, U0_b, params):
        rows = [solve_fn(x0_b[i], U0_b[i], params)
                for i in range(x0_b.shape[0])]
        return type(rows[0])(*(torch.stack(f) for f in zip(*rows)))

    return with_stats(run_b)


def controller_batched_fn(controller):
    """A controller's batched solve with batch statistics:
    ``(x0_b, U0_b, params) -> (SolveResult, BatchStats)``."""
    return with_stats(controller.batch_solve_fn())


def _collective(mesh: DataMesh, t: torch.Tensor):
    """(the tensor a collective takes, a function back to ``t``'s device and
    dtype): a host copy where the mesh is ``host_staged``; bool as uint8."""
    dtype, dev = t.dtype, t.device
    c = t.to(torch.uint8) if dtype == torch.bool else t
    if mesh.host_staged:
        c = c.cpu()
    return c.contiguous(), lambda r: r.to(device=dev, dtype=dtype)


def reduce_stats(stats: BatchStats, mesh: DataMesh) -> BatchStats:
    """The statistics of the global batch from each rank's: n_solved and
    n_converged summed, max_violation the max, mean_cost the mean of the
    ranks' mean costs (sum, then divide: gloo has no average; every shard is
    the same size).  On the device under NCCL: nothing waits for it."""
    if mesh.world_size == 1:
        return stats
    sums, back = _collective(mesh, torch.stack(
        [stats.n_solved, stats.n_converged, stats.mean_cost]))
    worst, back_v = _collective(mesh, stats.max_violation)
    dist.all_reduce(sums, dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(worst, dist.ReduceOp.MAX, group=mesh.group)
    sums, worst = back(sums), back_v(worst)
    return BatchStats(n_solved=sums[0], n_converged=sums[1],
                      max_violation=worst,
                      mean_cost=sums[2] / mesh.world_size)


def gather_batch(tree, mesh: DataMesh):
    """Every rank's local rows of a tree of tensors (leading axis the local
    batch, the same on every rank) concatenated in rank order: the global
    batch, on every rank (``all_gather`` on dim 0; the JAX dry run's
    ``process_allgather``)."""
    if mesh.world_size == 1:
        return tree

    def gather(t):
        c, back = _collective(mesh, t)
        parts = [torch.empty_like(c) for _ in range(mesh.world_size)]
        dist.all_gather(parts, c, group=mesh.group)
        return back(torch.cat(parts))

    return tree_map(gather, tree)


def sharded_solve_fn(solve_fn, mesh: DataMesh, batch_impl=None):
    """The batched solve of this rank's rows with global statistics.

    Each rank solves its local rows (``x0_b`` (B_local, nx), ``U0_b``) with
    ``batch_impl`` (a controller's ``batch_solve_fn()`` or
    ``batch_solve_refined_fn(...)``), or, with None, ``solve_fn`` robot by
    robot (``batched_solve_fn``); then ``reduce_stats`` over the mesh.
    Returns ``(x0_b, U0_b, params) -> (local SolveResult, global
    BatchStats)``: unlike the JAX function, which takes and returns global
    arrays, the result stays on the rank (``gather_batch`` for the global
    one).  The refine stage ranks the worst robots of the batch it is
    given: sharded, each shard refines its own worst, so a sharded refined
    solve equals the refined solve of each shard's rows, not the unsharded
    one (at world size 1 the two are one).
    """
    run = (with_stats(batch_impl) if batch_impl is not None
           else batched_solve_fn(solve_fn))

    def run_sharded(x0_b, U0_b, params):
        res, stats = run(x0_b, U0_b, params)
        return res, reduce_stats(stats, mesh)

    return run_sharded


def sharded_task_loop_fn(run, mesh: DataMesh):
    """The fleet task loop of ``sim/batch_task_engine.py`` on this rank's
    robots.

    ``run(x_start_b, global_pose_target_b, carry0=None) -> (TaskRolloutLog,
    carry)``.  Robots are independent (state, phase, IK, warm starts are
    all per robot), so no collective runs inside a tick: each rank runs the
    loop on its local robots on its device, and its log and carry stay
    local.  The carry a segment returns continues the next segment on the
    same rank (the fleet's checkpoint, one file a rank); ``gather_batch``
    assembles a global log where a caller needs it.
    """
    def to_rank(t):
        return t.to(mesh.device) if torch.is_tensor(t) else t

    def run_sharded(x_start_b, global_pose_target_b, carry0=None,
                    tick_hook=None):
        return run(to_rank(x_start_b), to_rank(global_pose_target_b),
                   tree_map(to_rank, carry0), tick_hook=tick_hook)

    return run_sharded

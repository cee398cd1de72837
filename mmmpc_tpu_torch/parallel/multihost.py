"""Multi-process scale-out on ``torch.distributed`` (counterpart of
``mmmpc_tpu/parallel/multihost.py``).

One process per GPU, each owning one device and one slice of the global
scenario batch; the batch statistics ride collectives between them
(``parallel/data_parallel.py::sharded_solve_fn``).  The three pieces a
multi-process run needs:

1. ``init_distributed``: the process group, from explicit settings or from
   a launcher's environment (``torchrun``), or nothing for a single process;
2. ``global_data_mesh``: this rank's view of the 1-D data mesh;
3. ``host_local_batch`` / ``process_batch_slice``: each process feeds only
   its own rows of the global batch, so no process holds the whole fleet on
   its device.

Launch, one process per card of a host:

    torchrun --nproc_per_node=<cards> -m mmmpc_tpu_torch.bench_multihost

The JAX package's processes each see every device of the mesh and pass
global arrays; a torch rank sees its own device only, so the port's
functions take and return the rank's local rows (``data_parallel.py``).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from mmmpc_tpu_torch.parallel.data_parallel import (
    DataMesh, make_mesh, tree_map,
)

# A rank that dies leaves the others in a collective: the group gives up
# after this many seconds instead of holding the card.
GROUP_TIMEOUT_S = 60

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
_DEVICE = None          # this rank's device, once init_distributed ran


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None,
                     device=None) -> bool:
    """Initialise the default process group if a run is configured.

    Resolution order: the explicit arguments, then ``torchrun``'s
    environment (``MASTER_ADDR`` / ``MASTER_PORT`` -> ``tcp://addr:port``,
    ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the device).  With
    neither an init method nor a world size it returns False and does
    nothing (the single-process run), as the JAX function does.

    The rank's device is ``device``, else ``cuda:LOCAL_RANK`` (0 without
    the variable): it becomes the current CUDA device before the group is
    made.  ``backend=None`` picks ``nccl`` for a CUDA device and ``gloo``
    for the CPU; an explicit backend is used as given (NCCL refuses two
    ranks on one card: ranks that share a card take ``gloo``), and a
    backend that fails raises.  The group times out after
    ``GROUP_TIMEOUT_S`` seconds.  Returns True once the group is up.
    """
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and world_size is None:
        return False            # single-process run; nothing to do
    if init_method is None or world_size is None or rank is None:
        raise ValueError(
            f"init_distributed: init_method={init_method!r}, world_size="
            f"{world_size!r}, rank={rank!r}: give all three (or set "
            f"{', '.join(_ENV[:4])})")
    device = torch.device(device if device is not None else
                          f"cuda:{int(env.get('LOCAL_RANK', 0))}")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = dict(backend=backend, init_method=init_method,
              world_size=world_size, rank=rank,
              timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    global _DEVICE
    _DEVICE = device
    return True


def rank_device():
    """The device ``init_distributed`` gave this rank (None before)."""
    return _DEVICE


def global_data_mesh() -> DataMesh:
    """This rank's view of the 1-D data mesh over every process: its rank,
    the world size, its device and the group; one process on the first
    CUDA device when no group is initialised."""
    return make_mesh()


def host_local_batch(mesh: DataMesh, local_arrays, dtype=None):
    """This process's slice of the global batch (a tree of numpy arrays or
    tensors, leading axis the local batch) as tensors on the rank's device,
    in ``dtype`` if given.  The global batch is never built: each rank holds
    its own rows only (``gather_batch`` assembles results where a caller
    needs them)."""
    def make(a):
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        return t.to(device=mesh.device, dtype=dtype or t.dtype)
    return tree_map(make, local_arrays)


def process_batch_slice(global_batch: int) -> tuple[int, int]:
    """(local_batch, offset) of this process's slice of a global batch."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    assert global_batch % n == 0, (global_batch, n)
    local = global_batch // n
    return local, local * rank

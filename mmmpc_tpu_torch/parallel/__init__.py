from mmmpc_tpu_torch.parallel.data_parallel import (  # noqa: F401
    make_mesh, batched_solve_fn, controller_batched_fn, sharded_solve_fn,
    sharded_task_loop_fn, gather_batch, reduce_stats, with_stats,
    BatchStats, DataMesh,
)
from mmmpc_tpu_torch.parallel.multihost import (  # noqa: F401
    global_data_mesh, host_local_batch, init_distributed,
    process_batch_slice,
)

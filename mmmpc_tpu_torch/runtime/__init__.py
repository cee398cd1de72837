"""The closed loop (counterpart of ``mmmpc_tpu/runtime``): the task state
machine, the local references, metrics and checkpoints."""

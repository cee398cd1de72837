"""The simulated plant (counterpart of ``mmmpc_tpu/sim``)."""

"""The scipy oracles of the controllers' OCPs (counterpart of
``mmmpc_tpu/verify``)."""

from mmmpc_tpu_torch.verify.oracle import lbfgs_solve, scipy_solve  # noqa: F401

"""Batch statistics (counterpart of ``BatchStats``, ``_with_stats`` and
``controller_batched_fn`` in ``mmmpc_tpu/parallel/data_parallel.py``; the
sharded multi-device solves are not ported yet)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class BatchStats(NamedTuple):
    """Statistics of one batched solve, as 0-d tensors on the solve's device."""
    n_solved: torch.Tensor        # solves in the batch
    n_converged: torch.Tensor     # solves meeting the constraint tolerance
    max_violation: torch.Tensor   # worst hard-constraint violation anywhere
    mean_cost: torch.Tensor


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


def controller_batched_fn(controller):
    """A controller's batched solve with batch statistics:
    ``(x0_b, U0_b, params) -> (SolveResult, BatchStats)``."""
    return with_stats(controller.batch_solve_fn())

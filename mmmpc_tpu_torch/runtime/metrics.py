"""Structured per-tick metrics (a copy of ``mmmpc_tpu/runtime/metrics.py``,
which holds no JAX but whose package loads it).

Every control tick appends one record (cost, constraint violation, solver
convergence, wall-clock latency of the solve, task phase); the log dumps
JSON for offline analysis.  ``end_solve`` reads the controller's batch-free
``last_result``, whose fields are 0-d.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional


@dataclasses.dataclass
class TickRecord:
    step: int
    task_flag: str
    cost: float
    max_violation: float
    converged: bool
    solve_latency_s: float


class MetricsLog:
    def __init__(self):
        self.records: List[TickRecord] = []
        self._t0: Optional[float] = None

    def start_solve(self):
        self._t0 = time.perf_counter()

    def end_solve(self, step, task_flag, result):
        latency = time.perf_counter() - self._t0 if self._t0 else float("nan")
        self._t0 = None
        self.records.append(TickRecord(
            step=step, task_flag=task_flag,
            cost=float(result.cost),
            max_violation=float(result.max_violation),
            converged=bool(result.converged),
            solve_latency_s=latency))

    def summary(self):
        if not self.records:
            return {}
        lat = sorted(r.solve_latency_s for r in self.records)
        return {
            "ticks": len(self.records),
            "p50_latency_s": lat[len(lat) // 2],
            "p99_latency_s": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "max_violation": max(r.max_violation for r in self.records),
            "all_converged": all(r.converged for r in self.records),
        }

    def dump_json(self, path):
        with open(path, "w") as f:
            json.dump([dataclasses.asdict(r) for r in self.records], f)

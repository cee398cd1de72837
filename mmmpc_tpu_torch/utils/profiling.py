"""Tracing and profiling hooks (counterpart of
``mmmpc_tpu/utils/profiling.py``).

Thin wrappers over ``torch.profiler`` so solver stages show up as named
ranges in a trace (Chrome / Perfetto format), with an NVTX range beside each
on a CUDA machine, plus a wall-clock section timer for host-side phases.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named range in a trace: a ``torch.profiler.record_function`` (no
    cost but a branch when no profiler runs) and, where CUDA is available,
    an NVTX range of the same name."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with CPU activity, and CUDA activity where CUDA is
    available, and write it as a Chrome trace into ``logdir``
    (``trace.<pid>.<n>.json``; view with Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = sum(1 for f in os.listdir(logdir)
            if f.startswith(f"trace.{os.getpid()}."))
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace.{os.getpid()}.{n}.json"))


class SectionTimer:
    """Accumulating host-side wall-clock timer for named sections."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {k: {"total_s": v, "count": self.counts[k],
                    "mean_s": v / self.counts[k]}
                for k, v in sorted(self.totals.items())}

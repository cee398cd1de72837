#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``mmmpc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase (the record of a run)
    python3 chip_smoke.py --kernels   # phases 1-3b only: build and check
    python3 chip_smoke.py --kernel wholebody_bwd   # phases 1-2, then the
        # [kernel] check of one kind of KINDS alone (no peak sweep: bounds
        # at the published 67 TFLOP/s; fma_peak runs phase 2b)

Phases, each reported on its own lines; any failure exits nonzero:

1. device: requires CUDA; prints ``nvidia-smi`` name and power limit,
   ``torch.version.cuda`` and the nvcc version;
2. build: compiles every kernel of ``mmmpc_tpu_torch/csrc`` for sm_90a (one
   nvcc per source, all started together) and prints the build seconds and
   the ptxas register / spill report of every kernel instance;
2b. peak: the FFMA count of the FMA microkernel's SASS (``cuobjdump``),
   then the sweep of ``mmmpc_tpu_torch/roofline.py``: each configuration's
   float32 rate, the best configuration's second of back-to-back launches
   on the host's clock, the best of each accumulator count run on inputs
   that count its trips exactly and against ``plain_fma`` (rtol 1e-5,
   atol 1e-6) at its own grid and shortest trip count, then the measured
   peak, its share of what the SM clock allows (above 101% fails) and of
   the published 67 TFLOP/s, and ``nvidia-smi`` clocks / power;
3. kernels: each kernel against its plain PyTorch version on the card at the
   bench shape (N=20, B=8192, 3 step sizes) on seeded inputs, at the
   tolerances of ``tests/test_torch_kernels.py``,
   ``tests/test_torch_generic_kernels.py`` and
   ``tests/test_pallas_riccati.py``: the whole-body pair on the qref bench
   problem, the generic pair of each formulation (demo, base, arm,
   endpoint) on the rows of ``mmmpc_tpu_torch/bench_controllers.py``, the
   Riccati sweep on the expansion blocks of each of those inputs and on the
   random SPD blocks of the Pallas test; the kernel's device time per
   launch (launches replayed from a CUDA graph), the wall time per wrapper
   call and the plain version's (CUDA events), and the least time the card
   could take (bytes moved over 3.35 TB/s against operations over the
   published 67 TFLOP/s float32, and over the measured peak); kernels A,
   B, C (each formulation's), D.base, D.arm, D.endpoint and E (at (9, 5)
   on the qref blocks, at (4, 2) on the SPD blocks) also at the ragged
   batches 8191, 1000 and 1 against their plain versions, with their
   launch geometry (``[kernel-batch]``; E's with the blocks an SM holds);
   kernel E also at (nx, nu) = (4, 2), which the
   kernel library does not hold: the pair's own library built on its first
   call (``[build-pair]``: seconds, the pair's launches in that call; ptxas
   registers / spills), then against its plain version on the SPD blocks
   at 2e-4;
3b. cuda-tests: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
   tests/test_torch_cuda.py`` from the checkout's root, every kernel
   against its plain version on small inputs (not with ``--kernel``);
4. slice: the refined whole-body qref solve of ``bench.py`` at batch 8192
   (one warm-up solve with the kernel launch counters reset just before it,
   then 10 solves timed one by one): median and quartiles of the solve time,
   solves/s at the median, converged fraction, max violation, and each
   kernel's launches, which must equal the schedule's 58 + 36 iterations per
   solve; then one more solve under ``torch.profiler``: the device ops it
   ran, the device busy time (union of their intervals), the idle share of
   the median solve, and each fused kernel's calls and time, found by its
   name (``KERNEL_SYMBOLS``); a kernel whose calls there differ from its
   wrapper's launches in that solve fails the phase (so does every profiled
   phase below), unless another profile of the solve, up to five, counts
   them all (the profiler drops records of a long trace now and then);
4b. unfused: the same solve with ``use_fused_backward=False``: the AL
   expansion in plain PyTorch and the Riccati sweep kernel in place of the
   fused backward kernel, which must not launch; launches, timing (3
   solves), profile, convergence, and the gate of phase 6 against phase 4's
   fused solve;
5. scaling: the same timing and profile at batch 1024;
6. reference: the same solve at batch 64 on the card and, through the plain
   versions, on the CPU: relative mean cost within 5e-3, the same converged
   flags on at least 95% of the robots (|dU| is printed, not gated);
7. formulations: each generic row of ``bench_controllers`` (demo, base, arm,
   endpoint) at batch 8192 through ``controller_batched_fn``: one warm-up
   solve with the counters reset just before it, in which each generic
   kernel must launch once per iteration of the row's schedule and its plain
   version never; timing and profile as in phase 4; converged fraction (at
   least 0.99) and max violation;
7b. formulations-unfused: each of those rows with ``use_fused_backward=
   False``: its Riccati sweep instance and its line search launch once per
   iteration, its fused backward never; timing (3 solves), profile,
   convergence, and the gate of phase 6 against the row's fused solve of
   phase 7;
8. formulations-reference: each of those rows at batch 64 on the card and,
   through the plain versions, on the CPU, with the gates of phase 6.

Each phase from 2b on prints its wall seconds (``[phase]``), and each
profiled solve the seconds the profile took.  The last two lines are a
JSON record of the kernels (E at (4, 2), on no solve path, with its
launches in its own check) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 8192
SMALL_BATCH = 1024
REPS = 10
# the unfused solves are host-bound at 0.1-1.6 s each: fewer timed solves
UNFUSED_REPS = 3
# profiles of one solve, at most, until the kernels' calls in it equal
# their launches (report_timing)
PROFILE_ATTEMPTS = 5
SEED = 0
# published peaks of one H100 SXM: HBM bytes/s, float32 FLOP/s (CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# the generic formulations: bench_controllers row -> formulation
ROWS = {"demo_1d": "demo", "base_only": "base", "arm_only": "arm",
        "wholebody_endpoint": "endpoint"}
GENERIC = tuple(ROWS.values())
# the formulations whose line search (C) and fused backward (D) run on the
# team kernels of generic_fwd.cuh / generic_bwd.cuh; the others (C.demo,
# D.demo, D.base) run one thread a candidate or a scenario
FWD_TEAMS = ("base", "arm", "endpoint")
BWD_TEAMS = ("arm", "endpoint")
# (nx, nu) of each generic formulation: its Riccati sweep instance
DIMS = {"demo": (2, 1), "base": (6, 2), "arm": (3, 3), "endpoint": (9, 5)}
# device-kernel names (as the profiler reports them) of each wrapper; a
# profiled solve whose count of a kernel differs from its wrapper's
# launches fails (report_timing), so a renamed kernel cannot read 0 calls
KERNEL_SYMBOLS = {"wholebody_fwd": "wb::fwd_kernel",
                  "wholebody_bwd": "wb::bwd_kernel",
                  **{f"generic_{d}.{f}":
                     f"gen::generic_{d}_kernel<gen::{f.capitalize()}>"
                     for f in GENERIC for d in ("fwd", "bwd")},
                  **{f"generic_fwd.{f}":
                     f"gen::generic_fwd_team_kernel<gen::{f.capitalize()}>"
                     for f in FWD_TEAMS},
                  **{f"generic_bwd.{f}":
                     f"gen::generic_bwd_team_kernel<gen::{f.capitalize()}>"
                     for f in BWD_TEAMS},
                  **{f"riccati_bwd.{nx}x{nu}":
                     f"ric::riccati_team_kernel<{nx}, {nu}>"
                     for nx, nu in DIMS.values()}}
# each wrapper kind: (its CUDA source, the TPU kernel it replaces)
KINDS = {"wholebody_fwd": ("wholebody_fwd.cu",
                           "mmmpc_tpu/ops/wholebody_fwd.py:237"),
         "wholebody_bwd": ("wholebody_bwd.cu",
                           "mmmpc_tpu/ops/wholebody_bwd.py:272"),
         "generic_fwd": ("generic_fwd.cuh", "mmmpc_tpu/ops/generic_fwd.py:261"),
         "generic_bwd": ("generic_bwd.cuh", "mmmpc_tpu/ops/generic_bwd.py:177"),
         "riccati_bwd": ("riccati.cu", "mmmpc_tpu/ops/riccati.py:152"),
         "fma_peak": ("fma_peak.cu", "scripts/roofline.py:153")}


def _line(tag, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def _nvcc_version():
    from mmmpc_tpu_torch.ops._cuda import _nvcc
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def _time_ms(fn, reps):
    """Mean milliseconds per call on the card (CUDA events, after warm-up)."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, reps):
    """Mean device milliseconds per launch of the kernel behind ``fn``:
    ``reps`` calls captured in a CUDA graph, replayed after warm-up and
    timed with CUDA events.  Back-to-back wrapper calls would time the
    wrapper's host work instead wherever that outlasts the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return _time_ms(graph.replay, 5) / reps


def _close(name, got, ref, rtol, atol):
    """Max abs error; raises if any entry is outside atol + rtol |ref| or is
    not finite."""
    got, ref = got.double(), ref.double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output not finite")
    err = (got - ref).abs()
    bad = int((err > atol + rtol * ref.abs()).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} entries outside rtol={rtol} "
                             f"atol={atol} (max abs err {err.max().item():.3e})")
    return err.max().item()


def _bound(inputs, outputs, flops, peak):
    """The least time the card could take: each input read once and each
    output written once over the HBM rate, against ``flops`` over the
    published float32 rate (``bound_ms``, ``bound_by``) and over the
    measured peak ``peak`` (FLOP/s; ``bound_ms_measured_peak``, None
    without a measured peak)."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_measured_peak": (None if peak is None else
                                       1e3 * max(t_bytes, flops / peak)),
            "bytes": nbytes, "flops": flops}


def fwd_flops(N, B, n_alpha, nx, nu, nc, nct):
    """Float operations of a fused rollout + line search that do not depend
    on the formulation: the feedback K (x - X), U + alpha kff, and the PHR
    sums of the stage and terminal rows.  The formulation's cost, rows and
    dynamics are left out, so this undercounts and the bound stays a lower
    bound."""
    per_stage = 2 * nu * nx + nx + 2 * nu + 5 * nc + 1
    return n_alpha * B * (N * per_stage + 5 * nct)


def bwd_flops(N, B, nx, nu):
    """Float operations of a fused backward sweep that do not depend on the
    formulation: per stage the Cholesky of Quu + reg I, the 1 + nx triangular
    solve pairs, and the value update with Vxx symmetrised.  The AL
    expansion and the sparse Q-block products are left out (a lower bound,
    as ``fwd_flops``)."""
    per_stage = (2 * nu ** 3 // 3 + 2 * nu * nu * (1 + nx) + 2 * nu * nu
                 + 4 * nu * nx + 2 * nu * nu * nx + 4 * nu * nx * (nx + 1))
    return N * B * per_stage


def ric_flops(N, B, nx, nu):
    """Float operations of the Riccati sweep on precomputed blocks: those of
    ``bwd_flops`` plus the dense Q-block products through A and B
    (A^T Vx, B^T Vx, Vxx B, B^T (Vxx B), Vxx A, B^T (Vxx A), A^T (Vxx A)) and
    the additions of the stage blocks: ~8.5 kFLOP per (9, 5) stage."""
    dense = (2 * nx * nx + 2 * nx * nu + 2 * nx * nx * nu + 2 * nu * nu * nx
             + 2 * nx ** 3 + 2 * nu * nx * nx + 2 * nx ** 3)
    adds = nx + nu + nx * nx + nu * nu + nu * nx
    return bwd_flops(N, B, nx, nu) + N * B * (dense + adds)


def check_pair(name, fwd, bwd, fargs, bargs, counts, bwd_check, peak,
               kinds):
    """One fused pair against its plain versions on the same inputs: the
    forward pass at X / U atol 2e-5 and cost rtol = atol = 2e-3 (float32
    op-order differences, as the JAX kernel tests allow), the backward
    pass by ``bwd_check(got, ref)`` -> max abs error.  Then each kernel's
    device time per launch (``ms``), the wall time per wrapper call on
    CUDA events (``call_ms``), the plain version's (``plain_ms``), and the
    bound.  ``name`` = (forward, backward) wrapper names; ``counts`` =
    (N, B, n_alpha, nx, nu, nc, nct); only the halves whose kind (the name
    up to its first dot) is in ``kinds`` run."""
    out = {}
    if name[0].split(".")[0] in kinds:
        out.update(_check_fwd(name[0], fwd, fargs, counts, peak))
    if name[1].split(".")[0] in kinds:
        out.update(_check_bwd(name[1], bwd, bargs, counts, bwd_check, peak))
    return out


def _fwd_errors(name, got, ref):
    """Max abs errors (X / U, cost) of a forward pass against its plain
    version, held at X / U atol 2e-5 and cost rtol = atol 2e-3."""
    return (max(_close(f"{name} Xc", got[0], ref[0], 0.0, 2e-5),
                _close(f"{name} Uc", got[1], ref[1], 0.0, 2e-5),
                _close(f"{name} xlast", got[2], ref[2], 0.0, 2e-5)),
            _close(f"{name} cost", got[3], ref[3], 2e-3, 2e-3))


def _check_fwd(name, fwd, fargs, counts, peak):
    """The forward half of ``check_pair``."""
    N, B, na, nx, nu, nc, nct = counts
    out = {}
    got, ref = fwd.cuda(*fargs), fwd.plain(*fargs)
    torch.cuda.synchronize()
    err, err_cost = _fwd_errors(name, got, ref)
    out[name] = dict(
        max_abs_err=max(err, err_cost),
        ms=_kernel_ms(lambda: fwd.cuda(*fargs), 20),
        call_ms=_time_ms(lambda: fwd.cuda(*fargs), 20),
        plain_ms=_time_ms(lambda: fwd.plain(*fargs), 3),
        **_bound([fwd.flat, *(a for a in fargs if torch.is_tensor(a))], got,
                 fwd_flops(N, B, na, nx, nu, nc, nct), peak))
    _line("kernel", name=name, max_abs_err_XU=f"{err:.3e}",
          max_abs_err_cost=f"{err_cost:.3e}", **_fmt(out[name]))
    return out


def _check_bwd(name, bwd, bargs, counts, bwd_check, peak):
    """The backward half of ``check_pair``."""
    N, B, na, nx, nu, nc, nct = counts
    out = {}
    got, ref = bwd.cuda(*bargs), bwd.plain(*bargs)
    torch.cuda.synchronize()
    err = bwd_check(got, ref)
    out[name] = dict(
        max_abs_err=err,
        ms=_kernel_ms(lambda: bwd.cuda(*bargs), 20),
        call_ms=_time_ms(lambda: bwd.cuda(*bargs), 20),
        plain_ms=_time_ms(lambda: bwd.plain(*bargs), 3),
        **_bound([bwd.flat, *(a for a in bargs if torch.is_tensor(a))], got,
                 bwd_flops(N, B, nx, nu), peak))
    _line("kernel", name=name, **_fmt(out[name]))
    return out


def _fmt(d):
    return {k: (f"{v:.4g}" if isinstance(v, float) else v)
            for k, v in d.items()}


def _check_f64(tag, got, ref, truth):
    """The arm's gains (its 1e6 wedge slack makes the solve ill-conditioned
    in float32; tests/test_generic_bwd.py): p99 of |kernel - plain| below
    5e-4, and the kernel's error against the plain version in float64 at
    most twice the plain float32 version's (1e-3 floor, 0.15 ceiling).
    Returns the max |kernel - plain|."""
    err = 0.0
    for k, g, r, tr in zip(("kff", "K"), got, ref, truth):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{tag} {k}: not finite")
        p99 = torch.quantile((g - r).abs().double().flatten(), 0.99).item()
        e_k = (g.double() - tr).abs().max().item()
        e_p = (r.double() - tr).abs().max().item()
        _line("kernel-arm-f64", name=tag, tensor=k,
              p99_kernel_vs_plain=f"{p99:.3e}", kernel_err_f64=f"{e_k:.3e}",
              plain_f32_err_f64=f"{e_p:.3e}")
        if not (p99 < 5e-4 and e_k <= max(2.0 * e_p, 1e-3) and e_k < 0.15):
            raise AssertionError(f"{tag} {k}: p99 {p99:.3e}, error "
                                 f"{e_k:.3e} vs {e_p:.3e}")
        err = max(err, (g - r).abs().max().item())
    return err


def _gains_check(tag, rtol, atol):
    """check(got, ref, args) of (kff, K) at rtol / atol."""
    return lambda got, ref, args: max(
        _close(f"{tag} {k}", g, r, rtol, atol)
        for k, g, r in zip(("kff", "K"), got, ref))


def check_riccati(blocks_of, blocks, reg, check, peak, timed=True):
    """Phase 3, kernel E on ``blocks`` (the sweep's nine block arguments)
    against ``plain_riccati_bm`` on the same blocks, held by
    ``check(got, ref, args)`` -> max abs error; with ``timed``, its device
    ms, call ms, plain ms and bound as ``check_pair``."""
    from mmmpc_tpu_torch.ops.riccati import (
        launch_geometry, plain_riccati_bm, riccati_backward_bm,
    )
    N, nx, B = blocks[0].shape
    nu = blocks[1].shape[1]
    name = f"riccati_bwd.{nx}x{nu}"
    args = (*blocks, reg)
    got, ref = riccati_backward_bm(*args), plain_riccati_bm(*args)
    torch.cuda.synchronize()
    out = dict(max_abs_err=check(got, ref, args))
    if timed:
        out.update(ms=_kernel_ms(lambda: riccati_backward_bm(*args), 20),
                   call_ms=_time_ms(lambda: riccati_backward_bm(*args), 20),
                   plain_ms=_time_ms(lambda: plain_riccati_bm(*args), 3),
                   **_bound(args, got, ric_flops(N, B, nx, nu), peak))
    _line("kernel", name=name, inputs=blocks_of, N=N, B=B, **_fmt(out),
          **launch_geometry(nx, nu, B))
    return out


def check_batches(name, cuda, plain, args, err, geometry, **kv):
    """Phase 3, a kernel beyond the bench shape: ``cuda`` against ``plain``
    on the first ``n`` scenarios of the batch-last ``args`` at the ragged
    batches 8191, 1000 and 1, held by ``err(got, ref, args)`` -> max abs
    error, with the launch geometry ``geometry(n)`` that the library
    reports."""
    for n in (8191, 1000, 1):
        a = tuple(x[..., :n].contiguous() if torch.is_tensor(x) else x
                  for x in args)
        got, ref = cuda(*a), plain(*a)
        torch.cuda.synchronize()
        _line("kernel-batch", name=name, **kv, B=n,
              max_abs_err=f"{err(got, ref, a):.4g}", **geometry(n))


def _riccati_batches(inputs, blocks, reg, check):
    """``check_batches`` of kernel E on ``blocks`` and ``reg``."""
    from mmmpc_tpu_torch.ops.riccati import (
        launch_geometry, plain_riccati_bm, riccati_backward_bm,
    )
    nx, nu = blocks[0].shape[1], blocks[1].shape[1]
    check_batches(f"riccati_bwd.{nx}x{nu}", riccati_backward_bm,
                  plain_riccati_bm, (*blocks, reg), check,
                  lambda n: launch_geometry(nx, nu, n), inputs=inputs)


def _test_problems_path():
    """Make tests/torch_problems.py importable as ``torch_problems``, by
    its directory: the name ``tests`` may belong to an installed package."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.append(tests)


def spd_blocks(device, B=1024, N=4, nx=9, nu=5):
    """The random SPD blocks of tests/test_pallas_riccati.py (seed 3, its
    batch and horizon; tests/torch_problems.py), batch-last on ``device``."""
    _test_problems_path()
    from torch_problems import batch_last, spd_blocks as blocks
    return tuple(batch_last(a, device) for a in blocks(nx, nu, B, N))


def check_new_pair(device, peak, dims=(4, 2)):
    """Phase 3, kernel E at a pair the kernel library does not hold: one
    call builds the pair's own library (its seconds and ptxas registers /
    spills) and launches it once on the card (the pair's counter), then the
    sweep against its plain version on the Pallas test's SPD blocks at
    rtol = atol = 2e-4, timed as ``check_riccati``."""
    from mmmpc_tpu_torch.ops import riccati
    from mmmpc_tpu_torch.ops._cuda import RICCATI
    nx, nu = dims
    name = f"riccati_bwd.{nx}x{nu}"
    blocks = spd_blocks(device, nx=nx, nu=nu)
    reg = torch.full((1024,), 1e-6, device=device)
    riccati.LAUNCHES[dims].reset()
    riccati.riccati_backward_bm(*blocks, reg)
    torch.cuda.synchronize()
    c = riccati.LAUNCHES[dims]
    launches = c.cuda
    if (launches, c.plain) != (1, 0):
        raise AssertionError(f"{name}: {launches} launches and {c.plain} "
                             f"plain calls in one call on the card, "
                             f"expected 1, 0")
    info = RICCATI.info[dims]
    _line("build-pair", name=name, seconds=f"{info.seconds:.1f}",
          library=info.path.name, launches=launches)
    for ln in info.log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("[ptxas] " + ln.strip(), flush=True)
    check = _gains_check(f"{name} spd", 2e-4, 2e-4)
    out = check_riccati("spd", blocks, reg, check, peak)
    _riccati_batches("spd", spd_blocks(device, B=BATCH, nx=nx, nu=nu),
                     torch.full((BATCH,), 1e-6, device=device), check)
    return dict(out, launches=launches)


def check_wholebody(mpc, x0, params, cfg, device, peak, kinds):
    """Phase 3, kernels A and B on the qref bench problem (B also by
    ``check_batches``), E on the expansion blocks of B's inputs and on
    the random SPD blocks of the Pallas test; the kernels whose kind is in
    ``kinds``."""
    from mmmpc_tpu_torch.ops._cuda import LIBRARY
    from mmmpc_tpu_torch.ops.wholebody_bwd import (
        launch_geometry as bwd_geometry,
    )
    from mmmpc_tpu_torch.ops.wholebody_fwd import (
        launch_geometry as fwd_geometry,
    )
    from mmmpc_tpu_torch.solver.al_ilqr import (
        rollout, stage_al_blocks, terminal_al_blocks,
    )
    rng = np.random.default_rng(SEED)
    N, B = mpc.N, x0.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    X, U = rollout(mpc.ocp, x0.T, t(0.1 * rng.standard_normal((N, 5, B))),
                   params)
    kff = t(0.05 * rng.standard_normal((N, 5, B)))
    K = t(0.05 * rng.standard_normal((N, 5, 9, B)))
    lam = t(0.5 * np.abs(rng.standard_normal((N, 28, B))))
    lamt = t(0.5 * np.abs(rng.standard_normal((18, B))))
    lame = t(0.1 * rng.standard_normal((2, B)))
    reg = torch.full((B,), 1e-6, device=device)
    fwd = mpc.ocp.lanes_fwd_factory(cfg, params)
    bwd = mpc.ocp.lanes_bwd_factory(cfg, params)

    def bwd_check(got, ref):
        # rtol = atol = 5e-3: op-order differences amplified through the
        # Cholesky on gains of magnitude ~10-100 (tests/test_fused_bwd.py)
        return max(_close("wholebody_bwd kff", got[0], ref[0], 5e-3, 5e-3),
                   _close("wholebody_bwd K", got[1], ref[1], 5e-3, 5e-3))

    fargs = (X[:-1], U, kff, K, lam, lamt, lame, 10.0)
    bargs = (X, U, lam, lamt, lame, 10.0, reg)
    out = check_pair(("wholebody_fwd", "wholebody_bwd"), fwd, bwd, fargs,
                     bargs, (N, B, cfg.n_alpha, 9, 5, 28, 18), bwd_check,
                     peak, kinds)
    if "wholebody_fwd" in kinds:
        check_batches("wholebody_fwd", fwd.cuda, fwd.plain, fargs,
                      lambda g, r, a: max(_fwd_errors("wholebody_fwd", g, r)),
                      lambda n: fwd_geometry(LIBRARY.get(), fwd.N, fwd.n_obs,
                                             fwd.n_hp, len(fwd.alphas), n))
    if "wholebody_bwd" in kinds:
        check_batches("wholebody_bwd", bwd.cuda, bwd.plain, bargs,
                      lambda g, r, a: bwd_check(g, r),
                      lambda n: bwd_geometry(LIBRARY.get(), bwd.N, bwd.n_obs,
                                             bwd.n_hp, n))
    if "riccati_bwd" not in kinds:
        return out
    # E on the same inputs: rtol = atol = 5e-3 as B
    inv = 1.0 / cfg.cost_scale
    blocks = (*stage_al_blocks(mpc.ocp, params, inv, X[:-1], U, lam, 10.0),
              *terminal_al_blocks(mpc.ocp, params, inv, X[-1], lamt, lame,
                                  10.0))
    check = _gains_check("riccati_bwd.9x5", 5e-3, 5e-3)
    out["riccati_bwd.9x5"] = check_riccati("qref", blocks, reg, check, peak)
    _riccati_batches("qref", blocks, reg, check)
    check_riccati("spd", spd_blocks(device),
                  torch.full((1024,), 1e-6, device=device),
                  _gains_check("riccati_bwd.9x5 spd", 2e-4, 2e-4), peak,
                  timed=False)
    out["riccati_bwd.4x2"] = check_new_pair(device, peak)
    return out


def check_generic(device, peak, kinds):
    """Phase 3, kernels C and D of each formulation on its bench row, and E
    on the expansion blocks of D's inputs; the kernels whose kind is in
    ``kinds``."""
    from mmmpc_tpu_torch.bench_controllers import problems
    from mmmpc_tpu_torch.ops._cuda import LIBRARY
    from mmmpc_tpu_torch.ops.generic_bwd import (
        launch_geometry as gen_bwd_geometry, plain_bwd,
    )
    from mmmpc_tpu_torch.ops.generic_fwd import (
        launch_geometry as gen_fwd_geometry,
    )
    from mmmpc_tpu_torch.ops.riccati import plain_riccati_bm
    from mmmpc_tpu_torch.solver.al_ilqr import (
        rollout, stage_al_blocks, terminal_al_blocks,
    )
    # gains tolerance (atol) of each generic backward kernel, rtol 1e-4; the
    # arm is held in the p99 / float64 form
    _test_problems_path()
    from torch_problems import BWD_ATOL
    out = {}
    for row, mpc, x0, _, params in problems(BATCH, device):
        if row not in ROWS:
            continue
        f = ROWS[row]
        rng = np.random.default_rng(SEED)
        N, B, nx, nu, cfg = mpc.N, BATCH, mpc.NX, mpc.NU, mpc.solver_config
        fwd = mpc.ocp.lanes_fwd_factory(cfg, params)
        bwd = mpc.ocp.lanes_bwd_factory(cfg, params)
        nc, nct = fwd.form.nc, fwd.form.nct

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        X, U = rollout(mpc.ocp, x0.T,
                       t(0.3 * rng.standard_normal((N, nu, B))), params)
        lame = t(np.zeros((0, B)))
        fargs = (X[:-1], U, t(0.05 * rng.standard_normal((N, nu, B))),
                 t(0.05 * rng.standard_normal((N, nu, nx, B))),
                 t(np.abs(rng.standard_normal((N, nc, B)))),
                 t(np.abs(rng.standard_normal((nct, B)))), lame, 10.0)
        bargs = (X, U, t(0.3 * np.abs(rng.standard_normal((N, nc, B)))),
                 t(0.3 * np.abs(rng.standard_normal((nct, B)))), lame, 10.0,
                 torch.full((B,), 1e-6, device=device))

        def bwd_check(got, ref, args, f=f, bwd=bwd, mpc=mpc, params=params):
            if f != "arm":
                return _gains_check(f"generic_bwd.{f}", 1e-4,
                                    BWD_ATOL[f])(got, ref, args)
            truth = plain_bwd(mpc.ocp, {k: v.double()
                                        for k, v in params.items()},
                              bwd.inv_scale,
                              *(a.double() if torch.is_tensor(a) else a
                                for a in args))
            return _check_f64("generic_bwd.arm", got, ref, truth)

        out.update(check_pair((f"generic_fwd.{f}", f"generic_bwd.{f}"), fwd,
                              bwd, fargs, bargs,
                              (N, B, cfg.n_alpha, nx, nu, nc, nct),
                              lambda g, r, bargs=bargs, check=bwd_check:
                              check(g, r, bargs), peak, kinds))
        form = bwd.form
        # the redesigned kernels at ragged batches (D.base: its stage
        # buffer; every C)
        if f in (*BWD_TEAMS, "base") and "generic_bwd" in kinds:
            check_batches(
                f"generic_bwd.{f}", bwd.cuda, bwd.plain, bargs, bwd_check,
                lambda n, f=f, form=form: gen_bwd_geometry(
                    LIBRARY.get(), f, N, form.n_obs, form.n_hp, n))
        if "generic_fwd" in kinds:
            check_batches(
                f"generic_fwd.{f}", fwd.cuda, fwd.plain, fargs,
                lambda g, r, a, f=f: max(_fwd_errors(f"generic_fwd.{f}", g,
                                                     r)),
                lambda n, f=f, form=form: gen_fwd_geometry(
                    LIBRARY.get(), f, N, form.n_obs, form.n_hp,
                    len(fwd.alphas), n))
        if "riccati_bwd" not in kinds:
            continue

        # E on the expansion blocks of D's inputs, at D's tolerances; the
        # arm's truth is the plain sweep in float64 on the same blocks
        name = f"riccati_bwd.{nx}x{nu}"
        if f == "arm":
            def ric_check(got, ref, args):
                return _check_f64(name, got, ref, plain_riccati_bm(
                    *(a.double() for a in args)))
        else:
            ric_check = _gains_check(name, 1e-4, BWD_ATOL[f])
        X, U, lam, lamt, lame, mu, reg = bargs
        ric = check_riccati(
            row, (*stage_al_blocks(mpc.ocp, params, bwd.inv_scale, X[:-1], U,
                                   lam, mu),
                  *terminal_al_blocks(mpc.ocp, params, bwd.inv_scale, X[-1],
                                      lamt, lame, mu)),
            reg, ric_check, peak)
        if f != "endpoint":          # (9, 5): the record keeps qref's blocks
            out[name] = ric
    return out


def time_solves(run, args, reps):
    """Seconds of each of ``reps`` solves, each synchronised."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return np.array(ts)


def profile_solve(run, args, names):
    """One solve under torch.profiler: (device ops, busy ms as the union of
    their intervals, {kernel: (calls, ms)} of the fused kernels ``names``),
    or None when the profiler saw no device activity.  Device activity
    only: with the host's ops recorded as well, the profile of one unfused
    solve (~73,000 device ops) took 40-48 s on an H100 host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(*args)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, end = 0.0, -np.inf
    for t0, t1, _ in spans:             # union of intervals, in us
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    ours = {}
    for name in names:
        d = [t1 - t0 for t0, t1, n in spans if KERNEL_SYMBOLS[name] in n]
        ours[name] = (len(d), sum(d) / 1e3)
    return len(spans), busy / 1e3, ours


def report_timing(tag, run, args, batch, counters, reps=REPS, **kv):
    """Time ``reps`` solves and profile one more; print both.  The profile
    must count, for each kernel of ``counters`` ({name: launch counter}),
    the calls its wrapper launched in the profiled solve: a kernel renamed
    away from ``KERNEL_SYMBOLS`` would read 0.  The profiler drops records
    of a long trace now and then (an unfused qref solve runs some 73,000
    device ops), so a solve whose counts differ is profiled again, up to
    ``PROFILE_ATTEMPTS`` times, and the phase fails only if every profile
    differs.  Returns the median solve seconds and the solves run here
    (``reps`` timed, one a profile)."""
    ts = time_solves(run, args, reps)
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    _line(tag, **kv, batch=batch, reps=reps, solve_s_median=f"{med:.4f}",
          solve_s_q1=f"{q1:.4f}", solve_s_q3=f"{q3:.4f}",
          solves_per_s_median=f"{batch / med:.1f}",
          solve_s=",".join(f"{t:.4f}" for t in ts))
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        t0 = time.perf_counter()
        before = {name: c.cuda for name, c in counters.items()}
        prof = profile_solve(run, args, counters)
        profile_s = f"{time.perf_counter() - t0:.1f}"
        if prof is None:
            _line(tag + "-profile", **kv, batch=batch, device_ops=(
                "not measured (the profiler saw no device activity)"))
            return med, reps + attempt
        n_ops, busy_ms, ours = prof
        differ = {name: (ours[name][0], c.cuda - before[name])
                  for name, c in counters.items()
                  if ours[name][0] != c.cuda - before[name]}
        if not differ:
            break
        _line(tag + "-profile-retry", **kv, attempt=attempt, device_ops=n_ops,
              **{f"{k}_calls_of_launches": f"{v[0]}/{v[1]}"
                 for k, v in differ.items()})
    else:
        raise AssertionError(
            f"{tag} {kv}: in each of {PROFILE_ATTEMPTS} profiles the calls of "
            f"{', '.join(repr(KERNEL_SYMBOLS[k]) for k in differ)} differ from "
            f"their wrappers' launches (last: {differ})")
    _line(tag + "-profile", **kv, batch=batch, profile_s=profile_s,
          attempts=attempt, device_ops=n_ops,
          device_busy_ms=f"{busy_ms:.3f}",
          idle_share_of_median_solve=f"{1 - busy_ms / (1e3 * med):.3f}",
          **{f"{k}_calls": v[0] for k, v in ours.items()},
          **{f"{k}_ms": f"{v[1]:.3f}" for k, v in ours.items()})
    return med, reps + attempt


def check_result(res, mpc, batch, device):
    """Finite results of the expected shapes, inputs inside the clamp box."""
    N, nx, nu = mpc.N, mpc.NX, mpc.NU
    shapes = {"X": (batch, N + 1, nx), "U": (batch, N, nu), "cost": (batch,),
              "max_violation": (batch,)}
    for k, shp in shapes.items():
        v = getattr(res, k)
        if tuple(v.shape) != shp:
            raise AssertionError(f"result {k}: shape {tuple(v.shape)} != {shp}")
        if not torch.isfinite(v).all():
            raise AssertionError(f"result {k}: non-finite values")
    lo = torch.as_tensor(mpc.ocp.u_lower, dtype=res.U.dtype, device=device)
    hi = torch.as_tensor(mpc.ocp.u_upper, dtype=res.U.dtype, device=device)
    if ((res.U < lo) | (res.U > hi)).any():
        raise AssertionError("inputs outside the clamped input box")


def count_launches(counters, per_solve, solves, absent=None):
    """{kernel: launches}; raises unless each kernel of ``counters``
    launched ``per_solve`` times in each of ``solves`` solves, each kernel
    of ``absent`` never, and no plain version ran."""
    for name, c in counters.items():
        if c.cuda != per_solve * solves or c.plain:
            raise AssertionError(f"{name}: {c.cuda} launches and {c.plain} "
                                 f"plain calls in {solves} solves, expected "
                                 f"{per_solve * solves} and 0")
    for name, c in (absent or {}).items():
        if c.cuda or c.plain:
            raise AssertionError(f"{name}: {c.cuda} launches and {c.plain} "
                                 f"plain calls, expected none")
    return {name: c.cuda for name, c in counters.items()}


def run_slice(device):
    """Phase 4: the refined solve at the bench batch through the kernels."""
    from mmmpc_tpu_torch.bench import REFINE_CFG, SOLVER_CFG, build_problem
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.parallel.data_parallel import with_stats
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    mpc, x0, U0, params = build_problem(BATCH, device)
    run = with_stats(mpc.batch_solve_refined_fn(REFINE_CFG))
    per_solve = iteration_count(SOLVER_CFG) + iteration_count(REFINE_CFG)
    counters = {"wholebody_fwd": wholebody_fwd.LAUNCHES,
                "wholebody_bwd": wholebody_bwd.LAUNCHES}
    for c in counters.values():
        c.reset()
    res, stats = run(x0, U0, params)
    torch.cuda.synchronize()
    launches = count_launches(counters, per_solve, 1)

    med, solves = report_timing("slice-timing", run, (x0, U0, params),
                                BATCH, counters)
    count_launches(counters, per_solve, 1 + solves)
    check_result(res, mpc, BATCH, device)
    conv = float(stats.n_converged) / float(stats.n_solved)
    maxv = float(stats.max_violation)
    _line("slice", batch=BATCH, solves_per_s_median=f"{BATCH / med:.1f}",
          batch_latency_s_median=f"{med:.4f}", converged_frac=f"{conv:.6f}",
          max_violation=f"{maxv:.3e}",
          mean_cost=f"{float(stats.mean_cost):.4f}",
          launches_per_solve=per_solve,
          **{f"launches_{k}": v for k, v in launches.items()})
    if conv < 0.99:
        raise AssertionError(f"converged_frac {conv} < 0.99")
    _line("bar", row="wholebody_qref_refined", converged_frac_is_1=conv == 1.0,
          max_violation_below_1e_3=maxv < 1e-3, met=conv == 1.0 and maxv < 1e-3)
    return launches, (res, stats)


def run_unfused(device, fused):
    """Phase 4b: the refined solve at the bench batch with the unfused
    backward (AL expansion in plain torch + the Riccati sweep kernel),
    gated against ``fused``, the (result, stats) of phase 4."""
    from mmmpc_tpu_torch.bench import REFINE_CFG, SOLVER_CFG, build_problem
    from mmmpc_tpu_torch.ops import riccati, wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.parallel.data_parallel import with_stats
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    cfg = dataclasses.replace(SOLVER_CFG, use_fused_backward=False)
    refine_cfg = dataclasses.replace(REFINE_CFG, use_fused_backward=False)
    mpc, x0, U0, params = build_problem(BATCH, device, cfg)
    run = with_stats(mpc.batch_solve_refined_fn(refine_cfg))
    per_solve = iteration_count(cfg) + iteration_count(refine_cfg)
    counters = {"riccati_bwd.9x5": riccati.LAUNCHES[(9, 5)],
                "wholebody_fwd": wholebody_fwd.LAUNCHES}
    absent = {"wholebody_bwd": wholebody_bwd.LAUNCHES}
    for c in (*counters.values(), *absent.values()):
        c.reset()
    res, stats = run(x0, U0, params)
    torch.cuda.synchronize()
    launches = count_launches(counters, per_solve, 1, absent)

    med, solves = report_timing("unfused-timing", run, (x0, U0, params),
                                BATCH, counters, reps=UNFUSED_REPS)
    count_launches(counters, per_solve, 1 + solves, absent)
    check_result(res, mpc, BATCH, device)
    conv = float(stats.n_converged) / float(stats.n_solved)
    maxv = float(stats.max_violation)
    _line("unfused", batch=BATCH, solves_per_s_median=f"{BATCH / med:.1f}",
          batch_latency_s_median=f"{med:.4f}", converged_frac=f"{conv:.6f}",
          max_violation=f"{maxv:.3e}",
          mean_cost=f"{float(stats.mean_cost):.4f}",
          launches_per_solve=per_solve,
          **{f"launches_{k}": v for k, v in launches.items()},
          launches_wholebody_bwd=0)
    if conv < 0.99:
        raise AssertionError(f"unfused: converged_frac {conv} < 0.99")
    _reference_gate("unfused-vs-fused", (res, stats), fused,
                    row="wholebody_qref_refined")
    _line("bar", row="wholebody_qref_refined_unfused",
          converged_frac_is_1=conv == 1.0,
          max_violation_below_1e_3=maxv < 1e-3, met=conv == 1.0 and maxv < 1e-3)
    return {"riccati_bwd.9x5": launches["riccati_bwd.9x5"]}


def run_scaling(device):
    """Phase 5: the kernels' and the solve's time at a batch 8x smaller."""
    from mmmpc_tpu_torch.bench import REFINE_CFG, build_problem
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.parallel.data_parallel import with_stats

    mpc, x0, U0, params = build_problem(SMALL_BATCH, device)
    run = with_stats(mpc.batch_solve_refined_fn(REFINE_CFG))
    run(x0, U0, params)
    torch.cuda.synchronize()
    report_timing("scaling", run, (x0, U0, params), SMALL_BATCH,
                  {"wholebody_fwd": wholebody_fwd.LAUNCHES,
                   "wholebody_bwd": wholebody_bwd.LAUNCHES})


def _reference_gate(tag, got, ref, **kv):
    """Two solves of one problem, ``got`` and ``ref`` = (result, stats):
    relative mean cost within 5e-3 and the same converged flags on at least
    95% of the robots.  A full solve is held to cost and feasibility, not to
    |dU|: a float reassociation can flip a near-tied line-search argmin and
    part two trajectories (ROADMAP queue 3)."""
    (rg, sg), (rc, sc) = got, ref
    dU = (rg.U.cpu() - rc.U.cpu()).abs().amax(dim=(1, 2)).numpy()
    dcost = ((rg.cost.cpu() - rc.cost.cpu()).abs()
             / rc.cost.cpu().abs().clamp(min=1e-12)).numpy()
    rel_cost = (abs(float(sg.mean_cost) - float(sc.mean_cost))
                / abs(float(sc.mean_cost)))
    same_conv = float((rg.converged.cpu() == rc.converged.cpu()).float()
                      .mean())
    conv = min(float(rg.converged.float().mean()),
               float(rc.converged.float().mean()))
    _line(tag, **kv, median_dU=f"{np.median(dU):.3e}",
          frac_dU_above_5e_3=f"{np.mean(dU > 5e-3):.4f}",
          median_rel_cost=f"{np.median(dcost):.3e}",
          max_rel_cost=f"{dcost.max():.3e}",
          rel_mean_cost=f"{rel_cost:.3e}", same_converged=f"{same_conv:.4f}",
          converged_frac_min=f"{conv:.4f}")
    if not (rel_cost < 5e-3 and same_conv >= 0.95):
        raise AssertionError(f"{tag} {kv}: the two solves disagree")
    return conv


def check_reference(device):
    """Phase 6: batch 64 through the kernels on the card against the plain
    versions on the CPU."""
    from mmmpc_tpu_torch.bench import REFINE_CFG, build_problem
    from mmmpc_tpu_torch.parallel.data_parallel import with_stats

    out = {}
    for dev in (device, torch.device("cpu")):
        mpc, x0, U0, params = build_problem(64, dev)
        run = with_stats(mpc.batch_solve_refined_fn(REFINE_CFG,
                                                    refine_size=16))
        out[dev.type] = run(x0, U0, params)
    if _reference_gate("reference", out["cuda"], out["cpu"]) < 0.95:
        raise AssertionError("reference: converged fraction below 0.95")


def run_formulations(device):
    """Phase 7: each generic row at the bench batch through its kernels."""
    from mmmpc_tpu_torch.bench_controllers import problems
    from mmmpc_tpu_torch.ops import generic_bwd, generic_fwd
    from mmmpc_tpu_torch.parallel.data_parallel import controller_batched_fn
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    launches, bars, results = {}, [], {}
    for row, mpc, x0, U0, params in problems(BATCH, device):
        if row not in ROWS:
            continue
        f = ROWS[row]
        run = controller_batched_fn(mpc)
        per_solve = iteration_count(mpc.solver_config)
        counters = {f"generic_fwd.{f}": generic_fwd.LAUNCHES[f],
                    f"generic_bwd.{f}": generic_bwd.LAUNCHES[f]}
        for c in counters.values():
            c.reset()
        res, stats = run(x0, U0, params)
        torch.cuda.synchronize()
        launches.update(count_launches(counters, per_solve, 1))
        results[row] = (res, stats)

        med, solves = report_timing("formulations-timing", run,
                                    (x0, U0, params), BATCH, counters,
                                    row=row)
        count_launches(counters, per_solve, 1 + solves)
        check_result(res, mpc, BATCH, device)
        conv = float(stats.n_converged) / float(stats.n_solved)
        maxv = float(stats.max_violation)
        _line("formulations", row=row, batch=BATCH,
              solves_per_s_median=f"{BATCH / med:.1f}",
              batch_latency_s_median=f"{med:.4f}",
              converged_frac=f"{conv:.6f}", max_violation=f"{maxv:.3e}",
              mean_cost=f"{float(stats.mean_cost):.6g}",
              launches_per_solve=per_solve)
        if conv < 0.99:
            raise AssertionError(f"{row}: converged_frac {conv} < 0.99")
        bars.append(conv == 1.0 and maxv < 1e-3)
        _line("bar", row=row, converged_frac_is_1=conv == 1.0,
              max_violation_below_1e_3=maxv < 1e-3, met=bars[-1])
    _line("bar", row="all_formulations", met=all(bars))
    return launches, results


def run_formulations_unfused(device, fused):
    """Phase 7b: each generic row at the bench batch with the unfused
    backward, gated against ``fused`` {row: (result, stats)} of phase 7."""
    from mmmpc_tpu_torch.bench_controllers import problems
    from mmmpc_tpu_torch.ops import generic_bwd, generic_fwd, riccati
    from mmmpc_tpu_torch.parallel.data_parallel import controller_batched_fn
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    launches, bars = {}, []
    for row, mpc, x0, U0, params in problems(BATCH, device):
        if row not in ROWS:
            continue
        f = ROWS[row]
        mpc.solver_config = dataclasses.replace(mpc.solver_config,
                                                use_fused_backward=False)
        run = controller_batched_fn(mpc)
        per_solve = iteration_count(mpc.solver_config)
        ric = "riccati_bwd.{}x{}".format(*DIMS[f])
        counters = {ric: riccati.LAUNCHES[DIMS[f]],
                    f"generic_fwd.{f}": generic_fwd.LAUNCHES[f]}
        absent = {f"generic_bwd.{f}": generic_bwd.LAUNCHES[f]}
        for c in (*counters.values(), *absent.values()):
            c.reset()
        res, stats = run(x0, U0, params)
        torch.cuda.synchronize()
        launches[row] = count_launches(counters, per_solve, 1, absent)[ric]

        med, solves = report_timing("formulations-unfused-timing", run,
                                    (x0, U0, params), BATCH, counters,
                                    reps=UNFUSED_REPS, row=row)
        count_launches(counters, per_solve, 1 + solves, absent)
        check_result(res, mpc, BATCH, device)
        conv = float(stats.n_converged) / float(stats.n_solved)
        maxv = float(stats.max_violation)
        _line("formulations-unfused", row=row, batch=BATCH,
              solves_per_s_median=f"{BATCH / med:.1f}",
              batch_latency_s_median=f"{med:.4f}",
              converged_frac=f"{conv:.6f}", max_violation=f"{maxv:.3e}",
              mean_cost=f"{float(stats.mean_cost):.6g}",
              launches_per_solve=per_solve, **{f"launches_{ric}": per_solve},
              **{f"launches_generic_bwd.{f}": 0})
        if conv < 0.99:
            raise AssertionError(f"{row} unfused: converged_frac {conv} < 0.99")
        _reference_gate("formulations-unfused-vs-fused", (res, stats),
                        fused[row], row=row)
        bars.append(conv == 1.0 and maxv < 1e-3)
        _line("bar", row=f"{row}_unfused", converged_frac_is_1=conv == 1.0,
              max_violation_below_1e_3=maxv < 1e-3, met=bars[-1])
    _line("bar", row="all_formulations_unfused", met=all(bars))
    # the record's launches of each sweep instance: its row's
    return {"riccati_bwd.{}x{}".format(*DIMS[ROWS[row]]): n
            for row, n in launches.items() if ROWS[row] != "endpoint"}


def check_formulations_reference(device):
    """Phase 8: each generic row at batch 64, card against CPU."""
    from mmmpc_tpu_torch.bench_controllers import problems
    from mmmpc_tpu_torch.parallel.data_parallel import controller_batched_fn

    out = {}
    for dev in (device, torch.device("cpu")):
        for row, mpc, x0, U0, params in problems(64, dev):
            if row in ROWS:
                out.setdefault(row, {})[dev.type] = controller_batched_fn(
                    mpc)(x0, U0, params)
    for row, o in out.items():
        _reference_gate("formulations-reference", o["cuda"], o["cpu"],
                        row=row)


def _sass_ffma(lib_path):
    """The FFMA instructions in the SASS of each FMA microkernel instance
    (``cuobjdump -sass``); raises unless each instance has at least one per
    accumulator.  Prints that the check was skipped where the toolkit has
    no cuobjdump."""
    from mmmpc_tpu_torch.ops._cuda import FMA_NACC
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if shutil.which(tool) is None:
        _line("peak-sass", cuobjdump="not available")
        return
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
        elif fn and "fma_peak_kernel" in fn and "FFMA" in ln:
            counts[fn] = counts.get(fn, 0) + 1
    found = {}
    for fn, n in sorted(counts.items()):
        nacc = int(re.search(r"ILi(\d+)E", fn).group(1))
        found[nacc] = n
        _line("peak-sass", nacc=nacc, function=fn, ffma=n)
    if any(found.get(nacc, 0) < nacc for nacc in FMA_NACC):
        raise AssertionError(f"fma_peak SASS: FFMA counts {found}, expected "
                             f"at least one per accumulator of {FMA_NACC}")


def run_peak(device):
    """Phase 2b: kernel F's SASS, the sweep, then each accumulator count's
    best configuration at its own grid and its shortest trip count, which
    is 3 mod 8 so the remainder of the unrolled trip loop runs: on inputs
    that count the trips exactly, and against ``plain_fma`` (rtol 1e-5,
    atol 1e-6: the kernel's one rounding per trip against plain torch's
    two, on chains that contract); then the gate of ``check_peak``.  The
    record entry is the best configuration at that trip count, on the
    inputs it was checked on.  Returns (measured FLOP/s, record entry,
    launches in the sweep)."""
    from mmmpc_tpu_torch import roofline
    from mmmpc_tpu_torch.ops._cuda import FMA_NACC, LIBRARY

    _sass_ffma(LIBRARY.info.path)
    roofline.LAUNCHES.reset()
    res = roofline.measure_fp32_peak(device)
    launches = roofline.LAUNCHES.cuda
    for r in res["sweep"]:
        _line("peak", nacc=r["nacc"], threads=r["threads"], blocks=r["blocks"],
              trips=",".join(map(str, r["trips"])),
              ms=",".join(f"{t:.4f}" for t in r["ms"]),
              tflops=f"{r['fp32_flops'] / 1e12:.3f}")

    host = res["host"]
    _line("peak-host", launches=host["launches"],
          event_ms=f"{host['event_ms']:.3f}", host_ms=f"{host['host_ms']:.3f}",
          tflops_host_clock=f"{host['fp32_flops'] / 1e12:.3f}",
          clocks_sm=repr(",".join(host["clocks_sm"])))

    def check(r):
        nacc, blocks, threads, inner = (r["nacc"], r["blocks"], r["threads"],
                                        r["trips"][0])
        n = blocks * threads
        # every trip ran: b = c = 1 counts them exactly
        x = roofline.count_inputs(nacc, n, device)
        got = roofline.fma_peak(x, nacc, inner, blocks, threads)
        if not torch.equal(got, x[:nacc] + inner):
            raise AssertionError(f"fma_peak_{nacc}: did not run {inner} trips")
        x = roofline.fma_inputs(nacc, n, device)
        got = roofline.fma_peak(x, nacc, inner, blocks, threads)
        e = _close(f"fma_peak_{nacc}", got, roofline.plain_fma(x, nacc, inner),
                   1e-5, 1e-6)
        _line("peak-check", nacc=nacc, blocks=blocks, threads=threads,
              inner=inner, trips_counted=inner, max_abs_err=f"{e:.3e}")
        return x, got, e

    checked = {}
    for nacc in FMA_NACC:
        r = max((r for r in res["sweep"] if r["nacc"] == nacc),
                key=lambda r: r["fp32_flops"])
        _line("peak-nacc", nacc=nacc,
              best_tflops=f"{r['fp32_flops'] / 1e12:.3f}")
        checked[nacc] = check(r)
    best = res["best"]
    _line("peak", measured_tflops=f"{res['fp32_flops'] / 1e12:.3f}",
          sweep_best_tflops=f"{best['fp32_flops'] / 1e12:.3f}",
          clock_ceiling_tflops=f"{res['clock_ceiling_flops'] / 1e12:.3f}",
          share_of_clock_ceiling=(
              f"{res['fp32_flops'] / res['clock_ceiling_flops']:.4f}"),
          published_tflops=f"{FP32_FLOP_PER_S / 1e12:.0f}",
          share_of_published=f"{res['fp32_flops'] / FP32_FLOP_PER_S:.4f}",
          best_nacc=best["nacc"], best_threads=best["threads"],
          best_blocks=best["blocks"], launches=launches,
          clocks_sm_power_draw_power_limit=repr(res["clocks_power"]))
    roofline.check_peak(res)

    nacc, blocks, threads, inner = (best["nacc"], best["blocks"],
                                    best["threads"], best["trips"][0])
    x, got, err = checked[nacc]
    entry = dict(max_abs_err=err,
                 ms=_kernel_ms(lambda: roofline.fma_peak(x, nacc, inner,
                                                         blocks, threads), 20),
                 plain_ms=_time_ms(lambda: roofline.plain_fma(x, nacc, inner),
                                   3),
                 **_bound([x], got, 2.0 * nacc * blocks * threads * inner,
                          res["fp32_flops"]))
    _line("kernel", name="fma_peak", nacc=nacc, blocks=blocks,
          threads=threads, inner=inner, **_fmt(entry))
    return res["fp32_flops"], entry, launches


def run_cuda_tests():
    """Phase 3b: the ``cuda``-marked tests of ``tests/test_torch_cuda.py``
    (no JAX there), in a pytest process of their own from the checkout's
    root: each kernel against its plain version on small inputs.  Fails
    unless pytest exits 0 with every selected test passed (a test that
    skips on the card is a failure here)."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p",
           "no:cacheprovider", "-m", "cuda", "-q", "tests/test_torch_cuda.py"]
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines() or [""]
    _line("cuda-tests", rc=proc.returncode, summary=repr(lines[-1]))
    if (proc.returncode != 0 or "passed" not in lines[-1]
            or re.search(r"skipped|failed|error", lines[-1])):
        print(proc.stdout[-8000:], proc.stderr[-4000:], sep="\n", flush=True)
        raise AssertionError(f"tests/test_torch_cuda.py: {lines[-1]!r}")


def _phase(name, fn, *args):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    _line("phase", name=name, seconds=f"{time.perf_counter() - t0:.1f}")
    return out


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (argv in ([], ["--kernels"]) or (
            argv[:1] == ["--kernel"] and len(argv) == 2 and argv[1] in KINDS)):
        print(f"chip_smoke: usage: [--kernels | --kernel one of "
              f"{', '.join(KINDS)}]", file=sys.stderr)
        return 2
    from mmmpc_tpu_torch.bench import SOLVER_CFG, build_problem
    from mmmpc_tpu_torch.ops._cuda import LIBRARY

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    _line("device", nvidia_smi=repr(smi), torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=repr(_nvcc_version()),
          name=repr(torch.cuda.get_device_name(0)))

    LIBRARY.get()
    info = LIBRARY.info
    _line("build", seconds=f"{info.seconds:.1f}", library=info.path.name)
    for ln in info.log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("[ptxas] " + ln.strip(), flush=True)

    timings, peak = {}, None
    kinds = set(argv[1:]) if argv[:1] == ["--kernel"] else set(KINDS)
    if "fma_peak" in kinds:
        peak, timings["fma_peak"], fma_launches = _phase("peak", run_peak,
                                                         device)
    if argv[:1] == ["--kernel"]:
        peak = None          # bounds at the published peak only
    if kinds & {"wholebody_fwd", "wholebody_bwd", "riccati_bwd"}:
        mpc, x0, _, params = build_problem(BATCH, device)
        timings.update(_phase("kernels-wholebody", check_wholebody, mpc, x0,
                              params, SOLVER_CFG, device, peak, kinds))
    if kinds & {"generic_fwd", "generic_bwd", "riccati_bwd"}:
        timings.update(_phase("kernels-generic", check_generic, device, peak,
                              kinds))
    if argv[:1] == ["--kernel"]:
        return 0
    _phase("cuda-tests", run_cuda_tests)
    if argv:
        return 0
    launches, fused = _phase("slice", run_slice, device)
    launches.update(_phase("unfused", run_unfused, device, fused))
    launches["fma_peak"] = fma_launches
    # E at (4, 2) runs on no solve path: its launches in its own check
    launches["riccati_bwd.4x2"] = timings["riccati_bwd.4x2"]["launches"]
    _phase("scaling", run_scaling, device)
    _phase("reference", check_reference, device)
    launches_f, fused_rows = _phase("formulations", run_formulations, device)
    launches.update(launches_f)
    launches.update(_phase("formulations-unfused", run_formulations_unfused,
                           device, fused_rows))
    _phase("formulations-reference", check_formulations_reference, device)

    record = {"kernels": []}
    for name, t in timings.items():
        source, replaces = KINDS[name.split(".")[0]]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"mmmpc_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "bound_ms_measured_peak": t["bound_ms_measured_peak"],
            "library_ms": None})
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

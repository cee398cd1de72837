#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``mmmpc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase (the record of a run)
    python3 chip_smoke.py --kernels   # phases 1-3 only: build and check

Phases, each reported on its own lines; any failure exits nonzero:

1. device: requires CUDA; prints ``nvidia-smi`` name and power limit,
   ``torch.version.cuda`` and the nvcc version;
2. build: compiles every kernel of ``mmmpc_tpu_torch/csrc`` for sm_90a (one
   nvcc per source, all started together) and prints the build seconds and
   the ptxas register / spill report of every kernel instance;
3. kernels: each kernel against its plain PyTorch version on the card at the
   bench shape (N=20, B=8192, 3 step sizes) on seeded inputs, at the
   tolerances of ``tests/test_torch_kernels.py`` and
   ``tests/test_torch_generic_kernels.py``: the whole-body pair on the qref
   bench problem, and the generic pair of each formulation (demo, base, arm,
   endpoint) on the rows of ``mmmpc_tpu_torch/bench_controllers.py``; the
   kernel's device time per launch (launches replayed from a CUDA graph),
   the wall time per wrapper call and the plain version's (CUDA events),
   and the least time the card could take (bytes moved over 3.35 TB/s
   against operations over 67 TFLOP/s float32);
4. slice: the refined whole-body qref solve of ``bench.py`` at batch 8192
   (one warm-up solve with the kernel launch counters reset just before it,
   then 10 solves timed one by one): median and quartiles of the solve time,
   solves/s at the median, converged fraction, max violation, and each
   kernel's launches, which must equal the schedule's 58 + 36 iterations per
   solve; then one more solve under ``torch.profiler``: the device ops it
   ran, the device busy time (union of their intervals), the idle share of
   the median solve, and each fused kernel's calls and time;
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
8. formulations-reference: each of those rows at batch 64 on the card and,
   through the plain versions, on the CPU, with the gates of phase 6.

The last two lines are a JSON record of the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 8192
SMALL_BATCH = 1024
REPS = 10
SEED = 0
# published peaks of one H100 SXM: HBM bytes/s, float32 FLOP/s (CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# the generic formulations: bench_controllers row -> formulation
ROWS = {"demo_1d": "demo", "base_only": "base", "arm_only": "arm",
        "wholebody_endpoint": "endpoint"}
GENERIC = tuple(ROWS.values())
# gains tolerance (atol) of each formulation's generic backward kernel, rtol
# 1e-4 (tests/test_generic_bwd.py); the arm is held in the p99 / float64 form
BWD_ATOL = {"demo": 1e-5, "base": 1e-3, "endpoint": 2e-4}
# device-kernel names (as the profiler reports them) of each wrapper
KERNEL_SYMBOLS = {"wholebody_fwd": "wb::fwd_kernel",
                  "wholebody_bwd": "wb::bwd_kernel",
                  **{f"generic_{d}.{f}":
                     f"gen::generic_{d}_kernel<gen::{f.capitalize()}>"
                     for f in GENERIC for d in ("fwd", "bwd")}}
REPLACES = {"wholebody_fwd": "mmmpc_tpu/ops/wholebody_fwd.py:237",
            "wholebody_bwd": "mmmpc_tpu/ops/wholebody_bwd.py:272",
            "generic_fwd": "mmmpc_tpu/ops/generic_fwd.py:261",
            "generic_bwd": "mmmpc_tpu/ops/generic_bwd.py:177"}


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


def _bound(inputs, outputs, flops):
    """The least time the card could take: each input read once and each
    output written once over the HBM rate, against ``flops`` over the
    float32 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
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


def check_pair(name, fwd, bwd, fargs, bargs, counts, bwd_check):
    """One fused pair against its plain versions on the same inputs: the
    forward pass at X / U atol 2e-5 and cost rtol = atol = 2e-3 (float32
    op-order differences, as the JAX kernel tests allow), the backward
    pass by ``bwd_check(got, ref)`` -> max abs error.  Then each kernel's
    device time per launch (``ms``), the wall time per wrapper call on
    CUDA events (``call_ms``), the plain version's (``plain_ms``), and the
    bound.  ``name`` = (forward, backward) wrapper names; ``counts`` =
    (N, B, n_alpha, nx, nu, nc, nct)."""
    N, B, na, nx, nu, nc, nct = counts
    out = {}
    got, ref = fwd.cuda(*fargs), fwd.plain(*fargs)
    torch.cuda.synchronize()
    err = max(_close(f"{name[0]} Xc", got[0], ref[0], 0.0, 2e-5),
              _close(f"{name[0]} Uc", got[1], ref[1], 0.0, 2e-5),
              _close(f"{name[0]} xlast", got[2], ref[2], 0.0, 2e-5))
    err_cost = _close(f"{name[0]} cost", got[3], ref[3], 2e-3, 2e-3)
    out[name[0]] = dict(
        max_abs_err=max(err, err_cost),
        ms=_kernel_ms(lambda: fwd.cuda(*fargs), 20),
        call_ms=_time_ms(lambda: fwd.cuda(*fargs), 20),
        plain_ms=_time_ms(lambda: fwd.plain(*fargs), 3),
        **_bound([fwd.flat, *(a for a in fargs if torch.is_tensor(a))], got,
                 fwd_flops(N, B, na, nx, nu, nc, nct)))
    _line("kernel", name=name[0], max_abs_err_XU=f"{err:.3e}",
          max_abs_err_cost=f"{err_cost:.3e}", **_fmt(out[name[0]]))

    got, ref = bwd.cuda(*bargs), bwd.plain(*bargs)
    torch.cuda.synchronize()
    err = bwd_check(got, ref)
    out[name[1]] = dict(
        max_abs_err=err,
        ms=_kernel_ms(lambda: bwd.cuda(*bargs), 20),
        call_ms=_time_ms(lambda: bwd.cuda(*bargs), 20),
        plain_ms=_time_ms(lambda: bwd.plain(*bargs), 3),
        **_bound([bwd.flat, *(a for a in bargs if torch.is_tensor(a))], got,
                 bwd_flops(N, B, nx, nu)))
    _line("kernel", name=name[1], **_fmt(out[name[1]]))
    return out


def _fmt(d):
    return {k: (f"{v:.4g}" if isinstance(v, float) else v)
            for k, v in d.items()}


def check_wholebody(mpc, x0, params, cfg, device):
    """Phase 3, kernels A and B on the qref bench problem."""
    from mmmpc_tpu_torch.solver.al_ilqr import rollout
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

    return check_pair(("wholebody_fwd", "wholebody_bwd"), fwd, bwd,
                      (X[:-1], U, kff, K, lam, lamt, lame, 10.0),
                      (X, U, lam, lamt, lame, 10.0, reg),
                      (N, B, cfg.n_alpha, 9, 5, 28, 18), bwd_check)


def check_generic(device):
    """Phase 3, kernels C and D of each formulation on its bench row."""
    from mmmpc_tpu_torch.bench_controllers import problems
    from mmmpc_tpu_torch.ops.generic_bwd import plain_bwd
    from mmmpc_tpu_torch.solver.al_ilqr import rollout
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

        def bwd_check(got, ref, f=f, bwd=bwd, mpc=mpc, bargs=bargs,
                      params=params):
            if f != "arm":
                return max(_close(f"generic_bwd.{f} {k}", g, r, 1e-4,
                                  BWD_ATOL[f])
                           for k, g, r in zip(("kff", "K"), got, ref))
            # the 1e6 wedge slack makes the solve ill-conditioned in float32
            # (tests/test_generic_bwd.py): p99 of |kernel - plain| below
            # 5e-4, and the kernel's error against the plain version in
            # float64 at most twice the plain float32 version's (1e-3
            # floor, 0.15 ceiling)
            truth = plain_bwd(mpc.ocp, {k: v.double()
                                        for k, v in params.items()},
                              bwd.inv_scale,
                              *(a.double() if torch.is_tensor(a) else a
                                for a in bargs))
            err = 0.0
            for k, g, r, tr in zip(("kff", "K"), got, ref, truth):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"generic_bwd.arm {k}: not finite")
                p99 = torch.quantile((g - r).abs().double().flatten(),
                                     0.99).item()
                e_k = (g.double() - tr).abs().max().item()
                e_p = (r.double() - tr).abs().max().item()
                _line("kernel-arm-f64", tensor=k, p99_kernel_vs_plain=
                      f"{p99:.3e}", kernel_err_f64=f"{e_k:.3e}",
                      plain_f32_err_f64=f"{e_p:.3e}")
                if not (p99 < 5e-4 and e_k <= max(2.0 * e_p, 1e-3)
                        and e_k < 0.15):
                    raise AssertionError(f"generic_bwd.arm {k}: p99 {p99:.3e}"
                                         f", error {e_k:.3e} vs {e_p:.3e}")
                err = max(err, (g - r).abs().max().item())
            return err

        out.update(check_pair((f"generic_fwd.{f}", f"generic_bwd.{f}"), fwd,
                              bwd, fargs, bargs,
                              (N, B, cfg.n_alpha, nx, nu, nc, nct),
                              bwd_check))
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
    or None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def report_timing(tag, run, args, batch, names, **kv):
    """Time ``REPS`` solves and profile one more; print both.  Returns the
    median solve seconds."""
    ts = time_solves(run, args, REPS)
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    _line(tag, **kv, batch=batch, reps=REPS, solve_s_median=f"{med:.4f}",
          solve_s_q1=f"{q1:.4f}", solve_s_q3=f"{q3:.4f}",
          solves_per_s_median=f"{batch / med:.1f}",
          solve_s=",".join(f"{t:.4f}" for t in ts))
    prof = profile_solve(run, args, names)
    if prof is None:
        _line(tag + "-profile", **kv, batch=batch,
              device_ops="not measured (the profiler saw no device activity)")
        return med
    n_ops, busy_ms, ours = prof
    _line(tag + "-profile", **kv, batch=batch, device_ops=n_ops,
          device_busy_ms=f"{busy_ms:.3f}",
          idle_share_of_median_solve=f"{1 - busy_ms / (1e3 * med):.3f}",
          **{f"{k}_calls": v[0] for k, v in ours.items()},
          **{f"{k}_ms": f"{v[1]:.3f}" for k, v in ours.items()})
    return med


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


def count_launches(counters, per_solve, solves):
    """{kernel: launches}; raises unless each kernel launched ``per_solve``
    times in each of ``solves`` solves and its plain version never."""
    for name, c in counters.items():
        if c.cuda != per_solve * solves or c.plain:
            raise AssertionError(f"{name}: {c.cuda} launches and {c.plain} "
                                 f"plain calls in {solves} solves, expected "
                                 f"{per_solve * solves} and 0")
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

    med = report_timing("slice-timing", run, (x0, U0, params), BATCH,
                        counters)
    count_launches(counters, per_solve, 2 + REPS)
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
    return launches


def run_scaling(device):
    """Phase 5: the kernels' and the solve's time at a batch 8x smaller."""
    from mmmpc_tpu_torch.bench import REFINE_CFG, build_problem
    from mmmpc_tpu_torch.parallel.data_parallel import with_stats

    mpc, x0, U0, params = build_problem(SMALL_BATCH, device)
    run = with_stats(mpc.batch_solve_refined_fn(REFINE_CFG))
    run(x0, U0, params)
    torch.cuda.synchronize()
    report_timing("scaling", run, (x0, U0, params), SMALL_BATCH,
                  ("wholebody_fwd", "wholebody_bwd"))


def _reference_gate(tag, out, **kv):
    """Card vs CPU solve of one problem: relative mean cost within 5e-3 and
    the same converged flags on at least 95% of the robots.  A full solve is
    held to cost and feasibility, not to |dU|: a float reassociation can
    flip a near-tied line-search argmin and part two trajectories (ROADMAP
    queue 3)."""
    (rg, sg), (rc, sc) = out["cuda"], out["cpu"]
    dU = (rg.U.cpu() - rc.U).abs().amax(dim=(1, 2)).numpy()
    dcost = ((rg.cost.cpu() - rc.cost).abs()
             / rc.cost.abs().clamp(min=1e-12)).numpy()
    rel_cost = (abs(float(sg.mean_cost) - float(sc.mean_cost))
                / abs(float(sc.mean_cost)))
    same_conv = float((rg.converged.cpu() == rc.converged).float().mean())
    conv = min(float(rg.converged.float().mean()),
               float(rc.converged.float().mean()))
    _line(tag, **kv, median_dU=f"{np.median(dU):.3e}",
          frac_dU_above_5e_3=f"{np.mean(dU > 5e-3):.4f}",
          median_rel_cost=f"{np.median(dcost):.3e}",
          max_rel_cost=f"{dcost.max():.3e}",
          rel_mean_cost=f"{rel_cost:.3e}", same_converged=f"{same_conv:.4f}",
          converged_frac_min=f"{conv:.4f}")
    if not (rel_cost < 5e-3 and same_conv >= 0.95):
        raise AssertionError(f"{tag} {kv}: card solve disagrees with the "
                             f"plain CPU solve")
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
    if _reference_gate("reference", out) < 0.95:
        raise AssertionError("reference: converged fraction below 0.95")


def run_formulations(device):
    """Phase 7: each generic row at the bench batch through its kernels."""
    from mmmpc_tpu_torch.bench_controllers import problems
    from mmmpc_tpu_torch.ops import generic_bwd, generic_fwd
    from mmmpc_tpu_torch.parallel.data_parallel import controller_batched_fn
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    launches, bars = {}, []
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

        med = report_timing("formulations-timing", run, (x0, U0, params),
                            BATCH, counters, row=row)
        count_launches(counters, per_solve, 2 + REPS)
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
    return launches


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
        _reference_gate("formulations-reference", o, row=row)


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
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

    mpc, x0, _, params = build_problem(BATCH, device)
    timings = check_wholebody(mpc, x0, params, SOLVER_CFG, device)
    timings.update(check_generic(device))
    if argv == ["--kernels"]:
        return 0
    launches = run_slice(device)
    run_scaling(device)
    check_reference(device)
    launches.update(run_formulations(device))
    check_formulations_reference(device)

    record = {"kernels": []}
    for name, t in timings.items():
        kind = name.split(".")[0]
        source = (f"{name}.cu" if "." not in name else f"{kind}.cuh")
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"mmmpc_tpu_torch/csrc/{source}",
            "replaces": REPLACES[kind], "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``mmmpc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits nonzero:

1. device: requires CUDA; prints ``nvidia-smi`` name and power limit,
   ``torch.version.cuda`` and the nvcc version;
2. build: compiles both fused kernels from ``mmmpc_tpu_torch/csrc`` for sm_90a
   and prints the build seconds and the ptxas register / spill report;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   bench shape (N=20, B=8192, 3 step sizes) on seeded inputs, at the
   tolerances of ``tests/test_torch_kernels.py``; CUDA-event times of both;
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
   flags on at least 95% of the robots (|dU| is printed, not gated).

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
KERNEL_SYMBOLS = {"wholebody_fwd": "wb::fwd_kernel",
                  "wholebody_bwd": "wb::bwd_kernel"}


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


def kernel_inputs(mpc, x0, params, device, rng):
    """Seeded inputs at the bench shape: X is the open-loop rollout of random
    U from the bench starts (as in every solver call)."""
    from mmmpc_tpu_torch.solver.al_ilqr import rollout
    N, B = mpc.N, x0.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    X, U = rollout(mpc.ocp, x0.T, t(0.1 * rng.standard_normal((N, 5, B))),
                   params)
    return dict(
        X=X, U=U,
        kff=t(0.05 * rng.standard_normal((N, 5, B))),
        K=t(0.05 * rng.standard_normal((N, 5, 9, B))),
        lam=t(0.5 * np.abs(rng.standard_normal((N, 28, B)))),
        lamt=t(0.5 * np.abs(rng.standard_normal((18, B)))),
        lame=t(0.1 * rng.standard_normal((2, B))),
        mu=10.0, reg=torch.full((B,), 1e-6, device=device))


def check_kernels(mpc, x0, params, cfg, device):
    """Phase 3: each kernel vs its plain version on the same inputs."""
    a = kernel_inputs(mpc, x0, params, device, np.random.default_rng(SEED))
    fwd = mpc.ocp.lanes_fwd_factory(cfg, params)
    bwd = mpc.ocp.lanes_bwd_factory(cfg, params)
    fargs = (a["X"][:-1], a["U"], a["kff"], a["K"], a["lam"], a["lamt"],
             a["lame"], a["mu"])
    bargs = (a["X"], a["U"], a["lam"], a["lamt"], a["lame"], a["mu"],
             a["reg"])

    out = {}
    got, ref = fwd.cuda(*fargs), fwd.plain(*fargs)
    torch.cuda.synchronize()
    # X / U atol 2e-5 and cost rtol = atol = 2e-3: float32 op-order
    # differences, as the JAX kernel test allows (tests/test_fwd_lanes.py)
    err = max(_close("fwd Xc", got[0], ref[0], 0.0, 2e-5),
              _close("fwd Uc", got[1], ref[1], 0.0, 2e-5),
              _close("fwd xlast", got[2], ref[2], 0.0, 2e-5))
    err_cost = _close("fwd cost", got[3], ref[3], 2e-3, 2e-3)
    out["wholebody_fwd"] = dict(
        max_abs_err=max(err, err_cost),
        ms=_time_ms(lambda: fwd.cuda(*fargs), 20),
        plain_ms=_time_ms(lambda: fwd.plain(*fargs), 3))
    _line("kernel", name="wholebody_fwd", max_abs_err_XU=f"{err:.3e}",
          max_abs_err_cost=f"{err_cost:.3e}", **{
              k: f"{v:.4f}" for k, v in out["wholebody_fwd"].items()
              if k != "max_abs_err"})

    got, ref = bwd.cuda(*bargs), bwd.plain(*bargs)
    torch.cuda.synchronize()
    # rtol = atol = 5e-3: op-order differences amplified through the
    # Cholesky on gains of magnitude ~10-100 (tests/test_fused_bwd.py)
    err = max(_close("bwd kff", got[0], ref[0], 5e-3, 5e-3),
              _close("bwd K", got[1], ref[1], 5e-3, 5e-3))
    out["wholebody_bwd"] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: bwd.cuda(*bargs), 20),
        plain_ms=_time_ms(lambda: bwd.plain(*bargs), 3))
    _line("kernel", name="wholebody_bwd", **{
        k: f"{v:.4g}" for k, v in out["wholebody_bwd"].items()})
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


def profile_solve(run, args):
    """One solve under torch.profiler: (device ops, busy ms as the union of
    their intervals, {kernel: (calls, ms)} of the fused kernels), or None
    when the profiler saw no device activity."""
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
    for name, symbol in KERNEL_SYMBOLS.items():
        d = [t1 - t0 for t0, t1, n in spans if n.startswith(symbol)]
        ours[name] = (len(d), sum(d) / 1e3)
    return len(spans), busy / 1e3, ours


def report_timing(tag, run, args, batch):
    """Time ``REPS`` solves and profile one more; print both.  Returns the
    median solve seconds."""
    ts = time_solves(run, args, REPS)
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    _line(tag, batch=batch, reps=REPS, solve_s_median=f"{med:.4f}",
          solve_s_q1=f"{q1:.4f}", solve_s_q3=f"{q3:.4f}",
          solves_per_s_median=f"{batch / med:.1f}",
          solve_s=",".join(f"{t:.4f}" for t in ts))
    prof = profile_solve(run, args)
    if prof is None:
        _line(tag + "-profile", batch=batch,
              device_ops="not measured (the profiler saw no device activity)")
        return med
    n_ops, busy_ms, ours = prof
    _line(tag + "-profile", batch=batch, device_ops=n_ops,
          device_busy_ms=f"{busy_ms:.3f}",
          idle_share_of_median_solve=f"{1 - busy_ms / (1e3 * med):.3f}",
          **{f"{k}_calls": v[0] for k, v in ours.items()},
          **{f"{k}_ms": f"{v[1]:.3f}" for k, v in ours.items()})
    return med


def run_slice(device):
    """Phase 4: the refined solve at the bench batch through the kernels."""
    from mmmpc_tpu_torch.bench import REFINE_CFG, SOLVER_CFG, build_problem
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.parallel.data_parallel import with_stats
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    mpc, x0, U0, params = build_problem(BATCH, device)
    run = with_stats(mpc.batch_solve_refined_fn(REFINE_CFG))
    per_solve = iteration_count(SOLVER_CFG) + iteration_count(REFINE_CFG)

    counters = (wholebody_fwd.LAUNCHES, wholebody_bwd.LAUNCHES)
    for c in counters:
        c.reset()
    res, stats = run(x0, U0, params)
    torch.cuda.synchronize()
    launches = {"wholebody_fwd": counters[0].cuda,
                "wholebody_bwd": counters[1].cuda}
    for name, n in launches.items():
        if n != per_solve:
            raise AssertionError(f"{name}: {n} launches in one solve, "
                                 f"expected {per_solve}")

    med = report_timing("slice-timing", run, (x0, U0, params), BATCH)
    for c in counters:
        if c.cuda != per_solve * (2 + REPS) or c.plain:
            raise AssertionError(f"launch counts {counters}")

    N = mpc.N
    shapes = {"X": (BATCH, N + 1, 9), "U": (BATCH, N, 5), "cost": (BATCH,),
              "max_violation": (BATCH,)}
    for k, shp in shapes.items():
        v = getattr(res, k)
        if tuple(v.shape) != shp:
            raise AssertionError(f"result {k}: shape {tuple(v.shape)} != {shp}")
        if not torch.isfinite(v).all():
            raise AssertionError(f"result {k}: non-finite values")
    lo = torch.as_tensor(mpc.ulim[0], dtype=res.U.dtype, device=device)
    hi = torch.as_tensor(mpc.ulim[1], dtype=res.U.dtype, device=device)
    if ((res.U < lo) | (res.U > hi)).any():
        raise AssertionError("inputs outside the clamped box ulim")
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
    _line("bar", converged_frac_is_1=conv == 1.0,
          max_violation_below_1e_3=maxv < 1e-3,
          met=conv == 1.0 and maxv < 1e-3)
    return launches


def run_scaling(device):
    """Phase 5: the kernels' and the solve's time at a batch 8x smaller."""
    from mmmpc_tpu_torch.bench import REFINE_CFG, build_problem
    from mmmpc_tpu_torch.parallel.data_parallel import with_stats

    mpc, x0, U0, params = build_problem(SMALL_BATCH, device)
    run = with_stats(mpc.batch_solve_refined_fn(REFINE_CFG))
    run(x0, U0, params)
    torch.cuda.synchronize()
    report_timing("scaling", run, (x0, U0, params), SMALL_BATCH)


def check_reference(device):
    """Phase 6: batch 64 through the kernels on the card against the plain
    versions on the CPU.  A full solve is held to cost and feasibility, not
    to |dU|: the problem has near-equal-cost minima far apart in U, and a
    float reassociation can flip a near-tied line-search argmin and part two
    trajectories (ROADMAP queue 3)."""
    from mmmpc_tpu_torch.bench import REFINE_CFG, build_problem
    from mmmpc_tpu_torch.parallel.data_parallel import with_stats

    out = {}
    for dev in (device, torch.device("cpu")):
        mpc, x0, U0, params = build_problem(64, dev)
        run = with_stats(mpc.batch_solve_refined_fn(REFINE_CFG,
                                                    refine_size=16))
        out[dev.type] = run(x0, U0, params)
    (rg, sg), (rc, sc) = out["cuda"], out["cpu"]
    dU = (rg.U.cpu() - rc.U).abs().amax(dim=(1, 2)).numpy()
    dcost = ((rg.cost.cpu() - rc.cost).abs() / rc.cost.abs()).numpy()
    rel_cost = (abs(float(sg.mean_cost) - float(sc.mean_cost))
                / abs(float(sc.mean_cost)))
    same_conv = float((rg.converged.cpu() == rc.converged).float().mean())
    conv = min(float(rg.converged.float().mean()),
               float(rc.converged.float().mean()))
    _line("reference", median_dU=f"{np.median(dU):.3e}",
          frac_dU_above_5e_3=f"{np.mean(dU > 5e-3):.4f}",
          median_rel_cost=f"{np.median(dcost):.3e}",
          max_rel_cost=f"{dcost.max():.3e}",
          rel_mean_cost=f"{rel_cost:.3e}", same_converged=f"{same_conv:.4f}",
          converged_frac_min=f"{conv:.4f}")
    if not (rel_cost < 5e-3 and same_conv >= 0.95 and conv >= 0.95):
        raise AssertionError("card solve disagrees with the plain CPU solve")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from mmmpc_tpu_torch.bench import SOLVER_CFG, build_problem
    from mmmpc_tpu_torch.ops._cuda import LIBRARY, SOURCES

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
    timings = check_kernels(mpc, x0, params, SOLVER_CFG, device)
    launches = run_slice(device)
    run_scaling(device)
    check_reference(device)

    sources = dict(zip(("wholebody_fwd", "wholebody_bwd"), SOURCES))
    replaces = {"wholebody_fwd": "mmmpc_tpu/ops/wholebody_fwd.py:237",
                "wholebody_bwd": "mmmpc_tpu/ops/wholebody_bwd.py:272"}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"mmmpc_tpu_torch/csrc/{sources[name]}",
         "replaces": replaces[name], "launches": launches[name],
         **timings[name]}
        for name in ("wholebody_fwd", "wholebody_bwd")]}
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

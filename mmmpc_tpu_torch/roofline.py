"""The card's measured float32 FMA peak (counterpart of
``scripts/roofline.py::measure_vpu_peak``).

    python -m mmmpc_tpu_torch.roofline --peak

prints one JSON object: the measured float32 rate, every configuration of
the sweep with its rate, and the card's name, clocks and power limit
(``nvidia-smi``), then fails if the rate is above what the clock allows.
It needs a CUDA card and writes no file.

The microkernel is ``csrc/fma_peak.cu`` (``fma_peak_<nacc>`` of the kernel
library): per thread ``nacc`` independent accumulators, ``a = a * b + c`` as
one ``fmaf`` for ``inner`` trips.  ``measure_fp32_peak`` sweeps nacc x
threads per block x blocks per SM and times each configuration with CUDA
events at four trip counts, interleaved (the median of five rounds of 5
launches each); its rate is the median slope of time against trips, which
cancels the launch, the loads and the stores.  The best configuration is
then timed anew over half-second runs of launches 4 and 8 times longer
(``confirm_rate``): that rate is the measured peak, free of the upward
pull of picking the largest of sixteen noisy readings.  The best
configuration is also run back to back for a second, timed by CUDA events
and by the host's clock, with the SM clock sampled meanwhile
(``host_check``).  A rate above 101% of SMs x 128 lanes x 2 x the highest
SM clock is refused (``check_peak``).
``plain_fma`` is the same recurrence in PyTorch.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import torch

from mmmpc_tpu_torch.ops._cuda import (
    FMA_NACC, LIBRARY, LaunchCounter, check_launch, check_tensor,
)

LAUNCHES = LaunchCounter()
# the sweep: accumulators per thread (FMA_NACC), threads per block, blocks
# per SM
SWEEP_THREADS = (256, 1024)
SWEEP_BLOCKS_PER_SM = (4, 8)
# FLOP per launch at the longest trip count of each configuration
WORK_FLOP = 2e11
# float32 FMA lanes per SM of Hopper (sm_90)
FP32_LANES_PER_SM = 128
# the published float32 rate of one H100 SXM (CUDA cores, 700 W)
PUBLISHED_FP32_FLOPS = 67e12


def plain_fma(x, nacc, inner):
    """x (nacc + 2, n): accumulators, b, c -> the accumulators (nacc, n)
    after ``inner`` trips of acc = acc * b + c (any device)."""
    acc, b, c = x[:nacc], x[nacc], x[nacc + 1]
    for _ in range(inner):
        acc = acc * b + c
    return acc


def fma_peak(x, nacc, inner, blocks, threads):
    """x (nacc + 2, n) with n = blocks * threads -> (nacc, n).  On the card
    it launches ``fma_peak_<nacc>`` on the current stream; on the CPU it runs
    ``plain_fma``."""
    if x.device.type == "cpu":
        LAUNCHES.plain += 1
        return plain_fma(x, nacc, inner)
    if nacc not in FMA_NACC:
        raise ValueError(f"fma_peak: no instance for nacc={nacc}; instances: "
                         f"{list(FMA_NACC)}")
    n = blocks * threads
    dev = x.device
    ptr = check_tensor("x", x, (nacc + 2, n), dev)
    out = torch.empty(nacc, n, dtype=torch.float32, device=dev)
    lib = LIBRARY.get()
    with torch.cuda.device(dev):
        err = getattr(lib, f"fma_peak_{nacc}")(
            ptr, out.data_ptr(), inner, blocks, threads,
            torch.cuda.current_stream().cuda_stream)
    check_launch(f"fma_peak_{nacc}", err)
    LAUNCHES.cuda += 1
    return out


def fma_inputs(nacc, n, device, seed=0):
    """Seeded inputs: accumulators in [-1, 1), b in [0.5, 0.99), c in
    [-0.01, 0.01), so every chain stays bounded."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    acc = torch.rand(nacc, n, generator=g) * 2 - 1
    b = 0.5 + 0.49 * torch.rand(1, n, generator=g)
    c = (torch.rand(1, n, generator=g) * 2 - 1) * 0.01
    return torch.cat([acc, b, c]).to(device)


def count_inputs(nacc, n, device):
    """Inputs that count the trips exactly: accumulators 0..nacc-1, b = 1,
    c = 1, so after ``inner`` trips each accumulator is its start value plus
    ``inner`` (exact in float32 below 2**24)."""
    acc = torch.arange(nacc, dtype=torch.float32)[:, None].expand(nacc, n)
    return torch.cat([acc, torch.ones(2, n)]).to(device)


def trip_counts(nacc, n):
    """The trip counts of one configuration: k / 4 of the count that does
    ``WORK_FLOP`` for k = 1..4, each 3 mod 8 so that the remainder of the
    trip loop (unrolled by 8) runs in every launch."""
    base = max(8, int(WORK_FLOP / (2 * nacc * n)) // 32 * 8)
    return tuple(k * base + 3 for k in (1, 2, 3, 4))


def median_slope(xs, ys):
    """The median of the slopes between every pair of points (Theil-Sen):
    one slow point moves it little."""
    return statistics.median((ys[j] - ys[i]) / (xs[j] - xs[i])
                             for i in range(len(xs))
                             for j in range(i + 1, len(xs)))


def _interleaved_ms(fns, reps, repeats):
    """Milliseconds per call of each of ``fns``: ``repeats`` rounds, each
    timing ``reps`` calls of every fn in turn with CUDA events (one warm-up
    call of each first); the median over the rounds."""
    for fn in fns:
        fn()
    runs = [[] for _ in fns]
    for _ in range(repeats):
        for fn, ms in zip(fns, runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end) / reps)
    return [statistics.median(ms) for ms in runs]


def nvidia_smi(fields):
    """``nvidia-smi --query-gpu=<fields>`` of card 0, as printed."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={fields}",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def clock_ceiling(device):
    """The most float32 FLOP/s the card's clock allows: SMs x FP32 lanes x
    2 x the highest SM clock (``nvidia-smi clocks.max.sm``)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * FP32_LANES_PER_SM * 2 * mhz * 1e6


def host_check(x, nacc, inner, blocks, threads, seconds=1.0):
    """Back-to-back launches of one configuration for about ``seconds``,
    timed by CUDA events and by the host's clock around them, with
    ``nvidia-smi clocks.sm`` sampled while they run: {"launches",
    "event_ms", "host_ms", "clocks_sm"}.  The host's time includes the
    launch gaps, so its rate is a lower bound on the card's."""
    fma_peak(x, nacc, inner, blocks, threads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fma_peak(x, nacc, inner, blocks, threads)
    torch.cuda.synchronize()
    launches = max(2, int(seconds / (time.perf_counter() - t0)))
    clocks, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            clocks.append(nvidia_smi("clocks.sm"))

    sampler = threading.Thread(target=sample)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(launches):
        fma_peak(x, nacc, inner, blocks, threads)
    end.record()
    sampler.start()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    stop.set()
    sampler.join()
    return {"launches": launches, "event_ms": start.elapsed_time(end),
            "host_ms": host_ms, "clocks_sm": clocks}


def confirm_trips(trips):
    """The two trip counts of ``confirm_rate``: 4 and 8 times the sweep's
    longest (~12 and ~24 ms a launch), still 3 mod 8."""
    return tuple(k * (trips[-1] - 3) + 3 for k in (4, 8))


def confirm_rate(x, nacc, trips, blocks, threads, seconds=0.5, rounds=3):
    """The float32 rate of one configuration measured anew over long
    launches: back-to-back launches at the two ``confirm_trips``, about
    ``seconds`` at the longer, in ``rounds`` interleaved rounds; the slope
    between the two medians.  Measuring the sweep's winner again keeps the
    sweep's largest error out of the result, and launches of 12-24 ms make
    the launch, the loads, the stores and the short runs' uneven block
    scheduling a small share of the difference."""
    lo, hi = confirm_trips(trips)
    runs = [lambda t=t: fma_peak(x, nacc, t, blocks, threads)
            for t in (lo, hi)]
    launches = max(5, int(seconds * 1e3 / _interleaved_ms(runs[1:], 1, 1)[0]))
    ms_lo, ms_hi = _interleaved_ms(runs, launches, rounds)
    return 2.0 * nacc * x.shape[1] * (hi - lo) / ((ms_hi - ms_lo) * 1e-3)


def check_peak(res):
    """Raise on a measured rate above 101% of what the clock allows or
    above 105% of the published rate: that is a timing fault, not a
    result."""
    rate, ceiling = res["fp32_flops"], res["clock_ceiling_flops"]
    if rate > 1.01 * ceiling or rate > 1.05 * PUBLISHED_FP32_FLOPS:
        raise RuntimeError(
            f"measured {rate / 1e12:.3f} TFLOP/s, above 101% of the clock's "
            f"{ceiling / 1e12:.3f} or 105% of the published "
            f"{PUBLISHED_FP32_FLOPS / 1e12:.0f}")


def measure_fp32_peak(device, reps=5, repeats=5):
    """Sweep the microkernel on ``device`` and return {"fp32_flops": best
    rate, "best": its configuration, "sweep": [every configuration with its
    trip counts, median ms at each and rate], "host": ``host_check`` of the
    best configuration at its longest trip count, "clock_ceiling_flops",
    "name", "power_limit", "clocks_power" (nvidia-smi right after the
    sweep)}.  Each configuration's rate is the median slope of its median
    times against the trip counts, timed interleaved; the best one's rate
    is then measured anew by ``confirm_rate``, which is the result.
    ``check_peak`` holds the result to the clock."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("measure_fp32_peak needs a CUDA device")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    sweep = []
    for nacc in FMA_NACC:
        for threads in SWEEP_THREADS:
            for per_sm in SWEEP_BLOCKS_PER_SM:
                blocks = per_sm * sms
                n = blocks * threads
                trips = trip_counts(nacc, n)
                x = fma_inputs(nacc, n, device)
                ms = _interleaved_ms(
                    [lambda t=t: fma_peak(x, nacc, t, blocks, threads)
                     for t in trips], reps, repeats)
                flops = 2.0 * nacc * n / (median_slope(trips, ms) * 1e-3)
                sweep.append({"nacc": nacc, "threads": threads,
                              "blocks": blocks, "trips": trips, "ms": ms,
                              "fp32_flops": flops})
    clocks_power = nvidia_smi("clocks.sm,power.draw,power.limit")
    best = max(sweep, key=lambda r: r["fp32_flops"])
    n = best["blocks"] * best["threads"]
    x = fma_inputs(best["nacc"], n, device)
    rate = confirm_rate(x, best["nacc"], best["trips"], best["blocks"],
                        best["threads"])
    host = host_check(x, best["nacc"], best["trips"][-1], best["blocks"],
                      best["threads"])
    host["fp32_flops"] = (2.0 * best["nacc"] * n * best["trips"][-1]
                          * host["launches"] / (host["host_ms"] * 1e-3))
    return {"fp32_flops": rate, "best": best, "sweep": sweep,
            "host": host, "published_fp32_flops": PUBLISHED_FP32_FLOPS,
            "clock_ceiling_flops": clock_ceiling(device),
            "name": torch.cuda.get_device_name(device),
            "power_limit": nvidia_smi("power.limit"),
            "clocks_power": clocks_power}


def main(argv):
    if argv != ["--peak"]:
        raise SystemExit("usage: python -m mmmpc_tpu_torch.roofline --peak")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the peak is measured on the card")
    res = measure_fp32_peak("cuda")
    print(json.dumps(res), flush=True)
    check_peak(res)


if __name__ == "__main__":
    main(sys.argv[1:])

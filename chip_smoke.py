#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``mmmpc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase (the record of a run)
    python3 chip_smoke.py --kernels   # phases 1-3b only: build and check
    python3 chip_smoke.py --closed-loop   # phases 1-2, then phase 9 alone
    python3 chip_smoke.py --moving-obs    # phases 1-2, then the moving
        # kernels' checks of phase 3 and phase 10 alone
    python3 chip_smoke.py --fleet     # phases 1-2, then phase 11 alone
    python3 chip_smoke.py --controllers   # phases 1-2, then phase 12 alone,
        # with the dossier's closed-loop and self-consistency rows
    python3 chip_smoke.py --fixed     # phases 1-2, then phase 13 alone
    python3 chip_smoke.py --long-horizon  # phases 1-2, then phase 14 alone
    python3 chip_smoke.py --multi-gpu     # phases 1-2, then phase 15 alone
    python3 chip_smoke.py --profile       # phases 1-2, then phase 16 alone
    python3 chip_smoke.py --tools         # phases 1-2, then phase 17 alone
    python3 chip_smoke.py --bench         # phases 1-2, then phase 4c alone
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
   B, C and D (each formulation's) and E (at (9, 5) on the qref blocks, at
   (4, 2) on the SPD blocks) also at the ragged batches 8191, 1000 and 1
   against their plain versions, with their launch geometry
   (``[kernel-batch]``; E's with the blocks an SM holds);
   kernels A and B also with an obstacle row a stage (``wholebody_fwd.moving``,
   ``wholebody_bwd.moving``) on the inputs of ``bench_controllers``'s
   ``wholebody_moving_obs`` row, timed with their bounds, at the ragged
   batches and at the dynamic-obstacle demo's shape (batch 1, 8 step
   sizes, cost_scale 1.0, ``inputs=demo``);
   kernels A and B also with per-scenario entries (their instances for the
   fleet, ``wholebody_fwd.fleet``, ``wholebody_bwd.fleet``) at the fleet's
   shape (the bench problem at batch 1024, all six entries per robot,
   ``tests/torch_problems.py::fleet_params``), timed with their bounds, at
   1023, 1000 and 1, and with U_last alone (``keys=U_last``); B's gains
   there also against its plain version in float64 (``[kernel-f64]``,
   ``_fleet_bwd_check``);
   kernels A and B also in the fixed terminal formulation
   (``wholebody_fwd.fixed``, ``wholebody_bwd.fixed``: statics
   ``bug_compat`` 0) on the bench problem built with
   ``replicate_terminal_selfcol_bug=False``, timed with their bounds, at
   8191, 1000 and 1, and on ``tests/torch_problems.py::selfcol_problem``
   (``inputs=selfcol``), where they must part from the bug-compatible
   kernels by at least ten tolerances (``differs_by_tolerances``);
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
   fused backward kernel, which must not launch; launches, timing (2
   solves), profile, convergence, and the gate of phase 6 against phase 4's
   fused solve;
4c. bench (also alone with ``--bench``): ``mmmpc_tpu_torch/bench.py``'s
   ``run(8192, 10)``, the entry point of ``python -m mmmpc_tpu_torch.bench``:
   one warm-up solve, then 10 solves back to back with one synchronise at
   the end (``[bench]``: its statistics and metric, beside phase 4's
   median solves/s and statistics); fails on a missed bar, on A's or B's
   launches other than the schedule's 94 a solve in its 11 solves, and
   unless its statistics are phase 4's to the bit (``held_to_the_bit``;
   alone, not compared);
4d. native: the host runtime ``mmmpc_tpu_torch/native`` built with ``g++``
   from ``csrc/mmrt.cpp`` (a failed build fails the phase), each function
   against the port's float64 torch function on seeded inputs at
   ``tests/test_torch_native.py``'s tolerances (``[native]``: the max abs
   error and the host microseconds a call of both);
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
   iteration, its fused backward never; timing (2 solves), profile,
   convergence, and the gate of phase 6 against the row's fused solve of
   phase 7;
8. formulations-reference: each of those rows at batch 64 on the card and,
   through the plain versions, on the CPU, with the gates of phase 6;
9. closed-loop: the demo's closed loop (``mmmpc_tpu_torch/
   demo_wholebody_qref.py``), each tick a warm-started solve of the qref
   controller at batch 1 with ``SolverConfig()`` (6 AL rounds x 10 sweeps,
   8 step sizes, cost_scale 1.0): first kernels A and B against their
   plain versions in those settings at batch 1 (``[kernel-loop]``: the
   terminal-equality mask off, on, and with the rotate weights; device and
   plain ms); then scenarios 1, 0 and 2 model-only and scenario 0 through
   the kinematic plant, each run to its end with the counters reset just
   before it: A and B must launch 60 times a tick and their plain versions
   never, and each run must meet the assertions of
   ``tests/test_runtime.py``'s closed-loop tests (``[closed-loop]``: steps,
   scenario 1's beside the JAX float32 demo's 208, phases, converged
   ticks, max violation, p50 / p99 ms a tick); one tick timed and
   profiled (``[closed-loop-tick]``), and one of no iteration, what a tick
   costs besides its iterations (``[closed-loop-tick-fixed]``); then
   ``mmmpc_tpu_torch/rt_latency.py``'s 100 warm ticks (``[rt-latency]``:
   p50 / p99 ms a tick);
10. moving-obs: the ``wholebody_moving_obs`` row of ``bench_controllers``
   (the qref row over its three obstacles predicted at constant
   velocities) at batch 8192, fused and unfused, as phases 7 and 7b run a
   row, the unfused solve gated against the fused one, and the row at
   batch 64 on the card against the plain versions on the CPU
   (``[moving-obs]``); then the dynamic-obstacle demo
   (``mmmpc_tpu_torch/demo_wholebody_separate.py``) model-only on the card
   to its end, A and B 60 launches a tick and their plain versions never:
   the task must finish with the end effector within 1 cm of the button and
   the base's clearance to the obstacle's inflated circle must stay >= 0 at
   every tick (``[moving-obs-demo]``: steps and least clearance beside the
   JAX float32 demo's, p50 / p99 ms a tick);
11. fleet: ``mmmpc_tpu_torch/bench_fleet_tasks.py``'s relaxed fleet
   (1024 robots of scenario 1, N=20, 6 AL rounds x 12 sweeps, 3 step
   sizes, cost_scale 1e5, 40-tick segments) for 400 ticks from the start,
   after a warm-up tick and a tick that must not make the host wait for
   the card (``[fleet-sync]``: ``torch.cuda.set_sync_debug_mode("error")``),
   with the counters reset just before them: A and B with
   per-scenario entries must launch 72 times a tick and their plain
   versions never (``[fleet]``: completion rate, median done tick, a
   tick's p50 / p99 ms from CUDA events recorded as the ticks are issued,
   robot-ticks/s, max violation, fallback ticks); one tick timed and
   profiled (``[fleet-tick]``); the phase fails when under 85% of the
   robots complete or a state turns non-finite; then ``rt_latency``'s
   fleet leg (``[fleet-rt]``: 1024 robots, each robot's U_last its own,
   p50 / p99 ms, the mean and least converged share of a tick), failing
   when the mean converged share is under 0.95;
12. controllers (also alone with ``--controllers``): the arm with its
   Cartesian reference (``CART_ROW``: the ``arm_only`` row's wedge, starts
   and schedule, the end point tracked from (0.45, 0, 0.5) to
   (0.35, 0, 0.6)): its kernels C.arm_cart and D.arm_cart as phase 3
   checks a kernel (``[kernel]``, ``[kernel-batch]``, E(3, 3) on their
   blocks), its solve at batch 8192 fused and unfused and at 64 card
   against CPU as phases 7, 7b and 8 run a row; then each generic
   controller's warm-started single-robot ``solve`` (demo, base, arm,
   Cartesian arm, endpoint; ``SolverConfig()``): first its C and D against
   their plain versions at the tick's shape (batch 1, 8 step sizes) on
   seeded inputs at the tolerances of phase 3 (``[kernel-loop]``, with
   device and plain ms), then 10 ticks after a warm-up, the model plant
   stepped in float64, C and D 60 launches a tick and their plain versions
   never, every tick converged with max violation below 1e-3
   (``[single-robot]``: p50 / p99 ms a tick); then the fidelity dossier
   (``mmmpc_tpu_torch/fidelity_dossier.py``, ``[dossier]``): each
   configuration solved on the card against the best feasible float64
   scipy oracle, run in worker processes on the CPU meanwhile, failing
   unless violation <= 1e-3 and relative cost <= 5e-3 in every row; with
   ``--controllers`` also its closed-loop and self-consistency rows;
13. fixed (also alone with ``--fixed``): the refined solve of phase 4's
   problem in the fixed terminal formulation
   (``replicate_terminal_selfcol_bug=False``) at batch 8192 (A and B each
   94 launches a solve; 10 solves timed; ``[fixed]``), held
   to the reference's bar; then, on ``tests/torch_problems.py``'s
   self-collision problem (batch 64), where the two settings part, the
   fused solve against the unfused one (A and E;
   ``[fixed-unfused-vs-fused]``) and against the plain versions on the CPU
   (``[fixed-reference]``), phase 6's gate, and against the
   bug-compatible solve, which must miss that gate
   (``[fixed-vs-bug-compat]``);
14. long-horizon (also alone with ``--long-horizon``): kernels A, B and E
   at N = 100, 500 and 2000 on ``bench_longhorizon``'s problem at batch 64, one
   call each against one call of the plain version (within the bench tolerances
   of the float32 plain version, or stage by stage no farther from the float64
   one than twice the float32 plain version is within 32 stages or than those
   tolerances; ``[kernel-gate]`` says which held), with the device ms a launch,
   the bound at that N, the shared-memory bytes and the blocks an SM holds
   (``[long-kernel]``); A and B at the least N the card's shared memory does
   not hold must raise a ValueError before launching (``[long-limit]``); then
   ``bench_longhorizon``'s rows (N = 20, 100, 500) at batch 1, 8 and 64, the
   sequential route (B) against the assoc route (``ops/assoc_riccati.py``, no
   backward kernel), each a warm-up and the median of 3 solves, every kernel's
   and the assoc sweep's calls checked (``[long-horizon]``: ms a solve with its
   spread, converged and moved shares, the routes' relative mean cost and
   shared converged flags, printed; on the row's first expansion the two sweeps
   in float64 at reg 1e-14 within 1e-6, and the float32 assoc sweep on the
   card at reg 1e-2 held stage by stage to its float64 version against the
   CPU's float32 one, gated);
15. multi-gpu (also alone with ``--multi-gpu``): ``python -m
   mmmpc_tpu_torch.bench_multihost --refined`` in a subprocess as one NCCL
   rank under a torchrun-style environment (``MASTER_ADDR`` /
   ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``): its
   converged fraction, max violation and mean cost must be this process's
   refined solve's (phase 4's digits) and A and B must launch 94 times a
   solve (``[multi-gpu] part=nccl-1-rank``); then ``python -m
   mmmpc_tpu_torch.dryrun_multiprocess`` with two gloo ranks sharing the
   card (their collectives on host copies, ``host_staged=True``): the
   bench problem at a global batch of 8192 refined per shard, each shard
   held against this process's refined solve of its 4096 rows (to the bit,
   else at a relative cost of 1e-6 with the same flags; ``shard_held``
   says which), the reference's bar on the reduced global statistics, and
   the sharded fleet (1024 robots, 2 segments of 10 ticks), each rank's
   logs and carry held against this process's loop on its 512 robots
   (``fleet_held``; ``[multi-gpu] part=gloo-2-ranks``).  The card cannot
   show scaling across cards;
16. profile (also alone with ``--profile``): ``profile_solver`` and
   ``profile_generic`` at batch 8192: a ``[component]`` line for each
   component of an iteration and of an AL round of each row (device ms
   between CUDA events over 20 calls, the host's ms to issue them, busy ms
   and device operations of one call in the profiler, PyTorch operators),
   then ``[predicted]`` (the JAX script's predicted solve beside the
   measured median of 5 stage-1 solves);
17. tools (also alone with ``--tools``): ``sweep_refine``'s ``CONFIGS_R2``
   and ``sweep_schedule``'s ``SCHEDULES`` at batch 8192, 3 timed solves a
   row (``[sweep-refine]``, ``[sweep-schedule]``: each row finite; the
   bench's own row, ``5x(16,10,12)`` + ``3x12@1024``, must end with phase
   4's statistics to the bit and converged 1.0, ``[sweep-refine-held]``;
   alone, a refined solve's here); ``fleet_diag`` (128 robots, parity
   mode, 400 ticks: its lines, the final phase histogram and the
   completion, states finite, ``[fleet-diag]``); ``host_fleet_parity`` in a
   process of its own (8 robots, 400 ticks, 8 worker processes on the card:
   the completion and the flag histogram, states finite, A and B 60
   launches a solve in every worker, ``[host-fleet]``); ``fidelity_analysis``
   (both verdicts, ``[fidelity-analysis]``).  A, B, C.arm and D.arm must
   launch exactly as the parts' solves and ticks say (``[tools]``), each
   part's seconds in ``[tools-part]``.

Every solve phase prints the reference's bar (converged fraction 1.0, max
violation below 1e-3) or a closed-loop run's assertions as a ``[bar]``
line, and a line with ``met=False`` fails its phase.

Each phase from 2b on prints its wall seconds (``[phase]``), and each
profiled solve the seconds the profile took.  The last two lines are a
JSON record of the kernels (E at (4, 2), on no solve path, with its
launches in its own check; A and B with their launches in phase 4, as
``launches_bench`` in phase 4c, and, as
``launches_closed_loop``, in phase 9's runs; their moving instances with
their launches in phase 10's fused row solve and, as ``launches_demo``, in
its demo run; the fleet instances with their launches in phase 11's ticks,
which A and B also list as ``launches_fleet``; C.arm_cart and D.arm_cart
with their launches in phase 12's fused row solve; every C and D, as
``launches_single_robot``, in phase 12's single-robot ticks; the fixed
instances of A and B with their launches in phase 13's fused warm-up
solve; A, B and E, as ``launches_long_horizon``, in phase 14; A and B and
their fleet instances, as ``launches_multi_gpu``, in phase 15's ranks: the
NCCL rank's warm-up solve and the gloo ranks' sharded solves, and the gloo
ranks' fleet ticks; A, B, their fleet instances, C.arm and D.arm, as
``launches_tools``, in phase 17) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

BATCH = 8192
SMALL_BATCH = 1024
REPS = 10
# the unfused solves are host-bound at 0.1-1.9 s each: fewer timed solves
UNFUSED_REPS = 2
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
# the arm with its Cartesian reference (phase 12): the arm_only row's
# controller, starts and schedule, tracking the end point
CART_ROW = "arm_cartesian"
CART_REF = ((0.45, 0.0, 0.5), (0.35, 0.0, 0.6))
GENERIC = (*ROWS.values(), "arm_cart")
# each formulation's instance of the kernel templates
INSTANCE = {"demo": "gen::Demo", "base": "gen::Base",
            "arm": "gen::Arm<false>", "arm_cart": "gen::Arm<true>",
            "endpoint": "gen::Endpoint"}
# the formulations whose line search (C) and fused backward (D) run on the
# team kernels of generic_fwd.cuh / generic_bwd.cuh; the others (C.demo,
# D.demo, D.base) run one thread a candidate or a scenario
FWD_TEAMS = ("base", "arm", "arm_cart", "endpoint")
BWD_TEAMS = ("arm", "arm_cart", "endpoint")
# the arm's two instances, whose gains are held in the p99 / float64 form
ARMS = ("arm", "arm_cart")
# (nx, nu) of each generic formulation: its Riccati sweep instance
DIMS = {"demo": (2, 1), "base": (6, 2), "arm": (3, 3), "arm_cart": (3, 3),
        "endpoint": (9, 5)}
# device-kernel names (as the profiler reports them) of each wrapper; a
# profiled solve whose count of a kernel differs from its wrapper's
# launches fails (report_timing), so a renamed kernel cannot read 0 calls
KERNEL_SYMBOLS = {"wholebody_fwd": "wb::fwd_kernel",
                  "wholebody_bwd": "wb::bwd_kernel",
                  # their instances with per-scenario entries (the fleet)
                  "wholebody_fwd.fleet": "wb::fwd_kernel<2, true, true>",
                  "wholebody_bwd.fleet": "wb::bwd_kernel<8, true, true>",
                  # (the arm's instances by prefix: the demangler may
                  # close a nested template with "> >" or ">>")
                  **{f"generic_{d}.{f}":
                     f"gen::generic_{d}_kernel<{INSTANCE[f]}>"
                     for f in GENERIC for d in ("fwd", "bwd")},
                  **{f"generic_fwd.{f}":
                     f"gen::generic_fwd_team_kernel<{INSTANCE[f]}"
                     for f in FWD_TEAMS},
                  **{f"generic_bwd.{f}":
                     f"gen::generic_bwd_team_kernel<{INSTANCE[f]}"
                     for f in BWD_TEAMS},
                  **{f"riccati_bwd.{nx}x{nu}":
                     f"ric::riccati_team_kernel<{nx}, {nu}>"
                     for nx, nu in DIMS.values()}}
# the closed loop's runs (scenario, through the kinematic plant), and the
# MPC steps in which the JAX package's float32 demo completes scenario 1
# (README.md)
LOOP_SCENARIOS = ((1, False), (0, False), (2, False), (0, True))
JAX_DEMO_STEPS_SCENARIO_1 = 208
# the JAX package's float32 dynamic-obstacle demo (demo_wholebody_separate.py,
# model-only, on a CPU): its MPC steps to completion (move 37, approach 12,
# rotate 107, manipulate 21 ticks) and the base's least clearance to the
# obstacle's inflated circle over the run (m, at tick 27)
JAX_MOVING_DEMO_STEPS = 178
JAX_MOVING_DEMO_CLEARANCE = 0.0857
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
        **_bound([fwd.flat, *_operands(fwd),
                  *(a for a in fargs if torch.is_tensor(a))], got,
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
        **_bound([bwd.flat, *_operands(bwd),
                  *(a for a in bargs if torch.is_tensor(a))], got,
                 bwd_flops(N, B, nx, nu), peak))
    _line("kernel", name=name, **_fmt(out[name]))
    return out


def _operands(w):
    """A whole-body wrapper's per-scenario operands (none for the others)."""
    return tuple(w.ps.t.values()) if hasattr(w, "ps") else ()


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


def _wholebody_args(mpc, x0, params, rng, device):
    """Seeded inputs of kernels A and B from x0 (B, nx): the rollout of
    small random inputs, random gains, nonnegative inequality multipliers
    -> (A's arguments, B's arguments)."""
    from mmmpc_tpu_torch.solver.al_ilqr import rollout
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
    return ((X[:-1], U, kff, K, lam, lamt, lame, 10.0),
            (X, U, lam, lamt, lame, 10.0, reg))


def _wholebody_bwd_check(got, ref):
    """B's gains against its plain version's, rtol = atol = 5e-3: op-order
    differences amplified through the Cholesky on gains of magnitude
    ~10-100 (tests/test_fused_bwd.py)."""
    return max(_close("wholebody_bwd kff", got[0], ref[0], 5e-3, 5e-3),
               _close("wholebody_bwd K", got[1], ref[1], 5e-3, 5e-3))


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
        stage_al_blocks, terminal_al_blocks,
    )
    N, B = mpc.N, x0.shape[0]
    fargs, bargs = _wholebody_args(mpc, x0, params,
                                   np.random.default_rng(SEED), device)
    X, U, lam, lamt, lame, _, reg = bargs
    fwd = mpc.ocp.lanes_fwd_factory(cfg, params)
    bwd = mpc.ocp.lanes_bwd_factory(cfg, params)
    out = check_pair(("wholebody_fwd", "wholebody_bwd"), fwd, bwd, fargs,
                     bargs, (N, B, cfg.n_alpha, 9, 5, 28, 18),
                     _wholebody_bwd_check, peak, kinds)
    if "wholebody_fwd" in kinds:
        check_batches("wholebody_fwd", fwd.cuda, fwd.plain, fargs,
                      lambda g, r, a: max(_fwd_errors("wholebody_fwd", g, r)),
                      lambda n: fwd_geometry(LIBRARY.get(), fwd.N, fwd.n_obs,
                                             fwd.n_hp, len(fwd.alphas), n))
    if "wholebody_bwd" in kinds:
        check_batches("wholebody_bwd", bwd.cuda, bwd.plain, bargs,
                      lambda g, r, a: _wholebody_bwd_check(g, r),
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


def generic_problems(batch, device, rows=tuple(ROWS)):
    """(row, formulation, mpc, x0, U0, params) of each generic row of
    ``bench_controllers`` named in ``rows`` and, with CART_ROW among them,
    of the arm with its Cartesian reference: the arm_only row's wedge,
    starts and schedule, the end point from CART_REF[0] to CART_REF[1] (the
    reference of ``tests/test_generic_bwd.py::_arm_problem``) over N=20."""
    from mmmpc_tpu_torch.bench_controllers import CFG_SMALL, DT, problems
    from mmmpc_tpu_torch.controllers import MPCManipulator3DoF
    from mmmpc_tpu_torch.models.robots import ManipulatorPanda3DoF
    from mmmpc_tpu_torch.utils.convert import params_from_numpy
    for row, mpc, x0, U0, params in problems(batch, device):
        if row in rows:
            yield row, ROWS[row], mpc, x0, U0, params
        if row == "arm_only" and CART_ROW in rows:
            cart = MPCManipulator3DoF(
                ManipulatorPanda3DoF(DT),
                [n[None] for n in mpc.hp_normals_value], mpc.hp_points_value[0],
                N=mpc.N, is_cartesian_ref=True, solver_config=CFG_SMALL,
                device=device)
            traj = np.linspace(*CART_REF, mpc.N + 1)
            p = dict(cart.make_params(traj, np.zeros((mpc.N, 3))),
                     U_last=np.zeros((mpc.N, 3)))
            yield (CART_ROW, "arm_cart", cart, x0, U0,
                   params_from_numpy(p, device, torch.float32))


def _generic_args(mpc, form, x0, params, rng, device):
    """Seeded (fargs, bargs) of kernels C and D of ``mpc`` (its
    formulation ``form``) at the batch of ``x0``: a rollout of random
    inputs from ``x0``, random gains and multipliers, penalty 10,
    regularisation 1e-6."""
    from mmmpc_tpu_torch.solver.al_ilqr import rollout
    N, B, nx, nu = mpc.N, x0.shape[0], mpc.NX, mpc.NU
    nc, nct = form.nc, form.nct

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
    return fargs, bargs


def _generic_bwd_check(f, mpc, bwd, params):
    """check(got, ref, args) of D of formulation ``f``: the gains at rtol
    1e-4 and ``BWD_ATOL[f]``, the arms' in the p99 / float64 form."""
    from mmmpc_tpu_torch.ops.generic_bwd import plain_bwd
    _test_problems_path()
    from torch_problems import BWD_ATOL
    if f not in ARMS:
        return _gains_check(f"generic_bwd.{f}", 1e-4, BWD_ATOL[f])

    def check(got, ref, args):
        truth = plain_bwd(mpc.ocp, {k: v.double() for k, v in params.items()},
                          bwd.inv_scale,
                          *(a.double() if torch.is_tensor(a) else a
                            for a in args))
        return _check_f64(f"generic_bwd.{f}", got, ref, truth)
    return check


def check_generic(device, peak, kinds, rows=tuple(ROWS)):
    """Phase 3, kernels C and D of each formulation on its bench row (those
    of ``rows``), and E on the expansion blocks of D's inputs; the kernels
    whose kind is in ``kinds``."""
    from mmmpc_tpu_torch.ops._cuda import LIBRARY
    from mmmpc_tpu_torch.ops.generic_bwd import (
        launch_geometry as gen_bwd_geometry,
    )
    from mmmpc_tpu_torch.ops.generic_fwd import (
        launch_geometry as gen_fwd_geometry,
    )
    from mmmpc_tpu_torch.ops.riccati import plain_riccati_bm
    from mmmpc_tpu_torch.solver.al_ilqr import (
        stage_al_blocks, terminal_al_blocks,
    )
    _test_problems_path()
    from torch_problems import BWD_ATOL
    out = {}
    for row, f, mpc, x0, _, params in generic_problems(BATCH, device, rows):
        rng = np.random.default_rng(SEED)
        N, B, nx, nu, cfg = mpc.N, BATCH, mpc.NX, mpc.NU, mpc.solver_config
        fwd = mpc.ocp.lanes_fwd_factory(cfg, params)
        bwd = mpc.ocp.lanes_bwd_factory(cfg, params)
        nc, nct = fwd.form.nc, fwd.form.nct
        fargs, bargs = _generic_args(mpc, fwd.form, x0, params, rng, device)
        bwd_check = _generic_bwd_check(f, mpc, bwd, params)

        out.update(check_pair((f"generic_fwd.{f}", f"generic_bwd.{f}"), fwd,
                              bwd, fargs, bargs,
                              (N, B, cfg.n_alpha, nx, nu, nc, nct),
                              lambda g, r, bargs=bargs, check=bwd_check:
                              check(g, r, bargs), peak, kinds))
        form = bwd.form
        # every C and D at ragged batches (D.base and D.demo: their stage
        # buffer; one robot: the single-robot solve's batch)
        if "generic_bwd" in kinds:
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
        if f in ARMS:
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
        # the record keeps (9, 5) on qref's blocks, (3, 3) on the joint arm's
        if f not in ("endpoint", "arm_cart"):
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


def report_timing(tag, run, args, batch, counters, reps=REPS, profile=True,
                  **kv):
    """Time ``reps`` solves and, with ``profile``, profile one more; print
    both.  The profile
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
    if not profile:
        return med, reps
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


def _bar(row, conv, maxv):
    """Print the reference's bar of one solve -- converged fraction 1.0 and
    max violation below the 1e-3 tolerance (``bench.py``) -- and return
    whether it was met."""
    met = conv == 1.0 and maxv < 1e-3
    _line("bar", row=row, converged_frac_is_1=conv == 1.0,
          max_violation_below_1e_3=maxv < 1e-3, met=met)
    return met


def _bars_met(phase, bars):
    """Fail the phase unless every bar ({row: met}) was met."""
    missed = [row for row, met in bars.items() if not met]
    if missed:
        raise AssertionError(f"{phase}: the bar was missed by {missed}")


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
    _bars_met("slice", {"wholebody_qref_refined":
                        _bar("wholebody_qref_refined", conv, maxv)})
    return launches, (res, stats), med


def run_bench(device, slice_run=None):
    """Phase 4c: ``bench.run(BATCH, REPS)``, the solve and the timing of
    ``python -m mmmpc_tpu_torch.bench``, with A's and B's launches counted
    over its warm-up and timed solves.  ``slice_run``: (median seconds,
    BatchStats) of phase 4, printed beside and held to the bit."""
    from mmmpc_tpu_torch import bench
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    per_solve = (iteration_count(bench.SOLVER_CFG)
                 + iteration_count(bench.REFINE_CFG))
    counters = {"wholebody_fwd": wholebody_fwd.LAUNCHES,
                "wholebody_bwd": wholebody_bwd.LAUNCHES}
    for c in counters.values():
        c.reset()
    stats, metric = bench.run(BATCH, REPS, device)
    launches = count_launches(counters, per_solve, 1 + REPS)
    beside = {}
    if slice_run is not None:
        med, slice_stats = slice_run
        held = ((stats["converged_frac"], stats["max_violation"],
                 stats["mean_cost"])
                == (float(slice_stats.n_converged)
                    / float(slice_stats.n_solved),
                    float(slice_stats.max_violation),
                    float(slice_stats.mean_cost)))
        beside = dict(slice_solves_per_s_median=f"{BATCH / med:.1f}",
                      slice_max_violation=(
                          f"{float(slice_stats.max_violation):.3e}"),
                      slice_mean_cost=f"{float(slice_stats.mean_cost):.4f}",
                      held_to_the_bit=held)
    _line("bench", **_strs(stats), **_strs(metric),
          launches_per_solve=per_solve,
          **{f"launches_{k}": v for k, v in launches.items()}, **beside)
    _bars_met("bench", {"wholebody_qref_bench": _bar(
        "wholebody_qref_bench", stats["converged_frac"],
        stats["max_violation"])})
    if not beside.get("held_to_the_bit", True):
        raise AssertionError("bench: its statistics are not [slice]'s")
    return launches


NATIVE_SEED = 21


def run_native():
    """Phase 4d: the host runtime built with g++ and each function held
    against the port's float64 torch function (numpy for the reference
    windowing) on inputs from ``NATIVE_SEED``, at the tolerances of
    ``tests/test_torch_native.py``; prints the max abs error and the host
    microseconds a call of each side."""
    from mmmpc_tpu_torch import native
    from mmmpc_tpu_torch.models.arm import arm_fk
    from mmmpc_tpu_torch.models.mobile_manipulator import (
        wholebody_fk, wholebody_step,
    )
    from mmmpc_tpu_torch.native.bindings import RUNTIME
    from mmmpc_tpu_torch.runtime.reference import local_ref_traj, nearest_index
    from mmmpc_tpu_torch.sim.kinematic_plant import (
        plant_observation, plant_step,
    )

    RUNTIME.get()                       # raises on a failed build
    _line("native-build", library=RUNTIME.path.name,
          seconds=f"{RUNTIME.seconds:.2f}")
    rng = np.random.default_rng(NATIVE_SEED)
    t = torch.as_tensor
    tup = lambda v: v if isinstance(v, tuple) else (v,)
    traj = rng.normal(size=(40, 9))
    idx = np.array([0, 1])
    # name: (calls, inputs, native, counterpart, tolerance)
    cases = {
        "arm_fk": (50, lambda: (rng.uniform([-1.5, -3.0, 0.0],
                                            [1.5, 0.0, 4.5]),),
                   native.arm_fk, lambda q: arm_fk(t(q)), 1e-14),
        "wholebody_fk": (20, lambda: (rng.normal(size=9),),
                         native.wholebody_fk, lambda x: wholebody_fk(t(x)),
                         1e-13),
        "wholebody_step": (20, lambda: (rng.normal(size=9),
                                        rng.normal(size=5), 0.1),
                           native.wholebody_step,
                           lambda x, u, dt: wholebody_step(t(x), t(u), dt),
                           1e-14),
        "plant_step": (20, lambda: (rng.normal(size=12),
                                    rng.normal(size=11), 0.01),
                       native.plant_step,
                       lambda s, a, dt: plant_step(t(s), t(a), dt), 1e-14),
        "plant_observation": (20, lambda: (rng.normal(size=12),
                                           rng.normal(size=11)),
                              native.plant_observation,
                              lambda s, a: plant_observation(t(s), t(a)),
                              1e-14),
        "nearest_index": (20, lambda: (traj, traj[rng.integers(40)]
                                       + 0.01, idx),
                          native.nearest_index, nearest_index, 0.0),
        "local_ref_window": (20, lambda: (traj, int(rng.integers(40)), 9),
                             native.local_ref_window,
                             lambda tr, i, n: local_ref_traj(
                                 tr, np.zeros((39, 5)), tr[i], idx,
                                 n - 1)[0], 0.0),
        "integrate_command": (20, lambda: (rng.normal(size=2),
                                           rng.normal(size=2), 0.01),
                              native.integrate_command,
                              lambda v, c, dt: v + dt * c * [-1.0, 1.0],
                              1e-15),
    }
    failed = []
    for name, (n, inputs, fn_native, fn_port, tol) in cases.items():
        err, s_native, s_port = 0.0, 0.0, 0.0
        for _ in range(n):
            args = inputs()
            t0 = time.perf_counter()
            got = tup(fn_native(*args))
            t1 = time.perf_counter()
            want = tup(fn_port(*args))
            s_native += t1 - t0
            s_port += time.perf_counter() - t1
            for g, w in zip(got, want):
                w = w.numpy() if torch.is_tensor(w) else np.asarray(w)
                err = max(err, float(np.max(np.abs(np.asarray(g) - w))))
        _line("native", name=name, calls=n, max_abs_err=f"{err:.3e}",
              tol=tol, us_native=f"{1e6 * s_native / n:.2f}",
              us_port=f"{1e6 * s_port / n:.2f}", met=err <= tol)
        if not err <= tol:
            failed.append(name)
    if failed:
        raise AssertionError(f"native: {failed} outside their tolerances")


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
    _bars_met("unfused", {"wholebody_qref_refined_unfused":
                          _bar("wholebody_qref_refined_unfused", conv, maxv)})
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


def run_formulations(device, rows=tuple(ROWS)):
    """Phase 7: each generic row of ``rows`` at the bench batch through its
    kernels, held to a converged fraction of at least 0.99 and to the
    reference's bar (``_bar``)."""
    from mmmpc_tpu_torch.ops import generic_bwd, generic_fwd
    from mmmpc_tpu_torch.parallel.data_parallel import controller_batched_fn
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    launches, bars, results = {}, {}, {}
    for row, f, mpc, x0, U0, params in generic_problems(BATCH, device, rows):
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
        bars[row] = _bar(row, conv, maxv)
    _line("bar", row="all_formulations", met=all(bars.values()))
    _bars_met("formulations", bars)
    return launches, results


def run_formulations_unfused(device, fused, rows=tuple(ROWS)):
    """Phase 7b: each generic row of ``rows`` at the bench batch with the
    unfused backward, gated against ``fused`` {row: (result, stats)} of
    phase 7 and held as ``run_formulations`` holds it."""
    from mmmpc_tpu_torch.ops import generic_bwd, generic_fwd, riccati
    from mmmpc_tpu_torch.parallel.data_parallel import controller_batched_fn
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    launches, bars = {}, {}
    for row, f, mpc, x0, U0, params in generic_problems(BATCH, device, rows):
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
        launches[f] = count_launches(counters, per_solve, 1, absent)[ric]

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
        _reference_gate("formulations-unfused-vs-fused", (res, stats),
                        fused[row], row=row)
        if conv < 0.99:
            raise AssertionError(f"{row} unfused: converged_frac {conv} < 0.99")
        bars[f"{row}_unfused"] = _bar(f"{row}_unfused", conv, maxv)
    _line("bar", row="all_formulations_unfused", met=all(bars.values()))
    _bars_met("formulations-unfused", bars)
    # the record's launches of each sweep instance: its row's (qref's for
    # (9, 5), the joint arm's for (3, 3))
    return {"riccati_bwd.{}x{}".format(*DIMS[f]): n
            for f, n in launches.items() if f not in ("endpoint", "arm_cart")}


def check_formulations_reference(device, rows=tuple(ROWS)):
    """Phase 8: each generic row of ``rows`` at batch 64, card against
    CPU."""
    from mmmpc_tpu_torch.parallel.data_parallel import controller_batched_fn

    out = {}
    for dev in (device, torch.device("cpu")):
        for row, _, mpc, x0, U0, params in generic_problems(64, dev, rows):
            out.setdefault(row, {})[dev.type] = controller_batched_fn(
                mpc)(x0, U0, params)
    for row, o in out.items():
        _reference_gate("formulations-reference", o["cuda"], o["cpu"],
                        row=row)


def check_loop_kernels(device):
    """Phase 9, kernels A and B against their plain versions in the closed
    loop's own settings: scenario 1's controller of the demo with
    ``SolverConfig()`` (8 step sizes, cost_scale 1.0) at batch 1, with the
    terminal-equality mask off, on, and on with the rotate weights, on
    seeded inputs at the tolerances of the bench shape; each kernel's
    device ms a launch and its plain version's ms at that shape."""
    from mmmpc_tpu_torch.demo_wholebody_qref import build_world
    from mmmpc_tpu_torch.ops._cuda import LIBRARY
    from mmmpc_tpu_torch.ops.wholebody_bwd import (
        launch_geometry as bwd_geometry,
    )
    from mmmpc_tpu_torch.ops.wholebody_fwd import (
        launch_geometry as fwd_geometry,
    )
    from mmmpc_tpu_torch.utils.convert import params_from_numpy

    world = build_world(1, physical_sim=False, device=device)
    mpc = world.controller
    cfg, N = mpc.solver_config, mpc.N
    rng = np.random.default_rng(SEED)
    x0 = torch.as_tensor(world.x_start[None], dtype=torch.float32,
                         device=device)
    traj = np.linspace(world.x_start, world.x_target, N + 1)
    rotate = np.diag([5, 5, 5, 0, 0, 1, 1, 1, 1.0])
    for setting in ("eq_mask_0", "eq_mask_1", "rotate_weights"):
        if setting == "eq_mask_1":
            mpc.add_terminal_position_constraint()
        if setting == "rotate_weights":
            mpc.setWeight(P=rotate, Q=rotate)
        params = params_from_numpy(
            dict(mpc.make_params(traj, np.zeros((N, 5))),
                 U_last=0.1 * rng.standard_normal((N, 5))), device,
            torch.float32)
        fargs, bargs = _wholebody_args(mpc, x0, params, rng, device)
        fwd = mpc.ocp.lanes_fwd_factory(cfg, params)
        bwd = mpc.ocp.lanes_bwd_factory(cfg, params)
        got_f, ref_f = fwd.cuda(*fargs), fwd.plain(*fargs)
        got_b, ref_b = bwd.cuda(*bargs), bwd.plain(*bargs)
        torch.cuda.synchronize()
        err_xu, err_cost = _fwd_errors("wholebody_fwd", got_f, ref_f)
        err_b = _wholebody_bwd_check(got_b, ref_b)
        lib = LIBRARY.get()
        _line("kernel-loop", setting=setting, B=1, n_alpha=len(fwd.alphas),
              cost_scale=cfg.cost_scale,
              eq_mask=float(params["eq_mask"]),
              fwd_max_abs_err_XU=f"{err_xu:.3e}",
              fwd_max_abs_err_cost=f"{err_cost:.3e}",
              bwd_max_abs_err=f"{err_b:.3e}",
              fwd_ms=f"{_kernel_ms(lambda: fwd.cuda(*fargs), 20):.4g}",
              fwd_plain_ms=f"{_time_ms(lambda: fwd.plain(*fargs), 3):.4g}",
              bwd_ms=f"{_kernel_ms(lambda: bwd.cuda(*bargs), 20):.4g}",
              bwd_plain_ms=f"{_time_ms(lambda: bwd.plain(*bargs), 3):.4g}",
              **{f"fwd_{k}": v for k, v in fwd_geometry(
                  lib, N, fwd.n_obs, fwd.n_hp, len(fwd.alphas), 1).items()},
              **{f"bwd_{k}": v for k, v in bwd_geometry(
                  lib, N, bwd.n_obs, bwd.n_hp, 1).items()})


def run_loop_scenarios(device, counters):
    """Phase 9, the closed loop of the demo: scenarios 1, 0 and 2 with the
    model-only plant and scenario 0 through the kinematic plant, each run
    to its end, each tick a warm-started solve of ``MPCWholeBody`` on the
    card at batch 1, with the counters reset just before each run.  In
    every run each kernel of ``counters`` must launch once an iteration of
    every tick and its plain version never, and the run must meet the
    assertions of ``tests/test_runtime.py``'s closed-loop tests (its bar
    line).  Returns each kernel's launches over the runs."""
    from mmmpc_tpu_torch.demo_wholebody_qref import build_world
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    total, bars = dict.fromkeys(counters, 0), {}
    for scenario, physical in LOOP_SCENARIOS:
        world = build_world(scenario, physical_sim=physical, device=device)
        per_tick = iteration_count(world.controller.solver_config)
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        world.run()
        wall = time.perf_counter() - t0
        records = world.metrics.records
        for name, n in count_launches(counters, per_tick,
                                      len(records)).items():
            total[name] += n
        summary = world.metrics.summary()
        phases = list(dict.fromkeys(r.task_flag for r in records))
        err = float(np.linalg.norm(world.manipulator_pose_log[-1][:3]
                                   - world.global_pose_target[:3]))
        lat_ms = 1e3 * np.array([r.solve_latency_s for r in records])
        row = (f"closed_loop_scenario{scenario}_"
               f"{'plant' if physical else 'model_only'}")
        _line("closed-loop", scenario=scenario,
              plant="kinematic" if physical else "model_only",
              task_flag=repr(world.task_flag), steps=world.mpc_step_counter,
              **({"jax_float32_demo_steps": JAX_DEMO_STEPS_SCENARIO_1}
                 if (scenario, physical) == (1, False) else {}),
              ticks=len(records), phases=repr(",".join(phases)),
              ticks_converged=sum(r.converged for r in records),
              max_violation=f"{summary['max_violation']:.3e}",
              ee_err_m=f"{err:.3e}",
              solve_ms_p50=f"{np.percentile(lat_ms, 50):.3f}",
              solve_ms_p99=f"{np.percentile(lat_ms, 99):.3f}",
              wall_s=f"{wall:.1f}", launches_per_tick=per_tick)
        # tests/test_runtime.py: every run ends with the end effector on the
        # button; scenario 0 model-only also converges on every tick below
        # 1e-4 and visits rotate and manipulate, scenario 1 move and
        # manipulate
        met = world.task_flag == "manipulate finish" and err <= 0.01 + 1e-6
        if (scenario, physical) == (0, False):
            met = (met and summary["all_converged"]
                   and summary["max_violation"] < 1e-4
                   and {"rotate", "manipulate"} <= set(phases))
        if scenario == 1:
            met = met and {"move", "manipulate"} <= set(phases)
        bars[row] = met
        _line("bar", row=row, met=met)
    _bars_met("closed-loop", bars)
    return total


def profile_tick(device, counters):
    """Phase 9, one scenario-1 tick of the move phase, warm-started: the
    time of 10 ticks and the profile of one more (device busy time, the
    idle share of the median tick, the kernels' calls); then the same at
    a schedule of no iteration (``[closed-loop-tick-fixed]``): what a tick
    costs besides its iterations (params to the device, the kernels'
    packed params, the first rollout, the constraints, the result)."""
    from mmmpc_tpu_torch.demo_wholebody_qref import build_world
    from mmmpc_tpu_torch.runtime.reference import local_ref_traj

    world = build_world(1, physical_sim=False, device=device)
    mpc = world.controller
    world.globalPlan2D()
    traj, u = local_ref_traj(world.traj_ref, world.u_ref, world.x_start,
                             [0, 1], mpc.N)
    args = (world.x_start, traj, u)
    for tag, cfg in (("closed-loop-tick", mpc.solver_config),
                     ("closed-loop-tick-fixed", dataclasses.replace(
                         mpc.solver_config, al_iters=1, ilqr_iters=0))):
        mpc.solver_config = cfg
        mpc.reset()
        mpc.solve(*args)
        report_timing(tag, mpc.solve, args, 1, counters)


def run_rt_latency(device, counters):
    """Phase 9, ``mmmpc_tpu_torch/rt_latency.py``'s single-robot loop on the
    card (the cold tick, then its warm ticks at ``RT_CFG``), with the
    launch check of ``count_launches``."""
    from mmmpc_tpu_torch import rt_latency
    from mmmpc_tpu_torch.bench import SOLVER_CFG
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    for c in counters.values():
        c.reset()
    r = rt_latency.single_scenario(device)
    per_run = (iteration_count(SOLVER_CFG)
               + r["ticks"] * iteration_count(rt_latency.RT_CFG))
    launches = count_launches(counters, per_run, 1)
    _line("rt-latency", ticks=r["ticks"], p50_ms=f"{r['p50_ms']:.3f}",
          p99_ms=f"{r['p99_ms']:.3f}",
          converged_share=f"{r['converged_share']:.3f}",
          max_violation=f"{r['max_violation']:.3e}",
          **{f"launches_{k}": v for k, v in launches.items()})


def run_closed_loop(device):
    """Phase 9: A and B in the loop's settings, the demo's scenarios, one
    profiled tick, ``rt_latency``.  Returns the kernels' launches in the
    scenario runs."""
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd

    counters = {"wholebody_fwd": wholebody_fwd.LAUNCHES,
                "wholebody_bwd": wholebody_bwd.LAUNCHES}
    check_loop_kernels(device)
    launches = run_loop_scenarios(device, counters)
    profile_tick(device, counters)
    run_rt_latency(device, counters)
    return launches


MOVING = ("wholebody_fwd.moving", "wholebody_bwd.moving")


def _wb_geometry(w, n):
    """The launch geometry of whole-body wrapper ``w`` (A if it has step
    sizes, else B) at batch n, as the library reports it."""
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.ops._cuda import LIBRARY
    if hasattr(w, "alphas"):
        return wholebody_fwd.launch_geometry(
            LIBRARY.get(), w.N, w.n_obs, w.n_hp, len(w.alphas), n,
            moving=w.moving, per_scenario=w.ps.mask)
    return wholebody_bwd.launch_geometry(LIBRARY.get(), w.N, w.n_obs,
                                         w.n_hp, n, moving=w.moving,
                                         per_scenario=w.ps.mask)


def _moving_row(batch, device):
    """The ``wholebody_moving_obs`` row of ``bench_controllers`` at
    ``batch`` on ``device``: (controller, x0_b, U0_b, params)."""
    from mmmpc_tpu_torch.bench_controllers import problems
    for row, mpc, x0, U0, params in problems(batch, device):
        if row == "wholebody_moving_obs":
            return mpc, x0, U0, params
    raise AssertionError("bench_controllers has no wholebody_moving_obs row")


def check_moving_kernels(device, peak, kinds):
    """Phase 3 (and the first part of ``--moving-obs``), kernels A and B
    with an obstacle row a stage: on the ``wholebody_moving_obs`` row's
    seeded inputs at the bench shape against their plain versions, timed,
    with their bounds (``[kernel]``, as ``check_pair``), at the ragged
    batches 8191, 1000 and 1 (``[kernel-batch]``), and at the dynamic-
    obstacle demo's shape: batch 1, one obstacle predicted over N=20, 8
    step sizes, cost_scale 1.0 (``[kernel-batch]``, ``inputs=demo``); the
    kernels whose kind is in ``kinds``."""
    from mmmpc_tpu_torch.demo_wholebody_separate import build_world
    from mmmpc_tpu_torch.utils.convert import params_from_numpy

    mpc, x0, _, params = _moving_row(BATCH, device)
    cfg = mpc.solver_config
    fargs, bargs = _wholebody_args(mpc, x0, params,
                                   np.random.default_rng(SEED), device)
    fwd = mpc.ocp.lanes_fwd_factory(cfg, params)
    bwd = mpc.ocp.lanes_bwd_factory(cfg, params)
    if not (fwd.moving and bwd.moving):
        raise AssertionError("the moving row's kernels have no moving table")
    out = check_pair(MOVING, fwd, bwd, fargs, bargs,
                     (mpc.N, BATCH, cfg.n_alpha, 9, 5, 28, 18),
                     _wholebody_bwd_check, peak, kinds)

    # the demo's shape: its first tick's prediction and references
    world = build_world(physical_sim=False, device=device)
    demo = world.controller
    demo.observe_obstacles(world.obstacle_positions + world.dt
                           * world.obstacle_velocity, world.obstacle_velocity)
    rng = np.random.default_rng(SEED)
    traj = np.linspace(world.x_start, world.x_target, demo.N + 1)
    dparams = params_from_numpy(
        dict(demo.make_params(traj, np.zeros((demo.N, 5))),
             U_last=0.1 * rng.standard_normal((demo.N, 5))), device,
        torch.float32)
    dfargs, dbargs = _wholebody_args(
        demo, torch.as_tensor(world.x_start[None], dtype=torch.float32,
                              device=device), dparams, rng, device)
    dcfg = demo.solver_config
    for name, w, args, dw, dargs, err in (
            (MOVING[0], fwd, fargs, demo.ocp.lanes_fwd_factory(dcfg, dparams),
             dfargs, lambda g, r, a: max(_fwd_errors(MOVING[0], g, r))),
            (MOVING[1], bwd, bargs, demo.ocp.lanes_bwd_factory(dcfg, dparams),
             dbargs, lambda g, r, a: _wholebody_bwd_check(g, r))):
        if name.split(".")[0] not in kinds:
            continue
        check_batches(name, w.cuda, w.plain, args, err,
                      lambda n, w=w: _wb_geometry(w, n))
        got, ref = dw.cuda(*dargs), dw.plain(*dargs)
        torch.cuda.synchronize()
        _line("kernel-batch", name=name, inputs="demo", B=1,
              n_obs=dw.n_obs, n_alpha=dcfg.n_alpha,
              cost_scale=dcfg.cost_scale,
              max_abs_err=f"{err(got, ref, dargs):.4g}",
              ms=f"{_kernel_ms(lambda: dw.cuda(*dargs), 20):.4g}",
              plain_ms=f"{_time_ms(lambda: dw.plain(*dargs), 3):.4g}",
              **_wb_geometry(dw, 1))
    return out


def run_moving_row(device):
    """Phase 10, the ``wholebody_moving_obs`` row at the bench batch through
    ``controller_batched_fn``, fused and then with the unfused backward
    (E in place of B), each as phase 7 and 7b run a row: the launches of
    its warm-up solve (each kernel once an iteration, the absent ones and
    every plain version never), timing and profile, convergence and the
    bar; the unfused solve gated against the fused one (phase 6's gate);
    then the row at batch 64 on the card against the plain versions on the
    CPU.  Returns A's and B's launches in the fused warm-up solve."""
    from mmmpc_tpu_torch.ops import riccati, wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.parallel.data_parallel import controller_batched_fn
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    row = "wholebody_moving_obs"
    fused_counters = {"wholebody_fwd": wholebody_fwd.LAUNCHES,
                      "wholebody_bwd": wholebody_bwd.LAUNCHES}
    unfused_counters = {"riccati_bwd.9x5": riccati.LAUNCHES[(9, 5)],
                        "wholebody_fwd": wholebody_fwd.LAUNCHES}
    launches, bars, results = {}, {}, {}
    for backward in ("fused", "unfused"):
        mpc, x0, U0, params = _moving_row(BATCH, device)
        if backward == "fused":
            counters, absent = fused_counters, {}
        else:
            mpc.solver_config = dataclasses.replace(mpc.solver_config,
                                                    use_fused_backward=False)
            counters = unfused_counters
            absent = {"wholebody_bwd": wholebody_bwd.LAUNCHES}
        run = controller_batched_fn(mpc)
        per_solve = iteration_count(mpc.solver_config)
        for c in (*counters.values(), *absent.values()):
            c.reset()
        res, stats = run(x0, U0, params)
        torch.cuda.synchronize()
        n = count_launches(counters, per_solve, 1, absent)
        if backward == "fused":
            launches = {MOVING[0]: n["wholebody_fwd"],
                        MOVING[1]: n["wholebody_bwd"]}
        results[backward] = (res, stats)
        med, solves = report_timing(
            "moving-obs-timing", run, (x0, U0, params), BATCH, counters,
            reps=REPS if backward == "fused" else UNFUSED_REPS, row=row,
            backward=backward)
        count_launches(counters, per_solve, 1 + solves, absent)
        check_result(res, mpc, BATCH, device)
        conv = float(stats.n_converged) / float(stats.n_solved)
        maxv = float(stats.max_violation)
        _line("moving-obs", row=row, backward=backward, batch=BATCH,
              solves_per_s_median=f"{BATCH / med:.1f}",
              batch_latency_s_median=f"{med:.4f}",
              converged_frac=f"{conv:.6f}", max_violation=f"{maxv:.3e}",
              mean_cost=f"{float(stats.mean_cost):.6g}",
              launches_per_solve=per_solve,
              **{f"launches_{k}": v for k, v in n.items()},
              **{f"launches_{k}": 0 for k in absent})
        bars[f"{row}_{backward}"] = _bar(f"{row}_{backward}", conv, maxv)
    _reference_gate("moving-obs-unfused-vs-fused", results["unfused"],
                    results["fused"], row=row)
    card, cpu = (controller_batched_fn(mpc)(x0, U0, params)
                 for mpc, x0, U0, params in (_moving_row(64, dev) for dev in (
                     device, torch.device("cpu"))))
    _reference_gate("moving-obs-reference", card, cpu, row=row)
    _bars_met("moving-obs", bars)
    return launches


def run_moving_demo(device):
    """Phase 10, the dynamic-obstacle demo model-only on the card, run to
    its end with the counters reset just before it: A and B launch once an
    iteration of every tick and their plain versions never; the run must
    end with the task finished and the end effector within 1 cm of the
    button (``tests/test_runtime.py``'s assertion), and the base must keep
    out of the obstacle's circle inflated by its own radius at every tick,
    the clearance taken from ``x_log[i]`` and ``obstacle_log[i]`` (the state
    and the obstacle of tick i).  Prints the steps beside the JAX float32
    demo's, the least clearance beside the JAX demo's and p50 / p99 ms a
    tick.  Returns A's and B's launches in the run."""
    from collections import Counter

    from mmmpc_tpu_torch.demo_wholebody_separate import build_world
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    counters = {"wholebody_fwd": wholebody_fwd.LAUNCHES,
                "wholebody_bwd": wholebody_bwd.LAUNCHES}
    world = build_world(physical_sim=False, device=device)
    mpc = world.controller
    per_tick = iteration_count(mpc.solver_config)
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    world.run()
    wall = time.perf_counter() - t0
    records = world.metrics.records
    launches = count_launches(counters, per_tick, len(records))
    xs = np.array([x[:2] for x in world.x_log])
    obs = np.array([o[0] for o in world.obstacle_log])
    inflated = mpc.obstacle_list[0].radius + mpc.base_radius
    clear = np.hypot(*(xs - obs).T) - inflated
    summary = world.metrics.summary()
    err = float(np.linalg.norm(world.manipulator_pose_log[-1][:3]
                               - world.global_pose_target[:3]))
    lat_ms = 1e3 * np.array([r.solve_latency_s for r in records])
    _line("moving-obs-demo", task_flag=repr(world.task_flag),
          steps=world.mpc_step_counter,
          jax_float32_demo_steps=JAX_MOVING_DEMO_STEPS,
          ticks=len(records), ticks_a_phase=repr(",".join(
              f"{k}:{v}" for k, v in Counter(
                  r.task_flag for r in records).items())),
          ticks_converged=sum(r.converged for r in records),
          max_violation=f"{summary['max_violation']:.3e}",
          ee_err_m=f"{err:.3e}", min_clearance_m=f"{clear.min():.4f}",
          min_clearance_tick=int(clear.argmin()) + 1,
          jax_float32_demo_min_clearance_m=JAX_MOVING_DEMO_CLEARANCE,
          inflated_radius_m=inflated,
          solve_ms_p50=f"{np.percentile(lat_ms, 50):.3f}",
          solve_ms_p99=f"{np.percentile(lat_ms, 99):.3f}",
          wall_s=f"{wall:.1f}", launches_per_tick=per_tick,
          **{f"launches_{k}": v for k, v in launches.items()})
    met = (world.task_flag == "manipulate finish" and err <= 0.01 + 1e-6
           and len(clear) == world.mpc_step_counter and clear.min() >= 0.0)
    _line("bar", row="moving_obs_demo_model_only", met=met)
    _bars_met("moving-obs-demo", {"moving_obs_demo_model_only": met})
    return {f"{k}.moving": v for k, v in launches.items()}


def run_moving_obs(device):
    """Phase 10: the moving row's solves, then the demo.  Returns the
    moving kernels' launches: in the row's fused solve and, as
    ``launches_demo``, in the demo's run."""
    launches = run_moving_row(device)
    demo = run_moving_demo(device)
    return launches, demo


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


def _plain_f64(w, args):
    """Whole-body wrapper ``w``'s plain version (A's if it has step sizes,
    else B's) in float64, its params and ``args`` cast up, on the same
    device: the truth of its float32 plain version."""
    from mmmpc_tpu_torch.ops.generic_bwd import plain_bwd
    from mmmpc_tpu_torch.ops.generic_fwd import plain_fwd
    from mmmpc_tpu_torch.ops.wholebody_fwd import unpack_params
    p = w.ps.params(unpack_params(w.flat, w.N, w.n_obs, w.n_hp, w.moving))
    p = {k: v.double() for k, v in p.items()}
    a = tuple(t.double() if torch.is_tensor(t) else t for t in args)
    if hasattr(w, "alphas"):
        return plain_fwd(w.ocp, p, w.alphas, w.inv_scale, *a)
    return plain_bwd(w.ocp, p, w.inv_scale, *a)


def _fleet_bwd_check(w, args, tag):
    """check(got, ref) of B's gains with per-scenario entries on ``args``
    (wrapper ``w``): every entry within rtol = atol = 5e-3 of the plain
    float32 version or, where it is not, no farther from the float64 plain
    version (the truth) than 5e-3 + 5e-3 |truth| or than the float32 plain
    version itself is.  On the fleet's inputs the float32 sweep of the plain
    version ends up to 3.6e-2 off its float64 twin where the kernel is
    2.9e-2 off (measured on an H100; PERF.md): the kernel is held to the
    truth where the float32 reference is no better.  Prints both errors;
    returns the max |kernel - plain|."""
    truth = _plain_f64(w, args)

    def check(got, ref):
        worst = 0.0
        for k, g, r, t in zip(("kff", "K"), got, ref, truth):
            if not torch.isfinite(g).all():
                raise AssertionError(f"{tag} {k}: kernel output not finite")
            g, r = g.double(), r.double()
            e, e_true, r_true = (g - r).abs(), (g - t).abs(), (r - t).abs()
            off = e > 5e-3 + 5e-3 * r.abs()
            bad = off & (e_true > torch.maximum(5e-3 + 5e-3 * t.abs(), r_true))
            _line("kernel-f64", name=tag, tensor=k,
                  max_abs_err=f"{e.max().item():.3e}",
                  outside_plain_tol=int(off.sum()),
                  kernel_err_f64=f"{e_true.max().item():.3e}",
                  plain_f32_err_f64=f"{r_true.max().item():.3e}",
                  failing=int(bad.sum()))
            if bad.any():
                raise AssertionError(f"{tag} {k}: {int(bad.sum())} entries "
                                     f"outside rtol=5e-3 atol=5e-3 of the "
                                     f"plain version and farther from its "
                                     f"float64 twin than it")
            worst = max(worst, e.max().item())
        return worst

    return check


FLEET = ("wholebody_fwd.fleet", "wholebody_bwd.fleet")
# the fleet's batch (bench_fleet_tasks, rt_latency's fleet leg)
FLEET_BATCH = 1024


def check_fleet_kernels(device, peak, kinds):
    """Phase 3, kernels A and B with per-scenario entries (their
    instances ``<T, true, true>``) at the fleet's shape: the bench problem's
    controller and starts (N=20, 3 step sizes, cost_scale 1e5) at batch
    1024 with all six entries per robot (``torch_problems.fleet_params``:
    references, previous inputs, Q and P rows of the task weight table,
    eq_mask 0 and 1 mixed) against their plain versions, timed with their
    bounds (``[kernel]``, as ``check_pair``); then at the ragged batches
    1023, 1000 and 1 (``[kernel-batch]``), and with U_last alone at 1024
    and those batches (``keys=U_last``), each on wrappers built from the
    params of the batch's first robots; the kernels whose kind is in
    ``kinds``.  B's gains are held by ``_fleet_bwd_check``."""
    from mmmpc_tpu_torch.bench import build_problem_numpy
    from mmmpc_tpu_torch.ops._cuda import LIBRARY
    from mmmpc_tpu_torch.ops.wholebody_bwd import (
        launch_geometry as bwd_geometry,
    )
    from mmmpc_tpu_torch.ops.wholebody_fwd import (
        launch_geometry as fwd_geometry,
    )
    from mmmpc_tpu_torch.utils.convert import params_from_numpy
    _test_problems_path()
    from torch_problems import FLEET_KEYS, fleet_params

    mpc, x0_b, params = build_problem_numpy(FLEET_BATCH)
    cfg, N = mpc.solver_config, mpc.N
    x0 = torch.as_tensor(x0_b, dtype=torch.float32, device=device)
    out = {}
    for keys in (FLEET_KEYS, ("U_last",)):
        p = params_from_numpy(fleet_params(params, FLEET_BATCH, keys), device,
                              torch.float32)
        fargs, bargs = _wholebody_args(mpc, x0, p,
                                       np.random.default_rng(SEED), device)
        fwd = mpc.ocp.lanes_fwd_factory(cfg, p)
        bwd = mpc.ocp.lanes_bwd_factory(cfg, p)
        if fwd.ps.keys != keys or bwd.ps.keys != keys:
            raise AssertionError(f"the fleet's wrappers took {fwd.ps.keys} "
                                 f"per scenario, not {keys}")
        tag = "all" if keys == FLEET_KEYS else "+".join(keys)
        if keys == FLEET_KEYS:
            out.update(check_pair(FLEET, fwd, bwd, fargs, bargs,
                                  (N, FLEET_BATCH, cfg.n_alpha, 9, 5, 28, 18),
                                  _fleet_bwd_check(bwd, bargs, FLEET[1]),
                                  peak, kinds))
        for name, w, args, factory in (
                (FLEET[0], fwd, fargs, mpc.ocp.lanes_fwd_factory),
                (FLEET[1], bwd, bargs, mpc.ocp.lanes_bwd_factory)):
            if name.split(".")[0] not in kinds:
                continue
            for n in ((FLEET_BATCH,) if keys != FLEET_KEYS else ()) + (
                    FLEET_BATCH - 1, 1000, 1):
                sub = factory(cfg, {k: v[..., :n].contiguous()
                                    if k in keys else v
                                    for k, v in p.items()})
                a = tuple(x[..., :n].contiguous() if torch.is_tensor(x)
                          else x for x in args)
                err = (_fleet_bwd_check(sub, a, f"{name} B={n}")
                       if name == FLEET[1] else
                       lambda g, r: max(_fwd_errors(FLEET[0], g, r)))
                got, ref = sub.cuda(*a), sub.plain(*a)
                torch.cuda.synchronize()
                geometry = (fwd_geometry(LIBRARY.get(), N, w.n_obs, w.n_hp,
                                         len(w.alphas), n,
                                         per_scenario=w.ps.mask)
                            if hasattr(w, "alphas") else
                            bwd_geometry(LIBRARY.get(), N, w.n_obs, w.n_hp,
                                         n, per_scenario=w.ps.mask))
                _line("kernel-batch", name=name, keys=tag, B=n,
                      max_abs_err=f"{err(got, ref):.4g}", **geometry)
    return out


# the fleet phase: ticks of the relaxed fleet, the least completion and the
# least mean converged share of rt_latency's fleet leg it must reach
FLEET_TICKS = 400
FLEET_MIN_COMPLETION = 0.85
FLEET_RT_MIN_CONVERGED = 0.95


def run_fleet_tasks(device, counters):
    """Phase 11, ``bench_fleet_tasks``' relaxed fleet (1024 robots of
    scenario 1, N=20, its CFG, 40-tick segments) for FLEET_TICKS ticks
    from the start, with the counters reset just before them: A and B with
    per-scenario entries must launch once an iteration of every tick and
    their plain versions never.  Before them, after a warm-up tick, one
    tick runs under ``torch.cuda.set_sync_debug_mode("error")``: an op that
    makes the host wait for the card fails the phase (``[fleet-sync]``).
    A tick's time is read from CUDA events recorded as each tick's ops are
    issued (nothing waits).  Then one tick from the last carry timed and
    profiled (``[fleet-tick]``).  Fails when under FLEET_MIN_COMPLETION of
    the robots complete or a state turns non-finite.  Returns the kernels'
    launches in the FLEET_TICKS ticks."""
    from mmmpc_tpu_torch import bench_fleet_tasks as bft
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    fleet = bft.build_fleet(FLEET_BATCH, 1, relax=True, device=device)
    one = bft.build_fleet(FLEET_BATCH, 1, relax=True, device=device, chunk=1)
    one.run(one.x0, one.gpt)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one.run(one.x0, one.gpt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _line("fleet-sync", ticks=1, waits_for_the_card=0)
    for c in counters.values():
        c.reset()
    start = torch.cuda.Event(enable_timing=True)
    events = []

    def hook():
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    start.record()
    r = bft.run_fleet(fleet, FLEET_TICKS, hook)
    torch.cuda.synchronize()
    per_tick = iteration_count(fleet.cfg)
    launches = count_launches(counters, per_tick, FLEET_TICKS)
    tick_ms = np.diff([0.0] + [start.elapsed_time(e) for e in events])
    rec = bft.summary(fleet, 1, r)
    _line("fleet", batch=FLEET_BATCH, ticks=FLEET_TICKS, mode=rec["mode"],
          budget=repr(rec["budget"]), horizon=rec["horizon"],
          completion_rate=rec["completion_rate"],
          median_done_tick=rec["median_done_tick"],
          fleet_tick_ms_p50=f"{np.percentile(tick_ms, 50):.3f}",
          fleet_tick_ms_p99=f"{np.percentile(tick_ms, 99):.3f}",
          fleet_tick_ms_mean=rec["fleet_tick_ms"],
          robot_ticks_per_s=rec["robot_ticks_per_s"], wall_s=rec["wall_s"],
          max_violation=f"{r['max_violation']:.3e}",
          fallback_ticks=r["fallback_ticks"], states_finite=r["finite"],
          launches_per_tick=per_tick,
          **{f"launches_{k}": v for k, v in launches.items()})
    report_timing("fleet-tick", one.run, (one.x0, one.gpt, r["carry"]),
                  FLEET_BATCH, counters)
    met = r["finite"] and rec["completion_rate"] >= FLEET_MIN_COMPLETION
    _line("bar", row="fleet_relaxed",
          completion_at_least=f"{FLEET_MIN_COMPLETION}",
          states_finite=r["finite"], met=met)
    _bars_met("fleet", {"fleet_relaxed": met})
    return launches


def run_fleet_rt(device, counters):
    """Phase 11, ``rt_latency``'s fleet leg on the card (the bench problem
    at batch 1024: the cold tick, then its warm ticks at ``RT_CFG``, each
    robot's U_last its own warm inputs), with the launch check of
    ``count_launches``; fails when the mean converged share of a tick is
    under FLEET_RT_MIN_CONVERGED."""
    from mmmpc_tpu_torch import rt_latency
    from mmmpc_tpu_torch.bench import SOLVER_CFG
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    for c in counters.values():
        c.reset()
    r = rt_latency.fleet(device)
    per_run = (iteration_count(SOLVER_CFG)
               + r["ticks"] * iteration_count(rt_latency.RT_CFG))
    launches = count_launches(counters, per_run, 1)
    _line("fleet-rt", batch=r["batch"], ticks=r["ticks"],
          p50_ms=f"{r['p50_ms']:.3f}", p99_ms=f"{r['p99_ms']:.3f}",
          mean_converged=f"{r['mean_converged']:.4f}",
          min_converged=f"{r['min_converged']:.4f}",
          max_violation=f"{r['max_violation']:.3e}",
          **{f"launches_{k}": v for k, v in launches.items()})
    met = r["mean_converged"] >= FLEET_RT_MIN_CONVERGED
    _line("bar", row="fleet_rt",
          mean_converged_at_least=f"{FLEET_RT_MIN_CONVERGED}", met=met)
    _bars_met("fleet-rt", {"fleet_rt": met})


def run_fleet(device):
    """Phase 11: the relaxed fleet, one profiled tick, then rt_latency's
    fleet leg.  Returns A's and B's launches in the fleet's ticks."""
    from mmmpc_tpu_torch.ops import wholebody_bwd, wholebody_fwd

    counters = {FLEET[0]: wholebody_fwd.LAUNCHES,
                FLEET[1]: wholebody_bwd.LAUNCHES}
    launches = run_fleet_tasks(device, counters)
    run_fleet_rt(device, counters)
    return launches


SINGLE_TICKS = 10


def check_tick_kernels(row, f, mpc, x0, params, device):
    """Kernels C and D of formulation ``f`` against their plain versions at
    the single-robot tick's shape (``mpc.solver_config``, batch 1) on
    seeded inputs, at phase 3's tolerances (``[kernel-loop]``: errors,
    device and plain ms, launch geometries).  Its launches are not the
    tick's: the caller resets the counters after it."""
    from mmmpc_tpu_torch.ops._cuda import LIBRARY
    from mmmpc_tpu_torch.ops.generic_bwd import (
        launch_geometry as bwd_geometry,
    )
    from mmmpc_tpu_torch.ops.generic_fwd import (
        launch_geometry as fwd_geometry,
    )
    cfg, N = mpc.solver_config, mpc.N
    fwd = mpc.ocp.lanes_fwd_factory(cfg, params)
    bwd = mpc.ocp.lanes_bwd_factory(cfg, params)
    fargs, bargs = _generic_args(mpc, fwd.form, x0, params,
                                 np.random.default_rng(SEED), device)
    got_f, ref_f = fwd.cuda(*fargs), fwd.plain(*fargs)
    got_b, ref_b = bwd.cuda(*bargs), bwd.plain(*bargs)
    torch.cuda.synchronize()
    err_xu, err_cost = _fwd_errors(f"generic_fwd.{f}", got_f, ref_f)
    err_b = _generic_bwd_check(f, mpc, bwd, params)(got_b, ref_b, bargs)
    lib, form = LIBRARY.get(), fwd.form
    _line("kernel-loop", row=row, formulation=f, B=1,
          n_alpha=len(fwd.alphas), cost_scale=cfg.cost_scale,
          fwd_max_abs_err_XU=f"{err_xu:.3e}",
          fwd_max_abs_err_cost=f"{err_cost:.3e}",
          bwd_max_abs_err=f"{err_b:.3e}",
          fwd_ms=f"{_kernel_ms(lambda: fwd.cuda(*fargs), 20):.4g}",
          fwd_plain_ms=f"{_time_ms(lambda: fwd.plain(*fargs), 3):.4g}",
          bwd_ms=f"{_kernel_ms(lambda: bwd.cuda(*bargs), 20):.4g}",
          bwd_plain_ms=f"{_time_ms(lambda: bwd.plain(*bargs), 3):.4g}",
          **{f"fwd_{k}": v for k, v in fwd_geometry(
              lib, f, N, form.n_obs, form.n_hp, len(fwd.alphas), 1).items()},
          **{f"bwd_{k}": v for k, v in bwd_geometry(
              lib, f, N, form.n_obs, form.n_hp, 1).items()})


def run_single_robot(device):
    """Phase 12: each generic controller's warm-started ``solve`` at batch
    1 on the card (``SolverConfig()``: 6 AL rounds x 10 sweeps, 8 step
    sizes), from robot 0 of its row (the Cartesian arm's too): its C and D
    against their plain versions at that shape (``check_tick_kernels``),
    then, the float64 model plant stepped by each tick's u[0], a warm-up
    tick and ``SINGLE_TICKS`` ticks with the counters reset just before
    them, in which C and D must launch 60 times a tick and their plain
    versions never, and every tick must converge with max violation below
    1e-3 (``[single-robot]``: p50 / p99 ms a tick, converged ticks, max
    violation).  Returns {kernel: launches in those ticks}."""
    from mmmpc_tpu_torch.ops import generic_bwd, generic_fwd
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count
    from mmmpc_tpu_torch.utils.configs import SolverConfig

    cfg = SolverConfig()
    per_tick = iteration_count(cfg)
    launches = {}
    for row, f, mpc, x0, _, params in generic_problems(
            1, device, (*ROWS, CART_ROW)):
        mpc.solver_config = cfg
        check_tick_kernels(row, f, mpc, x0, params, device)
        traj = params["X_ref"].double().cpu().numpy()
        u_ref = params["U_ref"].double().cpu().numpy()
        x = x0[0].double().cpu()
        mpc.reset()

        def tick(x):
            u0 = mpc.solve(x.numpy(), traj, u_ref)
            return mpc.ocp.dynamics(x, torch.as_tensor(u0, dtype=x.dtype))

        x = tick(x)
        counters = {f"generic_fwd.{f}": generic_fwd.LAUNCHES[f],
                    f"generic_bwd.{f}": generic_bwd.LAUNCHES[f]}
        for c in counters.values():
            c.reset()
        ms, conv, viol = [], 0, 0.0
        for _ in range(SINGLE_TICKS):
            t0 = time.perf_counter()
            x = tick(x)
            ms.append(1e3 * (time.perf_counter() - t0))
            conv += bool(mpc.last_result.converged)
            viol = max(viol, float(mpc.last_result.max_violation))
        n = count_launches(counters, per_tick, SINGLE_TICKS)
        launches.update(n)
        if not torch.isfinite(x).all():
            raise AssertionError(f"{row}: the plant's state is not finite")
        p50, p99 = np.percentile(ms, [50, 99])
        _line("single-robot", row=row, formulation=f, ticks=SINGLE_TICKS,
              tick_ms_p50=f"{p50:.3f}", tick_ms_p99=f"{p99:.3f}",
              launches_per_tick=per_tick, converged_ticks=conv,
              max_violation=f"{viol:.3e}",
              **{f"launches_{k}": v for k, v in n.items()})
        if conv < SINGLE_TICKS or viol >= 1e-3:
            raise AssertionError(f"{row}: {conv} of {SINGLE_TICKS} ticks "
                                 f"converged, max violation {viol:.3e}")
    return launches


def run_fidelity(device, full):
    """Phase 12: the dossier of ``mmmpc_tpu_torch/fidelity_dossier.py``,
    its oracles in worker processes on the CPU (float64) while the
    controllers solve on the card: the per-solve rows, with ``full`` the
    closed-loop and self-consistency rows too (``[dossier]``, one JSON row
    each).  Fails on a missed gate (violation <= 1e-3 and relative cost
    <= 5e-3 against the best feasible oracle)."""
    from mmmpc_tpu_torch.fidelity_dossier import run_dossier

    _, _, failures = run_dossier(
        device, closed_loop=full, self_consistency=full,
        report=lambda ln: print("[dossier] " + ln, flush=True))
    if failures:
        raise AssertionError("fidelity gates missed: " + "; ".join(failures))


def run_controllers(device, peak, full):
    """Phase 12: the Cartesian arm's kernels (C.arm_cart and D.arm_cart
    against their plain versions at the bench shape and at 8191, 1000 and
    1, E(3, 3) on their expansion blocks), its row at the bench batch fused
    and unfused and card against CPU at 64 (phases 7, 7b and 8 for that
    row), every generic controller's kernels and single-robot ``solve``
    at the tick's shape and the fidelity dossier.  Returns (the kernels'
    timings, the row's launches, the single-robot launches)."""
    timings = check_generic(device, peak,
                            {"generic_fwd", "generic_bwd", "riccati_bwd"},
                            rows=(CART_ROW,))
    launches, fused = run_formulations(device, (CART_ROW,))
    run_formulations_unfused(device, fused, (CART_ROW,))
    check_formulations_reference(device, (CART_ROW,))
    single = run_single_robot(device)
    run_fidelity(device, full)
    return timings, launches, single


# ---- the fixed terminal formulation (K4) and the long horizon ----
FIXED = ("wholebody_fwd.fixed", "wholebody_bwd.fixed")


def check_fixed_kernels(device, peak, kinds):
    """Phase 3, kernels A and B of the fixed terminal formulation (statics
    ``bug_compat`` 0: the self-collision rows of x_N in the terminal
    group): on the qref bench problem built with
    ``replicate_terminal_selfcol_bug=False`` against their plain versions,
    timed, with their bounds (``[kernel]``), at the ragged batches 8191,
    1000 and 1 (``[kernel-batch]``), and on the problem of
    ``tests/torch_problems.py::selfcol_problem`` (batch 64, N=5, the arm
    folded so the terminal self-collision rows are live; ``inputs=selfcol``)
    with the excess over the tolerance of the bug-compatible kernel's
    outputs there (``differs_by_tolerances``: on these inputs the two
    settings must part); the kernels whose kind is in ``kinds``."""
    from mmmpc_tpu_torch.bench import build_problem
    from mmmpc_tpu_torch.utils.convert import params_from_numpy
    _test_problems_path()
    from torch_problems import selfcol_problem

    mpc, x0, _, params = build_problem(BATCH, device,
                                       replicate_terminal_selfcol_bug=False)
    cfg = mpc.solver_config
    fargs, bargs = _wholebody_args(mpc, x0, params,
                                   np.random.default_rng(SEED), device)
    fwd = mpc.ocp.lanes_fwd_factory(cfg, params)
    bwd = mpc.ocp.lanes_bwd_factory(cfg, params)
    if fwd.bug_compat or bwd.bug_compat:
        raise AssertionError("the fixed controller's kernels are "
                             "bug-compatible")
    out = check_pair(FIXED, fwd, bwd, fargs, bargs,
                     (mpc.N, BATCH, cfg.n_alpha, 9, 5, 28, 18),
                     _wholebody_bwd_check, peak, kinds)

    # the self-collision problem, both settings
    sel = {}
    for bug in (False, True):
        smpc, sx0, _, sp = selfcol_problem(bug)
        p = params_from_numpy(sp, device, torch.float32)
        sf, sb = _wholebody_args(
            smpc, torch.as_tensor(sx0, dtype=torch.float32, device=device), p,
            np.random.default_rng(SEED), device)
        sel[bug] = (smpc.ocp.lanes_fwd_factory(smpc.solver_config, p), sf,
                    smpc.ocp.lanes_bwd_factory(smpc.solver_config, p), sb)
    fwd_err = lambda g, r, a: max(_fwd_errors(FIXED[0], g, r))  # noqa: E731
    bwd_err = lambda g, r, a: _wholebody_bwd_check(g, r)  # noqa: E731
    for name, w, args, err, i, tol in (
            (FIXED[0], fwd, fargs, fwd_err, 0, (2e-3, 2e-3)),
            (FIXED[1], bwd, bargs, bwd_err, 2, (5e-3, 5e-3))):
        if name.split(".")[0] not in kinds:
            continue
        check_batches(name, w.cuda, w.plain, args, err,
                      lambda n, w=w: _wb_geometry(w, n))
        sw, sa = sel[False][i], sel[False][i + 1]
        got, ref = sw.cuda(*sa), sw.plain(*sa)
        other = sel[True][i].cuda(*sel[True][i + 1])
        torch.cuda.synchronize()
        # A's rollout does not depend on the flag: its cost does
        pairs = list(zip(got, other))[-1:] if i == 0 else zip(got, other)
        excess = min(((g - o).abs() / (tol[1] + tol[0] * o.abs())).max()
                     .item() for g, o in pairs)
        _line("kernel-batch", name=name, inputs="selfcol", B=sa[0].shape[-1],
              max_abs_err=f"{err(got, ref, sa):.4g}",
              differs_by_tolerances=f"{excess:.4g}", **_wb_geometry(sw, 64))
        if excess < 10:
            raise AssertionError(f"{name}: the fixed and the bug-compatible "
                                 f"kernels part by only {excess:.3g} "
                                 f"tolerances on the self-collision problem")
    return out


# the fixed formulation's solve on the self-collision problem: the
# schedule of tests/test_torch_fixed_terminal.py's whole solve
SELFCOL_SOLVE = dict(al_iters=6, ilqr_iters=12)


def run_fixed(device):
    """Phase 13: the refined solve of ``bench.py``'s problem in the fixed
    terminal formulation (``replicate_terminal_selfcol_bug=False``) at the
    bench batch through A and B, each 94 launches a solve, 10 solves timed (not
    profiled: a profile took 14.6 s of the phase), the bar.  On that problem
    the terminal self-collision rows never win, so the rest runs on the problem
    of ``tests/torch_problems.py::selfcol_problem`` (batch 64, N=5, the arm
    folded; ``SELFCOL_SOLVE``), where the two settings part: the fused solve on
    the card against the unfused one (A and E, launches counted) and against
    the plain versions on the CPU (phase 6's gate), and against the
    bug-compatible solve, which must part from it (the converged flags of fewer
    than 95% of the robots, or the mean costs more than 5e-3, alike).  Returns
    {kernel: launches} of the fused warm-up solve."""
    from mmmpc_tpu_torch.bench import REFINE_CFG, SOLVER_CFG, build_problem
    from mmmpc_tpu_torch.ops import riccati, wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.parallel.data_parallel import (
        controller_batched_fn, with_stats,
    )
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count
    from mmmpc_tpu_torch.utils.configs import SolverConfig
    from mmmpc_tpu_torch.utils.convert import params_from_numpy
    _test_problems_path()
    from torch_problems import SELFCOL_CFG, selfcol_problem

    mpc, x0, U0, params = build_problem(
        BATCH, device, SOLVER_CFG, replicate_terminal_selfcol_bug=False)
    run = with_stats(mpc.batch_solve_refined_fn(REFINE_CFG))
    per_solve = iteration_count(SOLVER_CFG) + iteration_count(REFINE_CFG)
    counters = {FIXED[0]: wholebody_fwd.LAUNCHES,
                FIXED[1]: wholebody_bwd.LAUNCHES}
    for c in counters.values():
        c.reset()
    res, stats = run(x0, U0, params)
    torch.cuda.synchronize()
    launches = count_launches(counters, per_solve, 1)
    med, solves = report_timing("fixed-timing", run, (x0, U0, params), BATCH,
                                counters, reps=REPS, profile=False)
    count_launches(counters, per_solve, 1 + solves)
    check_result(res, mpc, BATCH, device)
    conv = float(stats.n_converged) / float(stats.n_solved)
    maxv = float(stats.max_violation)
    _line("fixed", batch=BATCH, solves_per_s_median=f"{BATCH / med:.1f}",
          batch_latency_s_median=f"{med:.4f}",
          converged_frac=f"{conv:.6f}", max_violation=f"{maxv:.3e}",
          mean_cost=f"{float(stats.mean_cost):.4f}",
          launches_per_solve=per_solve,
          **{f"launches_{k}": v for k, v in launches.items()})
    bar = _bar("wholebody_qref_fixed", conv, maxv)

    # the self-collision problem: fused, unfused, the CPU, the other setting
    out = {}
    for tag, dev, fused, bug in (("fused", device, True, False),
                                 ("unfused", device, False, False),
                                 ("cpu", torch.device("cpu"), True, False),
                                 ("bug_compat", device, True, True)):
        cfg = SolverConfig(**dict(SELFCOL_CFG, **SELFCOL_SOLVE),
                           use_fused_backward=fused)
        smpc, sx0, sU0, sp = selfcol_problem(bug, cfg=cfg)
        f32 = dict(dtype=torch.float32, device=dev)
        args = (torch.as_tensor(sx0, **f32), torch.as_tensor(sU0, **f32),
                params_from_numpy(sp, dev, torch.float32))
        scount = ({FIXED[0]: wholebody_fwd.LAUNCHES} if dev.type == "cuda"
                  else {})
        scount.update({FIXED[1]: wholebody_bwd.LAUNCHES} if fused
                      else {"riccati_bwd.9x5": riccati.LAUNCHES[(9, 5)]})
        for c in (*scount.values(), wholebody_bwd.LAUNCHES):
            c.reset()
        out[tag] = controller_batched_fn(smpc)(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            count_launches(scount, iteration_count(cfg), 1,
                           {} if fused else
                           {"wholebody_bwd": wholebody_bwd.LAUNCHES})
    _reference_gate("fixed-unfused-vs-fused", out["unfused"], out["fused"],
                    problem="selfcol")
    _reference_gate("fixed-reference", out["fused"], out["cpu"],
                    problem="selfcol")
    try:
        _reference_gate("fixed-vs-bug-compat", out["bug_compat"],
                        out["fused"], problem="selfcol")
    except AssertionError:
        pass            # they part, as they must
    else:
        raise AssertionError("fixed-vs-bug-compat: the two settings of "
                             "replicate_terminal_selfcol_bug agree on the "
                             "self-collision problem")
    _bars_met("fixed", {"wholebody_qref_fixed": bar})
    return launches


# the long horizon: the kernels' horizons and batch, B's and E's reg there
# (a value the solve's reg schedule reaches, at which their float32 sweeps
# stay near float64 over 2000 stages; at the least reg, 1e-6, both float32
# sweeps, the kernel's and the plain version's, land far from float64:
# long_horizon_drift.py, PERF.md), and the benchmark's batches and horizons
LONG_HORIZONS = (100, 500, 2000)
LONG_BATCH = 64
LONG_REG = 1e-2
LONG_BENCH_BATCHES = (1, 8, 64)
LONG_ROW_HORIZONS = (20, 100, 500)
LONG_BENCH_REPS = 3


def _long_check(tag, tols, plain64):
    """check(got, ref, args) of a kernel's outputs at a long horizon: each
    output within its (rtol, atol) of ``tols`` of the float32 plain version
    (the bench tolerances); where entries miss it, held stage by stage to the
    float64 plain version ``plain64(args)`` by
    ``tests/torch_problems.py::drift_gate`` (on every stage the kernel's
    largest error at most twice the float32 plain version's largest within 32
    stages, or within the bench tolerance of the truth): over hundreds of
    stages two float32 orders of the same rollout drift apart by a random walk
    of roundings, the kernel's and the plain version's alike, so neither is the
    truth entry by entry.  Prints which gate held (``[kernel-gate]``: ``plain``
    or ``f64``); returns the max abs error against the float32 plain version."""
    _test_problems_path()
    from torch_problems import drift_gate

    def check(got, ref, a):
        worst, gate, truth = 0.0, "plain", None
        for i, (g, r, (rtol, atol)) in enumerate(zip(got, ref, tols)):
            if not torch.isfinite(g).all():
                raise AssertionError(f"{tag} output {i}: not finite")
            g, r = g.double(), r.double()
            e = (g - r).abs()
            off = e > atol + rtol * r.abs()
            if off.any():
                gate = "f64"
                truth = plain64(a) if truth is None else truth
                ratio, at = drift_gate(g, r, truth[i], rtol, atol)
                _line("kernel-f64", name=tag, output=i,
                      outside_plain_tol=int(off.sum()),
                      kernel_err_f64=f"{(g - truth[i]).abs().max():.3e}",
                      plain_f32_err_f64=f"{(r - truth[i]).abs().max():.3e}",
                      worst_slice=at, worst_ratio_to_bound=f"{ratio:.3f}")
                if ratio > 1.0:
                    raise AssertionError(
                        f"{tag} output {i}: at slice {at} the kernel is "
                        f"{ratio:.3g} times its bound from the float64 "
                        f"plain version")
            worst = max(worst, e.max().item())
        _line("kernel-gate", name=tag, gate=gate)
        return worst
    return check


FWD_TOLS = ((0.0, 2e-5),) * 3 + ((2e-3, 2e-3),)
BWD_TOLS = ((5e-3, 5e-3),) * 2


def check_long_horizon_kernels(device, peak):
    """Phase 14, first part: kernels A, B and E at N = 100, 500 and 2000 on
    ``bench_longhorizon``'s problem at batch 64 (seeded inputs as phase 3's,
    B's and E's reg ``LONG_REG``, A's feedback gains zero): one call against
    one call of the plain version (``_long_check``: A at X / U atol 2e-5 and
    cost rtol = atol 2e-3, B and E at 5e-3, or stage by stage no farther from
    the float64 plain version than twice the float32 one within 32 stages), the
    device ms a launch (a CUDA-graph replay of 5), the bound at that N, the
    shared-memory bytes and the blocks an SM holds (``[long-kernel]``); then
    the past-the-limit launch: A and B at the least N whose shared memory the
    card does not allow must raise a ValueError naming N and the bytes
    (``[long-limit]``).  Returns {kernel: launches}."""
    from mmmpc_tpu_torch import bench_longhorizon
    from mmmpc_tpu_torch.ops import riccati, wholebody_bwd, wholebody_fwd
    from mmmpc_tpu_torch.ops._cuda import LIBRARY, shared_memory_optin
    from mmmpc_tpu_torch.ops.riccati import (
        launch_geometry as ric_geometry, plain_riccati_bm,
        riccati_backward_bm,
    )
    from mmmpc_tpu_torch.solver.al_ilqr import (
        stage_al_blocks, terminal_al_blocks,
    )

    lib = LIBRARY.get()
    counters = {"wholebody_fwd": wholebody_fwd.LAUNCHES,
                "wholebody_bwd": wholebody_bwd.LAUNCHES,
                "riccati_bwd.9x5": riccati.LAUNCHES[(9, 5)]}
    for c in counters.values():
        c.reset()
    for N in LONG_HORIZONS:
        t0 = time.perf_counter()
        mpc, x0, _, params = bench_longhorizon.build(N, LONG_BATCH, device)
        cfg = mpc.solver_config
        fargs, bargs = _wholebody_args(mpc, x0, params,
                                       np.random.default_rng(SEED), device)
        fwd = mpc.ocp.lanes_fwd_factory(cfg, params)
        bwd = mpc.ocp.lanes_bwd_factory(cfg, params)
        na = cfg.n_alpha
        # B at LONG_REG, held to its float64 plain version where the
        # float32 one drifts
        X, U, lam, lamt, lame, mu, reg = bargs
        reg = torch.full_like(reg, LONG_REG)
        bargs = (*bargs[:-1], reg)
        got, ref = bwd.cuda(*bargs), bwd.plain(*bargs)
        torch.cuda.synchronize()
        err = _long_check(f"wholebody_bwd N={N}", BWD_TOLS,
                          lambda a: _plain_f64(bwd, a))(
            got, ref, bargs)
        geo = _wb_geometry(bwd, LONG_BATCH)
        _line("long-kernel", name="wholebody_bwd", N=N, B=LONG_BATCH,
              max_abs_err=f"{err:.3e}",
              ms=f"{_kernel_ms(lambda: bwd.cuda(*bargs), 5):.4g}",
              **_fmt(_bound([bwd.flat, X, U, lam, lamt, lame, reg], got,
                            bwd_flops(N, LONG_BATCH, 9, 5), peak)),
              smem_bytes=geo["smem_bytes"], blocks=geo["blocks"],
              blocks_per_sm=wholebody_bwd.blocks_per_sm(
                  lib, N, bwd.n_obs, bwd.n_hp))
        # A, the same way, with the feedback K off: phase 3's random gains
        # overflow the explicit Euler rollout over 2000 stages, and with
        # B's gains the state's float32 rounding, times the gains, sets
        # the inputs' error (long_horizon_drift.py); the feedforward stays
        # random
        fargs = (*fargs[:3], torch.zeros_like(fargs[3]), *fargs[4:])
        got, ref = fwd.cuda(*fargs), fwd.plain(*fargs)
        torch.cuda.synchronize()
        err = _long_check(f"wholebody_fwd N={N}", FWD_TOLS,
                          lambda a: _plain_f64(fwd, a))(
            got, ref, fargs)
        geo = _wb_geometry(fwd, LONG_BATCH)
        _line("long-kernel", name="wholebody_fwd", N=N, B=LONG_BATCH,
              max_abs_err=f"{err:.3e}",
              ms=f"{_kernel_ms(lambda: fwd.cuda(*fargs), 5):.4g}",
              **_fmt(_bound([fwd.flat, *fargs[:-1]], got,
                            fwd_flops(N, LONG_BATCH, na, 9, 5, 28, 18),
                            peak)),
              smem_bytes=geo["smem_bytes"], blocks=geo["blocks"],
              blocks_per_sm=wholebody_fwd.blocks_per_sm(
                  lib, N, fwd.n_obs, fwd.n_hp, na))
        # E on the expansion blocks of B's inputs
        inv = 1.0 / cfg.cost_scale
        blocks = (*stage_al_blocks(mpc.ocp, params, inv, X[:-1], U, lam, mu),
                  *terminal_al_blocks(mpc.ocp, params, inv, X[-1], lamt, lame,
                                      mu))
        eargs = (*blocks, reg)
        got, ref = riccati_backward_bm(*eargs), plain_riccati_bm(*eargs)
        torch.cuda.synchronize()
        err = _long_check(
            f"riccati_bwd.9x5 N={N}", BWD_TOLS,
            lambda a: plain_riccati_bm(*(t.double() for t in a)))(
                got, ref, eargs)
        _line("long-kernel", name="riccati_bwd.9x5", N=N, B=LONG_BATCH,
              max_abs_err=f"{err:.3e}",
              ms=f"{_kernel_ms(lambda: riccati_backward_bm(*eargs), 5):.4g}",
              **_fmt(_bound(eargs, got, ric_flops(N, LONG_BATCH, 9, 5),
                            peak)),
              **ric_geometry(9, 5, LONG_BATCH))
        _line("long-kernel-seconds", N=N,
              seconds=f"{time.perf_counter() - t0:.1f}")
    launches = {k: c.cuda for k, c in counters.items()}

    # past the limit: the least N whose blocks the card does not allow
    limit = shared_memory_optin(device.index)
    for name, mod in (("wholebody_fwd", wholebody_fwd),
                      ("wholebody_bwd", wholebody_bwd)):
        def smem(n, mod=mod):
            w = types.SimpleNamespace(N=n, n_obs=3, n_hp=3, moving=False,
                                      ps=types.SimpleNamespace(mask=0),
                                      **({"alphas": (1.0,) * 4}
                                         if mod is wholebody_fwd else {}))
            return _wb_geometry(w, 1)["smem_bytes"]
        lo, hi = 20, 20
        while smem(hi) <= limit:
            lo, hi = hi, 2 * hi
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if smem(mid) <= limit else (lo, mid)
        mpc, x0, _, params = bench_longhorizon.build(hi, 1, device)
        fargs, bargs = _wholebody_args(mpc, x0, params,
                                       np.random.default_rng(SEED), device)
        w = (mpc.ocp.lanes_fwd_factory if mod is wholebody_fwd
             else mpc.ocp.lanes_bwd_factory)(mpc.solver_config, params)
        before = mod.LAUNCHES.cuda
        try:
            w.cuda(*(fargs if mod is wholebody_fwd else bargs))
        except ValueError as e:
            msg = str(e)
        else:
            raise AssertionError(f"{name} at N={hi} ({smem(hi)} B) launched")
        if f"N={hi}" not in msg or str(smem(hi)) not in msg or \
                mod.LAUNCHES.cuda != before:
            raise AssertionError(f"{name}: {msg!r}")
        _line("long-limit", name=name, optin_bytes=limit, last_N_that_fits=lo,
              its_bytes=smem(lo), refused_N=hi, refused_bytes=smem(hi),
              raised=repr(msg))
    return launches


def _sweep_checks(mpc, x0, U0, params, cfg):
    """The two routes' sweeps on one row's first expansion (the rollout of
    U0 from x0, zero multipliers, the first penalty), with the float32
    blocks the route hands its sweep: (1) both sweeps in float64 at reg
    1e-14, where the assoc sweep's regularised input elimination and the
    sequential sweep's coincide: their largest gap over the largest entry
    (``sweep_gap``, gated under 1e-6); (2) the assoc sweep in float32 on
    the card at ``LONG_REG``, held stage by stage to its float64 version by
    ``drift_gate`` against the same float32 sweep on the CPU, at 5e-3
    (``f32_ratio``, gated at most 1; at the least reg both float32 sweeps
    land far from float64 and part from each other by chance, as B's and
    E's do); (3) at reg_init, the route's first sweep, how far the float32
    assoc sweep on the card lands from the float64 sequential one, over its
    largest entry (``f32_vs_seq``, printed), and the float64 assoc sweep's
    (``f64_vs_seq``: the reg in the input elimination alone)."""
    from mmmpc_tpu_torch.ops.assoc_riccati import assoc_riccati_backward_bm
    from mmmpc_tpu_torch.ops.riccati import plain_riccati_bm
    from mmmpc_tpu_torch.solver.al_ilqr import (
        rollout, stage_al_blocks, terminal_al_blocks,
    )
    _test_problems_path()
    from torch_problems import drift_gate

    B, N = x0.shape[0], mpc.N
    z = dict(dtype=torch.float32, device=x0.device)
    X, U = rollout(mpc.ocp, x0.T, U0.permute(1, 2, 0), params)
    inv = 1.0 / cfg.cost_scale
    blocks = (*stage_al_blocks(mpc.ocp, params, inv, X[:-1], U,
                               torch.zeros(N, 28, B, **z), cfg.mu_init),
              *terminal_al_blocks(mpc.ocp, params, inv, X[-1],
                                  torch.zeros(18, B, **z),
                                  torch.zeros(2, B, **z), cfg.mu_init))
    b64 = [t.double() for t in blocks]

    def reg(r, dtype=torch.float64):
        return torch.full((B,), r, dtype=dtype, device=x0.device)

    gap = max(((a - q).abs().max() / q.abs().max()).item() for a, q in zip(
        assoc_riccati_backward_bm(*b64, reg(1e-14)),
        plain_riccati_bm(*b64, reg(1e-14))))
    r32 = reg(LONG_REG, torch.float32)
    got = assoc_riccati_backward_bm(*blocks, r32)
    ref = assoc_riccati_backward_bm(*(t.cpu() for t in blocks), r32.cpu())
    truth = assoc_riccati_backward_bm(*b64, reg(LONG_REG))
    ratio = max(drift_gate(g, r.to(g.device), t, 5e-3, 5e-3)[0]
                for g, r, t in zip(got, ref, truth))
    seq = plain_riccati_bm(*b64, reg(cfg.reg_init))

    def apart(xs):
        return max(((x.double() - q).abs().max() / q.abs().max()).item()
                   for x, q in zip(xs, seq))
    return {"sweep_gap": gap, "f32_ratio": ratio,
            "f32_vs_seq": apart(assoc_riccati_backward_bm(
                *blocks, reg(cfg.reg_init, torch.float32))),
            "f64_vs_seq": apart(assoc_riccati_backward_bm(
                *b64, reg(cfg.reg_init)))}


def run_long_horizon_rows(device):
    """Phase 14, second part: ``bench_longhorizon``'s rows at batch 1, 8
    and 64 and N = 20, 100, 500 (at N = 2000 neither route's solve leaves
    the initial guess, in the port as in the JAX package, so that row
    would time refused line searches), the sequential route (kernels B and
    A) against the assoc route (the expansion, ``ops/assoc_riccati.py`` and
    A): a warm-up and ``LONG_BENCH_REPS`` solves each timed alone (the
    median, the least and the most), with the counters reset before each
    route: the sequential route launches B once an iteration and calls no
    assoc sweep, the assoc route launches no backward kernel (B, E) and
    calls the assoc sweep once an iteration; A launches once an iteration
    in both; every result finite.  Each row prints the routes' converged
    shares, the share of robots whose inputs left the initial guess, their
    relative mean cost and shared converged flags (not gated: on this
    problem the two routes' iterates part in the JAX package too, by up to
    a third of the mean cost; ``tests/test_torch_assoc_solve.py``) and
    ``_sweep_checks`` on the row's first expansion, two of them gated
    (``[long-horizon]``).  Returns the rows and {kernel: launches}."""
    from mmmpc_tpu_torch import bench_longhorizon
    from mmmpc_tpu_torch.ops import (
        assoc_riccati, riccati, wholebody_bwd, wholebody_fwd,
    )
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    cfg0 = bench_longhorizon.CFG
    per_solve = iteration_count(cfg0)
    solves = 1 + LONG_BENCH_REPS
    counters = {"wholebody_fwd": wholebody_fwd.LAUNCHES,
                "wholebody_bwd": wholebody_bwd.LAUNCHES,
                "riccati_bwd.9x5": riccati.LAUNCHES[(9, 5)],
                "assoc": assoc_riccati.CALLS}
    total = {"wholebody_fwd": 0, "wholebody_bwd": 0}
    rows = []
    for batch in LONG_BENCH_BATCHES:
        for N in LONG_ROW_HORIZONS:
            mpc, x0, U0, params = bench_longhorizon.build(N, batch, device)
            row, res = {"N": N, "batch": batch}, {}
            for name, assoc in (("scan", False), ("assoc", True)):
                for c in counters.values():
                    c.reset()
                cfg = dataclasses.replace(cfg0, use_assoc_scan=assoc)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    times, res[name] = bench_longhorizon.time_solve(
                        mpc, x0, U0, params, cfg, LONG_BENCH_REPS)
                n = {k: (c.cuda, c.plain) for k, c in counters.items()}
                want = {"wholebody_fwd": (per_solve * solves, 0),
                        "wholebody_bwd": (0 if assoc else
                                          per_solve * solves, 0),
                        "riccati_bwd.9x5": (0, 0),
                        "assoc": (per_solve * solves if assoc else 0, 0)}
                if n != want:
                    raise AssertionError(f"long-horizon N={N} batch={batch} "
                                         f"{name}: calls {n}, expected {want}")
                if not all(torch.isfinite(t).all() for t in (
                        res[name].X, res[name].U, res[name].cost)):
                    raise AssertionError(f"long-horizon N={N} batch={batch} "
                                         f"{name}: non-finite result")
                total["wholebody_fwd"] += n["wholebody_fwd"][0]
                total["wholebody_bwd"] += n["wholebody_bwd"][0]
                row[f"{name}_ms"] = float(np.median(times))
                row[f"{name}_ms_min"] = min(times)
                row[f"{name}_ms_max"] = max(times)
                row[f"{name}_converged"] = float(
                    res[name].converged.float().mean())
                row[f"{name}_moved"] = float(
                    (res[name].U != U0).flatten(1).any(1).float().mean())
                row[f"{name}_assoc_calls"] = n["assoc"][0]
                row[f"{name}_bwd_launches"] = n["wholebody_bwd"][0]
            row["rel_mean_cost"] = (
                abs(float(res["assoc"].cost.mean())
                    - float(res["scan"].cost.mean()))
                / abs(float(res["scan"].cost.mean())))
            row["same_converged"] = float(
                (res["scan"].converged == res["assoc"].converged)
                .float().mean())
            row.update(_sweep_checks(mpc, x0, U0, params, cfg0))
            _line("long-horizon", **_fmt(row),
                  speedup_assoc=f"{row['scan_ms'] / row['assoc_ms']:.3f}")
            rows.append(row)
    apart = [(r["N"], r["batch"]) for r in rows
             if not (r["sweep_gap"] < 1e-6 and r["f32_ratio"] <= 1.0)]
    if apart:
        raise AssertionError(f"long-horizon: the sweeps disagree at "
                             f"(N, batch) {apart}")
    return rows, total


def run_long_horizon(device, peak):
    """Phase 14 (also alone with ``--long-horizon``): the kernels at long
    horizons and the benchmark's rows, each part's seconds a
    ``[phase]`` line.  Returns {kernel: launches} in the phase."""
    launches = _phase("long-horizon-kernels", check_long_horizon_kernels,
                      device, peak)
    _, total = _phase("long-horizon-rows", run_long_horizon_rows, device)
    for k, v in total.items():
        launches[k] += v
    return launches


MULTI_GPU_TICKS = 10         # ticks a fleet segment; two segments
MULTI_GPU_TIMEOUT_S = 240


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_module(tag, args, env=None):
    """``python -m <args>`` from the checkout's root with a time limit;
    prints its output and raises unless it exits 0."""
    import os
    cmd = [sys.executable, "-m", *args]
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                          env={**os.environ, **(env or {})},
                          capture_output=True, text=True,
                          timeout=MULTI_GPU_TIMEOUT_S)
    for ln in proc.stdout.strip().splitlines():
        print(f"[{tag}-out] {ln}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-6000:], flush=True)
        raise AssertionError(f"{' '.join(args)}: exit {proc.returncode}")
    return proc.stdout


def run_multi_gpu(device):
    """Phase 15, the multi-GPU path on the one card: ``bench_multihost
    --refined`` as one NCCL rank under a torchrun-style environment, which
    must print the refined solve's statistics of this process (``[slice]``'s
    digits) with 94 launches each of A and B a solve; then
    ``dryrun_multiprocess`` with two gloo ranks sharing the card (the
    collectives on host copies: ``host_staged``), the bench problem at a
    global batch of 8192 refined per shard -- each shard held against this
    process's refined solve of the same 4096 rows (to the bit, else at a
    relative cost of 1e-6 with the same flags), the reference's bar on the
    global statistics -- and the sharded fleet (1024 robots, two segments
    of MULTI_GPU_TICKS ticks), each rank's logs and carry against this
    process's loop on its robots.  Returns the ranks' launches of A and B
    ({kernel: launches}: the static instances in the NCCL rank's warm-up
    solve and the gloo ranks' sharded solves, the fleet instances in the
    ranks' fleet ticks)."""
    import tempfile

    from mmmpc_tpu_torch import dryrun_multiprocess as dry
    from mmmpc_tpu_torch.bench import (
        BATCH as B, REFINE_CFG, SOLVER_CFG, build_problem,
    )
    from mmmpc_tpu_torch.bench_fleet_tasks import CFG as FLEET_CFG
    from mmmpc_tpu_torch.parallel.data_parallel import tree_map, with_stats
    from mmmpc_tpu_torch.sim.batch_task_engine import PHASE_DONE, TaskRolloutLog
    from mmmpc_tpu_torch.solver.al_ilqr import SolveResult, iteration_count

    per_solve = iteration_count(SOLVER_CFG) + iteration_count(REFINE_CFG)
    mpc, x0, U0, params = build_problem(B, device)
    run = with_stats(mpc.batch_solve_refined_fn(REFINE_CFG))
    res, stats = run(x0, U0, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()        # timed as bench_multihost times
    for _ in range(REPS):
        run(x0, U0, params)
    torch.cuda.synchronize()
    this_sps = B * REPS / (time.perf_counter() - t0)
    want = dict(converged_frac=f"{float(stats.n_converged) / B:.6f}",
                max_violation=f"{float(stats.max_violation):.3e}",
                mean_cost=f"{float(stats.mean_cost):.4f}")

    # 1. one NCCL rank, as torchrun starts it
    out = _run_module("multi-gpu-nccl", [
        "mmmpc_tpu_torch.bench_multihost", "--refined"], env=dict(
            MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
            WORLD_SIZE="1", RANK="0", LOCAL_RANK="0"))
    rec = json.loads(out.strip().splitlines()[-1])
    got = dict(converged_frac=f"{rec['converged_frac']:.6f}",
               max_violation=f"{rec['max_violation']:.3e}",
               mean_cost=f"{rec['mean_cost']:.4f}")
    nccl_launches = {k: v[0] for k, v in rec["launches_per_solve"].items()}
    _line("multi-gpu", part="nccl-1-rank", backend=rec["backend"],
          distributed=rec["distributed"], global_batch=rec["global_batch"],
          solves_per_s=rec["value"], **got,
          this_process=",".join(want.values()),
          this_process_solves_per_s=f"{this_sps:.1f}",
          **{f"launches_{k}": v for k, v in nccl_launches.items()})
    if (rec["backend"] != "nccl" or not rec["distributed"] or got != want
            or set(nccl_launches.values()) != {per_solve}):
        raise AssertionError(f"multi-gpu NCCL rank: {rec} against {want}, "
                             f"{per_solve} launches a solve")
    bars = {"multi_gpu_nccl": _bar("multi_gpu_nccl", rec["converged_frac"],
                                   rec["max_violation"])}

    # 2-3. two gloo ranks sharing the card: the sharded refined solve, the
    # sharded fleet
    base = Path(__file__).resolve().parent / "build" / "dryrun"
    base.mkdir(parents=True, exist_ok=True)
    outdir = Path(tempfile.mkdtemp(dir=base))
    fleet_b = FLEET_BATCH
    _run_module("multi-gpu-gloo", [
        "mmmpc_tpu_torch.dryrun_multiprocess", "--device", "cuda",
        "--backend", "gloo", "--problem", "bench", "--refined", "--fleet-batch",
        str(fleet_b), "--ticks", str(MULTI_GPU_TICKS), "--out", str(outdir),
        "--timeout", str(MULTI_GPU_TIMEOUT_S - 20)])
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(dry.NPROC)]
    fl_run, fx0, fgpt = dry.build_fleet("bench", fleet_b, MULTI_GPU_TICKS,
                                        device, torch.float32)
    launches = {"wholebody_fwd": nccl_launches["wholebody_fwd"],
                "wholebody_bwd": nccl_launches["wholebody_bwd"],
                FLEET[0]: 0, FLEET[1]: 0}
    per_tick = iteration_count(FLEET_CFG)
    for r, rk in enumerate(ranks):
        rows = slice(rk["offset"], rk["offset"] + rk["local"])
        twin = run(x0[rows], U0[rows], params)[0]
        held = dry.hold(SolveResult(**{k: v.to(device) for k, v in
                                       rk["res"].items()}), twin,
                        f"rank {r} shard")
        frows = slice(rk["fleet_offset"],
                      rk["fleet_offset"] + rk["fleet_local"])
        r1, rc1 = fl_run(fx0[frows], fgpt[frows])
        r2, rc2 = fl_run(fx0[frows], fgpt[frows], rc1)
        to_dev = lambda t: t.to(device) if torch.is_tensor(t) else t
        logs = tuple(TaskRolloutLog(**tree_map(to_dev, lg))
                     for lg in rk["fleet_logs"])
        fheld = dry.hold_fleet(logs, tree_map(to_dev, rk["fleet_carry"]),
                               (r1, r2), rc2, f"rank {r} fleet")
        st = rk["stats"]
        for k in ("wholebody_fwd", "wholebody_bwd"):
            if rk["launches"][k] != per_solve:
                raise AssertionError(f"rank {r}: {rk['launches'][k]} {k} "
                                     f"launches, expected {per_solve}")
            launches[k] += rk["launches"][k]
        for k, name in zip(("wholebody_fwd", "wholebody_bwd"), FLEET):
            if rk["fleet_launches"][k] != per_tick * 2 * MULTI_GPU_TICKS:
                raise AssertionError(f"rank {r} fleet: "
                                     f"{rk['fleet_launches'][k]} {k} launches")
            launches[name] += rk["fleet_launches"][k]
        done = float((logs[-1].phase[:, -1] == PHASE_DONE).float().mean())
        _line("multi-gpu", part="gloo-2-ranks", rank=r,
              backend=rk["backend"], host_staged=rk["host_staged"],
              rows=f"{rows.start}:{rows.stop}", shard_held=held,
              shard_held_in_rank=rk["held"]["shard"],
              global_n_solved=int(float(st["n_solved"])),
              global_converged_frac=f"{float(st['n_converged']) / B:.6f}",
              global_max_violation=f"{float(st['max_violation']):.3e}",
              global_mean_cost=f"{float(st['mean_cost']):.4f}",
              solve_s=f"{rk['solve_s']:.3f}",
              fleet_robots=f"{frows.start}:{frows.stop}",
              fleet_ticks=2 * MULTI_GPU_TICKS, fleet_held=fheld,
              fleet_held_in_rank=rk["held"]["fleet"],
              fleet_done_share=f"{done:.4f}", fleet_s=f"{rk['fleet_s']:.3f}",
              **{f"launches_{k}": v for k, v in rk["launches"].items()},
              **{f"fleet_launches_{k}": v
                 for k, v in rk["fleet_launches"].items()})
        if rk["backend"] != "gloo" or float(st["n_solved"]) != B:
            raise AssertionError(f"rank {r}: {rk['backend']}, n_solved "
                                 f"{float(st['n_solved'])}")
    st = ranks[0]["stats"]
    bars["multi_gpu_gloo_global"] = _bar(
        "multi_gpu_gloo_global", float(st["n_converged"]) / B,
        float(st["max_violation"]))
    _bars_met("multi-gpu", bars)
    shutil.rmtree(outdir, ignore_errors=True)
    return launches


def run_profile(device):
    """Phase 16: ``profile_solver`` and ``profile_generic`` at the bench
    batch: one ``[component]`` line per component of each row (device ms
    over 20 calls between CUDA events, the host's ms to issue them, busy
    ms and device operations of one call in the profiler, PyTorch
    operators), then ``[predicted]``, the predicted solve beside the
    measured median of 5.  Fails on a non-finite time, or a kernel
    component (the backward, the line search, E) with no device
    operation in its profile."""
    from mmmpc_tpu_torch import profile_generic, profile_solver
    recs = {"wholebody_qref (profile_solver)":
            profile_solver.main([str(BATCH)])}
    recs.update(profile_generic.main([str(BATCH)]))
    for row, rec in recs.items():
        for name, c in rec["components"].items():
            times = (c["device_ms"], c["host_ms"], c["busy_ms"])
            if any(t is None or not np.isfinite(t) for t in times):
                raise AssertionError(f"profile {row} {name}: {c}")
            if name in ("bwd_fused", "line_search", "riccati") and not (
                    c["device_ops"]):
                raise AssertionError(f"profile {row} {name}: no device op "
                                     f"({c})")
        if not np.isfinite(rec["measured_ms"]):
            raise AssertionError(f"profile {row}: measured {rec}")


# ---- the tools: the sweeps, the fleet diagnosis, the host loop, the
# fidelity analysis

# timed solves a sweep row here (the modules time 10 when run alone)
TOOLS_REPS = 3
FLEET_DIAG_BATCH = 128
HOST_FLEET_ROBOTS = 8
HOST_FLEET_TICKS = 400
HOST_FLEET_PROCS = 8
TOOLS_DIR = Path(__file__).resolve().parent / "build" / "tools"


def _strs(rec):
    """A record's values for ``_line``: strings quoted (they hold spaces)."""
    return {k: repr(v) if isinstance(v, str) else v for k, v in rec.items()}


def _stats_bits(stats):
    return tuple(float(v) for v in (stats.n_solved, stats.n_converged,
                                     stats.max_violation, stats.mean_cost))


def bench_refined_stats(device):
    """The BatchStats of phase 4's refined solve at the bench batch."""
    from mmmpc_tpu_torch.bench import REFINE_CFG, build_problem
    from mmmpc_tpu_torch.parallel.data_parallel import with_stats

    mpc, x0, U0, params = build_problem(BATCH, device)
    return with_stats(mpc.batch_solve_refined_fn(REFINE_CFG))(x0, U0,
                                                              params)[1]


def _finite(res):
    return all(bool(torch.isfinite(t).all())
               for t in (res.X, res.U, res.cost, res.max_violation))


def run_sweeps(device, slice_stats):
    """``sweep_refine``'s ``CONFIGS_R2`` and ``sweep_schedule``'s
    ``SCHEDULES`` at the bench batch, ``TOOLS_REPS`` timed solves a row
    after a warm-up (``[sweep-refine]``, ``[sweep-schedule]``).  Fails on a
    row whose results are not finite, and unless the bench's own row
    (``BENCH_ROW``) ends with the statistics of ``slice_stats`` to the bit
    (the same kernels in the same order on the same problem) and converged
    1.0 (``[sweep-refine-held]``); another row under 1.0 is a finding.
    Returns A's and B's launches: each row's iterations times its solves."""
    from mmmpc_tpu_torch import sweep_refine, sweep_schedule
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    solves, launches = 1 + TOOLS_REPS, 0
    for entry in sweep_refine.CONFIGS_R2:
        rec, res, stats = sweep_refine.run_row(entry, BATCH, device,
                                               TOOLS_REPS)
        cfg, rcfg, _ = sweep_refine.configs(entry)
        launches += solves * (iteration_count(cfg) + (
            0 if rcfg is None else iteration_count(rcfg)))
        _line("sweep-refine", batch=BATCH, reps=TOOLS_REPS, **_strs(rec),
              finite=_finite(res))
        if not _finite(res):
            raise AssertionError(f"sweep-refine {rec}: not finite")
        if entry is sweep_refine.BENCH_ROW:
            held = _stats_bits(stats) == _stats_bits(slice_stats)
            _line("sweep-refine-held", stage1=repr(rec["stage1"]),
                  refine=repr(rec["refine"]),
                  converged_frac=rec["converged_frac"],
                  max_violation=f"{rec['max_violation']:.3e}",
                  mean_cost=f"{float(stats.mean_cost):.4f}",
                  slice_max_violation=f"{float(slice_stats.max_violation):.3e}",
                  slice_mean_cost=f"{float(slice_stats.mean_cost):.4f}",
                  held_to_the_bit=held)
            if not held or rec["converged_frac"] != 1.0:
                raise AssertionError("the bench's row of the sweep is not "
                                     "[slice]'s solve")
    for row in sweep_schedule.SCHEDULES:
        rec, res, _ = sweep_schedule.run_row(row, BATCH, device, TOOLS_REPS)
        launches += solves * rec["iters"]
        _line("sweep-schedule", batch=BATCH, reps=TOOLS_REPS, **_strs(rec),
              finite=_finite(res))
        if not _finite(res):
            raise AssertionError(f"sweep-schedule {rec}: not finite")
    return launches


def run_fleet_diag(device):
    """``fleet_diag`` at its default batch, parity mode, 10 segments of 40
    ticks: the JAX script's lines (``[fleet-diag-out]``), then the final
    phase histogram and the completion (``[fleet-diag]``).  Fails when a
    state is not finite.  Returns A's and B's launches: 72 a tick."""
    from mmmpc_tpu_torch import fleet_diag
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    phase, X = fleet_diag.run(FLEET_DIAG_BATCH, False, device,
                              report=lambda line: None)
    d = fleet_diag.diagnose(phase, X)
    for ln in fleet_diag.report_lines(d, "parity", FLEET_DIAG_BATCH):
        print("[fleet-diag-out] " + ln.replace("\n", " "), flush=True)
    finite = bool(np.isfinite(X).all())
    _line("fleet-diag", batch=FLEET_DIAG_BATCH, ticks=phase.shape[1],
          mode="parity", completion=f"{d['completion']:.4f}",
          histogram=repr(dict(sorted(d["histogram"].items()))),
          failing=len(d["failing"]), states_finite=finite)
    if not finite:
        raise AssertionError("fleet-diag: a state is not finite")
    return phase.shape[1] * iteration_count(fleet_diag.CFG)


def run_host_fleet(device):
    """``python -m mmmpc_tpu_torch.host_fleet_parity`` with
    ``HOST_FLEET_ROBOTS`` robots, ``HOST_FLEET_TICKS`` ticks and
    ``HOST_FLEET_PROCS`` worker processes on the card (``_run_module``; a
    worker that raises fails it): its JSON line, then the completion and
    the flag histogram (``[host-fleet]``).  Fails when a robot's states are
    not finite, or its A and B launches are not 60 a solve (the host loop
    solves every tick but the one that ends the task).  Returns A's and B's
    launches in the workers."""
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count
    from mmmpc_tpu_torch.utils.configs import SolverConfig

    TOOLS_DIR.mkdir(parents=True, exist_ok=True)
    dump = TOOLS_DIR / "host_fleet.json"
    out = _run_module("host-fleet", [
        "mmmpc_tpu_torch.host_fleet_parity", str(HOST_FLEET_ROBOTS), "1",
        f"--ticks={HOST_FLEET_TICKS}", f"--procs={HOST_FLEET_PROCS}",
        f"--dump={dump}", f"--device={device.type}"])
    rec = json.loads(out.strip().splitlines()[-1])
    rows = json.loads(dump.read_text())
    per_solve = iteration_count(SolverConfig())
    finite = all(r["finite"] for r in rows)
    n = {k: sum(r["launches"][k] for r in rows)
         for k in ("wholebody_fwd", "wholebody_bwd")}
    counted = all(r["launches"][k] == per_solve * (r["steps"] - r["done"])
                  for r in rows for k in n)
    _line("host-fleet", robots=HOST_FLEET_ROBOTS, ticks=HOST_FLEET_TICKS,
          procs=HOST_FLEET_PROCS,
          completion=rec["host_completion_rate"],
          median_done_steps=rec["median_done_steps"],
          flags=repr(rec["final_flag_histogram"]), wall_s=rec["wall_s"],
          states_finite=finite, launches_per_solve=per_solve,
          **{f"launches_{k}": v for k, v in n.items()})
    if not finite or len(rows) != HOST_FLEET_ROBOTS or not counted:
        raise AssertionError(f"host-fleet: finite={finite}, {len(rows)} "
                             f"rows, launches {n} counted={counted}")
    return n["wholebody_fwd"]


def run_fidelity_analysis(device):
    """``fidelity_analysis``'s two cases on the card (float32 solves, the
    float64 oracles on the host): each verdict as one JSON object
    (``[fidelity-analysis]``).  Fails on a cost or violation that is not
    finite.  Returns (A's and B's launches, C.arm's and D.arm's)."""
    from mmmpc_tpu_torch import fidelity_analysis as fa
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count

    outs = []
    for case in (fa.arm_case, fa.qref_case):
        t0 = time.perf_counter()
        outs.append(case(device, torch.float32))
        print("[fidelity-analysis] " + json.dumps(
            dict(outs[-1], seconds=round(time.perf_counter() - t0, 1))),
            flush=True)
    arm, qref = outs
    numbers = [arm["our_cost"], arm["our_viol"], arm["oracle_best_cost"],
               qref["cost_prod"], qref["cost_tight"],
               qref["cost_polish_of_prod"], *qref["viol"]]
    if not np.isfinite(numbers).all():
        raise AssertionError(f"fidelity-analysis: {numbers}")
    return (iteration_count(fa.PROD) + 2 * iteration_count(fa.XTREME),
            2 * iteration_count(fa.TIGHT))


def run_tools(device, slice_stats=None):
    """Phase 17: the sweeps, the fleet diagnosis, the host loop's fleet and
    the fidelity analysis, each part with its ``[tools-part]`` seconds, the
    counters reset just before them.  ``slice_stats``: phase 4's
    statistics (with ``--tools``, a refined solve's here, before the
    counters are reset).  Fails unless every kernel that a part runs
    launched exactly as its solves and ticks say, and no plain version ran.
    Returns the kernels' launches in the phase (A's and B's fleet instances
    in the fleet diagnosis's ticks)."""
    from mmmpc_tpu_torch.ops import (
        generic_bwd, generic_fwd, wholebody_bwd, wholebody_fwd,
    )

    if slice_stats is None:
        slice_stats = bench_refined_stats(device)
    counters = {"wholebody_fwd": wholebody_fwd.LAUNCHES,
                "wholebody_bwd": wholebody_bwd.LAUNCHES,
                "generic_fwd.arm": generic_fwd.LAUNCHES["arm"],
                "generic_bwd.arm": generic_bwd.LAUNCHES["arm"]}
    for c in counters.values():
        c.reset()

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(device, *args)
        _line("tools-part", name=name,
              seconds=f"{time.perf_counter() - t0:.1f}")
        return out

    n_sweep = part("sweeps", run_sweeps, slice_stats)
    n_fleet = part("fleet-diag", run_fleet_diag)
    n_host = part("host-fleet", run_host_fleet)
    n_wb, n_arm = part("fidelity-analysis", run_fidelity_analysis)
    wb, arm = ("wholebody_fwd", "wholebody_bwd"), ("generic_fwd.arm",
                                                   "generic_bwd.arm")
    # the host loop's launches are its workers', counted in their processes
    count_launches({k: counters[k] for k in wb}, n_sweep + n_fleet + n_wb, 1)
    count_launches({k: counters[k] for k in arm}, n_arm, 1)
    launches = {**dict.fromkeys(wb, n_sweep + n_host + n_wb),
                **dict.fromkeys((f"{k}.fleet" for k in wb), n_fleet),
                **dict.fromkeys(arm, n_arm)}
    _line("tools", **{f"launches_{k}": v for k, v in launches.items()})
    return launches


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
    if not (argv in ([], ["--kernels"], ["--closed-loop"], ["--moving-obs"],
                     ["--fleet"], ["--controllers"], ["--fixed"],
                     ["--long-horizon"], ["--multi-gpu"], ["--profile"],
                     ["--tools"], ["--bench"])
            or (argv[:1] == ["--kernel"] and len(argv) == 2
                and argv[1] in KINDS)):
        print(f"chip_smoke: usage: [--kernels | --closed-loop | --moving-obs "
              f"| --fleet | --controllers | --fixed | --long-horizon | "
              f"--multi-gpu | --profile | --tools | --bench | --kernel one of "
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

    if argv == ["--closed-loop"]:
        _phase("closed-loop", run_closed_loop, device)
        return 0
    if argv == ["--moving-obs"]:
        _phase("kernels-moving", check_moving_kernels, device, None,
               {"wholebody_fwd", "wholebody_bwd"})
        _phase("moving-obs", run_moving_obs, device)
        return 0
    if argv == ["--fleet"]:
        _phase("fleet", run_fleet, device)
        return 0
    if argv == ["--controllers"]:
        _phase("controllers", run_controllers, device, None, True)
        return 0
    if argv == ["--fixed"]:
        _phase("fixed", run_fixed, device)
        return 0
    if argv == ["--long-horizon"]:
        _phase("long-horizon", run_long_horizon, device, None)
        return 0
    if argv == ["--multi-gpu"]:
        _phase("multi-gpu", run_multi_gpu, device)
        return 0
    if argv == ["--profile"]:
        _phase("profile", run_profile, device)
        return 0
    if argv == ["--tools"]:
        _phase("tools", run_tools, device)
        return 0
    if argv == ["--bench"]:
        _phase("bench", run_bench, device)
        return 0
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
    if kinds & {"wholebody_fwd", "wholebody_bwd"}:
        timings.update(_phase("kernels-moving", check_moving_kernels, device,
                              peak, kinds))
        timings.update(_phase("kernels-fleet", check_fleet_kernels, device,
                              peak, kinds))
        timings.update(_phase("kernels-fixed", check_fixed_kernels, device,
                              peak, kinds))
    if kinds & {"generic_fwd", "generic_bwd", "riccati_bwd"}:
        timings.update(_phase("kernels-generic", check_generic, device, peak,
                              kinds))
    if argv[:1] == ["--kernel"]:
        return 0
    _phase("cuda-tests", run_cuda_tests)
    if argv:
        return 0
    launches, fused, slice_med = _phase("slice", run_slice, device)
    launches.update(_phase("unfused", run_unfused, device, fused))
    bench_launches = _phase("bench", run_bench, device,
                            (slice_med, fused[1]))
    _phase("native", run_native)
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
    loop_launches = _phase("closed-loop", run_closed_loop, device)
    moving_launches, demo_launches = _phase("moving-obs", run_moving_obs,
                                            device)
    launches.update(moving_launches)
    fleet_launches = _phase("fleet", run_fleet, device)
    launches.update(fleet_launches)
    cart_timings, cart_launches, single_launches = _phase(
        "controllers", run_controllers, device, peak, False)
    timings.update(cart_timings)
    launches.update(cart_launches)
    launches.update(_phase("fixed", run_fixed, device))
    long_launches = _phase("long-horizon", run_long_horizon, device, peak)
    multi_launches = _phase("multi-gpu", run_multi_gpu, device)
    _phase("profile", run_profile, device)
    tools_launches = _phase("tools", run_tools, device, fused[1])
    # A and B launch their fleet instances in the fleet's ticks
    fleet_launches.update({name.split(".")[0]: n
                           for name, n in fleet_launches.items()})

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
            "library_ms": None,
            **({"launches_bench": bench_launches[name]}
               if name in bench_launches else {}),
            **({"launches_closed_loop": loop_launches[name]}
               if name in loop_launches else {}),
            **({"launches_demo": demo_launches[name]}
               if name in demo_launches else {}),
            **({"launches_fleet": fleet_launches[name]}
               if name in fleet_launches else {}),
            **({"launches_single_robot": single_launches[name]}
               if name in single_launches else {}),
            **({"launches_long_horizon": long_launches[name]}
               if name in long_launches else {}),
            **({"launches_multi_gpu": multi_launches[name]}
               if name in multi_launches else {}),
            **({"launches_tools": tools_launches[name]}
               if name in tools_launches else {})})
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

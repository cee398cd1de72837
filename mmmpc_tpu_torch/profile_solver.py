"""Component timing of the batched AL-iLQR solve on the bench problem
(counterpart of ``scripts/profile_solver.py``).

    python -m mmmpc_tpu_torch.profile_solver [batch] [--device cpu]
        [--reps 20] [--solves 5]

Times each component of one iLQR iteration (``solver/batched.py``:
``ilqr_iter``) and of one AL round (``al_round``) in isolation, on the
solver's own functions and at the state the solve starts from, at the bench
batch (8192) and ``SOLVER_CFG``:

- ``setup``: ``build_core`` and the kernels' factories (statics and
  packed params), once a solve; ``rollout``: the open-loop rollout, once a
  solve; ``objective``: the final objective, once a solve;
- ``bwd_fused``: the fused backward (kernel B; D on a generic row), once an
  iteration;
- ``stage_al_blocks``, ``terminal_al_blocks``: the unfused path's AL
  expansion in plain PyTorch, and ``riccati``: kernel E on its blocks;
- ``line_search``: the rollout and cost of every step size (kernel A; C);
- ``accept_step``: the argmin over step sizes, the pick and the merge;
- ``al_total``: the AL cost, once a round; ``update_multipliers``: the
  constraints and the multiplier update, once a round.

For each one line ``[component]``: ``device_ms``, the span of ``reps``
back-to-back calls between two CUDA events over ``reps`` (on the CPU the
wall clock: the CPU computes as it issues); ``host_ms``, the host's time to
issue them (before the synchronise) over ``reps``; ``busy_ms`` and
``device_ops``, the union of the device's intervals and the number of device
operations of one call under ``torch.profiler`` (not measured on the CPU);
``aten_ops``, the PyTorch operators one call dispatches.  Where
``device_ms`` is near ``host_ms`` and above ``busy_ms`` the component is
held by the host.  Then ``[predicted]``, as the JAX script predicts a
solve: iterations x (the per-iteration components) + AL rounds x (al_total
+ update_multipliers) + setup + rollout + objective, from the busy, the
event and the host
times, fused (B) and unfused (the expansion and E), beside the measured
median wall of ``solves`` stage-1 solves (``batch_solve_fn``, fused): what
the device time does not explain is the host's.  It runs on the card and
raises when there is no CUDA unless ``--device cpu`` is given (the plain
versions, at batch 8 unless a batch is given).
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

REPS = 20
SOLVES = 5
FUSED = ("bwd_fused", "line_search", "accept_step")
UNFUSED = ("stage_al_blocks", "terminal_al_blocks", "riccati",
           "line_search", "accept_step")
PER_ROUND = ("al_total", "update_multipliers")
PER_SOLVE = ("setup", "rollout", "objective")
# the marker kernel around a component's profile (torch.cuda._sleep), and
# the markers before it in a profile's first run, doubled in each run after
# a run that lost them all
_MARKER = "spin_kernel"
_PRELUDE = 256


class _AtenCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def aten_ops(fn) -> int:
    """PyTorch operators one call of ``fn`` dispatches."""
    with _AtenCount() as c:
        fn()
    return c.n


def components(mpc, x0_b, U0_b, params, cfg):
    """{name: a call of that component} at the state a solve of ``mpc``'s
    OCP under ``cfg`` starts from: the rollout of U0_b, zero multipliers,
    the first round's penalty, the initial regularisation; the line search
    and the merge on the fused backward's gains."""
    from mmmpc_tpu_torch.ocp.spec import batch_first
    from mmmpc_tpu_torch.ops.riccati import riccati_backward_bm
    from mmmpc_tpu_torch.solver.al_ilqr import (
        _objective, build_core, rollout, stage_al_blocks, terminal_al_blocks,
    )
    from mmmpc_tpu_torch.solver.batched import accept_step, update_multipliers

    ocp = mpc.ocp
    cparams = batch_first(params)
    core = build_core(ocp, cparams, cfg)
    B = x0_b.shape[0]
    kw = dict(dtype=x0_b.dtype, device=x0_b.device)
    x0_bm, U0_bm = x0_b.T, U0_b.permute(1, 2, 0)
    X, U = rollout(ocp, x0_bm, U0_bm, cparams)
    lams = (torch.zeros(ocp.N, core.nc, B, **kw), torch.zeros(core.nct, B, **kw),
            torch.zeros(core.ne, B, **kw))
    mu = core.mu_at(0)
    reg = torch.full((B,), cfg.reg_init, **kw)
    inv_scale = 1.0 / cfg.cost_scale
    fwd_ls = ocp.lanes_fwd_factory(cfg, params)
    bwd = ocp.lanes_bwd_factory(cfg, params)
    cost = core.al_total(X, U, lams, mu)
    kffs, Ks = bwd(X, U, *lams, mu, reg)
    cand = fwd_ls(X[:-1], U, kffs, Ks, *lams, mu)
    sblocks = stage_al_blocks(ocp, params, inv_scale, X[:-1], U, lams[0], mu)
    tblocks = terminal_al_blocks(ocp, params, inv_scale, X[-1], lams[1],
                                 lams[2], mu)
    return {
        "setup": lambda: (build_core(ocp, cparams, cfg),
                          ocp.lanes_fwd_factory(cfg, params),
                          ocp.lanes_bwd_factory(cfg, params)),
        "rollout": lambda: rollout(ocp, x0_bm, U0_bm, cparams),
        "bwd_fused": lambda: bwd(X, U, *lams, mu, reg),
        "stage_al_blocks": lambda: stage_al_blocks(
            ocp, params, inv_scale, X[:-1], U, lams[0], mu),
        "terminal_al_blocks": lambda: terminal_al_blocks(
            ocp, params, inv_scale, X[-1], lams[1], lams[2], mu),
        "riccati": lambda: riccati_backward_bm(*sblocks, *tblocks, reg),
        "line_search": lambda: fwd_ls(X[:-1], U, kffs, Ks, *lams, mu),
        "accept_step": lambda: accept_step(cfg, cand, X, U, cost, reg),
        "al_total": lambda: core.al_total(X, U, lams, mu),
        "update_multipliers": lambda: update_multipliers(core, X, U, lams,
                                                         mu),
        "objective": lambda: _objective(ocp, X, U, cparams),
    }


def _time(fn, device, reps):
    """(device_ms, host_ms) a call over ``reps`` calls after two warm-ups."""
    cuda = device.type == "cuda"
    for _ in range(2):
        fn()
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    if not cuda:
        return host, host
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def _busy_ms(spans):
    """The union of the intervals (us) of ``spans``, in ms."""
    busy, end = 0.0, -math.inf
    for t0, t1, _ in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy / 1e3


def _profile(fn, attempts=8):
    """(device_ops, busy_ms, runs, prelude_lost) of one call of ``fn``, each
    from a ``torch.profiler`` run of its own (device activity only).  A
    profiler run drops the first records it should hold, a count that grows
    with the age of the process and that no wait on the host keeps
    (``profiler_drops.py`` at the root prints it).  So a run issues marker
    kernels first, ``_PRELUDE`` in the first run and twice as many in each
    run after one that lost them all, then ``fn``, then one marker; it
    counts only when its last operation is that marker and a prelude marker
    survives (the component is what lies between them), and the result
    only when two runs agree on the count.  ``prelude_lost`` is the markers
    the counted run lost.  None after ``attempts`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counts, prelude = set(), _PRELUDE
    for run in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(prelude):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        marks = [i for i, sp in enumerate(spans) if _MARKER in sp[2]]
        if len(marks) < 2 or marks[-1] != len(spans) - 1:
            prelude *= 2
            continue
        ops = spans[marks[-2] + 1:-1]
        if len(ops) in counts:
            return len(ops), _busy_ms(ops), run, prelude + 1 - len(marks)
        counts.add(len(ops))
    return None


def profile_components(mpc, x0_b, U0_b, params, cfg, reps=REPS):
    """{component: {device_ms, host_ms, busy_ms, device_ops, profile_runs,
    prelude_lost, aten_ops}}."""
    device = x0_b.device
    calls = components(mpc, x0_b, U0_b, params, cfg)
    rows = {}
    for name, fn in calls.items():
        dev_ms, host_ms = _time(fn, device, reps)
        rows[name] = dict(device_ms=dev_ms, host_ms=host_ms, busy_ms=None,
                          device_ops=None, profile_runs=None,
                          prelude_lost=None, aten_ops=aten_ops(fn))
        if device.type == "cuda":
            p = _profile(fn)
            if p is not None:
                rows[name].update(device_ops=p[0], busy_ms=p[1],
                                  profile_runs=p[2], prelude_lost=p[3])
    return rows


def measured_solve_ms(mpc, x0_b, U0_b, params, solves=SOLVES):
    """Median wall ms of ``solves`` stage-1 solves (``batch_solve_fn``),
    each synchronised, after a warm-up."""
    run = mpc.batch_solve_fn()
    sync = (torch.cuda.synchronize if x0_b.device.type == "cuda"
            else lambda: None)
    run(x0_b, U0_b, params)
    sync()
    ts = []
    for _ in range(solves):
        t0 = time.perf_counter()
        run(x0_b, U0_b, params)
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def predict(rows, cfg, key):
    """The JAX script's predicted solve (ms) from each component's ``key``
    time: (fused, unfused), or None where one is not measured."""
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count
    n_iters = iteration_count(cfg)
    out = []
    for per_iter in (FUSED, UNFUSED):
        ts = [rows[c][key] for c in (*per_iter, *PER_ROUND, *PER_SOLVE)]
        if any(t is None for t in ts):
            out.append(None)
            continue
        out.append(sum(rows[c][key] for c in per_iter) * n_iters
                   + sum(rows[c][key] for c in PER_ROUND) * cfg.al_iters
                   + sum(rows[c][key] for c in PER_SOLVE))
    return tuple(out)


def _fmt(v, spec=".4f"):
    return "not_measured" if v is None else format(v, spec)


def report(row, mpc, x0_b, U0_b, params, cfg, reps=REPS, solves=SOLVES):
    """Profile one row, print its lines; returns {components, predicted}."""
    from mmmpc_tpu_torch.solver.al_ilqr import iteration_count
    rows = profile_components(mpc, x0_b, U0_b, params, cfg, reps)
    batch = x0_b.shape[0]
    for name, r in rows.items():
        per = ("solve" if name in PER_SOLVE else
               "round" if name in PER_ROUND else "iteration")
        print(f"[component] row={row} batch={batch} name={name} per={per} "
              f"device_ms={_fmt(r['device_ms'])} host_ms={_fmt(r['host_ms'])} "
              f"busy_ms={_fmt(r['busy_ms'])} device_ops="
              f"{_fmt(r['device_ops'], 'd')} profile_runs="
              f"{_fmt(r['profile_runs'], 'd')} prelude_lost="
              f"{_fmt(r['prelude_lost'], 'd')} aten_ops={r['aten_ops']}",
              flush=True)
    measured = (measured_solve_ms(mpc, x0_b, U0_b, params, solves)
                if solves else None)
    pred = {key: predict(rows, cfg, key)
            for key in ("busy_ms", "device_ms", "host_ms")}
    busy_fused = pred["busy_ms"][0]
    print(f"[predicted] row={row} batch={batch} iterations="
          f"{iteration_count(cfg)} al_rounds={cfg.al_iters} "
          + " ".join(f"{k.split('_')[0]}_{kind}_ms={_fmt(v[i], '.3f')}"
                     for k, v in pred.items()
                     for i, kind in enumerate(("fused", "unfused")))
          + f" measured_fused_median_ms={_fmt(measured, '.3f')}"
          + (f" host_share_of_measured={1 - busy_fused / measured:.3f}"
             if measured and busy_fused is not None else ""), flush=True)
    return dict(components=rows, predicted=pred, measured_ms=measured)


def _parse(argv, with_names=False):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=None)
    if with_names:
        ap.add_argument("names", nargs="*")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--solves", type=int, default=SOLVES)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "versions")
    if args.batch is None and args.device == "cpu":
        args.batch = 8
    return args


def main(argv=None):
    from mmmpc_tpu_torch.bench import BATCH, SOLVER_CFG, build_problem
    args = _parse(sys.argv[1:] if argv is None else argv)
    batch = args.batch or BATCH
    mpc, x0_b, U0_b, params = build_problem(batch, torch.device(args.device))
    return report("wholebody_qref", mpc, x0_b, U0_b, params, SOLVER_CFG,
                  args.reps, args.solves)


if __name__ == "__main__":
    main()

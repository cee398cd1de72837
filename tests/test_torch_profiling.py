"""The port's profiling tools (``utils/profiling.py``, ``profile_solver``,
``profile_generic``) on the CPU.

- ``SectionTimer.summary()`` equals the JAX class's on the same sections
  under the same (stepped) clock;
- ``device_trace`` writes a Chrome trace holding a ``trace_annotation``
  range by its name;
- ``profile_solver`` and ``profile_generic`` with ``--device cpu`` at batch
  8 (the plain versions; one rep, no solve timed) print every component of
  every row with finite times and operator counts, and their predictions;
  ``report`` on the small problem of ``tests/test_parallel.py`` times a
  solve too, and the components it times are the solver's own: one
  iteration of them reproduces an iteration of the solve.
"""

import contextlib
import dataclasses
import io
import itertools
import json
import math
import re
import time

import pytest
import torch

from mmmpc_tpu.utils import profiling as profiling_j
from mmmpc_tpu_torch import dryrun_multiprocess as dry
from mmmpc_tpu_torch import profile_generic, profile_solver
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.utils import profiling
from mmmpc_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

COMPONENTS = ("setup", "rollout", "bwd_fused", "stage_al_blocks",
              "terminal_al_blocks", "riccati", "line_search", "accept_step",
              "al_total", "update_multipliers", "objective")
ROWS = ("demo_1d", "base_only", "arm_only", "wholebody_endpoint",
        "wholebody_qref", "wholebody_moving_obs")
_KV = re.compile(r"(\w+)=(\S+)")


def _sections(timer):
    for name in ("solve", "plant", "solve", "log", "solve"):
        with timer.section(name):
            pass
    return timer.summary()


def test_section_timer_matches_jax(monkeypatch):
    def clock():
        ticks = itertools.count()
        return lambda: 0.25 * next(ticks) ** 1.5
    monkeypatch.setattr(time, "perf_counter", clock())
    got = _sections(profiling.SectionTimer())
    monkeypatch.setattr(time, "perf_counter", clock())
    ref = _sections(profiling_j.SectionTimer())
    assert got == ref
    assert got["solve"]["count"] == 3


def test_device_trace_holds_the_annotation(tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.trace_annotation("mmmpc_solve_stage"):
            torch.ones(4).cumsum(0)
    assert prof is not None
    (path,) = tmp_path.glob("trace.*.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "mmmpc_solve_stage" in names
    assert any(n and "cumsum" in n for n in names)


def _lines(text, tag):
    return [dict(_KV.findall(ln)) for ln in text.splitlines()
            if ln.startswith(f"[{tag}]")]


def _check_components(lines, rows):
    assert [(ln["row"], ln["name"]) for ln in lines] == [
        (r, c) for r in rows for c in COMPONENTS]
    for ln in lines:
        assert ln["batch"] == "8"
        for k in ("device_ms", "host_ms"):
            assert math.isfinite(float(ln[k])) and float(ln[k]) > 0, ln
        assert int(ln["aten_ops"]) > 0, ln
        # no device profile on the CPU
        assert ln["busy_ms"] == ln["device_ops"] == "not_measured"


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


def test_profile_solver_prints_every_component():
    out, text = _run(profile_solver.main,
                     ["8", "--device", "cpu", "--reps", "1", "--solves", "0"])
    _check_components(_lines(text, "component"), ("wholebody_qref",))
    (pred,) = _lines(text, "predicted")
    assert pred["iterations"] == "58" and pred["al_rounds"] == "5"
    for k in ("device_fused_ms", "device_unfused_ms", "host_fused_ms"):
        assert math.isfinite(float(pred[k])), pred
    assert set(out["components"]) == set(COMPONENTS)


def test_profile_generic_prints_every_row():
    out, text = _run(profile_generic.main,
                     ["8", "--device", "cpu", "--reps", "1", "--solves", "0"])
    _check_components(_lines(text, "component"), ROWS)
    preds = _lines(text, "predicted")
    assert [p["row"] for p in preds] == list(ROWS)
    assert all(p["iterations"] == "104" for p in preds)
    assert tuple(out) == ROWS


def test_profile_generic_takes_names():
    _, text = _run(profile_generic.main,
                   ["8", "demo_1d", "--device", "cpu", "--reps", "1",
                    "--solves", "0"])
    assert {ln["row"] for ln in _lines(text, "component")} == {"demo_1d"}


@pytest.fixture(scope="module")
def small():
    mpc, x0_g, U0_g, params, _ = dry.build_problem("qref", 8, False)
    return (mpc, torch.as_tensor(x0_g), torch.as_tensor(U0_g),
            params_from_numpy(params, "cpu", torch.float64))


def test_report_times_the_solve(small):
    mpc, x0, U0, params = small
    out, text = _run(lambda _: profile_solver.report(
        "small", mpc, x0, U0, params, mpc.solver_config, reps=2, solves=1),
        None)
    (pred,) = _lines(text, "predicted")
    assert float(pred["measured_fused_median_ms"]) > 0
    assert out["measured_ms"] == pytest.approx(
        float(pred["measured_fused_median_ms"]), abs=1e-3)
    assert pred["iterations"] == "8"


def test_components_are_one_solver_iteration(small):
    """The first iteration of the solve, rebuilt from the timed components,
    is the solve's own: a one-iteration solve lands where
    rollout -> bwd_fused -> line_search -> accept_step -> update_multipliers
    does."""
    mpc, x0, U0, params = small
    cfg = dataclasses.replace(mpc.solver_config, al_iters=1, ilqr_iters=1)
    calls = profile_solver.components(mpc, x0, U0, params, cfg)
    kffs, Ks = calls["bwd_fused"]()
    assert kffs.shape == (5, 5, 8) and Ks.shape == (5, 5, 9, 8)
    X, U, cost, reg = calls["accept_step"]()
    res = al_ilqr_solve_batched(mpc.ocp, x0, U0, params, cfg)
    assert torch.equal(res.U, U.permute(2, 0, 1))
    assert torch.equal(res.X, X.permute(2, 0, 1))
    lam_stage, lam_term, lam_eq, viol = calls["update_multipliers"]()
    assert lam_stage.shape[-1] == 8 and viol.shape == (8,)

"""The port's benchmark entry point ``mmmpc_tpu_torch/bench.py`` (``run``
and ``main``, the counterpart of ``bench.py:90-145``) on the CPU, where the
kernels' wrappers run their plain versions.

Batch 8 at a schedule of one AL round of two sweeps
(``SolverConfig(al_iters=1, ilqr_iters=2)``) and a refine of one sweep:
short enough that robots fail, so ``report_unconverged``'s report must
reach stderr.  The statistics carry ``bench.py``'s keys, the metric line is
stdout's last line with ``bench.py``'s keys in its order, and the JAX
script ``bench.py`` is never imported.  No JAX solve.
"""

import json
import sys

import pytest
import torch

from mmmpc_tpu_torch import bench
from mmmpc_tpu_torch.solver.refine import continue_mu
from mmmpc_tpu_torch.utils.configs import SolverConfig

torch.set_num_threads(1)

SHORT = SolverConfig(al_iters=1, ilqr_iters=2)
SHORT_REFINE = continue_mu(SHORT, SHORT.al_iters, al_iters=1, ilqr_iters=1,
                           ilqr_iters_later=1, ilqr_iters_final=None)
STATS = {"device": str, "n_devices": int, "batch": int, "reps": int,
         "horizon": int, "batch_latency_s": float, "converged_frac": float,
         "max_violation": float, "mean_cost": float}
METRIC = {"metric": str, "value": float, "unit": str, "vs_baseline": float}
REPORT = "[worst-scenario report]"


def _check(stats, metric, batch, reps):
    assert list(stats) == list(STATS)
    assert all(isinstance(stats[k], t) for k, t in STATS.items()), stats
    assert list(metric) == list(METRIC)
    assert all(isinstance(metric[k], t) for k, t in METRIC.items()), metric
    assert (stats["device"], stats["n_devices"], stats["batch"],
            stats["reps"], stats["horizon"]) == ("cpu", 1, batch, reps, 20)
    assert 0.0 <= stats["converged_frac"] < 1.0
    assert stats["max_violation"] >= SHORT.constraint_tol
    assert metric["metric"] == "wholebody_qref_solves_per_s"
    assert metric["unit"] == "solves/s"
    rate = batch / stats["batch_latency_s"]
    assert metric["value"] == pytest.approx(rate, abs=0.05)
    assert metric["vs_baseline"] == pytest.approx(rate / 10.0, abs=0.05)


@pytest.fixture
def short_schedule(monkeypatch):
    monkeypatch.setattr(bench, "SOLVER_CFG", SHORT)
    monkeypatch.setattr(bench, "REFINE_CFG", SHORT_REFINE)


def test_bench_run(short_schedule, capsys):
    stats, metric = bench.run(8, 2, "cpu")
    _check(stats, metric, 8, 2)
    out, err = capsys.readouterr()
    assert out == ""
    assert REPORT in err


def test_bench_main(short_schedule, monkeypatch, capsys):
    monkeypatch.delitem(sys.modules, "bench", raising=False)
    monkeypatch.setattr(bench, "BATCH", 8)
    monkeypatch.setattr(bench, "REPS", 1)
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    err_lines = err.splitlines()
    assert REPORT in err
    _check(json.loads(err_lines[-1]), json.loads(lines[-1]), 8, 1)
    assert "bench" not in sys.modules

"""The port's multi-process scale-out against the JAX package's.

Two ranks joined by ``torch.distributed`` over gloo on the CPU, started by
``python -m mmmpc_tpu_torch.dryrun_multiprocess`` (worker processes of
their own, which never import this file or JAX; the group's store a file in
``tmp_path``), on the small whole-body problem of ``tests/test_parallel.py``
(N=5, 2 AL rounds x 4 sweeps, batch 16, float64, the plain kernels) and its
small fleet (scenario 0, 16 robots, two segments of 3 ticks):

- the gathered sharded solve against JAX's ``sharded_solve_fn`` on the
  8-device CPU mesh (its single-scenario solver vmapped), by relative cost
  and feasibility (ROADMAP queue 3: never by |dU|);
- each rank's shard against the port's single-process solve of its rows,
  the reduced statistics against the global batch's, the robot-by-robot
  solve (``batch_impl=None``) against the batched one: to the bit (held on
  this problem; the gates allow a relative cost of 1e-6 where batch size
  moves CPU rounding);
- each rank's fleet log and carry against the single-process loop on its
  robots (to the bit) and on the whole fleet (phases exactly, states and
  inputs at ``tests/test_parallel.py``'s 1e-6);
- the single-process helpers (``init_distributed`` with no settings,
  ``process_batch_slice``, ``make_mesh``, ``host_local_batch``) against
  JAX's where JAX has them.

JAX's sharded solve compiles at XLA's lowest CPU level in a thread while
the ranks run.
"""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu.controllers import MPCWholeBody as MPCWholeBodyJ
from mmmpc_tpu.models.obstacles import Obstacles as ObstaclesJ
from mmmpc_tpu.models.robots import MobileManipulator as MobileManipulatorJ
from mmmpc_tpu.parallel import make_mesh as make_mesh_j
from mmmpc_tpu.parallel import sharded_solve_fn as sharded_solve_fn_j
from mmmpc_tpu.parallel.multihost import (
    process_batch_slice as process_batch_slice_j,
)
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu_torch import dryrun_multiprocess as dry
from mmmpc_tpu_torch.parallel import (
    BatchStats, gather_batch, host_local_batch, init_distributed, make_mesh,
    process_batch_slice, reduce_stats, with_stats,
)
from mmmpc_tpu_torch.parallel.data_parallel import tree_leaves
from mmmpc_tpu_torch.solver.al_ilqr import SolveResult
from mmmpc_tpu_torch.sim.batch_task_engine import TaskRolloutLog
from mmmpc_tpu_torch.utils.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
B, FLEET, TICKS, NPROC = 16, 16, 3, 2
LOCAL = B // NPROC
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
F64 = torch.float64

torch.set_num_threads(1)


def _jax_sharded(x0_b, params):
    """JAX's sharded solve of the same problem on the 8-device mesh."""
    mpc = MPCWholeBodyJ(MobileManipulatorJ(0.1), [ObstaclesJ(1.0, 0.3, 0.3)],
                        [], N=5, solver_config=SolverConfigJ(al_iters=2,
                                                             ilqr_iters=4))
    args = (jnp.asarray(x0_b), jnp.zeros((B, 5, 5)),
            {k: jnp.asarray(v) for k, v in params.items()})
    run = sharded_solve_fn_j(mpc.solve_fn(), make_mesh_j())
    compiled = jax.jit(run).lower(*args).compile(FAST_COMPILE)
    return jax.tree.map(np.asarray, compiled(*args))


def _result(d):
    return SolveResult(**d)


def _log(d):
    return TaskRolloutLog(**d)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' records, JAX's sharded solve, and the port's
    single-process twins: the batched solve of each rank's rows and of the
    whole batch, and the fleet loop on each rank's robots and on all."""
    out = tmp_path_factory.mktemp("ranks")
    mpc, x0_g, U0_g, params_np, impl = dry.build_problem("qref", B, False)
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(_jax_sharded, x0_g, params_np)
        proc = subprocess.Popen(
            [sys.executable, "-m", "mmmpc_tpu_torch.dryrun_multiprocess",
             "--device", "cpu", "--problem", "qref", "--dtype", "float64",
             "--robot-loop", "--fleet-batch", str(FLEET), "--ticks",
             str(TICKS), "--out", str(out), "--timeout", "240"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        params = params_from_numpy(params_np, "cpu", F64)
        x0, U0 = torch.as_tensor(x0_g), torch.as_tensor(U0_g)
        solve = with_stats(impl)
        twins = [solve(x0[r * LOCAL:(r + 1) * LOCAL],
                       U0[r * LOCAL:(r + 1) * LOCAL], params)
                 for r in range(NPROC)]
        whole = solve(x0, U0, params)
        run, fx0, fgpt = dry.build_fleet("qref", FLEET, TICKS, "cpu", F64)
        fleet_twins = []
        for r in range(NPROC):
            rows = slice(r * FLEET // NPROC, (r + 1) * FLEET // NPROC)
            log1, c1 = run(fx0[rows], fgpt[rows])
            log2, c2 = run(fx0[rows], fgpt[rows], c1)
            fleet_twins.append(((log1, log2), c2))
        g1, gc1 = run(fx0, fgpt)
        g2, _ = run(fx0, fgpt, gc1)
        stdout = proc.communicate(timeout=300)[0]
        res_j, stats_j = jax_run.result()
    assert proc.returncode == 0, stdout
    assert "PASS" in stdout, stdout
    recs = [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(NPROC)]
    return dict(recs=recs, twins=twins, whole=whole, fleet=fleet_twins,
                fleet_whole=(g1, g2), res_j=res_j, stats_j=stats_j,
                x0=x0_g, stdout=stdout)


def _hold_bitwise(got, ref):
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name


def test_sharded_solve_matches_jax(runs):
    """The gathered port solve against JAX's sharded solve: each robot's
    cost within 5e-3 (relative), the same converged flags on every robot,
    both feasible, and the statistics alike."""
    got = _result(runs["recs"][0]["gathered"])
    res_j, stats_j = runs["res_j"], runs["stats_j"]
    np.testing.assert_array_equal(runs["recs"][0]["x0"].numpy(),
                                  runs["x0"][:LOCAL])
    assert tuple(got.U.shape) == res_j.U.shape == (B, 5, 5)
    rel = np.abs(got.cost.numpy() - res_j.cost) / np.abs(res_j.cost)
    assert rel.max() < 5e-3, rel.max()
    np.testing.assert_array_equal(got.converged.numpy(), res_j.converged)
    assert got.max_violation.max() < 1e-3 and res_j.max_violation.max() < 1e-3
    stats = runs["recs"][0]["stats"]
    assert float(stats["n_solved"]) == float(stats_j.n_solved) == B
    assert float(stats["n_converged"]) == float(stats_j.n_converged)
    assert abs(float(stats["mean_cost"]) - float(stats_j.mean_cost)) < (
        5e-3 * abs(float(stats_j.mean_cost)))


@pytest.mark.parametrize("rank", range(NPROC))
def test_shard_equals_single_process_solve(runs, rank):
    """A rank's shard is the single-process solve of its rows, to the bit,
    and (unrefined) the same rows of the whole batch's solve."""
    rec = runs["recs"][rank]
    assert (rec["offset"], rec["local"]) == (rank * LOCAL, LOCAL)
    assert rec["held"]["shard"] == "bitwise"
    got = _result(rec["res"])
    _hold_bitwise(got, runs["twins"][rank][0])
    rows = slice(rank * LOCAL, (rank + 1) * LOCAL)
    _hold_bitwise(got, SolveResult(*(f[rows] for f in runs["whole"][0])))


@pytest.mark.parametrize("rank", range(NPROC))
def test_stats_are_the_global_batch(runs, rank):
    """Every rank holds the statistics of the whole batch."""
    stats = BatchStats(**runs["recs"][rank]["stats"])
    ref = runs["whole"][1]
    assert float(stats.n_solved) == float(ref.n_solved) == B
    assert float(stats.n_converged) == float(ref.n_converged)
    assert float(stats.max_violation) == float(ref.max_violation)
    np.testing.assert_allclose(float(stats.mean_cost), float(ref.mean_cost),
                               rtol=1e-12)


@pytest.mark.parametrize("rank", range(NPROC))
def test_robot_loop_equals_batched_impl(runs, rank):
    """``batch_impl=None`` (the batch-1 solve robot by robot) equals
    ``batch_impl=batch_solve_fn()`` on each shard, statistics too."""
    rec = runs["recs"][rank]
    assert rec["held"]["robot_loop"] == "bitwise"
    _hold_bitwise(_result(rec["res_loop"]), _result(rec["res"]))
    for k, v in rec["stats"].items():
        assert torch.equal(rec["stats_loop"][k], v), k


@pytest.mark.parametrize("rank", range(NPROC))
def test_sharded_fleet_equals_single_loop(runs, rank):
    """Each rank's two segments (the second from the first's carry) equal
    the single-process loop on its robots to the bit, and the whole fleet's
    loop on those robots with the phases exactly."""
    rec = runs["recs"][rank]
    assert rec["held"]["fleet"] == "bitwise"
    (r1, r2), rc = runs["fleet"][rank]
    for got, ref in zip(rec["fleet_logs"], (r1, r2)):
        _hold_bitwise(_log(got), ref)
    flat, got_flat = tree_leaves(rc), tree_leaves(rec["fleet_carry"])
    assert len(flat) == len(got_flat) == 10
    assert all(torch.equal(a, b) for a, b in zip(got_flat, flat))
    rows = slice(rank * FLEET // NPROC, (rank + 1) * FLEET // NPROC)
    for got, ref in zip(rec["fleet_logs"], runs["fleet_whole"]):
        got = _log(got)
        assert torch.equal(got.phase, ref.phase[rows])
        assert torch.equal(got.done_at, ref.done_at[rows])
        for k in ("X", "U"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       getattr(ref, k)[rows].numpy(),
                                       atol=1e-6)


def test_ranks_ran_gloo_on_the_cpu(runs):
    for rank, rec in enumerate(runs["recs"]):
        assert (rec["rank"], rec["world_size"]) == (rank, NPROC)
        assert rec["backend"] == "gloo" and not rec["host_staged"]
        assert rec["device"] == "cpu"
        # the plain kernels ran: no CUDA launch
        assert set(rec["launches"].values()) == {0}


def test_init_distributed_without_settings_is_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        init_distributed(init_method="file:///nonexistent/store")


def test_init_distributed_resolves_its_settings(monkeypatch):
    """Explicit arguments first, then torchrun's environment; nccl for a
    CUDA device (made current first, and bound to the group), gloo for the
    CPU, an explicit backend as given; the group's timeout."""
    from mmmpc_tpu_torch.parallel import multihost
    calls, current = [], []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(multihost, "_DEVICE", None)
    env = dict(MASTER_ADDR="hostA", MASTER_PORT="29511", WORLD_SIZE="4",
               RANK="3", LOCAL_RANK="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert init_distributed() is True
    kw = calls.pop()
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == (
        "tcp://hostA:29511", 4, 3)
    assert kw["backend"] == "nccl" and kw["device_id"] == torch.device(
        "cuda", 1)
    assert current == [torch.device("cuda", 1)]
    assert kw["timeout"].total_seconds() == multihost.GROUP_TIMEOUT_S == 60
    assert multihost.rank_device() == torch.device("cuda", 1)
    assert init_distributed("file:///s", 2, 0, device="cpu") is True
    kw = calls.pop()
    assert (kw["init_method"], kw["world_size"], kw["rank"],
            kw["backend"]) == ("file:///s", 2, 0, "gloo")
    assert "device_id" not in kw
    assert init_distributed(backend="gloo", device="cuda:0") is True
    kw = calls.pop()
    assert kw["backend"] == "gloo" and "device_id" not in kw


def test_single_rank_group_on_a_file_store(tmp_path):
    """A real group of one gloo rank: the mesh reads it; the reduction and
    the gather at world size 1 are the identity."""
    assert init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        mesh = make_mesh()
        assert (mesh.rank, mesh.world_size, mesh.backend) == (0, 1, "gloo")
        assert mesh.device == torch.device("cpu") and not mesh.host_staged
        assert process_batch_slice(8) == (8, 0)
        x = torch.arange(6.0).reshape(3, 2)
        assert gather_batch(x, mesh) is x
    finally:
        torch.distributed.destroy_process_group()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("batch", [16, 8192])
def test_process_batch_slice_matches_jax(batch):
    assert process_batch_slice(batch) == process_batch_slice_j(batch) == (
        batch, 0)


def test_single_process_mesh_and_collectives():
    """World size 1: the mesh, the host-local feeding (no copy of the
    global batch; the dtype asked for), the reduction and the gather are
    the identity."""
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.device.type) == (0, 1, "cpu")
    assert mesh.backend is None and not mesh.host_staged
    assert make_mesh().device.type == "cuda"      # the card by default
    a = np.arange(12.0).reshape(4, 3)
    x, (y,) = host_local_batch(mesh, (a, [a[:2]]), dtype=torch.float32)
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    np.testing.assert_array_equal(x.numpy(), a)
    assert y.shape == (2, 3)
    stats = BatchStats(*(torch.tensor(v) for v in (4.0, 3.0, 1e-4, 2.5)))
    assert reduce_stats(stats, mesh) is stats
    tree = {"a": x, "b": (x, None)}
    assert gather_batch(tree, mesh) is tree

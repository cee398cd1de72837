"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package (nor another test module that
does), so it runs where the card is, without the repo's ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``chip_smoke.py`` runs that command in a phase of its own.)  The inputs are
made from seeded numpy by tests/torch_problems.py, whose builders the parity
tests against the JAX package use too, at small sizes (N=5, batch 64 and a
partial block of 37, the generic pairs also at 1, the arms' backward at
1024 and 1000; N=4, batch 64 for the Riccati sweep), at the tolerances of those
tests:

- the whole-body qref pair (A, B) on the problem of
  tests/test_torch_kernels.py, and with an obstacle row a stage on the
  problem of tests/test_torch_moving_obs.py and at the dynamic-obstacle
  demo's shape (N=20, batch 1, 8 step sizes), and with per-scenario entries
  (the fleet's: all six, and U_last alone) on the problem of
  tests/test_torch_fleet.py at batches 64 and 1: X / U atol 2e-5, cost
  rtol = atol = 2e-3; gains rtol = atol = 5e-3;
- the generic pair (C, D) of each formulation (the arm's joint-space and
  Cartesian instances each) on the problems of
  tests/test_torch_generic_kernels.py: X / U atol 2e-5, cost rtol = atol =
  2e-3; gains atol 1e-5 (demo), 1e-3 (base), 2e-4 (endpoint) with rtol
  1e-4, and the arms' in the p99 / float64 form (their 1e6 wedge slack
  makes the solve ill-conditioned in float32);
- the whole-body pair of the fixed terminal formulation
  (``replicate_terminal_selfcol_bug=False``) on the problem of
  tests/test_torch_fixed_terminal.py, whose terminal self-collision rows
  are live, at the same tolerances;
- the whole-body pair at N = 500 on ``bench_longhorizon``'s problem (batch
  8): X / U atol 2e-5, cost rtol = atol = 2e-3, gains rtol = atol = 5e-3
  or, where the float32 plain version drifts, no farther from its float64
  twin than twice it; and a horizon past the card's shared memory refused
  with a ValueError before any launch;
- the Riccati sweep E at each (nx, nu) of the kernel library and at (4, 2),
  which builds its own library on first use, on random SPD blocks at 2e-4;
- the parallel-prefix sweep (``ops/assoc_riccati.py``, plain torch) on the
  card against the plain sequential sweep in float64 on SPD blocks at
  N = 64, at tests/test_assoc_riccati.py's 1e-6 / 1e-7;
- the FMA microkernel F: every trip counted, and rtol 1e-5 / atol 1e-6
  against ``plain_fma``.
"""

import numpy as np
import pytest
import torch

from mmmpc_tpu_torch import roofline
from mmmpc_tpu_torch.demo_wholebody_separate import build_world
from mmmpc_tpu_torch.ocp.spec import per_scenario_keys
from mmmpc_tpu_torch.ops import assoc_riccati, riccati, wholebody_bwd
from mmmpc_tpu_torch.ops import wholebody_fwd
from mmmpc_tpu_torch.ops._cuda import FMA_NACC, RICCATI_INSTANCES
from mmmpc_tpu_torch.ops.generic_bwd import plain_bwd
from mmmpc_tpu_torch.ops.generic_fwd import plain_fwd
from mmmpc_tpu_torch.solver.al_ilqr import rollout
from mmmpc_tpu_torch.utils.convert import params_from_numpy

from torch_problems import (
    ARM_BATCH, ARMS, B, BWD_ATOL, FLEET_KEYS, FORMULATIONS, N, batch_last,
    drift_gate, fleet_params, generic_problem, long_problem, qref_problem,
    selfcol_problem, spd_blocks,
)

# at 64 scenarios the arm's ill-conditioned ones pass the 1% of entries of
# its p99 form (the one-thread kernel fails it there too), so its backward
# runs at ARM_BATCH, and 1000 leaves a partial block of its teams
ARM_PART = 1000


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _first(args, batch):
    """The first ``batch`` scenarios of batch-last arguments."""
    return tuple(a[..., :batch].contiguous() if torch.is_tensor(a) else a
                 for a in args)


def _wholebody_call(device, mpc, x0_b, U0_b, params, kernel, batch):
    """The whole-body wrapper ``kernel`` of ``mpc`` and its arguments on the
    card: the first ``batch`` scenarios of seeded inputs (the rollout of
    U0_b from x0_b, random gains and multipliers) and of the per-scenario
    entries of ``params`` -> (wrapper, arguments)."""
    full = x0_b.shape[0]
    N = mpc.N
    p = params_from_numpy(params, device, torch.float32)
    ps = per_scenario_keys(p)
    p_first = {k: v[..., :batch].contiguous() if k in ps else v
               for k, v in p.items()}
    rng = np.random.default_rng(5)
    X, U = rollout(mpc.ocp, _t(x0_b, device).T,
                   _t(U0_b, device).permute(1, 2, 0), p)
    lam = _t(np.abs(rng.standard_normal((N, 28, full))), device)
    lamt = _t(np.abs(rng.standard_normal((18, full))), device)
    lame = _t(0.1 * rng.standard_normal((2, full)), device)
    if kernel == "wholebody_fwd":
        f = mpc.ocp.lanes_fwd_factory(mpc.solver_config, p_first)
        args = (X[:-1], U,
                _t(0.05 * rng.standard_normal((N, 5, full)), device),
                _t(0.05 * rng.standard_normal((N, 5, 9, full)), device), lam,
                lamt, lame, 10.0)
    else:
        f = mpc.ocp.lanes_bwd_factory(mpc.solver_config, p_first)
        args = (X, U, lam, lamt, lame, 10.0,
                torch.full((full,), 1e-6, device=device))
    return f, _first(args, batch)


def _check_wholebody(device, mpc, x0_b, U0_b, params, kernel, batch):
    """The whole-body CUDA kernel ``kernel`` against its plain version on
    the card (``_wholebody_call``'s inputs): X / U atol 2e-5, cost rtol =
    atol = 2e-3; gains rtol = atol = 5e-3."""
    f, args = _wholebody_call(device, mpc, x0_b, U0_b, params, kernel, batch)
    tols = ([(0.0, 2e-5)] * 3 + [(2e-3, 2e-3)] if kernel == "wholebody_fwd"
            else [(5e-3, 5e-3)] * 2)
    got, ref = f.cuda(*args), f.plain(*args)
    torch.cuda.synchronize()
    for g, r, (rtol, atol) in zip(got, ref, tols):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, batch", [
    pytest.param("wholebody_fwd", B, id="wholebody_fwd"),
    pytest.param("wholebody_bwd", B, id="wholebody_bwd"),
    pytest.param("wholebody_bwd", 1, id="wholebody_bwd-1"),
    pytest.param("wholebody_bwd", 37, id="wholebody_bwd-37")])
def test_cuda_kernel_matches_plain(device, kernel, batch):
    """The whole-body CUDA kernel against its plain version on the card,
    same inputs; the backward kernel also on the first 1 and 37 scenarios
    (a partial block of its teams)."""
    _check_wholebody(device, *qref_problem(eq_mask=1.0), kernel, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [B, 37])
@pytest.mark.parametrize("kernel", ["wholebody_fwd", "wholebody_bwd"])
def test_cuda_moving_kernel_matches_plain(device, kernel, batch):
    """The whole-body CUDA kernels with an obstacle row a stage (the table
    of ``moving_table``, every row its own) against their plain versions
    on the card, on the whole batch and on a partial block of 37."""
    _check_wholebody(device, *qref_problem(eq_mask=1.0, moving=True), kernel,
                     batch)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [B, 1])
@pytest.mark.parametrize("keys", [FLEET_KEYS, ("U_last",)],
                         ids=["all", "U_last"])
@pytest.mark.parametrize("kernel", ["wholebody_fwd", "wholebody_bwd"])
def test_cuda_fleet_kernel_matches_plain(device, kernel, keys, batch):
    """The whole-body CUDA kernels with per-scenario entries (their
    instances for the fleet) against their plain versions on the card: all
    six entries (eq_mask 0 and 1 mixed, Q and P rows of the task weight
    table) and U_last alone, on the whole batch and on one robot."""
    mpc, x0_b, U0_b, params = qref_problem(eq_mask=1.0)
    _check_wholebody(device, mpc, x0_b, U0_b,
                     fleet_params(params, B, keys), kernel, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["wholebody_fwd", "wholebody_bwd"])
def test_cuda_moving_demo_shape_matches_plain(device, kernel):
    """The dynamic-obstacle demo's shape: one robot, N=20, one obstacle
    predicted over the horizon, 8 step sizes, cost_scale 1.0."""
    world = build_world(device=device)
    mpc = world.controller
    mpc.observe_obstacles([[2.5, -0.44]], [[0.0, 0.6]])
    rng = np.random.default_rng(2)
    traj = np.linspace(world.x_start, world.x_target, mpc.N + 1)
    params = dict(mpc.make_params(traj, np.zeros((mpc.N, 5))),
                  U_last=0.1 * rng.standard_normal((mpc.N, 5)))
    assert params["obstacles"].shape == (mpc.N + 1, 1, 3)
    U0 = 0.3 * rng.standard_normal((1, mpc.N, 5))
    _check_wholebody(device, mpc, world.x_start[None], U0, params, kernel, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [B, 37])
@pytest.mark.parametrize("kernel", ["wholebody_fwd", "wholebody_bwd"])
def test_cuda_fixed_kernel_matches_plain(device, kernel, batch):
    """The whole-body CUDA kernels of the fixed terminal formulation (the
    self-collision rows of x_N in the terminal group) against their plain
    versions on the card, on the problem whose terminal self-collision rows
    are live, the whole batch and a partial block of 37."""
    mpc, x0_b, U0_b, params = selfcol_problem(False)
    _check_wholebody(device, mpc, x0_b, U0_b, params, kernel, batch)


LONG_N, LONG_BATCH = 500, 8


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["wholebody_fwd", "wholebody_bwd"])
def test_cuda_long_horizon_kernel_matches_plain(device, kernel):
    """The whole-body CUDA kernels at N = 500 (their packed params in
    shared memory 500 stages long) against their plain versions: each
    output within the tolerances of the float32 plain version (X / U atol
    2e-5, cost rtol = atol = 2e-3; gains rtol = atol = 5e-3) or, where it
    is not, stage by stage no farther from the float64 plain version than
    twice the float32 plain version within 32 stages or than those
    tolerances (``drift_gate``: over 500 stages two float32 orders of one
    rollout drift apart by a random walk of roundings)."""
    mpc, x0_b, U0_b, params = long_problem(LONG_N, LONG_BATCH)
    f, args = _wholebody_call(device, mpc, x0_b, U0_b, params, kernel,
                              LONG_BATCH)
    got, ref = f.cuda(*args), f.plain(*args)
    torch.cuda.synchronize()
    p = params_from_numpy(params, device, torch.float64)
    a64 = tuple(a.double() if torch.is_tensor(a) else a for a in args)
    if kernel == "wholebody_fwd":
        tols = [(0.0, 2e-5)] * 3 + [(2e-3, 2e-3)]
        truth = plain_fwd(mpc.ocp, p, f.alphas, f.inv_scale, *a64)
    else:
        tols = [(5e-3, 5e-3)] * 2
        truth = plain_bwd(mpc.ocp, p, f.inv_scale, *a64)
    for g, r, t, (rtol, atol) in zip(got, ref, truth, tols):
        assert torch.isfinite(g).all()
        g, r = g.double(), r.double()
        if ((g - r).abs() > atol + rtol * r.abs()).any():
            ratio, at = drift_gate(g, r, t, rtol, atol)
            assert ratio <= 1.0, (ratio, at)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["wholebody_fwd", "wholebody_bwd"])
def test_cuda_horizon_past_shared_memory_raises(device, kernel):
    """A horizon whose packed params overflow the card's shared memory a
    block is refused with a ValueError naming N, before any launch."""
    mpc, x0_b, U0_b, params = long_problem(4000, 1)
    f, args = _wholebody_call(device, mpc, x0_b, U0_b, params, kernel, 1)
    counter = (wholebody_fwd if kernel == "wholebody_fwd"
               else wholebody_bwd).LAUNCHES
    before = counter.cuda
    with pytest.raises(ValueError, match="N=4000 needs"):
        f.cuda(*args)
    assert counter.cuda == before


@pytest.mark.cuda
def test_cuda_assoc_sweep_matches_sequential(device):
    """The parallel-prefix sweep on the card against the plain sequential
    sweep, float64, SPD blocks (9, 5) at N = 64, reg 1e-8."""
    args = [batch_last(a.astype(np.float64), device)
            for a in spd_blocks(9, 5, batch=8, horizon=64)]
    reg = torch.full((8,), 1e-8, dtype=torch.float64, device=device)
    before = assoc_riccati.CALLS.cuda
    got = assoc_riccati.assoc_riccati_backward_bm(*args, reg)
    ref = riccati.plain_riccati_bm(*args, reg)
    assert assoc_riccati.CALLS.cuda == before + 1
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, part", [
    ("fwd", "all"), ("fwd", "part"), ("fwd", "one"), ("bwd", "all"),
    ("bwd", "part"), ("bwd", "one")])
@pytest.mark.parametrize("name", FORMULATIONS)
def test_cuda_generic_kernel_matches_plain(device, name, kernel, part):
    """Each generic CUDA kernel instance against its plain version on the
    card, on the whole batch and on its first scenarios, a partial block of
    the team kernels (C.base, C.arm, C.endpoint, D.arm, D.endpoint) and of
    the one-thread kernels with their stage buffers (C.demo, D.base,
    D.demo): 64 and 37, the arms' backward 1024 and 1000; both kernels
    also on one scenario (a team block of one scenario and its idle teams;
    a one-thread block where all but one thread return), the single-robot
    solve's batch."""
    arm_bwd = name in ARMS and kernel == "bwd"
    full = ARM_BATCH if arm_bwd else B
    batch = {"all": full, "part": ARM_PART if arm_bwd else 37, "one": 1}[part]
    mpc, x0_b, U0_b, params = generic_problem(name, full)
    p = params_from_numpy(params, device, torch.float32)
    rng = np.random.default_rng(5)
    nx, nu = mpc.NX, mpc.NU
    X, U = rollout(mpc.ocp, _t(x0_b, device).T,
                   _t(U0_b, device).permute(1, 2, 0), p)
    if kernel == "fwd":
        f = mpc.ocp.lanes_fwd_factory(mpc.solver_config, p)
        args = _first((
            X[:-1], U, _t(0.05 * rng.standard_normal((N, nu, full)), device),
            _t(0.05 * rng.standard_normal((N, nu, nx, full)), device),
            _t(np.abs(rng.standard_normal((N, f.form.nc, full))), device),
            _t(np.abs(rng.standard_normal((f.form.nct, full))), device),
            _t(np.zeros((0, full)), device), 10.0), batch)
        got, ref = f.cuda(*args), f.plain(*args)
        torch.cuda.synchronize()
        for g, r, tol in zip(got, ref, [(0.0, 2e-5)] * 3 + [(2e-3, 2e-3)]):
            torch.testing.assert_close(g, r, rtol=tol[0], atol=tol[1])
        return
    f = mpc.ocp.lanes_bwd_factory(mpc.solver_config, p)
    args = _first((
        X, U, _t(0.3 * np.abs(rng.standard_normal((N, f.form.nc, full))), device),
        _t(0.3 * np.abs(rng.standard_normal((f.form.nct, full))), device),
        _t(np.zeros((0, full)), device), 10.0,
        torch.full((full,), 1e-6, device=device)), batch)
    got, ref = f.cuda(*args), f.plain(*args)
    torch.cuda.synchronize()
    if name not in ARMS:
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=BWD_ATOL[name])
        return
    truth = plain_bwd(mpc.ocp, {k: v.double() for k, v in p.items()},
                      f.inv_scale, *(a.double() if torch.is_tensor(a) else a
                                     for a in args))
    for g, r, tr in zip(got, ref, truth):
        cross = (g - r).abs().double()
        assert torch.quantile(cross.flatten(), 0.99) < 5e-4
        e_kernel = (g.double() - tr).abs().max()
        assert e_kernel <= max(2.0 * (r.double() - tr).abs().max(), 1e-3)
        assert e_kernel < 0.15


@pytest.mark.cuda
@pytest.mark.parametrize("dims", (*RICCATI_INSTANCES, (4, 2)))
def test_cuda_riccati_matches_plain(device, dims):
    """Each CUDA instance of the Riccati sweep against the plain sweep on
    the card, same SPD blocks, at the Pallas test's 2e-4; (4, 2) builds its
    own library on its first use."""
    args = [batch_last(a, device) for a in spd_blocks(*dims)]
    reg = torch.full((B,), 1e-6, device=device)
    got = riccati.riccati_backward_bm(*args, reg)
    ref = riccati.plain_riccati_bm(*args, reg)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("nacc", FMA_NACC)
def test_cuda_fma_peak_matches_plain(device, nacc):
    """At 16 trips and at 1003 (3 mod 8: the remainder of the trip loop
    unrolled by 8 runs): every trip runs (inputs that count them exactly),
    and the microkernel's one rounding per trip against plain torch's two
    at rtol 1e-5, atol 1e-6."""
    x = roofline.fma_inputs(nacc, 4 * 256, device)
    for inner in (16, 1003):
        count = roofline.count_inputs(nacc, 4 * 256, device)
        assert torch.equal(roofline.fma_peak(count, nacc, inner, 4, 256),
                           count[:nacc] + inner)
        got = roofline.fma_peak(x, nacc, inner, 4, 256)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, roofline.plain_fma(x, nacc, inner),
                                   rtol=1e-5, atol=1e-6)

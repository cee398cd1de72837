"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package (nor another test module that
does), so it runs where the card is, without the repo's ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``chip_smoke.py`` runs that command in a phase of its own.)  The inputs are
made from seeded numpy by tests/torch_problems.py, whose builders the parity
tests against the JAX package use too, at small sizes (N=5, batch 64 and a
partial block of 37, the line searches also at 1, the arm's backward at 1024
and 1000; N=4, batch 64 for the Riccati sweep), at the tolerances of those
tests:

- the whole-body qref pair (A, B) on the problem of
  tests/test_torch_kernels.py: X / U atol 2e-5, cost rtol = atol = 2e-3;
  gains rtol = atol = 5e-3;
- the generic pair (C, D) of each formulation on the problems of
  tests/test_torch_generic_kernels.py: X / U atol 2e-5, cost rtol = atol =
  2e-3; gains atol 1e-5 (demo), 1e-3 (base), 2e-4 (endpoint) with rtol
  1e-4, and the arm's in the p99 / float64 form (its 1e6 wedge slack makes
  the solve ill-conditioned in float32);
- the Riccati sweep E at each (nx, nu) of the kernel library and at (4, 2),
  which builds its own library on first use, on random SPD blocks at 2e-4;
- the FMA microkernel F: every trip counted, and rtol 1e-5 / atol 1e-6
  against ``plain_fma``.
"""

import numpy as np
import pytest
import torch

from mmmpc_tpu_torch import roofline
from mmmpc_tpu_torch.ops import riccati
from mmmpc_tpu_torch.ops._cuda import FMA_NACC, RICCATI_INSTANCES
from mmmpc_tpu_torch.ops.generic_bwd import plain_bwd
from mmmpc_tpu_torch.solver.al_ilqr import rollout
from mmmpc_tpu_torch.utils.convert import params_from_numpy

from torch_problems import (
    ARM_BATCH, B, BWD_ATOL, FORMULATIONS, N, batch_last, generic_problem,
    qref_problem, spd_blocks,
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
    mpc, x0_b, U0_b, params = qref_problem(eq_mask=1.0)
    p = params_from_numpy(params, device, torch.float32)
    rng = np.random.default_rng(5)
    X, U = rollout(mpc.ocp, _t(x0_b, device).T,
                   _t(U0_b, device).permute(1, 2, 0), p)
    lam = _t(np.abs(rng.standard_normal((N, 28, B))), device)
    lamt = _t(np.abs(rng.standard_normal((18, B))), device)
    lame = _t(0.1 * rng.standard_normal((2, B)), device)
    if kernel == "wholebody_fwd":
        f = mpc.ocp.lanes_fwd_factory(mpc.solver_config, p)
        args = (X[:-1], U, _t(0.05 * rng.standard_normal((N, 5, B)), device),
                _t(0.05 * rng.standard_normal((N, 5, 9, B)), device), lam,
                lamt, lame, 10.0)
        tols = [(0.0, 2e-5)] * 3 + [(2e-3, 2e-3)]
    else:
        f = mpc.ocp.lanes_bwd_factory(mpc.solver_config, p)
        args = _first((X, U, lam, lamt, lame, 10.0,
                       torch.full((B,), 1e-6, device=device)), batch)
        tols = [(5e-3, 5e-3)] * 2
    got, ref = f.cuda(*args), f.plain(*args)
    torch.cuda.synchronize()
    for g, r, (rtol, atol) in zip(got, ref, tols):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, part", [
    ("fwd", "all"), ("fwd", "part"), ("fwd", "one"), ("bwd", "all"),
    ("bwd", "part")])
@pytest.mark.parametrize("name", FORMULATIONS)
def test_cuda_generic_kernel_matches_plain(device, name, kernel, part):
    """Each generic CUDA kernel instance against its plain version on the
    card, on the whole batch and on its first scenarios, a partial block of
    the team kernels (C.base, C.arm, C.endpoint, D.arm, D.endpoint) and of
    the one-thread kernels with their stage buffers (C.demo, D.base,
    D.demo): 64 and 37, the arm's backward 1024 and 1000; the line searches
    also on one scenario (a team block of one scenario and its idle teams;
    a one-thread block where all but one thread return)."""
    arm_bwd = name == "arm" and kernel == "bwd"
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
    if name != "arm":
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

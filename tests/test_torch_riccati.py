"""Parity of the port's Riccati sweep on precomputed blocks (kernel E's plain
version, ``ops/riccati.py``) and of its batch-last AL expansion with the JAX
package, the plain FMA recurrence of the peak microkernel (kernel F), and
(on a CUDA card) of each CUDA instance with its plain version.

- ``plain_riccati_bm`` against the JAX package's plain sweep, the vmapped
  ``build_core(...).backward_scan`` (no Pallas interpret mode), on the random
  SPD blocks of tests/test_pallas_riccati.py at B=64, N=4, float32, for each
  (nx, nu) instance, with a scalar and a per-scenario reg: rtol = atol = 2e-4
  (the Pallas test's tolerance);
- ``stage_al_blocks`` / ``terminal_al_blocks`` against the JAX
  ``core.stage_derivs`` / ``core.terminal_derivs`` vmapped over the batch,
  float64, B=64, N=5, on the qref problem of tests/test_torch_kernels.py and
  the endpoint problem of tests/test_torch_generic_kernels.py: rtol = atol =
  1e-9 (the same closed forms in another op order);
- ``plain_fma`` against a numpy loop, exactly; the sweep's trip counts and
  its slope fit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu.solver.al_ilqr import build_core, rollout as rollout_j
from mmmpc_tpu_torch import roofline
from mmmpc_tpu_torch.ops import riccati
from mmmpc_tpu_torch.ops._cuda import FMA_NACC, RICCATI_INSTANCES
from mmmpc_tpu_torch.solver.al_ilqr import (
    stage_al_blocks, terminal_al_blocks,
)
from mmmpc_tpu_torch.utils.convert import params_from_numpy
from tests import test_torch_generic_kernels as gk
from tests import test_torch_kernels as wk

B, N = 64, 4
F32 = jnp.float32
# the formulation of each (nx, nu) instance, whose JAX core supplies the sweep
FORMULATION = {(2, 1): "demo", (6, 2): "base", (3, 3): "arm",
               (9, 5): "endpoint"}

torch.set_num_threads(1)    # batch 64: threads only contend with the others


def spd_blocks(nx, nu, batch=B, horizon=N):
    """The random blocks of tests/test_pallas_riccati.py, batch-major
    float32 numpy: (lx, lu, lxx, luu, lux, A, Bm, term_g, term_H)."""
    rng = np.random.default_rng(3)

    def mk(*s):
        return rng.standard_normal(s).astype(np.float32)

    def spd(a, n):
        return a @ np.swapaxes(a, -1, -2) + 5 * np.eye(n, dtype=np.float32)

    lx, lu = mk(batch, horizon, nx), mk(batch, horizon, nu)
    lxx = spd(mk(batch, horizon, nx, nx), nx)
    luu = spd(mk(batch, horizon, nu, nu), nu)
    lux = mk(batch, horizon, nu, nx)
    A = mk(batch, horizon, nx, nx) * 0.1 + np.eye(nx, dtype=np.float32)
    Bm = mk(batch, horizon, nx, nu) * 0.1
    tg = mk(batch, nx)
    tH = spd(mk(batch, nx, nx), nx)
    return lx, lu, lxx, luu, lux, A, Bm, tg, tH


def _bl(a):
    """Batch-major numpy -> batch-last contiguous tensor."""
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)))


@functools.lru_cache(maxsize=None)
def _jax_sweep(dims):
    """The JAX package's plain sweep, vmapped over the batch (reg per
    scenario) and jitted once per (nx, nu)."""
    mpc_j, _, _, _, p_j, _ = gk.make_problem(FORMULATION[dims])
    core = build_core(mpc_j.ocp, {k: jnp.asarray(v, F32)
                                  for k, v in p_j.items()},
                      mpc_j.solver_config, F32)

    def reference(lx, lu, lxx, luu, lux, A, Bm, tg, tH, r):
        return core.backward_scan((lx, lu, lxx, luu, lux, A, Bm), tg, tH, r)

    return jax.jit(jax.vmap(reference))


@pytest.mark.parametrize("per_scenario_reg", [False, True])
@pytest.mark.parametrize("dims", RICCATI_INSTANCES)
def test_plain_riccati_matches_jax(dims, per_scenario_reg):
    nx, nu = dims
    blocks = spd_blocks(nx, nu)
    reg = (np.random.default_rng(5).uniform(1e-6, 1e-2, B).astype(np.float32)
           if per_scenario_reg else 1e-6)
    kff_r, K_r = _jax_sweep(dims)(*blocks, np.broadcast_to(
        np.float32(reg), (B,)))

    riccati.LAUNCHES[dims].reset()
    kff, K = riccati.riccati_backward_bm(
        *(_bl(a) for a in blocks),
        torch.as_tensor(reg) if per_scenario_reg else reg)
    assert (riccati.LAUNCHES[dims].cuda, riccati.LAUNCHES[dims].plain) == (0, 1)
    assert tuple(kff.shape) == (N, nu, B) and tuple(K.shape) == (N, nu, nx, B)
    np.testing.assert_allclose(kff.permute(2, 0, 1).numpy(),
                               np.asarray(kff_r), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(K.permute(3, 0, 1, 2).numpy(),
                               np.asarray(K_r), rtol=2e-4, atol=2e-4)


def test_riccati_wrapper_rejects_other_devices():
    blocks = [_bl(a).to("meta") for a in spd_blocks(2, 1)]
    with pytest.raises(ValueError, match="no riccati_backward_bm"):
        riccati.riccati_backward_bm(*blocks, 1e-6)


@pytest.mark.parametrize("name", ["qref", "endpoint"])
def test_stage_and_terminal_derivs_match_jax(name):
    if name == "qref":      # the terminal equality on: every block is live
        mpc_j, mpc_t, x0_b, U0_b, p_j = wk.make_problem(1.0)
        p_t = p_j
    else:
        mpc_j, mpc_t, x0_b, U0_b, p_j, p_t = gk.make_problem(name)
    f64 = jnp.float64
    pj = {k: jnp.asarray(v, f64) for k, v in p_j.items()}
    cfg = mpc_j.solver_config
    core_j = build_core(mpc_j.ocp, pj, cfg, f64)
    X, Uc = jax.vmap(lambda x0, U: rollout_j(mpc_j.ocp, x0, U, pj))(
        jnp.asarray(x0_b, f64), jnp.asarray(U0_b, f64))
    X, Uc = np.asarray(X), np.asarray(Uc)
    rng = np.random.default_rng(9)
    Bsz = x0_b.shape[0]
    lam = 0.5 * np.abs(rng.standard_normal((Bsz, mpc_j.N, core_j.nc)))
    lam_t = 0.5 * np.abs(rng.standard_normal((Bsz, core_j.nct)))
    lam_e = 0.1 * rng.standard_normal((Bsz, core_j.ne))
    mu = 10.0

    derivs_j = jax.jit(jax.vmap(jax.vmap(
        core_j.stage_derivs, in_axes=(0, 0, 0, 0, None)),
        in_axes=(0, 0, None, 0, None)))(X[:, :-1], Uc, core_j.ks, lam, mu)
    term_j = jax.jit(jax.vmap(core_j.terminal_derivs,
                              in_axes=(0, 0, 0, None)))(X[:, -1], lam_t,
                                                        lam_e, mu)

    p64 = params_from_numpy(p_t, "cpu", torch.float64)
    inv_scale = 1.0 / mpc_t.solver_config.cost_scale
    Xt = _bl(X)
    derivs_t = stage_al_blocks(mpc_t.ocp, p64, inv_scale, Xt[:-1], _bl(Uc),
                               _bl(lam), mu)
    term_t = terminal_al_blocks(mpc_t.ocp, p64, inv_scale, Xt[-1],
                                _bl(lam_t), _bl(lam_e), mu)
    for got, ref in zip((*derivs_t, *term_t), (*derivs_j, *term_j)):
        assert got.is_contiguous()
        np.testing.assert_allclose(got.movedim(-1, 0).numpy(),
                                   np.asarray(ref), rtol=1e-9, atol=1e-9)


def test_plain_fma_matches_numpy_loop():
    nacc, n, inner = 4, 96, 37
    x = roofline.fma_inputs(nacc, n, "cpu")
    acc = x[:nacc].numpy().copy()
    b, c = x[nacc].numpy(), x[nacc + 1].numpy()
    for _ in range(inner):
        acc = acc * b + c
    np.testing.assert_array_equal(roofline.plain_fma(x, nacc, inner).numpy(),
                                  acc)
    assert np.isfinite(acc).all() and np.abs(acc).max() <= 1.0
    # the wrapper takes the plain version for a CPU tensor
    roofline.LAUNCHES.reset()
    np.testing.assert_array_equal(
        roofline.fma_peak(x, nacc, inner, 3, 32).numpy(), acc)
    assert (roofline.LAUNCHES.cuda, roofline.LAUNCHES.plain) == (0, 1)


def test_sweep_trip_counts_and_slope():
    """Every configuration of the sweep times four trip counts, evenly
    spaced, each 3 mod 8, the longest doing about the sweep's work; the
    median slope is exact on a line and holds against one slow point."""
    sms = 132
    for nacc in FMA_NACC:
        for threads in roofline.SWEEP_THREADS:
            for per_sm in roofline.SWEEP_BLOCKS_PER_SM:
                n = per_sm * sms * threads
                trips = roofline.trip_counts(nacc, n)
                assert all(t % 8 == 3 for t in trips)
                assert len({b - a for a, b in zip(trips, trips[1:])}) == 1
                work = 2.0 * nacc * n * trips[-1]
                assert 0.99 * roofline.WORK_FLOP < work <= roofline.WORK_FLOP
                lo, hi = roofline.confirm_trips(trips)
                assert lo % 8 == hi % 8 == 3 and hi - 3 == 2 * (lo - 3)
                assert hi < 2 ** 24     # the count inputs stay exact
    trips = roofline.trip_counts(8, 4 * sms * 256)
    ms = [0.25 + 3e-5 * t for t in trips]
    assert roofline.median_slope(trips, ms) == pytest.approx(3e-5, rel=1e-9)
    # one slow point (the sweep's nacc-32 outlier on an H100) moves the
    # median slope by less than 1%
    ms[1] *= 1.1
    assert roofline.median_slope(trips, ms) == pytest.approx(3e-5, rel=1e-2)


def test_count_inputs_count_the_trips():
    x = roofline.count_inputs(4, 96, "cpu")
    for inner in (16, 1003):
        out = roofline.fma_peak(x, 4, inner, 3, 32)
        assert torch.equal(out, x[:4] + inner)


def test_peak_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        roofline.measure_fp32_peak("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dims", RICCATI_INSTANCES)
def test_cuda_riccati_matches_plain(dims):
    """Each CUDA instance against the plain sweep on the card, same SPD
    blocks, at the Pallas test's 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    args = [_bl(a).cuda() for a in spd_blocks(*dims)]
    reg = torch.full((B,), 1e-6, device="cuda")
    got = riccati.riccati_backward_bm(*args, reg)
    ref = riccati.plain_riccati_bm(*args, reg)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("nacc", FMA_NACC)
def test_cuda_fma_peak_matches_plain(nacc):
    """At 16 trips and at 1003 (3 mod 8: the remainder of the trip loop
    unrolled by 8 runs): every trip runs (inputs that count them exactly),
    and the microkernel's one rounding per trip against plain torch's two
    at rtol 1e-5, atol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    x = roofline.fma_inputs(nacc, 4 * 256, "cuda")
    for inner in (16, 1003):
        count = roofline.count_inputs(nacc, 4 * 256, "cuda")
        assert torch.equal(roofline.fma_peak(count, nacc, inner, 4, 256),
                           count[:nacc] + inner)
        got = roofline.fma_peak(x, nacc, inner, 4, 256)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, roofline.plain_fma(x, nacc, inner),
                                   rtol=1e-5, atol=1e-6)

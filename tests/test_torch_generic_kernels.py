"""Parity of the plain versions of the two generic fused kernels with the JAX
package, for each of the four formulations that run them (demo, base, arm,
whole-body endpoint), and the launch geometries the kernel library reports
(each CUDA kernel instance against its plain version on a card:
tests/test_torch_cuda.py).

float32, B=64, N=5, on the problems of tests/test_generic_fwd.py and
tests/test_generic_bwd.py (the base with two ground obstacles, the arm with
the wedge of the bench, so its 1e6 slack is active on part of the batch).
The JAX side is the vmapped per-scenario reference, not the Pallas kernels:
``core.fwd_pass`` over (alpha, batch) for the line search, and
``core.stage_derivs`` / ``core.terminal_derivs`` followed by the scan Riccati
sweep for the backward pass.  Tolerances are the JAX kernel tests': X / U
atol 2e-5 and cost rtol = atol = 2e-3 (test_generic_fwd.py); gains atol 1e-5
(demo), 1e-3 (base), 2e-4 (endpoint) with rtol 1e-4 (test_generic_bwd.py).
The arm's gains are held as test_generic_bwd.py holds them: its 1e6 wedge
slack makes the Riccati solve ill-conditioned in float32, so (at the JAX
test's batch of 1024) the p99 of the difference between the two float32
paths must be below 5e-4, and the port's error against the JAX package's
float64 gains at most twice the JAX float32 path's own (1e-3 floor, 0.15
ceiling); in float64 the two agree to 1e-9 of the gains' scale.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu import controllers as ctl_j
from mmmpc_tpu.models import obstacles as obs_j
from mmmpc_tpu.models import robots as robots_j
from mmmpc_tpu.solver.al_ilqr import build_core, rollout as rollout_j
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu_torch.ops.generic_bwd import plain_bwd
from mmmpc_tpu_torch.utils.configs import SolverConfig
from mmmpc_tpu_torch.utils.convert import params_from_numpy

import torch_problems as tp
from torch_problems import ARM_BATCH, B, BWD_ATOL, FORMULATIONS, N

F32 = jnp.float32
CFG = tp.GENERIC_CFG

torch.set_num_threads(1)    # batch 64: threads only contend with the others


@functools.lru_cache(maxsize=None)
def make_problem(name, batch=B, cfg_items=tuple(CFG.items())):
    """Both packages' controllers and identical float64 numpy data
    (tests/torch_problems.py): starts x0_b (batch, nx), inputs U0_b (batch,
    N, nu), and each package's params (the port's in float64 as numpy)."""
    mpc_t, x0_b, U0_b, p_t = tp.generic_problem(
        name, batch, SolverConfig(**dict(cfg_items)))
    mpc_j = tp.generic_controller(name, SolverConfigJ(**dict(cfg_items)),
                                  (ctl_j, obs_j, robots_j))
    return mpc_j, mpc_t, x0_b, U0_b, tp.generic_params(mpc_j, name), p_t


def _jax_rollout(mpc_j, x0_b, U0_b, p_j, dtype):
    pj = {k: jnp.asarray(v, dtype) for k, v in p_j.items()}
    X, Uc = jax.vmap(lambda x0, U: rollout_j(mpc_j.ocp, x0, U, pj))(
        jnp.asarray(x0_b, dtype), jnp.asarray(U0_b, dtype))
    return pj, np.asarray(X), np.asarray(Uc)


def _bm(a, *perm, dtype=np.float32):
    """Batch-major numpy -> batch-last tensor (float32 by default)."""
    return torch.as_tensor(np.ascontiguousarray(
        np.transpose(np.asarray(a, dtype), perm)))


@functools.lru_cache(maxsize=None)
def _fwd_case(name):
    """Formulation ``name``'s line-search inputs at batch B, batch-major
    (X[:, :-1] with x0 first, U, kff, K, lam, lam_t, lam_e), and the JAX
    package's candidates on them (X, U, cost over (alpha, batch))."""
    mpc_j, mpc_t, x0_b, U0_b, p_j, p_t = make_problem(name)
    pj, X, Uc = _jax_rollout(mpc_j, x0_b, U0_b, p_j, F32)
    nx, nu = mpc_t.NX, mpc_t.NU
    cfg = mpc_j.solver_config
    core = build_core(mpc_j.ocp, pj, cfg, F32)
    rng = np.random.default_rng(11)
    kff = (0.05 * rng.standard_normal((B, N, nu))).astype(np.float32)
    K = (0.05 * rng.standard_normal((B, N, nu, nx))).astype(np.float32)
    # nonzero multipliers on every row, the masked ones included
    lam = np.abs(rng.standard_normal((B, N, core.nc))).astype(np.float32)
    lam_t = np.abs(rng.standard_normal((B, core.nct))).astype(np.float32)
    lam_e = np.zeros((B, 0), np.float32)

    alphas = cfg.alpha_decay ** jnp.arange(cfg.n_alpha, dtype=F32)
    fwd_b = jax.vmap(core.fwd_pass, in_axes=(0, 0, 0, 0, 0, None, 0, None))
    Xr, Ur, cr = jax.jit(jax.vmap(lambda a: fwd_b(
        X[:, 0], X, Uc, kff, K, a, (lam, lam_t, lam_e),
        jnp.asarray(10.0, F32))))(alphas)
    return (mpc_t, p_t, (np.array(X[:, :-1]), np.array(Uc), kff, K, lam,
                         lam_t, lam_e),
            (np.asarray(Xr), np.asarray(Ur), np.asarray(cr)))


def _check_fwd(name, batch):
    """The port's line search on the first ``batch`` scenarios of
    ``_fwd_case(name)`` against the JAX package's candidates there."""
    mpc_t, p_t, (X, Uc, kff, K, lam, lam_t, lam_e), (Xr, Ur, cr) = \
        _fwd_case(name)
    X, Uc, kff, K, lam, lam_t, lam_e = (
        a[:batch] for a in (X, Uc, kff, K, lam, lam_t, lam_e))
    Xr, Ur, cr = Xr[:, :batch], Ur[:, :batch], cr[:, :batch]
    fwd = mpc_t.ocp.lanes_fwd_factory(
        mpc_t.solver_config, params_from_numpy(p_t, "cpu", torch.float32))
    Xc, Uc_t, xlast, cc = fwd(_bm(X, 1, 2, 0), _bm(Uc, 1, 2, 0),
                              _bm(kff, 1, 2, 0), _bm(K, 1, 2, 3, 0),
                              _bm(lam, 1, 2, 0), _bm(lam_t, 1, 0),
                              _bm(lam_e, 1, 0), 10.0)
    np.testing.assert_allclose(Xc.permute(1, 3, 0, 2).numpy(),
                               Xr[:, :, :-1], atol=2e-5)
    np.testing.assert_allclose(xlast.permute(0, 2, 1).numpy(),
                               Xr[:, :, -1], atol=2e-5)
    np.testing.assert_allclose(Uc_t.permute(1, 3, 0, 2).numpy(), Ur,
                               atol=2e-5)
    np.testing.assert_allclose(cc.numpy(), cr, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", FORMULATIONS)
def test_generic_fwd_plain_matches_jax(name):
    _check_fwd(name, B)


@pytest.mark.parametrize("batch", (37, 1))
@pytest.mark.parametrize("name", FORMULATIONS)
def test_generic_fwd_plain_matches_jax_at_ragged_batch(name, batch):
    """The line search's wrapper on CPU tensors at ragged batches (37
    scenarios, tests/test_torch_cuda.py's partial block, and one) against
    the JAX package's candidates of the same scenarios, taken from the
    batch-B case (no new JAX compile)."""
    _check_fwd(name, batch)


def _jax_gains(mpc_j, x0_b, U0_b, p_j, lams, dtype):
    """The JAX package's structured expansion + scan Riccati sweep, vmapped
    over the batch: (kff (B, N, nu), K (B, N, nu, nx))."""
    pj, X, Uc = _jax_rollout(mpc_j, x0_b, U0_b, p_j, dtype)
    core = build_core(mpc_j.ocp, pj, mpc_j.solver_config, dtype)
    mu = jnp.asarray(10.0, dtype)

    def reference(x, u, lam, lt, le, r):
        derivs = jax.vmap(core.stage_derivs, in_axes=(0, 0, 0, 0, None))(
            x[:-1], u, core.ks, lam, mu)
        tg, tH = core.terminal_derivs(x[-1], lt, le, mu)
        return core.backward_scan(derivs, tg, tH, r)

    lam, lam_t, lam_e, reg = (jnp.asarray(a, dtype) for a in lams)
    kff, K = jax.jit(jax.vmap(reference))(X, Uc, lam, lam_t, lam_e, reg)
    return np.asarray(kff), np.asarray(K), X, Uc


@pytest.mark.parametrize("name", FORMULATIONS)
def test_generic_bwd_plain_matches_jax(name):
    # the arm at the JAX test's batch: its p99 is taken over a batch where
    # the ill-conditioned scenarios (2% here) are the tail it was set for
    batch = ARM_BATCH if name == "arm" else B
    mpc_j, mpc_t, x0_b, U0_b, p_j, p_t = make_problem(name, batch)
    form = mpc_t.ocp.lanes_bwd_factory(
        mpc_t.solver_config, params_from_numpy(p_t, "cpu", torch.float32))
    nc, nct = form.form.nc, form.form.nct
    rng = np.random.default_rng(3)
    lams = ((0.3 * np.abs(rng.standard_normal((batch, N, nc))))
            .astype(np.float32),
            (0.3 * np.abs(rng.standard_normal((batch, nct))))
            .astype(np.float32),
            np.zeros((batch, 0), np.float32),
            np.full((batch,), 1e-6, np.float32))

    kff_r, K_r, X, Uc = _jax_gains(mpc_j, x0_b, U0_b, p_j, lams, F32)
    kff, K = form(_bm(X, 1, 2, 0), _bm(Uc, 1, 2, 0), _bm(lams[0], 1, 2, 0),
                  _bm(lams[1], 1, 0), _bm(lams[2], 1, 0), 10.0,
                  torch.as_tensor(lams[3]))
    kff, K = kff.permute(2, 0, 1).numpy(), K.permute(3, 0, 1, 2).numpy()
    if name != "arm":
        np.testing.assert_allclose(kff, kff_r, rtol=1e-4,
                                   atol=BWD_ATOL[name])
        np.testing.assert_allclose(K, K_r, rtol=1e-4, atol=BWD_ATOL[name])
        return
    kff64, K64, X64, U64 = _jax_gains(mpc_j, x0_b, U0_b, p_j, lams,
                                      jnp.float64)
    # the algebra itself: in float64 the two agree to 1e-9 of the gains'
    # scale, the conditioning notwithstanding
    f64 = dict(dtype=np.float64)
    port64 = plain_bwd(mpc_t.ocp, params_from_numpy(p_t, "cpu", torch.float64),
                       1.0, _bm(X64, 1, 2, 0, **f64), _bm(U64, 1, 2, 0, **f64),
                       _bm(lams[0], 1, 2, 0, **f64), _bm(lams[1], 1, 0, **f64),
                       _bm(lams[2], 1, 0, **f64), 10.0,
                       _bm(lams[3], 0, **f64))
    for got, ref in ((port64[0].permute(2, 0, 1), kff64),
                     (port64[1].permute(3, 0, 1, 2), K64)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-9 * np.abs(ref).max())
    for port, jax32, truth in ((kff, kff_r, kff64), (K, K_r, K64)):
        cross = np.abs(port.astype(np.float64) - jax32)
        assert np.percentile(cross, 99) < 5e-4, np.percentile(cross, 99)
        e_port = np.abs(port - truth).max()
        e_jax = np.abs(jax32 - truth).max()
        assert e_port <= max(2.0 * e_jax, 1e-3), (e_port, e_jax)
        assert e_port < 0.15, e_port


def test_layout_check_reads_the_formulations_sizes():
    """Each launch holds the host blocks' sizes against the ones the library
    reports for the formulation (a stand-in library here)."""
    from mmmpc_tpu_torch.ops._cuda import check_layout
    _, mpc_t, _, _, _, p_t = make_problem("base")
    fwd = mpc_t.ocp.lanes_fwd_factory(
        mpc_t.solver_config, params_from_numpy(p_t, "cpu", torch.float32))

    class Library:
        def __init__(self, extra):
            self.extra = extra

        def gen_statics_size_base(self):
            return fwd.statics.size + self.extra

        def gen_params_size_base(self, n, n_obs, n_hp):
            assert (n, n_obs, n_hp) == (N, 2, 0)
            return fwd.flat.numel()

    check_layout(Library(0), fwd.statics, fwd.flat, N, 2, 0, "base")
    with pytest.raises(RuntimeError, match="layout mismatch"):
        check_layout(Library(1), fwd.statics, fwd.flat, N, 2, 0, "base")


def test_bwd_launch_geometry_reports_the_library():
    """``launch_geometry`` of a formulation's fused backward reports the
    lanes a scenario, threads, blocks and shared-memory bytes with which
    the library's ``gen_bwd_<name>`` launches, as its
    ``gen_bwd_geometry_<name>`` (here a stand-in) writes them: the team
    kernel of the endpoint (8 lanes, 16 scenarios a block) and of the arm
    (4 lanes, 32 scenarios a block), the demo's and the base's one thread
    a scenario (128 a block, their stage buffer in static shared memory, so
    no dynamic bytes)."""
    from mmmpc_tpu_torch.ops.generic_bwd import launch_geometry

    class Library:
        def gen_bwd_geometry_endpoint(self, n, n_obs, n_hp, batch, out):
            assert (n, n_obs, n_hp) == (N, 3, 0)
            out[0], out[1], out[2], out[3] = 8, 128, -(-batch // 16), 4 * n
            return 0

        def gen_bwd_geometry_arm(self, n, n_obs, n_hp, batch, out):
            assert (n, n_obs, n_hp) == (N, 0, 2)
            out[0], out[1], out[2], out[3] = 4, 128, -(-batch // 32), 8 * n
            return 0

        def one_thread(self, n, n_obs, n_hp, batch, out):
            out[0], out[1], out[2], out[3] = 1, 128, -(-batch // 128), 0
            return 0

        gen_bwd_geometry_demo = gen_bwd_geometry_base = one_thread

    assert launch_geometry(Library(), "endpoint", N, 3, 0, 8191) == dict(
        team=8, threads=128, blocks=512, smem_bytes=4 * N)
    assert launch_geometry(Library(), "arm", N, 0, 2, 8191) == dict(
        team=4, threads=128, blocks=256, smem_bytes=8 * N)
    assert launch_geometry(Library(), "arm", N, 0, 2, 1)["blocks"] == 1
    assert launch_geometry(Library(), "demo", N, 0, 0, 129)["blocks"] == 2
    assert launch_geometry(Library(), "base", N, 2, 0, 8191) == dict(
        team=1, threads=128, blocks=64, smem_bytes=0)
    assert launch_geometry(Library(), "base", N, 2, 0, 1)["blocks"] == 1


def test_fwd_launch_geometry_reports_the_library():
    """``launch_geometry`` of a formulation's fused line search reports the
    lanes a candidate, threads, blocks and shared-memory bytes with which
    the library's ``gen_fwd_<name>`` launches at a batch and a number of
    step sizes, as its ``gen_fwd_geometry_<name>`` (here a stand-in) writes
    them: the team line search of the base, the arm and the endpoint (2
    lanes a candidate, so a block of 128 threads holds min((128 / 2) /
    n_alpha, 32) scenarios), the demo's one thread a candidate (its stage
    ring in static shared memory, so no dynamic bytes); the demo and the
    base also at the ragged batches 8191, 1000 and 1 at which chip_smoke.py
    checks them on the card."""
    from mmmpc_tpu_torch.ops.generic_fwd import launch_geometry

    # packed-buffer floats (a stand-in for the shared bytes) and (n_obs,
    # n_hp) of each team instance
    SMEM = {"base": 3 * N, "arm": 2 * N, "endpoint": 4 * N}
    OBS = {"demo": (0, 0), "base": (2, 0), "arm": (0, 2), "endpoint": (3, 0)}

    class Library:
        def __getattr__(self, entry):
            name = entry.removeprefix("gen_fwd_geometry_")

            def team(n, n_obs, n_hp, n_alpha, batch, out):
                assert (n, n_obs, n_hp) == (N, *OBS[name])
                scen = min(64 // n_alpha, 32)
                out[0], out[1] = 2, 128
                out[2], out[3] = -(-batch // scen), SMEM[name]
                return 0

            def one_thread(n, n_obs, n_hp, n_alpha, batch, out):
                assert (n, n_obs, n_hp) == (N, *OBS[name])
                out[0], out[1] = 1, 128
                out[2], out[3] = -(-(n_alpha * batch) // 128), 0
                return 0
            return one_thread if name == "demo" else team

    for name in ("base", "arm", "endpoint"):
        assert launch_geometry(Library(), name, N, *OBS[name], 3, 8192) == dict(
            team=2, threads=128, blocks=391, smem_bytes=SMEM[name])
        assert launch_geometry(Library(), name, N, *OBS[name], 1, 8191)[
            "blocks"] == 256
    assert launch_geometry(Library(), "demo", N, 0, 0, 3, 8192) == dict(
        team=1, threads=128, blocks=192, smem_bytes=0)
    for name, blocks in (("demo", [192, 24, 1]), ("base", [391, 48, 1])):
        assert [launch_geometry(Library(), name, N, *OBS[name], 3, batch)[
            "blocks"] for batch in (8191, 1000, 1)] == blocks

"""Parity of the plain versions of the two fused kernels with the JAX
package's plain references (each CUDA kernel against its plain version on a
card: tests/test_torch_cuda.py).

float32, B=64, N=5, on the problem of tests/test_fwd_lanes.py (one ground
obstacle and one half-plane, so every constraint family is live).  The JAX
side is the vmapped per-scenario reference, not the Pallas kernels:
``core.fwd_pass`` over (alpha, batch) for the line search, and
``core.stage_derivs`` / ``core.terminal_derivs`` followed by the scan
Riccati sweep for the backward pass.  Tolerances are the JAX kernel tests':
X / U atol 2e-5 and cost rtol = atol = 2e-3 (tests/test_fwd_lanes.py), gains
rtol = atol = 5e-3 (tests/test_fused_bwd.py) — float32 op-order differences,
amplified through the Cholesky on the gains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu import controllers as controllers_j
from mmmpc_tpu.models import obstacles as obstacles_j
from mmmpc_tpu.models import robots as robots_j
from mmmpc_tpu.solver.al_ilqr import build_core, rollout as rollout_j
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu_torch.utils.configs import SolverConfig
from mmmpc_tpu_torch.utils.convert import params_from_numpy

import torch_problems as tp
from torch_problems import B, N

F32 = jnp.float32
CFG = tp.QREF_CFG

torch.set_num_threads(1)    # batch 64: threads only contend with the others


def make_problem(eq_mask=0.0):
    """Both packages' controllers on identical data (tests/torch_problems.py);
    the params are the JAX package's."""
    mpc_t, x0_b, U0_b, _ = tp.qref_problem(eq_mask, SolverConfig(**CFG))
    mpc_j, _, _, params = tp.qref_problem(
        eq_mask, SolverConfigJ(**CFG),
        (controllers_j, obstacles_j, robots_j))
    return mpc_j, mpc_t, x0_b, U0_b, params


def _inputs(mpc_j, x0_b, U0_b, params, seed):
    """Rollout X (batch-major, JAX) + random multipliers / gains."""
    pj = {k: jnp.asarray(v, F32) for k, v in params.items()}
    X, Uc = jax.vmap(lambda x0, U: rollout_j(mpc_j.ocp, x0, U, pj))(
        jnp.asarray(x0_b, F32), jnp.asarray(U0_b, F32))
    rng = np.random.default_rng(seed)
    return pj, np.asarray(X), np.asarray(Uc), rng


def _bm(a, *perm):
    return torch.as_tensor(np.ascontiguousarray(np.transpose(a, perm)))


@pytest.fixture(scope="module")
def references():
    """{eq_mask: (problem, the line search's inputs and JAX's results, the
    backward pass's inputs and JAX's gains)} for eq_mask 0 and 1: the
    vmapped ``core.fwd_pass`` over (alpha, batch), and ``core.stage_derivs``
    / ``core.terminal_derivs`` followed by the scan Riccati sweep, in one
    jitted program whose params are an argument, compiled once."""
    mpc_j = make_problem()[0]
    cfg = mpc_j.solver_config
    alphas = cfg.alpha_decay ** jnp.arange(cfg.n_alpha, dtype=F32)
    mu = jnp.asarray(10.0, F32)

    @jax.jit
    def reference(pj, fwd_args, bwd_args):
        core = build_core(mpc_j.ocp, pj, cfg, F32)
        X, Uc, kff, K, lam, lam_t, lam_e = fwd_args
        fwd_b = jax.vmap(core.fwd_pass,
                         in_axes=(0, 0, 0, 0, 0, None, 0, None))
        fwd = jax.vmap(lambda a: fwd_b(X[:, 0], X, Uc, kff, K, a,
                                       (lam, lam_t, lam_e), mu))(alphas)

        def backward(x, u, l, lt, le, r):
            derivs = jax.vmap(core.stage_derivs, in_axes=(0, 0, 0, 0, None))(
                x[:-1], u, core.ks, l, mu)
            tg, tH = core.terminal_derivs(x[-1], lt, le, mu)
            return core.backward_scan(derivs, tg, tH, r)

        return fwd, jax.vmap(backward)(*bwd_args)

    out, fwd_in = {}, None
    for eq_mask in (0.0, 1.0):
        problem = make_problem(eq_mask)
        mpc_j, mpc_t, x0_b, U0_b, params = problem
        if fwd_in is None:
            pj, X, Uc, rng = _inputs(mpc_j, x0_b, U0_b, params, 11)
            kff = (0.05 * rng.standard_normal((B, N, 5))).astype(np.float32)
            K = (0.05 * rng.standard_normal((B, N, 5, 9))).astype(np.float32)
            lam = np.abs(rng.standard_normal((B, N, 28))).astype(np.float32)
            lam_t = np.abs(rng.standard_normal((B, 18))).astype(np.float32)
            lam_e = np.zeros((B, 2), np.float32)
            fwd_in = (X, Uc, kff, K, lam, lam_t, lam_e)
        pj, X, Uc, rng = _inputs(mpc_j, x0_b, U0_b, params, 3)
        lam = (0.5 * np.abs(rng.standard_normal((B, N, 28)))).astype(
            np.float32)
        lam_t = (0.5 * np.abs(rng.standard_normal((B, 18)))).astype(
            np.float32)
        lam_e = (0.1 * rng.standard_normal((B, 2))).astype(np.float32)
        reg = np.full((B,), 1e-6, np.float32)
        bwd_in = (X, Uc, lam, lam_t, lam_e, reg)
        fwd_r, bwd_r = reference(pj, fwd_in, bwd_in)
        out[eq_mask] = (problem, fwd_in, fwd_r, bwd_in, bwd_r)
    return out


def test_fwd_plain_matches_jax(references):
    (_, mpc_t, _, _, params), fwd_in, (Xr, Ur, cr), _, _ = references[0.0]
    X, Uc, kff, K, lam, lam_t, lam_e = fwd_in
    fwd = mpc_t.ocp.lanes_fwd_factory(
        mpc_t.solver_config, params_from_numpy(params, "cpu", torch.float32))
    Xc, Uc_t, xlast, cc = fwd(_bm(X[:, :-1], 1, 2, 0), _bm(Uc, 1, 2, 0),
                              _bm(kff, 1, 2, 0), _bm(K, 1, 2, 3, 0),
                              _bm(lam, 1, 2, 0), _bm(lam_t, 1, 0),
                              _bm(lam_e, 1, 0), 10.0)
    np.testing.assert_allclose(Xc.permute(1, 3, 0, 2).numpy(),
                               np.asarray(Xr[:, :, :-1]), atol=2e-5)
    np.testing.assert_allclose(xlast.permute(0, 2, 1).numpy(),
                               np.asarray(Xr[:, :, -1]), atol=2e-5)
    np.testing.assert_allclose(Uc_t.permute(1, 3, 0, 2).numpy(),
                               np.asarray(Ur), atol=2e-5)
    np.testing.assert_allclose(cc.numpy(), np.asarray(cr), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("eq_mask", [0.0, 1.0])
def test_bwd_plain_matches_jax(references, eq_mask):
    (_, mpc_t, _, _, params), _, _, bwd_in, (kff_r, K_r) = references[eq_mask]
    X, Uc, lam, lam_t, lam_e, reg = bwd_in
    bwd = mpc_t.ocp.lanes_bwd_factory(
        mpc_t.solver_config, params_from_numpy(params, "cpu", torch.float32))
    kff, K = bwd(_bm(X, 1, 2, 0), _bm(Uc, 1, 2, 0), _bm(lam, 1, 2, 0),
                 _bm(lam_t, 1, 0), _bm(lam_e, 1, 0), 10.0,
                 torch.as_tensor(reg))
    np.testing.assert_allclose(kff.permute(2, 0, 1).numpy(),
                               np.asarray(kff_r), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(K.permute(3, 0, 1, 2).numpy(),
                               np.asarray(K_r), rtol=5e-3, atol=5e-3)


def test_layout_check_rejects_a_size_mismatch():
    """Each launch holds the host blocks' sizes against the library's; a
    library (here a stand-in) that reports other sizes stops the launch."""
    from mmmpc_tpu_torch.ops._cuda import check_layout
    _, mpc_t, _, _, params = make_problem()
    fwd = mpc_t.ocp.lanes_fwd_factory(
        mpc_t.solver_config, params_from_numpy(params, "cpu", torch.float32))

    class Library:
        def __init__(self, extra):
            self.extra = extra

        def wb_statics_size(self):
            return fwd.statics.size + self.extra

        def wb_params_size(self, n, n_obs, n_hp, moving):
            assert (n, n_obs, n_hp, moving) == (N, 1, 1, 0)
            return fwd.flat.numel()

    check_layout(Library(0), fwd.statics, fwd.flat, N, fwd.n_obs, fwd.n_hp)
    with pytest.raises(RuntimeError, match="layout mismatch"):
        check_layout(Library(1), fwd.statics, fwd.flat, N, fwd.n_obs,
                     fwd.n_hp)


def test_bwd_launch_geometry_checks_the_team_size():
    """``launch_geometry`` reports the team size, threads, blocks and
    shared-memory bytes with which the library's ``wb_bwd_launch`` launches,
    as its ``wb_bwd_geometry`` (here a stand-in) writes them for the
    problem's sizes and the batch."""
    from mmmpc_tpu_torch.ops.wholebody_bwd import launch_geometry

    class Library:
        def wb_bwd_geometry(self, n, n_obs, n_hp, moving, per_scenario,
                            batch, out):
            assert (n, n_obs, n_hp, moving) == (N, 1, 1, 0)
            out[0], out[1], out[2], out[3] = (8, 128, -(-batch // 16),
                                              4 * n + per_scenario)
            return 0

    assert launch_geometry(Library(), N, 1, 1, 37) == dict(
        team=8, threads=128, blocks=3, smem_bytes=4 * N)
    assert launch_geometry(Library(), N, 1, 1, 37,
                           per_scenario=63)["smem_bytes"] == 4 * N + 63


def test_fwd_launch_geometry_reports_the_library():
    """``launch_geometry`` of the line search reports the lanes a
    candidate, threads, blocks and shared-memory bytes with which the
    library's ``wb_fwd_launch`` launches, as its ``wb_fwd_geometry`` (here
    a stand-in) writes them for the problem's sizes, the step sizes and the
    batch: the candidates of a scenario in one block."""
    from mmmpc_tpu_torch.ops.wholebody_fwd import launch_geometry

    class Library:
        def wb_fwd_geometry(self, n, n_obs, n_hp, moving, per_scenario,
                            n_alpha, batch, out):
            assert (n, n_obs, n_hp, moving) == (N, 1, 1, 0)
            scen = min((128 // 2) // n_alpha, 32)
            out[0], out[1], out[2], out[3] = (2, 128, -(-batch // scen),
                                              4 * n + per_scenario)
            return 0

    assert launch_geometry(Library(), N, 1, 1, 3, 37) == dict(
        team=2, threads=128, blocks=2, smem_bytes=4 * N)
    assert launch_geometry(Library(), N, 1, 1, 8, 37)["blocks"] == 5
    assert launch_geometry(Library(), N, 1, 1, 3, 37,
                           per_scenario=1)["smem_bytes"] == 4 * N + 1

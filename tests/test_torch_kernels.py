"""Parity of the plain versions of the two fused kernels with the JAX
package's plain references, and (on a CUDA card) of each CUDA kernel with
its plain version.

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

from mmmpc_tpu.controllers import MPCWholeBody as MPCWholeBodyJ
from mmmpc_tpu.models.obstacles import Obstacles as ObstaclesJ
from mmmpc_tpu.models.robots import MobileManipulator as MobileManipulatorJ
from mmmpc_tpu.solver.al_ilqr import build_core, rollout as rollout_j
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu_torch.controllers import MPCWholeBody
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import MobileManipulator
from mmmpc_tpu_torch.solver.al_ilqr import rollout
from mmmpc_tpu_torch.utils.configs import SolverConfig
from mmmpc_tpu_torch.utils.convert import params_from_numpy

B, N = 64, 5
F32 = jnp.float32
CFG = dict(al_iters=2, ilqr_iters=4, n_alpha=3, alpha_decay=0.4,
           cost_scale=1e5)

torch.set_num_threads(1)    # batch 64: threads only contend with the others


def make_problem(eq_mask=0.0):
    """Both packages' controllers on identical data; inputs from numpy."""
    obstacles = [(1.0, 0.2, 0.3)]
    halfplanes = [(np.array([0.8, 0.1, 1.0]), np.array([[1.0, 0.0, 0.0]]))]
    mpc_j = MPCWholeBodyJ(MobileManipulatorJ(0.1),
                          [ObstaclesJ(*o) for o in obstacles], halfplanes,
                          N=N, solver_config=SolverConfigJ(**CFG))
    mpc_t = MPCWholeBody(MobileManipulator(0.1),
                         [Obstacles(*o) for o in obstacles], halfplanes,
                         N=N, solver_config=SolverConfig(**CFG))
    if eq_mask:
        mpc_j.add_terminal_position_constraint()
        mpc_t.add_terminal_position_constraint()
    rng = np.random.default_rng(7)
    x0 = np.zeros(9)
    x0[6:] = [-np.pi / 4, -np.pi / 2, np.pi / 2]
    x0_b = x0[None] + 0.02 * rng.standard_normal((B, 9)) * np.array(
        [1, 1, 0.2, 0, 0, 0, 0.1, 0.1, 0.1])
    U0_b = 0.1 * rng.standard_normal((B, N, 5))
    target = np.concatenate([[0.5, 0.1, 0, 0, 0, 0], x0[6:]])
    traj = np.linspace(x0, target, N + 1)
    params = {k: np.asarray(v, np.float64) for k, v in dict(
        mpc_j.make_params(traj, np.zeros((N, 5))),
        U_last=np.zeros((N, 5))).items()}
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


def test_fwd_plain_matches_jax():
    mpc_j, mpc_t, x0_b, U0_b, params = make_problem()
    pj, X, Uc, rng = _inputs(mpc_j, x0_b, U0_b, params, 11)
    kff = (0.05 * rng.standard_normal((B, N, 5))).astype(np.float32)
    K = (0.05 * rng.standard_normal((B, N, 5, 9))).astype(np.float32)
    lam = np.abs(rng.standard_normal((B, N, 28))).astype(np.float32)
    lam_t = np.abs(rng.standard_normal((B, 18))).astype(np.float32)
    lam_e = np.zeros((B, 2), np.float32)
    cfg = mpc_j.solver_config

    core = build_core(mpc_j.ocp, pj, cfg, F32)
    alphas = cfg.alpha_decay ** jnp.arange(cfg.n_alpha, dtype=F32)
    fwd_b = jax.vmap(core.fwd_pass, in_axes=(0, 0, 0, 0, 0, None, 0, None))
    Xr, Ur, cr = jax.jit(jax.vmap(lambda a: fwd_b(
        X[:, 0], X, Uc, kff, K, a, (lam, lam_t, lam_e),
        jnp.asarray(10.0, F32))))(alphas)

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
def test_bwd_plain_matches_jax(eq_mask):
    mpc_j, mpc_t, x0_b, U0_b, params = make_problem(eq_mask)
    pj, X, Uc, rng = _inputs(mpc_j, x0_b, U0_b, params, 3)
    lam = (0.5 * np.abs(rng.standard_normal((B, N, 28)))).astype(np.float32)
    lam_t = (0.5 * np.abs(rng.standard_normal((B, 18)))).astype(np.float32)
    lam_e = (0.1 * rng.standard_normal((B, 2))).astype(np.float32)
    reg = np.full((B,), 1e-6, np.float32)
    cfg = mpc_j.solver_config
    mu = jnp.asarray(10.0, F32)

    core = build_core(mpc_j.ocp, pj, cfg, F32)

    def reference(x, u, l, lt, le, r):
        derivs = jax.vmap(core.stage_derivs, in_axes=(0, 0, 0, 0, None))(
            x[:-1], u, core.ks, l, mu)
        tg, tH = core.terminal_derivs(x[-1], lt, le, mu)
        return core.backward_scan(derivs, tg, tH, r)

    kff_r, K_r = jax.jit(jax.vmap(reference))(X, Uc, lam, lam_t, lam_e, reg)

    bwd = mpc_t.ocp.lanes_bwd_factory(
        mpc_t.solver_config, params_from_numpy(params, "cpu", torch.float32))
    kff, K = bwd(_bm(X, 1, 2, 0), _bm(Uc, 1, 2, 0), _bm(lam, 1, 2, 0),
                 _bm(lam_t, 1, 0), _bm(lam_e, 1, 0), 10.0,
                 torch.as_tensor(reg))
    np.testing.assert_allclose(kff.permute(2, 0, 1).numpy(),
                               np.asarray(kff_r), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(K.permute(3, 0, 1, 2).numpy(),
                               np.asarray(K_r), rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["wholebody_fwd", "wholebody_bwd"])
def test_cuda_kernel_matches_plain(kernel):
    """The CUDA kernel against its plain version on the card, same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    _, mpc_t, x0_b, U0_b, params = make_problem(1.0)
    dev = torch.device("cuda")
    p = params_from_numpy(params, dev, torch.float32)
    rng = np.random.default_rng(5)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    X, U = rollout(mpc_t.ocp, t(x0_b).T, t(U0_b).permute(1, 2, 0), p)
    lam = t(np.abs(rng.standard_normal((N, 28, B))))
    lamt = t(np.abs(rng.standard_normal((18, B))))
    lame = t(0.1 * rng.standard_normal((2, B)))
    if kernel == "wholebody_fwd":
        f = mpc_t.ocp.lanes_fwd_factory(mpc_t.solver_config, p)
        args = (X[:-1], U, t(0.05 * rng.standard_normal((N, 5, B))),
                t(0.05 * rng.standard_normal((N, 5, 9, B))), lam, lamt, lame,
                10.0)
        tols = [(0.0, 2e-5)] * 3 + [(2e-3, 2e-3)]
    else:
        f = mpc_t.ocp.lanes_bwd_factory(mpc_t.solver_config, p)
        args = (X, U, lam, lamt, lame, 10.0,
                torch.full((B,), 1e-6, device=dev))
        tols = [(5e-3, 5e-3)] * 2
    got, ref = f.cuda(*args), f.plain(*args)
    torch.cuda.synchronize()
    for g, r, (rtol, atol) in zip(got, ref, tols):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


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

        def wb_params_size(self, n, n_obs, n_hp):
            assert (n, n_obs, n_hp) == (N, 1, 1)
            return fwd.flat.numel()

    check_layout(Library(0), fwd.statics, fwd.flat, N, fwd.n_obs, fwd.n_hp)
    with pytest.raises(RuntimeError, match="layout mismatch"):
        check_layout(Library(1), fwd.statics, fwd.flat, N, fwd.n_obs,
                     fwd.n_hp)

"""Parity of the plain versions of the two generic fused kernels with the JAX
package, for each of the four formulations that run them (demo, base, arm,
whole-body endpoint), and (on a CUDA card) of each CUDA kernel instance with
its plain version.

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
from mmmpc_tpu_torch import controllers as ctl_t
from mmmpc_tpu_torch.models import obstacles as obs_t
from mmmpc_tpu_torch.models import robots as robots_t
from mmmpc_tpu_torch.ops.generic_bwd import plain_bwd
from mmmpc_tpu_torch.solver.al_ilqr import rollout
from mmmpc_tpu_torch.utils.configs import SolverConfig
from mmmpc_tpu_torch.utils.convert import params_from_numpy

B, N = 64, 5
ARM_BATCH = 1024
F32 = jnp.float32
CFG = dict(al_iters=2, ilqr_iters=4, n_alpha=3, alpha_decay=0.4)
FORMULATIONS = ("demo", "base", "arm", "endpoint")
# gains tolerance (atol) of each formulation's backward pass; rtol 1e-4
BWD_ATOL = {"demo": 1e-5, "base": 1e-3, "endpoint": 2e-4}
WEDGE = ([np.array([[1 / np.sqrt(2), 0, 1 / np.sqrt(2)]]),
          np.array([[-1 / np.sqrt(2), 0, 1 / np.sqrt(2)]])],
         np.array([0.0, 0.0, 0.35]))

torch.set_num_threads(1)    # batch 64: threads only contend with the others


def _controllers(name, cfg_kw):
    """(JAX controller, port controller) of one formulation, same data."""
    def build(ctl, obs, robots, cfg):
        if name == "demo":
            return ctl.MPC(robots.RobotDemo(0.1), N=N, solver_config=cfg)
        if name == "base":
            return ctl.MPCBase(robots.Base(0.1),
                               [obs.Obstacles(1.2, 0.15, 0.3),
                                obs.Obstacles(0.4, -0.4, 0.25)],
                               N=N, solver_config=cfg)
        if name == "arm":
            return ctl.MPCManipulator3DoF(robots.ManipulatorPanda3DoF(0.1),
                                          *WEDGE, N=N, solver_config=cfg)
        return ctl.MPCWholeBodyEndpoint(robots.MobileManipulator(0.1),
                                        [obs.Obstacles(1.0, 0.2, 0.3)], N=N,
                                        solver_config=cfg)
    return (build(ctl_j, obs_j, robots_j, SolverConfigJ(**cfg_kw)),
            build(ctl_t, obs_t, robots_t, SolverConfig(**cfg_kw)))


@functools.lru_cache(maxsize=None)
def make_problem(name, batch=B, cfg_items=tuple(CFG.items())):
    """Both packages' controllers and identical float64 numpy data: starts
    x0_b (batch, nx), inputs U0_b (batch, N, nu), and each package's params
    (the port's in float64 as numpy)."""
    mpc_j, mpc_t = _controllers(name, dict(cfg_items))
    rng = np.random.default_rng(0)
    if name == "demo":
        x0_b = np.stack([rng.uniform(-2, 2, batch),
                         rng.uniform(-0.9, 0.9, batch)], axis=1)
        traj, nu = np.linspace([0.0, 0.0], [3.0, 0.0], N + 1), 1
    elif name == "base":
        x0_b = rng.standard_normal((batch, 6)) * np.array(
            [0.4, 0.4, 0.6, 0.2, 0.2, 0.2])
        traj = np.linspace(np.zeros(6), np.array([2.0, 0.4, 0.5, 0, 0, 0]),
                           N + 1)
        nu = 2
    elif name == "arm":
        q0 = np.array([0.3, -1.2, 1.2])
        x0_b = np.clip(q0[None] + rng.standard_normal((batch, 3)) * 0.2,
                       mpc_t.qlim[0] + 1e-3, mpc_t.qlim[1] - 1e-3)
        traj, nu = np.linspace(q0, [0.0, -0.6, 0.9], N + 1), 3
    else:
        x0 = np.zeros(9)
        x0[6:] = [-np.pi / 4, -np.pi / 2, np.pi / 2]
        x0_b = x0[None] + 0.05 * rng.standard_normal((batch, 9)) * np.array(
            [1, 1, 0.5, 0.2, 0.2, 0.2, 0.3, 0.3, 0.3])
        traj = np.linspace([0.6, 0.1, 1.1, 0.0], [0.8, 0.2, 1.0, 0.3], N + 1)
        nu = 5
    U0_b = 0.3 * rng.standard_normal((batch, N, nu))
    extra = {"U_last": np.zeros((N, nu))} if name in ("arm", "endpoint") else {}
    p_j = {k: np.asarray(v, np.float64) for k, v in dict(
        mpc_j.make_params(traj, np.zeros((N, nu))), **extra).items()}
    p_t = {k: np.asarray(v, np.float64) for k, v in dict(
        mpc_t.make_params(traj, np.zeros((N, nu))), **extra).items()}
    return mpc_j, mpc_t, x0_b, U0_b, p_j, p_t


def _jax_rollout(mpc_j, x0_b, U0_b, p_j, dtype):
    pj = {k: jnp.asarray(v, dtype) for k, v in p_j.items()}
    X, Uc = jax.vmap(lambda x0, U: rollout_j(mpc_j.ocp, x0, U, pj))(
        jnp.asarray(x0_b, dtype), jnp.asarray(U0_b, dtype))
    return pj, np.asarray(X), np.asarray(Uc)


def _bm(a, *perm, dtype=np.float32):
    """Batch-major numpy -> batch-last tensor (float32 by default)."""
    return torch.as_tensor(np.ascontiguousarray(
        np.transpose(np.asarray(a, dtype), perm)))


@pytest.mark.parametrize("name", FORMULATIONS)
def test_generic_fwd_plain_matches_jax(name):
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

    fwd = mpc_t.ocp.lanes_fwd_factory(
        mpc_t.solver_config, params_from_numpy(p_t, "cpu", torch.float32))
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


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("name", FORMULATIONS)
def test_cuda_generic_kernel_matches_plain(name, kernel):
    """Each CUDA kernel instance against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    _, mpc_t, x0_b, U0_b, _, p_t = make_problem(name)
    dev = torch.device("cuda")
    p = params_from_numpy(p_t, dev, torch.float32)
    rng = np.random.default_rng(5)
    nx, nu = mpc_t.NX, mpc_t.NU

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    X, U = rollout(mpc_t.ocp, t(x0_b).T, t(U0_b).permute(1, 2, 0), p)
    if kernel == "fwd":
        f = mpc_t.ocp.lanes_fwd_factory(mpc_t.solver_config, p)
        args = (X[:-1], U, t(0.05 * rng.standard_normal((N, nu, B))),
                t(0.05 * rng.standard_normal((N, nu, nx, B))),
                t(np.abs(rng.standard_normal((N, f.form.nc, B)))),
                t(np.abs(rng.standard_normal((f.form.nct, B)))),
                t(np.zeros((0, B))), 10.0)
        got, ref = f.cuda(*args), f.plain(*args)
        torch.cuda.synchronize()
        for g, r, tol in zip(got, ref, [(0.0, 2e-5)] * 3 + [(2e-3, 2e-3)]):
            torch.testing.assert_close(g, r, rtol=tol[0], atol=tol[1])
        return
    f = mpc_t.ocp.lanes_bwd_factory(mpc_t.solver_config, p)
    args = (X, U, t(0.3 * np.abs(rng.standard_normal((N, f.form.nc, B)))),
            t(0.3 * np.abs(rng.standard_normal((f.form.nct, B)))),
            t(np.zeros((0, B))), 10.0, torch.full((B,), 1e-6, device=dev))
    got, ref = f.cuda(*args), f.plain(*args)
    torch.cuda.synchronize()
    if name != "arm":
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=BWD_ATOL[name])
        return
    truth = plain_bwd(mpc_t.ocp, {k: v.double() for k, v in p.items()},
                      f.inv_scale, *(a.double() if torch.is_tensor(a) else a
                                     for a in args))
    for g, r, tr in zip(got, ref, truth):
        cross = (g - r).abs().double()
        assert torch.quantile(cross.flatten(), 0.99) < 5e-4
        e_kernel = (g.double() - tr).abs().max()
        assert e_kernel <= max(2.0 * (r.double() - tr).abs().max(), 1e-3)
        assert e_kernel < 0.15

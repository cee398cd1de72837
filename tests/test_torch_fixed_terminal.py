"""The port's fixed terminal formulation (``MPCWholeBody(
replicate_terminal_selfcol_bug=False)``) against the JAX package's.

On the problem of ``tests/torch_problems.py::selfcol_problem`` (the arm
folded with its end point inside a self-collision sphere at the stage
states and at x_N, float32, B=64, N=5, cost_scale 1.0):

- the stage and terminal costs and the slack values (the residuals' slack
  row) at the rollout's states, every stage, and the AL expansion that the
  unfused path hands kernel E (``stage_al_blocks`` / ``terminal_al_blocks``)
  against JAX's ``core.stage_derivs`` / ``core.terminal_derivs``, float64
  on both sides, at 1e-8;
- kernels A and B's plain versions against the JAX package's vmapped
  references in float64, at the JAX kernel tests' tolerances: X / U atol
  2e-5, cost rtol = atol = 2e-3; gains rtol = atol = 5e-3, with the
  terminal equality off and on;
- the two settings of the flag differ on this problem by more than ten
  times those tolerances, in A's cost and B's gains;
- stage_cost == ||stage_residuals||^2 of the fixed formulation (the
  counterpart of ``tests/test_residuals.py``'s bug-fix case);
- the flag reaches the kernels' statics, and ``MPCWholeBodyMovingObs``
  passes it on;
- one whole solve at N=6 from the fold against JAX's float32 single solve
  on the same inputs: relative cost <= 5e-3, both feasible at 1e-3.

The file's two JAX programs are compiled at XLA's lowest CPU optimisation
level, the solve's in a thread of its own while the port solves.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu import controllers as controllers_j
from mmmpc_tpu.models import obstacles as obstacles_j
from mmmpc_tpu.models import robots as robots_j
from mmmpc_tpu.solver import al_ilqr_solve as al_ilqr_solve_j
from mmmpc_tpu.solver.al_ilqr import build_core
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu_torch.controllers import MPCWholeBody, MPCWholeBodyMovingObs
from mmmpc_tpu_torch.models.mobile_manipulator import wholebody_fk
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import MobileManipulator
from mmmpc_tpu_torch.ocp.constraints import self_collision_g
from mmmpc_tpu_torch.solver.al_ilqr import (
    rollout, stage_al_blocks, terminal_al_blocks,
)
from mmmpc_tpu_torch.utils.configs import SolverConfig
from mmmpc_tpu_torch.utils.convert import params_from_numpy

import torch_problems as tp
from tests.test_torch_kernels import _bm
from torch_problems import B, N

JAX_MODULES = (controllers_j, obstacles_j, robots_j)
# XLA's lowest CPU optimisation level: the same operations, less compile
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
F32 = jnp.float32

torch.set_num_threads(1)    # small batches: threads only contend


def make_problem(bug_compat=False, eq_mask=0.0):
    """Both packages' controllers of the self-collision problem on identical
    data; the params are the JAX package's (float64 numpy) with
    ``eq_mask``."""
    mpc_t, x0_b, U0_b, params = tp.selfcol_problem(bug_compat)
    mpc_j = tp.selfcol_problem(bug_compat, SolverConfigJ(**tp.SELFCOL_CFG),
                               JAX_MODULES)[0]
    return mpc_j, mpc_t, x0_b, U0_b, dict(params, eq_mask=np.asarray(eq_mask))


def _kernel_inputs(mpc_t, x0_b, U0_b, params):
    """The inputs of kernels A and B, batch-major float32 numpy: the port's
    float32 rollout X (B, N+1, 9), U (B, N, 5), then seeded gains and
    multipliers."""
    f = np.float32
    rng = np.random.default_rng(3)
    X, U = rollout(mpc_t.ocp, torch.as_tensor(x0_b, dtype=torch.float32).T,
                   torch.as_tensor(U0_b, dtype=torch.float32).permute(1, 2, 0),
                   params_from_numpy(params, "cpu", torch.float32))
    return dict(
        X=X.permute(2, 0, 1).numpy(), U=U.permute(2, 0, 1).numpy(),
        kff=(0.05 * rng.standard_normal((B, N, 5))).astype(f),
        K=(0.05 * rng.standard_normal((B, N, 5, 9))).astype(f),
        lam=(0.5 * np.abs(rng.standard_normal((B, N, 28)))).astype(f),
        lam_t=(0.5 * np.abs(rng.standard_normal((B, 18)))).astype(f),
        lam_e=(0.1 * rng.standard_normal((B, 2))).astype(f),
        reg=np.full((B,), 1e-6, f))


def _port_fwd(mpc_t, params, a):
    fwd = mpc_t.ocp.lanes_fwd_factory(
        mpc_t.solver_config, params_from_numpy(params, "cpu", torch.float32))
    return fwd(_bm(a["X"][:, :-1], 1, 2, 0), _bm(a["U"], 1, 2, 0),
               _bm(a["kff"], 1, 2, 0), _bm(a["K"], 1, 2, 3, 0),
               _bm(a["lam"], 1, 2, 0), _bm(a["lam_t"], 1, 0),
               _bm(a["lam_e"], 1, 0), 10.0)


def _port_bwd(mpc_t, params, a):
    bwd = mpc_t.ocp.lanes_bwd_factory(
        mpc_t.solver_config, params_from_numpy(params, "cpu", torch.float32))
    return bwd(_bm(a["X"], 1, 2, 0), _bm(a["U"], 1, 2, 0),
               _bm(a["lam"], 1, 2, 0), _bm(a["lam_t"], 1, 0),
               _bm(a["lam_e"], 1, 0), 10.0, torch.as_tensor(a["reg"]))


@pytest.fixture(scope="module")
def jax_slice():
    """JAX's float32 solve of the slice (``_jax_slice_solve``), traced,
    compiled and run in a thread of its own from the file's first JAX
    program on: a future."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_slice_solve, *_slice_inputs(), SLICE_KW)


@pytest.fixture(scope="module")
def cases(jax_slice):
    """For eq_mask 0 and 1, the fixed formulation's problem, the kernels'
    inputs and the JAX package's float64 results on them: the costs and
    residuals of every stage state and of x_N, the line search of every
    step size (``core.fwd_pass``), the stage and terminal expansions and
    the gains of the scan sweep on them; one compile, the params an
    argument (while ``jax_slice`` compiles)."""
    mpc_j = make_problem()[0]
    cfg = mpc_j.solver_config
    ocp = mpc_j.ocp
    f64 = jnp.float64
    alphas = cfg.alpha_decay ** jnp.arange(cfg.n_alpha, dtype=f64)
    mu = jnp.asarray(10.0, f64)

    def reference(p, X, U, kff, K, lam, lam_t, lam_e, reg):
        core = build_core(ocp, p, cfg, f64)
        ks = jnp.arange(N)
        per_stage = jax.vmap(jax.vmap(
            lambda x, u, k: (ocp.stage_cost(x, u, k, p),
                             ocp.stage_residuals(x, u, k, p)),
            in_axes=(0, 0, 0)), in_axes=(0, 0, None))(X[:, :-1], U, ks)
        terminal = jax.vmap(lambda x: (ocp.terminal_cost(x, p),
                                       ocp.terminal_residuals(x, p)))(
            X[:, -1])
        fwd_b = jax.vmap(core.fwd_pass,
                         in_axes=(0, 0, 0, 0, 0, None, 0, None))
        fwd = jax.vmap(lambda al: fwd_b(X[:, 0], X, U, kff, K, al,
                                        (lam, lam_t, lam_e), mu))(alphas)
        derivs = jax.vmap(jax.vmap(core.stage_derivs,
                                   in_axes=(0, 0, 0, 0, None)),
                          in_axes=(0, 0, None, 0, None))(
            X[:, :-1], U, core.ks, lam, mu)
        term = jax.vmap(core.terminal_derivs, in_axes=(0, 0, 0, None))(
            X[:, -1], lam_t, lam_e, mu)
        gains = jax.vmap(core.backward_scan)(derivs, *term, reg)
        return per_stage, terminal, fwd, derivs, term, gains

    out, compiled = {}, None
    for eq_mask in (0.0, 1.0):
        _, mpc_t, x0_b, U0_b, params = make_problem(eq_mask=eq_mask)
        a = _kernel_inputs(mpc_t, x0_b, U0_b, params)
        args = ({k: jnp.asarray(v, f64) for k, v in params.items()},
                *(jnp.asarray(a[k], f64) for k in (
                    "X", "U", "kff", "K", "lam", "lam_t", "lam_e", "reg")))
        if compiled is None:
            compiled = jax.jit(reference).lower(*args).compile(FAST_COMPILE)
        out[eq_mask] = (mpc_t, params, a, compiled(*args))
    return out


def test_selfcol_rows_are_live():
    """The problem's self-collision rows are positive at x_N and at the
    stage states on most of the batch (else both settings would agree)."""
    _, mpc_t, x0_b, U0_b, params = make_problem()
    X = torch.as_tensor(_kernel_inputs(mpc_t, x0_b, U0_b, params)["X"])
    pose, j2, j3 = wholebody_fk(X)
    g = self_collision_g(pose[..., :3], j2, j3).amax(-1)     # (B, N+1)
    assert (g > 0).float().mean(0).min() > 0.9
    assert g.max() > 0.04


def test_fixed_costs_and_slack_match_jax_f64(cases):
    """stage_cost, stage_residuals (the last row is S_sqrt relu(max) of the
    stage's slack group), terminal_cost and terminal_residuals at every
    state of the rollout, float64 on both sides."""
    mpc_t, params, a, ((c_j, r_j), (ct_j, rt_j), *_) = cases[1.0]
    ocp = mpc_t.ocp
    p = params_from_numpy(params, "cpu", torch.float64)
    X = torch.as_tensor(a["X"], dtype=torch.float64)
    U = torch.as_tensor(a["U"], dtype=torch.float64)
    ks = torch.arange(N)
    got = (ocp.stage_cost(X[:, :-1], U, ks, p),
           ocp.stage_residuals(X[:, :-1], U, ks, p),
           ocp.terminal_cost(X[:, -1], p), ocp.terminal_residuals(X[:, -1], p))
    for g, r in zip(got, (c_j, r_j, ct_j, rt_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-8)
    # the terminal slack row is live, from the self-collision rows alone
    assert (got[3][:, -1] > 0).float().mean() > 0.9


def test_fixed_unfused_expansion_matches_jax_f64(cases):
    """The blocks the unfused path hands kernel E, float64 on both sides,
    with the terminal equality on so every block is live."""
    mpc_t, params, a, (_, _, _, derivs_j, term_j, _) = cases[1.0]

    def bl(name, last=None):
        v = a[name] if last is None else a[name][:, last]
        return torch.as_tensor(np.ascontiguousarray(
            np.moveaxis(v.astype(np.float64), 0, -1)))

    p64 = params_from_numpy(params, "cpu", torch.float64)
    inv_scale = 1.0 / mpc_t.solver_config.cost_scale
    got = (*stage_al_blocks(mpc_t.ocp, p64, inv_scale, bl("X")[:-1], bl("U"),
                            bl("lam"), 10.0),
           *terminal_al_blocks(mpc_t.ocp, p64, inv_scale, bl("X")[-1],
                               bl("lam_t"), bl("lam_e"), 10.0))
    for g, r in zip(got, (*derivs_j, *term_j)):
        np.testing.assert_allclose(g.movedim(-1, 0).numpy(), np.asarray(r),
                                   rtol=1e-8, atol=1e-8)


def test_fixed_fwd_plain_matches_jax(cases):
    mpc_t, params, a, (_, _, (Xr, Ur, cr), *_) = cases[0.0]
    Xc, Uc, xlast, cost = _port_fwd(mpc_t, params, a)
    np.testing.assert_allclose(Xc.permute(1, 3, 0, 2).numpy(),
                               np.asarray(Xr[:, :, :-1]), atol=2e-5)
    np.testing.assert_allclose(xlast.permute(0, 2, 1).numpy(),
                               np.asarray(Xr[:, :, -1]), atol=2e-5)
    np.testing.assert_allclose(Uc.permute(1, 3, 0, 2).numpy(),
                               np.asarray(Ur), atol=2e-5)
    np.testing.assert_allclose(cost.numpy(), np.asarray(cr), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("eq_mask", [0.0, 1.0])
def test_fixed_bwd_plain_matches_jax(cases, eq_mask):
    mpc_t, params, a, (*_, (kff_r, K_r)) = cases[eq_mask]
    kff, K = _port_bwd(mpc_t, params, a)
    np.testing.assert_allclose(kff.permute(2, 0, 1).numpy(),
                               np.asarray(kff_r), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(K.permute(3, 0, 1, 2).numpy(),
                               np.asarray(K_r), rtol=5e-3, atol=5e-3)


def test_flag_settings_differ():
    """On this problem the bug-compatible and the fixed kernels' plain
    versions part by more than ten times the kernel tolerances: A's cost
    (the rollout itself does not depend on the flag) and B's gains."""
    _, fixed, x0_b, U0_b, params = make_problem(False, 1.0)
    bug = tp.selfcol_problem(True)[0]
    a = _kernel_inputs(fixed, x0_b, U0_b, params)
    f_fixed, f_bug = _port_fwd(fixed, params, a), _port_fwd(bug, params, a)
    for g, r in zip(f_fixed[:3], f_bug[:3]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    excess = ((f_fixed[3] - f_bug[3]).abs()
              / (2e-3 + 2e-3 * f_bug[3].abs())).max()
    assert excess > 10
    for g, r in zip(_port_bwd(fixed, params, a), _port_bwd(bug, params, a)):
        assert ((g - r).abs() / (5e-3 + 5e-3 * r.abs())).max() > 10


def test_fixed_residuals_reproduce_the_costs():
    """stage_cost == ||stage_residuals||^2 and terminal_cost ==
    ||terminal_residuals||^2 for the fixed formulation (the problem of
    tests/test_residuals.py::test_wholebody_qref_residuals_bugfix_mode), at
    random states, inputs and stages in float64."""
    mpc = MPCWholeBody(MobileManipulator(0.1), [Obstacles(1.0, 0.3, 0.4)],
                       [], N=6, replicate_terminal_selfcol_bug=False)
    rng = np.random.default_rng(11)
    params = params_from_numpy(dict(
        mpc.make_params(rng.normal(size=(7, 9)) * 0.5,
                        rng.normal(size=(6, 5)) * 0.2),
        U_last=rng.normal(size=(6, 5)) * 0.1), "cpu", torch.float64)
    x = torch.as_tensor(rng.normal(size=(40, 9)))
    # folded at the world origin: self-collision live
    x[:10, :3] = 0.0
    x[:10, 6:] = torch.as_tensor(tp.FOLDED_Q)
    u = torch.as_tensor(rng.normal(size=(40, 5)) * 0.5)
    k = torch.as_tensor(rng.integers(0, 6, 40))
    k[:10] = 5
    r = mpc.ocp.stage_residuals(x, u, k, params)
    torch.testing.assert_close((r * r).sum(-1),
                               mpc.ocp.stage_cost(x, u, k, params),
                               rtol=1e-10, atol=1e-10)
    rt = mpc.ocp.terminal_residuals(x, params)
    torch.testing.assert_close((rt * rt).sum(-1),
                               mpc.ocp.terminal_cost(x, params),
                               rtol=1e-10, atol=1e-10)
    assert (rt[:10, -1] > 0).all()


def test_flag_reaches_the_kernels():
    """The flag is the kernels' statics field ``bug_compat``, 1.0 by
    default and 0.0 when fixed, and ``MPCWholeBodyMovingObs`` passes it on
    to its OCP and its kernels."""
    from mmmpc_tpu_torch.ops.wholebody_fwd import _STATIC_FIELDS
    names = [n for n, _ in _STATIC_FIELDS]
    at = sum(n for _, n in _STATIC_FIELDS[:names.index("bug_compat")])
    assert names.index("bug_compat") == names.index("moving") + 1
    for cls, kw in ((MPCWholeBody, {}),
                    (MPCWholeBodyMovingObs, {})):
        for bug in (True, False):
            mpc = cls(MobileManipulator(0.1), [Obstacles(1.0, 0.3, 0.4)], [],
                      N=4, replicate_terminal_selfcol_bug=bug, **kw)
            assert mpc.replicate_terminal_selfcol_bug is bug
            p = params_from_numpy(dict(
                mpc.make_params(np.zeros((5, 9)), np.zeros((4, 5))),
                U_last=np.zeros((4, 5))), "cpu", torch.float32)
            for w in (mpc.ocp.lanes_fwd_factory(mpc.solver_config, p),
                      mpc.ocp.lanes_bwd_factory(mpc.solver_config, p)):
                assert w.bug_compat is bug
                assert w.statics[at] == float(bug)


# ------------------------------------------------------------- the slice

SLICE_N = 6
SLICE_KW = dict(al_iters=6, ilqr_iters=12)


def _slice_inputs():
    """From the fold at the world origin, the base's reference to
    (0.5, 0.1) with the arm held folded."""
    x0 = np.zeros(9)
    x0[6:] = tp.FOLDED_Q
    target = x0.copy()
    target[:2] = [0.5, 0.1]
    return x0, np.linspace(x0, target, SLICE_N + 1), np.zeros((SLICE_N, 5))


def _jax_slice_solve(x0, traj, u_ref, kw):
    """JAX's float32 single solve of the fixed formulation from rest, with
    zero multipliers and U_last, as the port's first tick solves it."""
    mpc_j = controllers_j.MPCWholeBody(
        robots_j.MobileManipulator(0.1),
        [obstacles_j.Obstacles(1.0, 0.2, 0.3)],
        [(np.array([0.8, 0.1, 1.0]), np.array([[1.0, 0.0, 0.0]]))],
        N=SLICE_N, solver_config=SolverConfigJ(**kw),
        replicate_terminal_selfcol_bug=False)
    p = {k: jnp.asarray(v, F32) for k, v in
         mpc_j.make_params(traj, u_ref).items()}
    p["U_last"] = jnp.zeros((SLICE_N, 5), F32)
    lam0 = (jnp.zeros((SLICE_N, 28), F32), jnp.zeros(18, F32),
            jnp.zeros(2, F32))
    args = (jnp.asarray(x0, F32), jnp.zeros((SLICE_N, 5), F32), p, lam0)
    return jax.jit(lambda x, U, pp, lam: al_ilqr_solve_j(
        mpc_j.ocp, x, U, pp, SolverConfigJ(**kw), lam0=lam)).lower(
        *args).compile(FAST_COMPILE)(*args)


def test_fixed_solve_matches_jax_float32(jax_slice):
    """The port's warm-started solve of the fixed formulation (plain
    kernels, float32) against JAX's float32 single solve on the same
    inputs: cost within 5e-3 relative, both feasible at 1e-3."""
    x0, traj, u_ref = _slice_inputs()
    with torch.inference_mode():
        mpc = MPCWholeBody(
            MobileManipulator(0.1), [Obstacles(1.0, 0.2, 0.3)],
            [(np.array([0.8, 0.1, 1.0]), np.array([[1.0, 0.0, 0.0]]))],
            N=SLICE_N, solver_config=SolverConfig(**SLICE_KW), device="cpu",
            replicate_terminal_selfcol_bug=False)
        mpc.solve(x0, traj, u_ref)
    res_t, res_j = mpc.last_result, jax_slice.result()
    assert res_j.cost.dtype == jnp.float32
    cost_t, cost_j = float(res_t.cost), float(res_j.cost)
    rel = abs(cost_t - cost_j) / abs(cost_j)
    print(f"cost port {cost_t:.6f} jax {cost_j:.6f} rel {rel:.3e}, viol "
          f"{float(res_t.max_violation):.3e} / "
          f"{float(res_j.max_violation):.3e}")
    assert rel <= 5e-3
    assert float(res_t.max_violation) <= 1e-3
    assert float(res_j.max_violation) <= 1e-3

"""The port's moving-obstacle whole-body MPC against the JAX package's.

- ``predict_obstacle_trajectory`` (host float64) to 1e-12;
- kernels A and B's plain versions with a per-stage obstacle table whose
  rows all differ (tests/torch_problems.py ``moving_table``; the problem of
  tests/test_torch_kernels.py, float32, B=64, N=5) against the JAX
  package's vmapped references, at the JAX kernel tests' tolerances: X / U
  atol 2e-5, cost rtol = atol = 2e-3; gains rtol = atol = 5e-3, with the
  terminal equality off and on;
- the unfused expansion (``stage_al_blocks`` / ``terminal_al_blocks``) of
  the same problem against JAX's ``core.stage_derivs`` /
  ``core.terminal_derivs`` in float64 at 1e-8;
- a table that repeats the static row gives the static controller's plain
  A and B outputs;
- the slice: the JAX test's crossing obstacle (tests/test_controllers.py,
  N=10), the port's warm-started solve held against JAX's float32 single
  solve on the same inputs by cost (5e-3 relative) with both feasible at
  1e-3, and the port's plan bending away from the predicted crossing;
- the demo's interface with stub solves, and the bench row's params.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu import controllers as controllers_j
from mmmpc_tpu.controllers import (
    MPCWholeBodyMovingObs as MPCWholeBodyMovingObsJ,
    predict_obstacle_trajectory as predict_j,
)
from mmmpc_tpu.models import obstacles as obstacles_j
from mmmpc_tpu.models import robots as robots_j
from mmmpc_tpu.solver import al_ilqr_solve as al_ilqr_solve_j
from mmmpc_tpu.solver.al_ilqr import build_core
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu_torch import bench_controllers
from mmmpc_tpu_torch.controllers import (
    MPCWholeBodyMovingObs, predict_obstacle_trajectory,
)
from mmmpc_tpu_torch.demo_wholebody_separate import build_world
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import MobileManipulator
from mmmpc_tpu_torch.solver.al_ilqr import (
    rollout, stage_al_blocks, terminal_al_blocks,
)
from mmmpc_tpu_torch.utils.configs import SolverConfig
from mmmpc_tpu_torch.utils.convert import params_from_numpy

import torch_problems as tp
from tests.test_torch_kernels import _bm
from torch_problems import B, N

F32 = jnp.float32
JAX_MODULES = (controllers_j, obstacles_j, robots_j)
# The file's two JAX programs compiled at XLA's lowest CPU optimisation
# level: the same operations (the last bits may differ), a quarter less
# compile time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

torch.set_num_threads(1)    # small batches: threads only contend


def make_problem(eq_mask=0.0):
    """Both packages' controllers of the moving qref problem on identical
    data; the params are the JAX package's (float64 numpy)."""
    mpc_t, x0_b, U0_b, _ = tp.qref_problem(
        eq_mask, SolverConfig(**tp.QREF_CFG), moving=True)
    mpc_j, _, _, params = tp.qref_problem(
        eq_mask, SolverConfigJ(**tp.QREF_CFG), JAX_MODULES, moving=True)
    return mpc_j, mpc_t, x0_b, U0_b, params


def _kernel_inputs(mpc_t, x0_b, U0_b, params, rng):
    """The inputs of kernels A and B, batch-major float32 numpy: the port's
    float32 rollout X (B, N+1, 9), U (B, N, 5), then gains and
    multipliers."""
    f = np.float32
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
def cases():
    """For eq_mask 0 and 1: the problem, the kernels' inputs and the JAX
    package's references on them in float64 -- the line search of every
    step size (``core.fwd_pass``), the stage and terminal expansions
    (``core.stage_derivs`` / ``core.terminal_derivs``) and the gains of
    the scan sweep on them -- from one compile, the params an argument."""
    mpc_j = make_problem()[0]
    cfg = mpc_j.solver_config
    f64 = jnp.float64
    alphas = cfg.alpha_decay ** jnp.arange(cfg.n_alpha, dtype=f64)
    mu = jnp.asarray(10.0, f64)

    def reference(p, X, U, kff, K, lam, lam_t, lam_e, reg):
        core = build_core(mpc_j.ocp, p, cfg, f64)
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
        return fwd, derivs, term, gains

    out, compiled = {}, None
    for eq_mask in (0.0, 1.0):
        _, mpc_t, x0_b, U0_b, params = make_problem(eq_mask)
        a = _kernel_inputs(mpc_t, x0_b, U0_b, params,
                           np.random.default_rng(3))
        args = ({k: jnp.asarray(v, f64) for k, v in params.items()},
                *(jnp.asarray(a[k], f64) for k in (
                    "X", "U", "kff", "K", "lam", "lam_t", "lam_e", "reg")))
        if compiled is None:
            compiled = jax.jit(reference).lower(*args).compile(FAST_COMPILE)
        out[eq_mask] = (mpc_t, params, a, compiled(*args))
    return out


def test_predict_obstacle_trajectory_matches_jax():
    rng = np.random.default_rng(4)
    obs = np.concatenate([rng.uniform(-3, 3, (3, 2)),
                          rng.uniform(0.1, 0.6, (3, 1))], axis=1)
    vel = rng.standard_normal((3, 2))
    got = predict_obstacle_trajectory(obs, vel, 20, 0.1)
    assert got.shape == (21, 3, 3) and got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(predict_j(obs, vel, 20, 0.1)),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[:, :, 2], np.broadcast_to(obs[:, 2],
                                                                (21, 3)))


def test_table_rows_differ_by_stage():
    """The problem's table: one row a stage, each its own, and the circle
    live at the last stage of the rollout and not at the first."""
    mpc_j, mpc_t, x0_b, U0_b, params = make_problem()
    table = params["obstacles"]
    assert table.shape == (N + 1, 1, 3)
    assert len({tuple(r) for r in table[:, 0]}) == N + 1
    np.testing.assert_array_equal(mpc_t.obstacles_value, table)
    np.testing.assert_array_equal(np.asarray(mpc_j.obstacles_value), table)
    X = _kernel_inputs(mpc_t, x0_b, U0_b, params,
                       np.random.default_rng(0))["X"]
    clear = (np.hypot(X[..., 0] - table[:, 0, 0], X[..., 1] - table[:, 0, 1])
             - table[:, 0, 2] - mpc_t.base_radius)          # (B, N+1)
    assert (clear[:, 0] > 0).all() and (clear[:, -1] < 0).all()


def test_moving_fwd_plain_matches_jax(cases):
    mpc_t, params, a, ((Xr, Ur, cr), *_) = cases[0.0]
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
def test_moving_bwd_plain_matches_jax(cases, eq_mask):
    mpc_t, params, a, (_, _, _, (kff_r, K_r)) = cases[eq_mask]
    kff, K = _port_bwd(mpc_t, params, a)
    np.testing.assert_allclose(kff.permute(2, 0, 1).numpy(),
                               np.asarray(kff_r), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(K.permute(3, 0, 1, 2).numpy(),
                               np.asarray(K_r), rtol=5e-3, atol=5e-3)


def test_moving_unfused_expansion_matches_jax_f64(cases):
    """The blocks the unfused path hands kernel E, float64 on both sides,
    with the terminal equality on so every block is live."""
    mpc_t, params, a, (_, derivs_j, term_j, _) = cases[1.0]

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


def test_tiled_table_matches_static_controller():
    """A moving controller whose table repeats the static row at every
    stage computes what the static controller does, in A and in B."""
    mpc_s, x0_b, U0_b, params_s = tp.qref_problem(1.0)
    mpc_m = MPCWholeBodyMovingObs(
        mpc_s.robot_model, mpc_s.obstacle_list,
        mpc_s.obstacle_manipulation_list, N=N,
        solver_config=mpc_s.solver_config)
    mpc_m.add_terminal_position_constraint()
    params_m = dict(params_s, obstacles=mpc_m.obstacles_value)
    assert params_m["obstacles"].shape == (N + 1, 1, 3)
    a = _kernel_inputs(mpc_s, x0_b, U0_b, params_s,
                       np.random.default_rng(5))
    for port in (_port_fwd, _port_bwd):
        for got, ref in zip(port(mpc_m, params_m, a),
                            port(mpc_s, params_s, a)):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=1e-6)


# ------------------------------------------------------------- the slice

SLICE_N = 10


def _jax_slice_solve(x0, traj, u_ref, obs0, vel, kw):
    """JAX's float32 single solve of the crossing obstacle from rest, with
    zero multipliers and U_last, as the port's first tick solves it."""
    mpc_j = MPCWholeBodyMovingObsJ(
        robots_j.MobileManipulator(0.1), [obstacles_j.Obstacles(*obs0[0])],
        [], N=SLICE_N, solver_config=SolverConfigJ(**kw))
    mpc_j.observe_obstacles(obs0[:, :2], vel)
    p = {k: jnp.asarray(v, F32) for k, v in
         mpc_j.make_params(traj, u_ref).items()}
    p["U_last"] = jnp.zeros((SLICE_N, 5), F32)
    lam0 = (jnp.zeros((SLICE_N, 28), F32), jnp.zeros(18, F32),
            jnp.zeros(2, F32))
    args = (jnp.asarray(x0, F32), jnp.zeros((SLICE_N, 5), F32), p, lam0)
    return jax.jit(lambda x, U, pp, lam: al_ilqr_solve_j(
        mpc_j.ocp, x, U, pp, SolverConfigJ(**kw), lam0=lam)).lower(
        *args).compile(FAST_COMPILE)(*args)


@pytest.fixture(scope="module")
def slice_solves():
    """The crossing obstacle of tests/test_controllers.py: the port's
    warm-started solves (plain kernels, float32) with the obstacle standing
    still and with it predicted to cross, and JAX's float32 single solve of
    the crossing one on the same inputs (traced and compiled in a thread of
    its own meanwhile)."""
    x0 = np.zeros(9)
    x0[6:] = [0, -1.0, 1.0]
    target = x0 + np.array([1.5, 0, 0, 0, 0, 0, 0, 0, 0.0])
    traj = np.linspace(x0, target, SLICE_N + 1)
    u_ref = np.zeros((SLICE_N, 5))
    obs0 = np.array([[0.9, -1.1, 0.3]])     # beside the path now
    vel = np.array([[0.0, 1.2]])            # crossing it
    kw = dict(al_iters=6, ilqr_iters=12)
    out = {}
    with ThreadPoolExecutor(1) as pool:
        jax_solve = pool.submit(_jax_slice_solve, x0, traj, u_ref, obs0, vel,
                                kw)
        with torch.inference_mode():
            for name in ("static", "moving"):
                mpc = MPCWholeBodyMovingObs(
                    MobileManipulator(0.1), [Obstacles(*obs0[0])], [],
                    N=SLICE_N, solver_config=SolverConfig(**kw),
                    device="cpu")
                if name == "moving":
                    mpc.observe_obstacles(obs0[:, :2], vel)
                mpc.solve(x0, traj, u_ref)
                out[name] = mpc.last_result
        out["jax"] = jax_solve.result()
    return out


def test_moving_solve_matches_jax_float32(slice_solves):
    res_t, res_j = slice_solves["moving"], slice_solves["jax"]
    assert res_j.cost.dtype == jnp.float32
    assert res_t.U.shape == (SLICE_N, 5)
    cost_t, cost_j = float(res_t.cost), float(res_j.cost)
    rel = abs(cost_t - cost_j) / abs(cost_j)
    print(f"cost port {cost_t:.6f} jax {cost_j:.6f} rel {rel:.3e}, viol "
          f"{float(res_t.max_violation):.3e} / "
          f"{float(res_j.max_violation):.3e}")
    assert rel <= 5e-3
    assert float(res_t.max_violation) <= 1e-3
    assert float(res_j.max_violation) <= 1e-3


def test_moving_solve_anticipates_the_crossing(slice_solves):
    """An obstacle predicted to cross the path bends the port's plan more
    than the same obstacle standing still beside it."""
    y_static = slice_solves["static"].X[:, 1].abs().max().item()
    y_moving = slice_solves["moving"].X[:, 1].abs().max().item()
    assert y_moving > y_static + 1e-4


# ------------------------------------------------- the demo, the bench row

def test_interface_moves_the_obstacle_and_refreshes_the_prediction():
    """With stub solves: each tick the obstacle moves by dt * v, the log
    holds its position, and the controller's table is the prediction from
    it."""
    world = build_world(device="cpu")
    ctrl = world.controller
    tables = []

    def solve(x, traj_ref, u_ref):
        tables.append(ctrl.obstacles_value.copy())
        return np.zeros(5)

    ctrl.solve = solve
    ctrl.last_result = types.SimpleNamespace(cost=0.0, max_violation=0.0,
                                             converged=True)
    world.current_state = world.x_start
    world.task_flag = "move"
    world.is_active = True
    p0 = np.array([[2.5, -0.5]])
    v = np.array([[0.0, 0.6]])
    for tick in range(1, 4):
        world.timerCallback()
        pos = p0 + tick * world.dt * v
        np.testing.assert_allclose(world.obstacle_log[-1], pos, atol=1e-12)
        np.testing.assert_allclose(
            tables[-1], predict_obstacle_trajectory(
                np.c_[pos, [0.5]], v, ctrl.N, ctrl.dt), atol=1e-12)
    assert len(world.obstacle_log) == len(world.x_log) == 3
    assert ctrl.obstacle_list[0].radius == 0.5


def test_bench_moving_row_matches_jax_script():
    """The ``wholebody_moving_obs`` row of ``bench_controllers``: the qref
    row's starts and references over the JAX script's predicted table."""
    rows = {name: (mpc, x0, p) for name, mpc, x0, p in
            bench_controllers.problems_numpy(8)}
    mpc, x0, params = rows["wholebody_moving_obs"]
    np.testing.assert_array_equal(x0, rows["wholebody_qref"][1])
    assert params["obstacles"].shape == (bench_controllers.N + 1, 3, 3)
    sc_obs = mpc.obstacles_value[0]
    mov_j = MPCWholeBodyMovingObsJ(
        robots_j.MobileManipulator(bench_controllers.DT),
        [obstacles_j.Obstacles(*r) for r in sc_obs],
        mpc.obstacle_manipulation_list, N=bench_controllers.N)
    mov_j.observe_obstacles(sc_obs[:, :2],
                            np.tile([0.05, 0.02], (len(sc_obs), 1)))
    ref = mov_j.make_params(params["X_ref"], params["U_ref"])
    for k, v in ref.items():
        np.testing.assert_allclose(params[k], np.asarray(v), rtol=0,
                                   atol=1e-6, err_msg=k)

"""The port's fleet engine against the JAX package's.

- Kernels A and B's plain versions with per-scenario operands (all six of
  U_last, X_ref, U_ref, Q, P, eq_mask: eq_mask 0 and 1 mixed, Q and P rows
  of the task weight table; and U_last alone) on the qref problem of
  tests/torch_problems.py (float32, B=64, N=5) against the JAX package's
  vmapped references with per-scenario in_axes, at the JAX kernel tests'
  tolerances: X / U atol 2e-5, cost rtol = atol = 2e-3; gains rtol = atol =
  5e-3.
- A per-scenario solve equals the robots solved one by one (port only);
  so do the expansion route (E) and the assoc route, which equal the fused
  route too (float64, at cost_scale 1.0); the refine stage re-solves its
  robots with their own entries; an entry the OCP takes shared only
  raises with a batch axis, and so does a per-robot Q or P with an entry
  off its diagonal off the fused route (A reads their diagonals).
- The task loop (scenario 1, N=10, 8 robots, 3 ticks, a small budget,
  ``aim_at_button=True``, float64) against ``make_batch_task_loop`` from a
  carry whose robots sit just before each transition (move -> approach,
  -> rotate, rotate -> manipulate with its IK, -> done, the stuck
  re-approach, the rotate-orbit escape, a finished robot): phases and
  done ticks exactly, states at atol 1e-4, costs at a relative 1e-6 and
  violations at 1e-6.  The JAX loop solves each robot with its
  single-scenario solver (its batched solve's fallback on a CPU), the
  port with the batched solve on the plain kernels, on the fused route
  and, from the same carry, on the host-parity solver
  (``host_parity_solver=True``: the expansion and E, B never).
- Segments threaded by the carry (a legacy 5-tuple too) equal one run bit
  for bit; the float64 weight table leaves a float32 solve float32; the
  helpers (``stand_off_target``, the batched ``arm_ik`` in float64 at 1e-6,
  ``_local_window``) against JAX; the closed-loop engine's fallback; the
  failure report's lines against JAX's on the same log.

Two JAX programs are compiled, both at XLA's lowest CPU optimisation level
(``FAST_COMPILE``), in a thread while the port's side runs.
"""

import dataclasses
import io
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu import controllers as controllers_j
from mmmpc_tpu.models import obstacles as obstacles_j
from mmmpc_tpu.models import robots as robots_j
from mmmpc_tpu.models.arm import arm_ik as arm_ik_j
from mmmpc_tpu.sim import batch_engine as batch_engine_j
from mmmpc_tpu.sim import batch_task_engine as task_j
from mmmpc_tpu.solver.al_ilqr import build_core
from mmmpc_tpu.utils import debugging as debugging_j
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu_torch.controllers import MPCWholeBody
from mmmpc_tpu_torch.models.arm import arm_ik
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import MobileManipulator
from mmmpc_tpu_torch.sim import batch_engine, batch_task_engine as task_t
from mmmpc_tpu_torch.sim.batch_task_engine import (
    PHASE_APPROACH, PHASE_DONE, PHASE_MANIP, PHASE_MOVE, PHASE_ROTATE,
    W_TABLE, make_batch_task_loop, stand_off_target,
)
from mmmpc_tpu_torch.ops import assoc_riccati, riccati, wholebody_bwd
from mmmpc_tpu_torch.solver.al_ilqr import iteration_count, rollout
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.solver.refine import (
    al_ilqr_solve_refined, default_refine_config,
)
from mmmpc_tpu_torch.utils import debugging
from mmmpc_tpu_torch.utils.configs import (
    BASELINK2JOINT1_X, BASELINK2JOINT1_Z, WORKING_RADIUS, SolverConfig,
    make_scenario,
)
from mmmpc_tpu_torch.utils.convert import params_from_numpy

import torch_problems as tp
from tests.test_torch_kernels import _bm
from torch_problems import B, FLEET_KEYS, N

F32 = jnp.float32
JAX_MODULES = (controllers_j, obstacles_j, robots_j)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# the task loop's case: scenario 1 at N=10, 8 robots, 3 ticks, a small
# budget, the recovery mode (its stuck detectors are seeded below)
LOOP_N, LOOP_TICKS, IK_ITERS, STUCK = 10, 3, 40, 25
LOOP_CFG = dict(al_iters=1, ilqr_iters=4, cost_scale=1e5,
                constraint_tol=1e-3, n_alpha=3, alpha_decay=0.35)

torch.set_num_threads(1)    # small batches: threads only contend


# --------------------------------------------------- kernels A and B

def _kernel_inputs(mpc_t, x0_b, U0_b, params, rng):
    """The inputs of A and B, batch-major float32 numpy (as
    tests/test_torch_moving_obs.py): the port's rollout, gains,
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


def _kernel_program(mpc_j, args):
    """JAX's references of A and B on every scenario with its own entries
    (``core.fwd_pass`` of each step size; ``core.stage_derivs`` /
    ``core.terminal_derivs`` and the scan sweep), vmapped over the
    scenario: the six per-scenario entries batch-first (in_axes 0), the
    others shared; compiled once."""
    cfg = mpc_j.solver_config
    alphas = cfg.alpha_decay ** jnp.arange(cfg.n_alpha, dtype=F32)
    mu = jnp.asarray(10.0, F32)

    def one(p, X, U, kff, K, lam, lam_t, lam_e, reg):
        core = build_core(mpc_j.ocp, p, cfg, F32)
        fwd = jax.vmap(lambda a: core.fwd_pass(
            X[0], X, U, kff, K, a, (lam, lam_t, lam_e), mu))(alphas)
        derivs = jax.vmap(core.stage_derivs, in_axes=(0, 0, 0, 0, None))(
            X[:-1], U, core.ks, lam, mu)
        tg, tH = core.terminal_derivs(X[-1], lam_t, lam_e, mu)
        return fwd, core.backward_scan(derivs, tg, tH, reg)

    def reference(shared, ps, *a):
        return jax.vmap(lambda q, *r: one(dict(shared, **q), *r))(ps, *a)

    return jax.jit(reference).lower(*args).compile(FAST_COMPILE)


def _kernel_cases():
    """{keys: (port controller, params with those entries per scenario,
    the kernels' inputs)} for all six entries and for U_last alone, and
    JAX's (controller, arguments of its program) for each."""
    mpc_t, x0_b, U0_b, base = tp.qref_problem(
        1.0, SolverConfig(**tp.QREF_CFG))
    mpc_j = tp.qref_problem(1.0, SolverConfigJ(**tp.QREF_CFG),
                            JAX_MODULES)[0]
    a = _kernel_inputs(mpc_t, x0_b, U0_b, base, np.random.default_rng(3))
    arrays = [jnp.asarray(a[k], F32) for k in
              ("X", "U", "kff", "K", "lam", "lam_t", "lam_e", "reg")]
    cases, jax_args = {}, {}
    for keys in (FLEET_KEYS, ("U_last",)):
        params = tp.fleet_params(base, B, keys)
        # JAX's side: every entry of FLEET_KEYS per scenario, the shared
        # ones broadcast, so that one program serves both
        full = {k: (np.moveaxis(params[k], -1, 0) if k in keys
                    else np.broadcast_to(params[k], (B,) + np.shape(params[k])))
                for k in FLEET_KEYS}
        shared = {k: jnp.asarray(v, F32) for k, v in params.items()
                  if k not in FLEET_KEYS}
        jax_args[keys] = (shared, {k: jnp.asarray(v, F32)
                                   for k, v in full.items()}, *arrays)
        cases[keys] = (mpc_t, params, a)
    return cases, mpc_j, jax_args


def _kernel_refs(mpc_j, kernel_args):
    """JAX's kernel references on each key set, from one program."""
    compiled = _kernel_program(mpc_j, kernel_args[FLEET_KEYS])
    return {keys: compiled(*args) for keys, args in kernel_args.items()}


@pytest.fixture(scope="module")
def cases():
    """The port's kernel cases and task loop (with its helpers), and JAX's
    results on the same inputs, its two programs compiled and run in two
    threads while the port's loop runs."""
    kernel, mpc_j, kernel_args = _kernel_cases()
    sc, mpc_t, shared = _loop_controller(tp.PORT, SolverConfig(**LOOP_CFG))
    carry, xs, gpt = _seeded_carry(sc)
    x0 = np.tile(xs, (8, 1))
    gpts = np.tile(gpt, (8, 1))
    helpers = _helper_inputs(xs)
    loop_args = (jnp.asarray(x0), jnp.asarray(gpts), _to(carry, jnp.asarray),
                 *(jnp.asarray(h) for h in helpers))
    with ThreadPoolExecutor(2) as pool:
        jax_loop = pool.submit(_jax_loop_program, sc, loop_args)
        jax_refs = pool.submit(_kernel_refs, mpc_j, kernel_args)
        run = make_batch_task_loop(
            mpc_t.ocp, SolverConfig(**LOOP_CFG),
            params_from_numpy(shared, "cpu", torch.float64),
            t_move=sc.t_move, t_manipulate=sc.t_manipulate, dt=sc.dt,
            n_ticks=LOOP_TICKS, ik_iters=IK_ITERS, aim_at_button=True,
            stuck_ticks=STUCK)
        run_hp = make_batch_task_loop(
            mpc_t.ocp, SolverConfig(**LOOP_CFG),
            params_from_numpy(shared, "cpu", torch.float64),
            t_move=sc.t_move, t_manipulate=sc.t_manipulate, dt=sc.dt,
            n_ticks=LOOP_TICKS, ik_iters=IK_ITERS, aim_at_button=True,
            stuck_ticks=STUCK, host_parity_solver=True)
        t = torch.as_tensor
        with torch.inference_mode():
            log, carry_t = run(t(x0), t(gpts), _to(carry, t))
            counters = (wholebody_bwd.LAUNCHES, riccati.LAUNCHES[(9, 5)])
            for c in counters:
                c.reset()
            log_hp, _ = run_hp(t(x0), t(gpts), _to(carry, t))
            hp_calls = [c.plain for c in counters]
            q, tgt, traj, u_ref, xw = (t(h) for h in helpers)
            port_helpers = (
                arm_ik(q, tgt, iters=IK_ITERS),
                batch_engine._local_window(traj, u_ref, xw, [0, 1], LOOP_N),
                stand_off_target(t(x0), t(gpts)))
        (log_j, carry_j), *jax_helpers = jax_loop.result()
        refs = jax_refs.result()
    return dict(kernel={k: (*v, refs[k]) for k, v in kernel.items()},
                log=log, carry=carry_t, log_j=log_j, carry_j=carry_j,
                log_hp=log_hp, hp_calls=hp_calls,
                helpers=port_helpers, helpers_j=jax_helpers)


@pytest.mark.parametrize("keys", [FLEET_KEYS, ("U_last",)],
                         ids=["all", "U_last"])
def test_fleet_fwd_plain_matches_jax(cases, keys):
    mpc_t, params, a, ((Xr, Ur, cr), _) = cases["kernel"][keys]
    p = params_from_numpy(params, "cpu", torch.float32)
    fwd = mpc_t.ocp.lanes_fwd_factory(mpc_t.solver_config, p)
    assert fwd.ps.keys == keys
    Xc, Uc, xlast, cost = fwd(
        _bm(a["X"][:, :-1], 1, 2, 0), _bm(a["U"], 1, 2, 0),
        _bm(a["kff"], 1, 2, 0), _bm(a["K"], 1, 2, 3, 0),
        _bm(a["lam"], 1, 2, 0), _bm(a["lam_t"], 1, 0),
        _bm(a["lam_e"], 1, 0), 10.0)
    # JAX: (B, n_alpha, ...) -> the port's (..., n_alpha, ..., B)
    np.testing.assert_allclose(Xc.permute(3, 1, 0, 2).numpy(),
                               np.asarray(Xr[:, :, :-1]), atol=2e-5)
    np.testing.assert_allclose(xlast.permute(2, 0, 1).numpy(),
                               np.asarray(Xr[:, :, -1]), atol=2e-5)
    np.testing.assert_allclose(Uc.permute(3, 1, 0, 2).numpy(),
                               np.asarray(Ur), atol=2e-5)
    np.testing.assert_allclose(cost.T.numpy(), np.asarray(cr), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("keys", [FLEET_KEYS, ("U_last",)],
                         ids=["all", "U_last"])
def test_fleet_bwd_plain_matches_jax(cases, keys):
    mpc_t, params, a, (_, (kff_r, K_r)) = cases["kernel"][keys]
    p = params_from_numpy(params, "cpu", torch.float32)
    bwd = mpc_t.ocp.lanes_bwd_factory(mpc_t.solver_config, p)
    assert bwd.ps.keys == keys
    kff, K = bwd(_bm(a["X"], 1, 2, 0), _bm(a["U"], 1, 2, 0),
                 _bm(a["lam"], 1, 2, 0), _bm(a["lam_t"], 1, 0),
                 _bm(a["lam_e"], 1, 0), 10.0, torch.as_tensor(a["reg"]))
    np.testing.assert_allclose(kff.permute(2, 0, 1).numpy(),
                               np.asarray(kff_r), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(K.permute(3, 0, 1, 2).numpy(),
                               np.asarray(K_r), rtol=5e-3, atol=5e-3)


def test_fleet_problem_entries_differ_by_robot():
    """The problem's entries are each robot's own: the weight rows of both
    kinds and both mask values occur, and the kernels take the diagonals."""
    mpc_t, _, _, base = tp.qref_problem(1.0)
    params = tp.fleet_params(base, B)
    assert {int(m) for m in params["eq_mask"]} == {0, 1}
    for k in ("Q", "P"):
        rows = {tuple(np.diag(params[k][..., b])) for b in range(B)}
        assert rows == {tuple(np.diag(w)) for w in W_TABLE}
    fwd = mpc_t.ocp.lanes_fwd_factory(
        mpc_t.solver_config, params_from_numpy(params, "cpu", torch.float32))
    assert fwd.ps.mask == 63 and tuple(fwd.ps.t["Q"].shape) == (9, B)
    np.testing.assert_array_equal(fwd.ps.t["P"].numpy(), np.diagonal(
        params["P"], axis1=0, axis2=1).T.astype(np.float32))


def test_per_scenario_solve_equals_separate_solves():
    """A solve with all six entries per robot at B=4 equals the four robots
    solved one by one with their entries shared (float64, plain kernels)."""
    mpc, x0_b, U0_b, base = tp.qref_problem(0.0)
    params = tp.fleet_params(base, 4)
    p = params_from_numpy(params, "cpu", torch.float64)
    x0, U0 = torch.as_tensor(x0_b[:4]), torch.as_tensor(U0_b[:4])
    res = al_ilqr_solve_batched(mpc.ocp, x0, U0, p, mpc.solver_config)
    assert res.cost.shape == (4,)
    for b in range(4):
        pb = debugging.scenario_params(p, b)
        one = al_ilqr_solve_batched(mpc.ocp, x0[b:b + 1], U0[b:b + 1], pb,
                                    mpc.solver_config)
        rel = abs(float(res.cost[b]) - float(one.cost[0])) / abs(
            float(one.cost[0]))
        assert rel <= 1e-6, (b, rel)
        assert float(res.max_violation[b]) == pytest.approx(
            float(one.max_violation[0]), abs=1e-9)


def test_per_scenario_keys_outside_the_ocps_are_shared_only():
    """An entry with a batch axis that the OCP does not take per scenario
    raises, on every route."""
    mpc, x0_b, U0_b, base = tp.qref_problem(0.0)
    p = params_from_numpy(tp.fleet_params(base, B), "cpu", torch.float32)
    x0, U0 = (torch.as_tensor(v, dtype=torch.float32) for v in (x0_b, U0_b))
    ocp = dataclasses.replace(mpc.ocp, per_scenario_keys=frozenset())
    for cfg in (mpc.solver_config, dataclasses.replace(
            mpc.solver_config, use_fused_backward=False)):
        with pytest.raises(ValueError, match="shared only"):
            al_ilqr_solve_batched(ocp, x0, U0, p, cfg)


# the qref problem at the closed loop's cost scale, where the assoc sweep's
# reg in the input elimination is negligible: at cost_scale 1e5 the input
# Hessian is of the order of reg and the two sweeps part (ROADMAP queue 3,
# in the JAX package too)
ROUTE_CFG = dict(tp.QREF_CFG, cost_scale=1.0)
ROUTES = {"unfused": dict(use_fused_backward=False),
          "assoc": dict(use_assoc_scan=True)}


@pytest.mark.parametrize("route", ROUTES)
def test_per_scenario_routes_match_fused_and_separate_solves(route):
    """All six entries per robot at B=4, float64: the expansion route (E)
    and the assoc route each against the fused route (B) on the same
    robots, and against the robots solved one by one on that route with
    their entries shared, at relative cost 1e-6; the counters show the
    route."""
    cfg = SolverConfig(**ROUTE_CFG)
    mpc, x0_b, U0_b, base = tp.qref_problem(0.0, cfg)
    p = params_from_numpy(tp.fleet_params(base, 4), "cpu", torch.float64)
    x0, U0 = torch.as_tensor(x0_b[:4]), torch.as_tensor(U0_b[:4])
    fused = al_ilqr_solve_batched(mpc.ocp, x0, U0, p, cfg)
    rcfg = dataclasses.replace(cfg, **ROUTES[route])
    counters = (wholebody_bwd.LAUNCHES, riccati.LAUNCHES[(9, 5)],
                assoc_riccati.CALLS)
    for c in counters:
        c.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)     # assoc at B=4, N=5
        res = al_ilqr_solve_batched(mpc.ocp, x0, U0, p, rcfg)
        n = iteration_count(cfg)
        assert [c.plain for c in counters] == (
            [0, n, 0] if route == "unfused" else [0, 0, n])
        alone = [al_ilqr_solve_batched(
            mpc.ocp, x0[b:b + 1], U0[b:b + 1],
            debugging.scenario_params(p, b), rcfg) for b in range(4)]
    for b in range(4):
        for ref in (fused.cost[b], alone[b].cost[0]):
            rel = abs(float(res.cost[b] - ref)) / abs(float(ref))
            assert rel <= 1e-6, (b, rel)
        assert float(res.max_violation[b]) == pytest.approx(
            float(alone[b].max_violation[0]), abs=1e-9)


@pytest.mark.parametrize("route", ROUTES)
def test_off_diagonal_per_robot_weights_raise_off_the_fused_route(route):
    """A's fleet instance reads the diagonal of a per-robot Q and P; off
    the fused route the callables read them whole, so there a per-robot Q
    or P with an entry off its diagonal raises before any work (the
    diagonal ones of ``fleet_params`` are taken, above)."""
    mpc, x0_b, U0_b, base = tp.qref_problem(0.0)
    p = params_from_numpy(tp.fleet_params(base, 4), "cpu", torch.float64)
    x0, U0 = torch.as_tensor(x0_b[:4]), torch.as_tensor(U0_b[:4])
    cfg = dataclasses.replace(mpc.solver_config, **ROUTES[route])
    for key in ("Q", "P"):
        q = dict(p, **{key: p[key].clone()})
        q[key][0, 1, 2] = q[key][1, 0, 2] = 0.5
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # assoc at B=4
            with pytest.raises(ValueError, match="off the diagonal"):
                al_ilqr_solve_batched(mpc.ocp, x0, U0, q, cfg)


def test_refined_per_scenario_solve_gathers_the_entries():
    """The refine stage re-solves its robots with their own entries (the
    JAX package gathers the per-scenario entries, ``mmmpc_tpu/solver/
    refine.py:89-91``): at B=4 with a refine size of 2, each re-solved
    robot's result is its stage-2 solve alone, from its stage-1 state."""
    mpc, x0_b, U0_b, base = tp.qref_problem(0.0)
    cfg = mpc.solver_config
    p = params_from_numpy(tp.fleet_params(base, 4), "cpu", torch.float64)
    x0, U0 = torch.as_tensor(x0_b[:4]), torch.as_tensor(U0_b[:4])
    # one AL round of the default stage 2 keeps the re-solves short
    refine_cfg = dataclasses.replace(default_refine_config(cfg), al_iters=1)
    res = al_ilqr_solve_refined(mpc.ocp, x0, U0, p, cfg,
                                refine_cfg=refine_cfg, refine_size=2)
    res1 = al_ilqr_solve_batched(mpc.ocp, x0, U0, p, cfg)
    idx = torch.sort(res1.max_violation, descending=True,
                     stable=True).indices[:2]
    assert float(res1.max_violation[idx].min()) > 0.0
    for b in idx.tolist():
        lam = (res1.lam_stage[b:b + 1], res1.lam_term[b:b + 1],
               res1.lam_eq[b:b + 1])
        two = al_ilqr_solve_batched(
            mpc.ocp, x0[b:b + 1], res1.U[b:b + 1],
            debugging.scenario_params(p, b), refine_cfg, lam0_b=lam)
        want = (two if float(two.max_violation[0])
                < float(res1.max_violation[b]) else
                type(two)(*(f[b:b + 1] for f in res1)))
        rel = abs(float(res.cost[b] - want.cost[0])) / abs(float(want.cost[0]))
        assert rel <= 1e-9, (b, rel)


# ----------------------------------------------------- the task loop

def _loop_controller(modules, cfg):
    ctl, obs, robots = modules
    sc = make_scenario(1, N=LOOP_N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    kw = {} if ctl is controllers_j else dict(device="cpu")
    mpc = ctl.MPCWholeBody(robots.MobileManipulator(sc.dt),
                           [obs.Obstacles(*r) for r in sc.ground_obstacles],
                           hp, N=LOOP_N, solver_config=cfg, **kw)
    shared = mpc.make_params(np.zeros((LOOP_N + 1, 9)),
                             np.zeros((LOOP_N, 5)))
    for k in ("X_ref", "U_ref"):
        shared.pop(k)
    return sc, mpc, {k: np.asarray(v, np.float64) for k, v in shared.items()}


def _seeded_carry(sc):
    """Eight robots of scenario 1, each just before a transition, as the
    loop's 6-tuple carry (float64 numpy): move -> approach, approach ->
    rotate, move -> rotate in one tick, rotate -> manipulate (the IK tick)
    at the stand-off point aimed at the button, manipulate -> done with the
    end effector on the button, the stuck re-approach, the rotate-orbit
    escape, and a finished robot."""
    xs = np.asarray(sc.x_start, np.float64)
    gpt = np.asarray(sc.global_pose_target, np.float64)
    xt = stand_off_target(torch.as_tensor(xs), torch.as_tensor(gpt)).numpy()
    q_btn = arm_ik(torch.as_tensor(xs[6:9]), torch.as_tensor(np.array(
        [WORKING_RADIUS - BASELINK2JOINT1_X, 0.0,
         gpt[2] - BASELINK2JOINT1_Z]))).numpy()
    x = np.tile(xt, (8, 1))
    x[0, :2] += [1.0, 0.5]
    x[1, :2] += [0.1, -0.05]
    x[2, :2] += [0.05, 0.1]
    x[4, 6:9] = q_btn
    x[5, 6:9] = xs[6:9] + [0.2, -0.1, 0.1]
    x[6, :2] += [0.1, 0.05]
    x[7, 6:9] = q_btn
    phase = np.array([PHASE_MOVE, PHASE_APPROACH, PHASE_MOVE, PHASE_ROTATE,
                      PHASE_MANIP, PHASE_MANIP, PHASE_ROTATE, PHASE_DONE],
                     np.int32)
    best = np.full(8, 1e9)
    best[5] = 0.0                       # no improvement possible
    stale = np.zeros(8, np.int32)
    stale[5] = STUCK - 1
    rot = np.zeros(8, np.int32)
    rot[6] = 3 * STUCK - 1
    T_man = int(round(sc.t_manipulate / sc.dt))
    rng = np.random.default_rng(4)
    U = 0.05 * rng.standard_normal((8, LOOP_N, 5))
    lams = (np.zeros((8, LOOP_N, 28)), np.zeros((8, 18)), np.zeros((8, 2)))
    man = np.repeat(x[:, None], T_man + 1, axis=1)
    return (x, U, lams, phase, man, (best, stale, rot)), xs, gpt


def _to(tree, f):
    if isinstance(tree, tuple):
        return tuple(_to(t, f) for t in tree)
    return f(tree)


def _jax_loop_program(sc, args):
    """JAX's task loop for LOOP_TICKS ticks from the seeded carry, and the
    helpers on their own inputs, in one program (float64)."""
    _, mpc_j, shared = _loop_controller(JAX_MODULES, SolverConfigJ(**LOOP_CFG))
    run = task_j.make_batch_task_loop(
        mpc_j.ocp, SolverConfigJ(**LOOP_CFG),
        {k: jnp.asarray(v) for k, v in shared.items()}, t_move=sc.t_move,
        t_manipulate=sc.t_manipulate, dt=sc.dt, n_ticks=LOOP_TICKS,
        ik_iters=IK_ITERS, aim_at_button=True, stuck_ticks=STUCK)

    def program(x0, gpt, carry, q, tgt, traj, u_ref, xw):
        window = jax.vmap(lambda t, u, x: batch_engine_j._local_window(
            t, u, x, jnp.array([0, 1]), LOOP_N))
        return (run(x0, gpt, carry),
                jax.vmap(lambda a, b: arm_ik_j(a, b, iters=IK_ITERS))(q, tgt),
                window(traj, u_ref, xw), task_j.stand_off_target(x0, gpt))

    return jax.jit(program).lower(*args).compile(FAST_COMPILE)(*args)


def _helper_inputs(xs):
    """The batched IK's starts and targets, and the reference windows'
    trajectories (with ties and an end overrun) and states."""
    rng = np.random.default_rng(6)
    q = xs[6:9] + 0.3 * rng.standard_normal((8, 3))
    tgt = np.stack([0.55 + 0.1 * rng.random(8), np.zeros(8),
                    0.1 + 0.2 * rng.random(8)], axis=-1)
    traj = np.repeat(np.linspace(0, 1, 15)[None, :, None], 8, 0) * np.ones(9)
    traj[:, 5:7] = traj[:, 6:7]             # a tie: the first is taken
    traj += 0.01 * rng.standard_normal(traj.shape)
    u_ref = rng.standard_normal((8, 14, 5))
    xw = rng.random((8, 9))
    xw[0] = traj[0, -1]                      # the end: rows repeat
    return q, tgt, traj, u_ref, xw


def test_task_loop_phases_match_jax(cases):
    log, log_j = cases["log"], cases["log_j"]
    phase = log.phase.numpy()
    np.testing.assert_array_equal(phase, np.asarray(log_j.phase))
    np.testing.assert_array_equal(log.done_at.numpy(),
                                  np.asarray(log_j.done_at))
    # each seeded robot made its transition on the first tick
    assert phase[:, 0].tolist() == [
        PHASE_APPROACH, PHASE_ROTATE, PHASE_ROTATE, PHASE_MANIP, PHASE_DONE,
        PHASE_ROTATE, PHASE_APPROACH, PHASE_DONE]
    assert log.done_at.tolist()[4] == 0 and log.done_at.tolist()[7] == 0


def test_task_loop_states_costs_match_jax(cases):
    log, log_j = cases["log"], cases["log_j"]
    assert log.X.dtype == torch.float64
    np.testing.assert_allclose(log.X.numpy(), np.asarray(log_j.X), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(log.U.numpy(), np.asarray(log_j.U), rtol=0,
                               atol=1e-4)
    cost, cost_j = log.cost.numpy(), np.asarray(log_j.cost)
    rel = np.abs(cost - cost_j) / np.maximum(np.abs(cost_j), 1e-12)
    viol, viol_j = log.violation.numpy(), np.asarray(log_j.violation)
    print(f"rel cost median {np.median(rel):.3e} max {rel.max():.3e}, "
          f"|dviol| max {np.abs(viol - viol_j).max():.3e}")
    assert rel.max() <= 1e-6
    assert np.abs(viol - viol_j).max() <= 1e-6
    assert not log.fallback.any()


def test_host_parity_task_loop_matches_jax(cases):
    """The port's loop with ``host_parity_solver=True`` (the expansion and
    E in place of B) from the same seeded carry against JAX's log, which on
    a CPU is its vmapped per-scenario route (``mmmpc_tpu/solver/
    batched.py:96-97``), at ``test_task_loop_states_costs_match_jax``'s
    tolerances."""
    log, log_j = cases["log_hp"], cases["log_j"]
    # B never, E once an iteration of each tick's solve
    assert cases["hp_calls"] == [
        0, LOOP_TICKS * iteration_count(SolverConfig(**LOOP_CFG))]
    np.testing.assert_array_equal(log.phase.numpy(), np.asarray(log_j.phase))
    np.testing.assert_allclose(log.X.numpy(), np.asarray(log_j.X), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(log.U.numpy(), np.asarray(log_j.U), rtol=0,
                               atol=1e-4)
    cost, cost_j = log.cost.numpy(), np.asarray(log_j.cost)
    rel = np.abs(cost - cost_j) / np.maximum(np.abs(cost_j), 1e-12)
    viol, viol_j = log.violation.numpy(), np.asarray(log_j.violation)
    print(f"rel cost median {np.median(rel):.3e} max {rel.max():.3e}, "
          f"|dviol| max {np.abs(viol - viol_j).max():.3e}")
    assert rel.max() <= 1e-6
    assert np.abs(viol - viol_j).max() <= 1e-6
    assert not log.fallback.any()


def test_task_loop_carry_matches_jax(cases):
    """The carry's phases, manipulate plans (the IK tick's) and stuck
    detectors."""
    c, cj = cases["carry"], cases["carry_j"]
    np.testing.assert_array_equal(c[3].numpy(), np.asarray(cj[3]))
    np.testing.assert_allclose(c[4].numpy(), np.asarray(cj[4]), rtol=0,
                               atol=1e-4)
    for a, b in zip(c[5], cj[5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_helpers_match_jax(cases):
    (q, (tr, ur), xt), (q_j, (tr_j, ur_j), xt_j) = (cases["helpers"],
                                                    cases["helpers_j"])
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(tr_j))
    np.testing.assert_array_equal(ur.numpy(), np.asarray(ur_j))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xt_j), rtol=0,
                               atol=1e-12)


def _small_loop(n_ticks, dtype=torch.float32, **kw):
    sc, mpc, shared = _loop_controller(
        tp.PORT, SolverConfig(**dict(LOOP_CFG, al_iters=1, ilqr_iters=2)))
    run = make_batch_task_loop(
        mpc.ocp, mpc.solver_config, params_from_numpy(shared, "cpu", dtype),
        t_move=sc.t_move, t_manipulate=sc.t_manipulate, dt=sc.dt,
        n_ticks=n_ticks, ik_iters=5, **kw)
    carry, xs, gpt = _seeded_carry(sc)
    t = lambda a: torch.as_tensor(a, dtype=dtype if a.dtype != np.int32
                                  else torch.int32)
    return run, t(np.tile(xs, (4, 1))), t(np.tile(gpt, (4, 1))), _to(
        carry, lambda a: t(a[:4]))


def test_segments_through_the_carry_equal_one_run():
    """Two segments of 3 ticks threaded by the carry (the second from a
    legacy 5-tuple, which the parity mode does not read the stuck
    detectors of) equal one run of 6 ticks bit for bit."""
    run6, x0, gpt, carry = _small_loop(6)
    run3 = _small_loop(3)[0]
    with torch.inference_mode():
        log, end = run6(x0, gpt, carry)
        log1, mid = run3(x0, gpt, carry)
        log2, end2 = run3(x0, gpt, mid[:5])
    for f in ("U", "phase", "cost", "violation", "fallback"):
        joined = torch.cat([getattr(log1, f), getattr(log2, f)], dim=1)
        assert torch.equal(joined, getattr(log, f)), f
    assert torch.equal(torch.cat([log1.X, log2.X[:, 1:]], dim=1), log.X)
    for a, b in zip(end[:5], end2[:5]):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)


def test_float64_weight_table_keeps_a_float32_solve_float32(monkeypatch):
    """The weight table is float64; a float32 fleet's solve takes its rows
    in float32, and the log and the carry stay float32."""
    assert W_TABLE.dtype == np.float64
    seen = []
    real = task_t.al_ilqr_solve_batched

    def spy(ocp, x0, U0, params, cfg, lam0_b=None):
        seen.append({k: v.dtype for k, v in params.items()})
        return real(ocp, x0, U0, params, cfg, lam0_b=lam0_b)

    monkeypatch.setattr(task_t, "al_ilqr_solve_batched", spy)
    run, x0, gpt, carry = _small_loop(1)
    with torch.inference_mode():
        log, out = run(x0, gpt, carry)
    assert {d for p in seen for d in p.values()} == {torch.float32}
    for v in (log.X, log.U, log.cost, log.violation, out[0], out[1]):
        assert v.dtype == torch.float32


# ------------------------------------------- the closed-loop engine

def test_closed_loop_falls_back_on_a_failed_solve(monkeypatch):
    """A robot whose solve comes back non-finite (or above the fallback
    violation) applies its warm inputs shifted by a step and keeps its old
    multipliers; the others apply their solves'."""
    mpc = MPCWholeBody(MobileManipulator(0.1), [Obstacles(5.0, 5.0, 0.3)],
                       [], N=5, solver_config=SolverConfig(al_iters=1,
                                                           ilqr_iters=2),
                       device="cpu")
    shared = mpc.make_params(np.zeros((6, 9)), np.zeros((5, 5)))
    for k in ("X_ref", "U_ref"):
        shared.pop(k)
    shared = params_from_numpy(shared, "cpu", torch.float64)
    real = batch_engine.al_ilqr_solve_batched
    calls = []

    def failing(ocp, x0, U0, params, cfg, lam0_b=None):
        res = real(ocp, x0, U0, params, cfg, lam0_b=lam0_b)
        calls.append((U0.clone(), tuple(v.clone() for v in lam0_b), res))
        if len(calls) == 2:        # tick 2: robot 1 NaN, robot 2 infeasible
            U = res.U.clone()
            U[1, 3] = float("nan")
            viol = res.max_violation.clone()
            viol[2] = 2.0
            res = res._replace(U=U, max_violation=viol)
        return res

    monkeypatch.setattr(batch_engine, "al_ilqr_solve_batched", failing)
    x0 = torch.zeros(3, 9, dtype=torch.float64)
    x0[:, 6:] = torch.tensor([0.0, -1.0, 1.0])
    traj = torch.stack([torch.linspace(0, 1, 21, dtype=torch.float64)[:, None]
                        * torch.tensor([0.8, 0.1 * b] + [0.0] * 7)
                        + x0[0] for b in range(3)])
    run = batch_engine.make_batch_closed_loop(mpc.ocp, mpc.solver_config,
                                              shared, [0, 1], n_ticks=3)
    log = run(x0, traj, torch.zeros(3, 20, 5, dtype=torch.float64))
    assert log.fallback.tolist() == [[False, False, False],
                                     [False, True, False],
                                     [False, True, False]]
    U_tick2, lams_tick2, res2 = calls[1]
    U_tick3, lams_tick3, _ = calls[2]
    for b in (1, 2):
        shifted = torch.cat([U_tick2[b, 1:], U_tick2[b, -1:]])
        assert torch.equal(U_tick3[b], shifted)
        assert torch.equal(log.U[b, 1], shifted[0])
        for new, old in zip(lams_tick3, lams_tick2):
            assert torch.equal(new[b], old[b])
    assert torch.equal(U_tick3[0], res2.U[0])
    assert torch.isfinite(log.X).all()


def test_rollout_failure_report_matches_jax():
    """``report_rollout_failures``' lines on one log, as JAX's prints them."""
    rng = np.random.default_rng(8)
    viol = np.abs(rng.standard_normal((6, 5))) * 1e-4
    viol[2, 3], viol[4, 1] = 0.5, 2e-3
    fb = np.zeros((6, 5), bool)
    fb[5, 2] = True
    X = rng.standard_normal((6, 6, 9))
    log = batch_engine.RolloutLog(X=torch.as_tensor(X), U=None, cost=None,
                                  violation=torch.as_tensor(viol),
                                  fallback=torch.as_tensor(fb))
    log_j = batch_engine_j.RolloutLog(X=X, U=None, cost=None, violation=viol,
                                      fallback=fb)
    got, want = io.StringIO(), io.StringIO()
    assert debugging.report_rollout_failures(log, constraint_tol=1e-3,
                                             top_k=3, file=got)
    assert debugging_j.report_rollout_failures(log_j, constraint_tol=1e-3,
                                               top_k=3, file=want)
    assert got.getvalue() == want.getvalue()
    quiet = log._replace(fallback=torch.zeros_like(log.fallback))
    assert not debugging.report_rollout_failures(quiet, constraint_tol=1.0,
                                                 top_k=3, file=got)

"""The port's closed loop against the JAX package's: the warm-started
single-robot MPC tick, the dual shift, the task state machine, the planners
and local references, the plant, the arm's IK and the checkpoints.

The tick: three warm-started scenario-1 ticks of the port's ``MPCWholeBody``
on the CPU (the batched solve at batch 1, ``SolverConfig()`` of the demo,
float32, kernels A and B through their plain versions), each held against
the JAX package's float32 single-scenario ``al_ilqr_solve`` on the same
x0, warm inputs, multipliers and params: relative cost within 5e-3, both
feasible at 1e-3 (ROADMAP queue 3: a full solve is held to cost and
feasibility, never to |dU|, which is printed).  The two run different
solvers -- the port kernels A and B, JAX the generic Gauss-Newton expansion
and a scanned Riccati sweep -- on one problem.  The JAX solve compiles once
for the file, in the module fixture.

Everything else is host code in float64: the plant to 1e-12, the local
references to 1e-9, the IK to 1e-6 in q, ``shift_multipliers`` to 1e-7, the
copied modules exactly.
"""

import dataclasses
import json
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmmpc_tpu.runtime.metrics as metrics_j
import mmmpc_tpu.runtime.reference as reference_j
import mmmpc_tpu.sim.kinematic_plant as plant_j
from demo_wholebody_qref import build_world as build_world_j
from mmmpc_tpu.models.arm import arm_fk as arm_fk_j
from mmmpc_tpu.models.arm import arm_ik as arm_ik_j
from mmmpc_tpu.models.robots import MobileManipulator as MobileManipulatorJ
from mmmpc_tpu.runtime.interface import Interface as InterfaceJ
from mmmpc_tpu.solver import al_ilqr_solve as al_ilqr_solve_j
from mmmpc_tpu.solver import shift_multipliers as shift_multipliers_j
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu.utils.math import angle_diff as angle_diff_j
import mmmpc_tpu_torch.runtime.metrics as metrics_t
import mmmpc_tpu_torch.runtime.reference as reference_t
import mmmpc_tpu_torch.sim.kinematic_plant as plant_t
from mmmpc_tpu_torch.demo_wholebody_qref import build_world
from mmmpc_tpu_torch.models.arm import (
    ARM_IK_LOWER, ARM_IK_UPPER, arm_fk, arm_ik,
)
from mmmpc_tpu_torch.models.robots import MobileManipulator
from mmmpc_tpu_torch.ops.wholebody_fwd import unpack_params
from mmmpc_tpu_torch.runtime import checkpoint
from mmmpc_tpu_torch.runtime.interface import Interface
from mmmpc_tpu_torch.solver.al_ilqr import shift_multipliers
from mmmpc_tpu_torch.utils.configs import (
    BASELINK2JOINT1_X, BASELINK2JOINT1_Z, WORKING_RADIUS, SolverConfig,
    make_scenario,
)
from mmmpc_tpu_torch.utils.convert import params_from_numpy
from mmmpc_tpu_torch.utils.math import angle_diff

TICKS = 3
PI = np.pi

torch.set_num_threads(1)    # batch 1: threads only contend with the others


# ------------------------------------------------- the warm-started ticks

@pytest.fixture(scope="module")
def ticks():
    """The port's scenario-1 loop (model-only plant) on the CPU for TICKS
    ticks from the start, each tick's solve inputs recorded, and the JAX
    single solve of each tick on the same inputs."""
    world = build_world(1, physical_sim=False, device="cpu")
    ctrl = world.controller
    solve_impl = ctrl._solve_impl
    record = []

    def recording(x_init, params):
        u = (np.zeros((ctrl.N, 5), np.float32) if ctrl.u_latest is None
             else ctrl.u_latest.numpy().copy())
        lams = (None if ctrl.lam_latest is None
                else tuple(v.numpy().copy() for v in ctrl.lam_latest))
        out = solve_impl(x_init, params)
        record.append(dict(x=np.asarray(x_init, np.float32), U=u, lams=lams,
                           params=params, res=ctrl.last_result, u0=out))
        return out

    ctrl._solve_impl = recording
    # the JAX solve compiled for the ticks' shapes in a thread of its own
    # while the port's ticks run
    f32 = jnp.float32
    shapes = dict(ctrl.make_params(np.zeros((21, 9)), np.zeros((20, 5))),
                  U_last=np.zeros((20, 5)))
    like = (jax.ShapeDtypeStruct((9,), f32),
            jax.ShapeDtypeStruct((20, 5), f32),
            {k: jax.ShapeDtypeStruct(np.shape(v), f32)
             for k, v in shapes.items()},
            tuple(jax.ShapeDtypeStruct(s, f32)
                  for s in ((20, 28), (18,), (2,))))
    ocp_j = build_world_j(1, N=20, physical_sim=False).controller.ocp
    with ThreadPoolExecutor(1) as pool:
        compiled = pool.submit(lambda: jax.jit(
            lambda x0, U0, p, lam0: al_ilqr_solve_j(
                ocp_j, x0, U0, p, SolverConfigJ(), lam0=lam0)).lower(
            *like).compile())
        _start(world)
        # without autograd's bookkeeping: the same ops and bits, a fifth
        # less host time a tick on the CPU
        with torch.inference_mode():
            for _ in range(TICKS):
                world.timerCallback()
        solve_j = compiled.result()
    for r in record:
        p = {k: jnp.asarray(v, f32) for k, v in r["params"].items()}
        p["U_last"] = jnp.asarray(r["U"], f32)
        lams = r["lams"] or (np.zeros((20, 28)), np.zeros(18), np.zeros(2))
        r["res_j"] = solve_j(jnp.asarray(r["x"], f32), jnp.asarray(r["U"], f32),
                             p, tuple(jnp.asarray(v, f32) for v in lams))
    return record


def _start(world):
    world.current_state = world.x_start
    world.task_flag = "move"
    world.is_active = True


@pytest.mark.parametrize("tick", range(TICKS))
def test_warm_started_tick_matches_jax_float32(ticks, tick):
    r = ticks[tick]
    res_t, res_j = r["res"], r["res_j"]
    assert res_j.cost.dtype == jnp.float32
    assert res_t.U.shape == (20, 5) and res_t.cost.shape == ()
    cost_t, cost_j = float(res_t.cost), float(res_j.cost)
    rel = abs(cost_t - cost_j) / abs(cost_j)
    du0 = np.abs(np.asarray(res_t.U[0]) - np.asarray(res_j.U[0])).max()
    print(f"tick {tick + 1}: cost port {cost_t:.6f} jax {cost_j:.6f} rel "
          f"{rel:.3e}, viol {float(res_t.max_violation):.3e} / "
          f"{float(res_j.max_violation):.3e}, |du0| {du0:.3e}")
    assert rel <= 5e-3
    assert float(res_t.max_violation) <= 1e-3
    assert float(res_j.max_violation) <= 1e-3
    np.testing.assert_array_equal(r["u0"], res_t.U[0].numpy())
    # the next tick starts from this one's inputs and shifted multipliers
    if tick + 1 < TICKS:
        nxt = ticks[tick + 1]
        np.testing.assert_array_equal(nxt["U"], res_t.U.numpy())
        np.testing.assert_array_equal(
            nxt["lams"][0], 0.5 * np.concatenate(
                [res_t.lam_stage[1:], res_t.lam_stage[-1:]]))


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    """A LoopState saved after tick 1 and restored into a fresh loop repeats
    tick 2 exactly.  Tick 1 starts from seeded multipliers, so that the
    checkpoint carries nonzero ones: the terminal equality's (the start's
    inequalities are slack and zero theirs).  Both loops solve two AL rounds
    of two sweeps, a fraction of a full tick's cost with the same state to
    save and restore."""
    cfg = dataclasses.replace(SolverConfig(), al_iters=2, ilqr_iters=2)
    first, fresh = (build_world(1, physical_sim=False, device="cpu")
                    for _ in range(2))
    first.controller.solver_config = fresh.controller.solver_config = cfg
    rng = np.random.default_rng(3)
    first.controller.lam_latest = tuple(
        torch.as_tensor(0.5 * rng.random(shape), dtype=torch.float32)
        for shape in ((20, 28), (18,), (2,)))
    _start(first)
    first.timerCallback()
    assert float(first.controller.lam_latest[2].abs().min()) > 0.0
    checkpoint.save(tmp_path / "loop.npz", checkpoint.LoopState.capture(first))
    first.timerCallback()
    state = checkpoint.load(tmp_path / "loop.npz")
    assert isinstance(state, checkpoint.LoopState)
    assert state.task_flag == "move" and state.mpc_step_counter == 1
    state.restore(fresh)
    fresh.is_active = True
    fresh.timerCallback()
    res, ref = fresh.controller.last_result, first.controller.last_result
    for name in ("X", "U", "cost", "lam_stage", "lam_term", "lam_eq"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name
    np.testing.assert_array_equal(fresh.u_log[-1], first.u_log[-1])


# ------------------------------------------------------ the dual shift

@pytest.mark.parametrize("batch", [None, 1])
def test_shift_multipliers_matches_jax(batch):
    rng = np.random.default_rng(5)
    lead = () if batch is None else (batch,)
    lams = (rng.random(lead + (20, 28)), rng.random(lead + (18,)),
            rng.standard_normal(lead + (2,)))
    got = shift_multipliers(*(torch.as_tensor(v) for v in lams))
    want = shift_multipliers_j(*(jnp.asarray(v) for v in lams))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-7)
    # stage k+1 moves to k, the last stage is repeated, all halved
    stage = lams[0].reshape(-1, 20, 28)
    shifted = got[0].numpy().reshape(-1, 20, 28)
    np.testing.assert_array_equal(shifted[:, :-1], 0.5 * stage[:, 1:])
    np.testing.assert_array_equal(shifted[:, -1], 0.5 * stage[:, -1])


# ------------------------------------------------------ the copied modules

@pytest.mark.parametrize("case", ["start", "middle", "past_end", "other_space"])
def test_reference_copy_matches_jax(case):
    rng = np.random.default_rng(7)
    traj = np.cumsum(rng.standard_normal((51, 9)) * 0.1, axis=0)
    u = rng.standard_normal((50, 5))
    cur = {"start": traj[0], "middle": traj[23] + 0.01,
           "past_end": traj[-1] + 0.5, "other_space": traj[30]}[case]
    kw = ({"current_pose": traj[31, 6:9] + 0.01, "different_space": True}
          if case == "other_space" else {})
    for idx in ([6, 7, 8],) if kw else ([0, 1], [6, 7, 8]):
        assert (reference_t.nearest_index(traj, cur, np.array(idx))
                == reference_j.nearest_index(traj, cur, np.array(idx)))
        got = reference_t.local_ref_traj(traj, u, cur, idx, 20, **kw)
        want = reference_j.local_ref_traj(traj, u, cur, idx, 20, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the pose window's yaw is made continuous with the current yaw
    for psi in (PI - 0.01, -PI + 0.02, 0.3):
        traj_w = traj.copy()
        traj_w[-1, 2] = -PI + 0.01
        got = reference_t.local_ref_pose(traj_w, u, psi, 20, angle_diff)
        want = reference_j.local_ref_pose(traj_w, u, psi, 20, angle_diff_j)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_metrics_copy_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    logs = (metrics_t.MetricsLog(), metrics_j.MetricsLog())
    for step in range(1, 40):
        res = types.SimpleNamespace(cost=rng.random() * 100,
                                    max_violation=rng.random() * 1e-3,
                                    converged=bool(rng.random() < 0.9))
        for log in logs:
            log.end_solve(step, "move", res)
    for log in logs:
        for r in log.records:        # the latencies are the clocks'
            r.solve_latency_s = 0.001 * r.step
    assert logs[0].summary() == logs[1].summary()
    for i, log in enumerate(logs):
        log.dump_json(tmp_path / f"{i}.json")
    dumps = [json.loads((tmp_path / f"{i}.json").read_text())
             for i in range(2)]
    assert dumps[0] == dumps[1]
    assert ([f.name for f in dataclasses.fields(metrics_t.TickRecord)]
            == [f.name for f in dataclasses.fields(metrics_j.TickRecord)])


# ------------------------------------------------------------ the plant

def test_plant_matches_jax_float64():
    rng = np.random.default_rng(11)
    init = np.concatenate([rng.standard_normal(3), rng.standard_normal(9)])
    env_t = plant_t.KinematicPlant(init, 0.01)
    env_j = plant_j.KinematicPlant(init, 0.01)
    s_t = torch.as_tensor(env_t._state)
    s_j = jnp.asarray(env_j._state)
    for _ in range(100):
        a = rng.uniform(-1.0, 1.0, 11)
        ob_t, ob_j = env_t.step(a), env_j.step(a)
        for k in ("position", "velocity"):
            np.testing.assert_allclose(ob_t["robot_0"]["joint_state"][k],
                                       ob_j["robot_0"]["joint_state"][k],
                                       rtol=0, atol=1e-12)
        s_t = plant_t.plant_step(s_t, torch.as_tensor(a), 0.01)
        s_j = plant_j.plant_step(s_j, jnp.asarray(a), 0.01)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(s_t.numpy(), env_t._state, rtol=0,
                                   atol=1e-12)
        for g, w in zip(plant_t.plant_observation(s_t, torch.as_tensor(a)),
                        plant_j.plant_observation(s_j, jnp.asarray(a))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-12)


# -------------------------------------------------------------- the IK

def test_arm_ik_matches_jax_float64():
    """From the start's joints to the arm-frame target of scenario 1's
    switch to 'manipulate', the base parked at its stand-off target."""
    sc = make_scenario(1)
    q0 = sc.x_start[6:9]
    target = np.array([WORKING_RADIUS - BASELINK2JOINT1_X, 0.0,
                       sc.global_pose_target[2] - BASELINK2JOINT1_Z])
    q_t = arm_ik(torch.as_tensor(q0), torch.as_tensor(target))
    q_j = np.asarray(arm_ik_j(jnp.asarray(q0), jnp.asarray(target)))
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=1e-6)
    ee, _, _ = arm_fk(q_t)
    assert np.abs(ee.numpy()[[0, 2]] - target[[0, 2]]).max() <= 1e-4
    assert (np.all(q_t.numpy() >= np.array(ARM_IK_LOWER))
            and np.all(q_t.numpy() <= np.array(ARM_IK_UPPER)))
    ee_j, _, _ = arm_fk_j(jnp.asarray(q_t.numpy()))
    np.testing.assert_allclose(ee.numpy(), np.asarray(ee_j), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("a, b", [(3.1, -3.1), (-3.14, 3.14), (0.25, 0.5),
                                  (np.float64(PI - 0.001), -PI),
                                  (np.array(2.0), np.array(-PI))])
def test_angle_diff_matches_jax_on_host_floats(a, b):
    np.testing.assert_allclose(float(angle_diff(a, b)),
                               float(angle_diff_j(a, b)), rtol=0, atol=1e-15)


# ------------------------------------------------------ the state machine

class _StubController:
    """The closed loop's view of a controller: the robot model, N, nu, the
    FSM's weight and mask calls (recorded), and a solve that records its
    local references and returns zeros."""

    def __init__(self, robot):
        self.robot_model = robot
        self.N = 20
        self.ocp = types.SimpleNamespace(nu=5)
        self.last_result = types.SimpleNamespace(cost=0.0, max_violation=0.0,
                                                 converged=True)
        self.calls = []

    def setWeight(self, **weights):
        self.calls.append(("setWeight", {k: np.asarray(v)
                                         for k, v in weights.items()}))

    def add_terminal_position_constraint(self):
        self.calls.append(("eq_mask", 1.0))

    def solve(self, x, traj_ref, u_ref):
        self.calls.append(("solve", np.array(traj_ref), np.array(u_ref)))
        return np.zeros(5)


def _scripted_states(x_start, x_target, q_goal=None):
    """States that walk scenario 1's task through every phase: move,
    approach, rotate (twice: the yaw still far), move finish -> manipulate
    (the yaw within 0.5 deg across the wrap at pi), manipulate halfway,
    manipulate finish (the arm at the IK goal)."""
    q0 = x_start[6:9]
    parked = np.array([x_target[0] + 0.003, x_target[1], PI - 0.002, 0, 0, 0])
    states = [x_start,
              np.r_[3.2, 3.4, 0.7, 0.1, 0.1, 0.0, q0],
              np.r_[4.9, 4.95, 2.0, 0.0, 0.0, 0.0, q0],
              np.r_[x_target[0], x_target[1], 3.0, 0.0, 0.0, 0.0, q0],
              np.r_[parked, q0]]
    if q_goal is not None:
        states += [np.r_[parked, 0.5 * (q0 + q_goal)], np.r_[parked, q_goal]]
    return states


def _drive(interface, states):
    interface.current_state = interface.x_start
    interface.task_flag = "move"
    interface.is_active = True
    flags = []
    for s in states:
        interface.current_state = np.asarray(s, dtype=float)
        interface.timerCallback()
        flags.append((interface.task_flag, interface.is_active))
    return flags


def test_state_machine_matches_jax():
    sc = make_scenario(1)

    def world(iface, robot):
        return iface(0.1, 5, 2, sc.x_start, sc.global_pose_target,
                     _StubController(robot(0.1)))

    # the first five states reach the manipulate plan; its IK goal then
    # scripts the last two
    probe = world(Interface, MobileManipulator)
    _drive(probe, _scripted_states(sc.x_start, probe.x_target))
    states = _scripted_states(sc.x_start, probe.x_target,
                              probe.traj_ref[-1, 6:9])
    worlds = [world(Interface, MobileManipulator),
              world(InterfaceJ, MobileManipulatorJ)]
    port, jax_world = worlds
    flags = [_drive(w, states) for w in worlds]

    assert flags[0] == flags[1]
    assert [f for f, _ in flags[0]] == [
        "move", "approach", "rotate", "rotate", "manipulate", "manipulate",
        "manipulate finish"]
    assert flags[0][-1][1] is False
    np.testing.assert_array_equal(port.x_target, jax_world.x_target)
    np.testing.assert_allclose(port.local_pose_target,
                               jax_world.local_pose_target, rtol=0,
                               atol=1e-12)
    # the manipulate plan: linspace to the IK goal, equal to 1e-6 in q
    np.testing.assert_allclose(port.traj_ref, jax_world.traj_ref, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(port.manipulator_pose_log,
                               jax_world.manipulator_pose_log, rtol=0,
                               atol=1e-9)
    calls_t, calls_j = (w.controller.calls for w in worlds)
    assert [c[0] for c in calls_t] == [c[0] for c in calls_j]
    assert [c[0] for c in calls_t].count("solve") == 6
    for ct, cj in zip(calls_t, calls_j):
        if ct[0] == "setWeight":
            assert ct[1].keys() == cj[1].keys()
            for k in ct[1]:
                np.testing.assert_array_equal(ct[1][k], cj[1][k])
        elif ct[0] == "solve":
            # the local references handed to the solve
            np.testing.assert_allclose(ct[1], cj[1], rtol=0, atol=1e-9)
            np.testing.assert_allclose(ct[2], cj[2], rtol=0, atol=1e-9)
        else:
            assert ct == cj


# ------------------------------------------- runtime params reach A and B

def test_weights_and_mask_reach_the_kernels_params():
    """setWeight and the terminal-equality mask change the params that the
    next tick packs for kernels A and B (the factories repack per solve)."""
    world = build_world(1, physical_sim=False, device="cpu")
    mpc = world.controller
    traj = np.tile(world.x_start, (21, 1))
    cfg = mpc.solver_config

    def packed():
        p = params_from_numpy(dict(mpc.make_params(traj, np.zeros((20, 5))),
                                   U_last=np.zeros((20, 5))), "cpu",
                              torch.float32)
        return [unpack_params(f(cfg, p).flat, 20, mpc.n_obs, mpc.n_hp)
                for f in (mpc.ocp.lanes_fwd_factory,
                          mpc.ocp.lanes_bwd_factory)]

    for fwd_bwd in packed():
        assert float(fwd_bwd["eq_mask"]) == 0.0
    W = np.diag([5, 5, 5, 0, 0, 1, 1, 1, 1.0])
    mpc.setWeight(P=W, Q=W)
    mpc.add_terminal_position_constraint()
    for fwd_bwd in packed():
        assert float(fwd_bwd["eq_mask"]) == 1.0
        np.testing.assert_array_equal(fwd_bwd["Q"].numpy(), W)
        np.testing.assert_array_equal(fwd_bwd["P"].numpy(), W)

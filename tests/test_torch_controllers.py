"""The generic controllers' single-robot ``solve`` and the scipy oracle of the
port (counterpart of the parts of tests/test_controllers.py that hold the
demo, base and arm controllers), on the CPU (``device="cpu"``: the kernels'
plain versions, float32 as on the card).

- Each controller honours the reference's protocol: the demo accelerates
  toward its target and keeps its warm start; the base's solve matches the
  port's oracle (L-BFGS-B, whose solution is checked feasible, so it is the
  constrained optimum) at rtol 1e-3 on the cost; ``setWeight`` on the input
  weight shrinks the base's input; the arm moves every joint toward its
  target within its rate limits, the wedge raises its cost, and with the
  Cartesian reference its end point moves toward the reference; the arm's
  and the endpoint's ``solve`` clamp the start into their boxes.
- The oracle's objective, gradient and constraint Jacobian
  (``mmmpc_tpu_torch/verify/oracle.py``, torch.autograd) against the JAX
  package's (``mmmpc_tpu/verify/oracle.py``, JAX autodiff) at three seeded
  points, float64, to 1e-9, on the Cartesian arm of
  tests/torch_problems.py (its rows: joint box, rate box, self-collision),
  the JAX side compiled at XLA's lowest optimisation level.  No JAX solve
  is compiled here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmmpc_tpu import controllers as ctl_j
from mmmpc_tpu.models import obstacles as obs_j
from mmmpc_tpu.models import robots as robots_j
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu.verify.oracle import _plain_rollout, _shooting_fns
from mmmpc_tpu_torch.controllers import (
    MPC, MPCBase, MPCManipulator3DoF, MPCWholeBodyEndpoint,
)
from mmmpc_tpu_torch.models.arm import arm_fk
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import (
    Base, ManipulatorPanda3DoF, MobileManipulator, RobotDemo,
)
from mmmpc_tpu_torch.ops import generic_bwd, generic_fwd
from mmmpc_tpu_torch.utils.configs import SolverConfig
from mmmpc_tpu_torch.verify.oracle import Shooting, lbfgs_solve

import torch_problems as tp

DT = 0.1
CPU = dict(device="cpu")
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
WEDGE = tp.WEDGE

torch.set_num_threads(1)    # batch 1: threads only contend


def test_demo_controller_tracks():
    mpc = MPC(RobotDemo(DT), N=10, **CPU)
    traj = np.stack([np.linspace(0, 1, 11), np.zeros(11)], axis=1)
    u0 = mpc.solve(np.array([0.0, 0.0]), traj, np.zeros(10))
    assert u0.shape == (1,)
    assert u0[0] > 0.1          # accelerates toward the target
    assert mpc.u_latest is not None and mpc.u_latest.device.type == "cpu"
    mpc.reset()
    assert mpc.u_latest is None and mpc.lam_latest is None


def test_base_controller_matches_oracle():
    mpc = MPCBase(Base(DT), [Obstacles(1.2, 0.1, 0.3)], N=12,
                  solver_config=SolverConfig(al_iters=8, ilqr_iters=15), **CPU)
    x0 = np.zeros(6)
    traj = np.linspace(x0, np.array([2.5, 0, 0, 0, 0, 0]), 13)
    u_ref = np.zeros((12, 2))
    mpc.solve(x0, traj, u_ref)
    res = mpc.last_result
    params = dict(mpc.make_params(traj, u_ref), U_last=np.zeros((12, 2)))
    U_o, _, cost_o, _ = lbfgs_solve(mpc.ocp, x0, np.zeros((12, 2)), params)
    sh = Shooting(mpc.ocp, x0, params)
    with torch.no_grad():
        assert float(sh.ineq(U_o.reshape(-1)).max()) <= 1e-6
    np.testing.assert_allclose(float(res.cost), cost_o, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(res.U.double().numpy(), U_o.numpy(), atol=2e-2)


def test_base_set_weight_changes_solution():
    mpc = MPCBase(Base(DT), [], N=8, **CPU)
    x0 = np.zeros(6)
    traj = np.linspace(x0, np.array([1.0, 0, 0, 0, 0, 0]), 9)
    u1 = mpc.solve(x0, traj, np.zeros((8, 2)))
    mpc.reset()
    mpc.setWeight(R=np.diag([100.0, 100.0]))
    u2 = mpc.solve(x0, traj, np.zeros((8, 2)))
    assert abs(u2[0]) < abs(u1[0])  # heavier input weight => smaller input
    a = torch.tensor([3.0, -3.0])
    assert torch.allclose(mpc.angleDiff(a, -a), torch.tensor([6.0 - 2 * np.pi,
                                                              2 * np.pi - 6.0]))


def test_manipulator_controller_joint_tracking():
    mpc = MPCManipulator3DoF(ManipulatorPanda3DoF(DT), [], np.array([]), N=10,
                             **CPU)
    q0 = np.array([0.0, -0.5, 0.5])
    q_target = np.array([0.3, -1.0, 1.0])
    u0 = mpc.solve(q0, np.linspace(q0, q_target, 11), np.zeros((10, 3)))
    assert u0.shape == (3,)
    assert np.all(np.sign(u0) == np.sign(q_target - q0))
    assert np.all(np.abs(u0) <= 1.0 + 1e-6)       # dq limits


def test_manipulator_convex_obstacle_pushes_away():
    free = MPCManipulator3DoF(ManipulatorPanda3DoF(DT), [], np.array([]),
                              N=10, **CPU)
    blocked = MPCManipulator3DoF(
        ManipulatorPanda3DoF(DT), *WEDGE, N=10,
        solver_config=SolverConfig(al_iters=4, ilqr_iters=15), **CPU)
    q0 = np.array([0.3, -1.2, 1.2])
    traj = np.tile(q0, (11, 1))
    free.solve(q0, traj, np.zeros((10, 3)))
    blocked.solve(q0, traj, np.zeros((10, 3)))
    assert (float(blocked.last_result.cost)
            >= float(free.last_result.cost) - 1e-9)


def test_cartesian_arm_moves_end_point_toward_reference():
    """A tick of the Cartesian arm runs its own kernels' plain versions (60
    iterations at ``SolverConfig()``) and moves the end point toward its
    reference."""
    mpc = MPCManipulator3DoF(ManipulatorPanda3DoF(DT), *WEDGE, N=10,
                             is_cartesian_ref=True, **CPU)
    q0 = np.array([0.3, -1.2, 1.2])
    target = np.array([0.45, 0.0, 0.5])
    traj = np.linspace(target, [0.35, 0.0, 0.6], 11)
    ee = lambda q: arm_fk(torch.as_tensor(q))[0].numpy()
    counters = [m.LAUNCHES[f] for m in (generic_fwd, generic_bwd)
                for f in ("arm_cart", "arm")]
    for c in counters:
        c.reset()
    u0 = mpc.solve(q0, traj, np.zeros((10, 3)))
    assert [(c.cuda, c.plain) for c in counters] == [(0, 60), (0, 0)] * 2
    res = mpc.last_result
    assert bool(res.converged), float(res.max_violation)
    # the first step moves the end point toward the first reference, the
    # plan toward the last
    assert (np.linalg.norm(ee(q0 + DT * u0) - target)
            < np.linalg.norm(ee(q0) - target))
    assert (np.linalg.norm(ee(res.X[-1].double().numpy()) - traj[-1])
            < np.linalg.norm(ee(q0) - traj[-1]))


def test_solve_clamps_the_start_into_the_box():
    """The arm and the endpoint controllers clamp infeasible feedback into
    their joint / state boxes before solving (the reference's :134-135)."""
    arm = MPCManipulator3DoF(ManipulatorPanda3DoF(DT), [], np.array([]), N=4,
                             solver_config=SolverConfig(al_iters=1,
                                                        ilqr_iters=1), **CPU)
    q = np.array([0.0, 0.2, -0.1])        # q2 > 0 and q3 < 0: clamped to 0
    arm.solve(q, np.tile(q, (5, 1)), np.zeros((4, 3)))
    np.testing.assert_array_equal(arm.last_result.X[0].numpy(), [0, 0, 0])
    ep = MPCWholeBodyEndpoint(MobileManipulator(DT), [], N=4,
                              solver_config=SolverConfig(al_iters=1,
                                                         ilqr_iters=1), **CPU)
    x = np.zeros(9)
    x[6:] = [0.0, 0.3, -0.2]
    ep.solve(x, np.zeros((5, 4)), np.zeros((4, 5)))
    assert ep.last_result.X[0, 7] == 0 and ep.last_result.X[0, 8] == 0


def test_oracle_functions_match_jax():
    """The port's single-shooting objective, its gradient and the
    inequality rows and their Jacobian against the JAX oracle's (its own
    jitted objective and gradient, and scipy_solve's ``cons_ineq``) at three
    seeded points (inputs and starts), float64, to 1e-9; the JAX side
    compiled at XLA's lowest optimisation level."""
    name = "arm_cart"
    mpc_t, x0_b, _, p_t = tp.generic_problem(name, 3)
    mpc_j = tp.generic_controller(name, SolverConfigJ(**tp.GENERIC_CFG),
                                  (ctl_j, obs_j, robots_j))
    ocp_j = mpc_j.ocp
    p_j = {k: jnp.asarray(v) for k, v in tp.generic_params(mpc_j, name).items()}
    ks = jnp.arange(tp.N)

    def cons_j(z, x0):
        U = z.reshape(tp.N, mpc_j.NU)
        X = _plain_rollout(ocp_j, x0, U)
        cs = jax.vmap(lambda x, u, k: ocp_j.stage_ineq(x, u, k, p_j))(
            X[:-1], U, ks).reshape(-1)
        return jnp.concatenate([cs, ocp_j.terminal_ineq(X[-1], p_j)])

    rng = np.random.default_rng(21)
    zs = 0.4 * rng.standard_normal((len(x0_b), tp.N * mpc_t.NU))
    like = (zs[0], jnp.asarray(x0_b[0]))
    obj_j, grad_j = (fn.lower(*like, p_j).compile(FAST_COMPILE)
                     for fn in _shooting_fns(ocp_j))
    con_j, jac_j = (jax.jit(fn).lower(*like).compile(FAST_COMPILE)
                    for fn in (cons_j, jax.jacfwd(cons_j)))
    for z, x0 in zip(zs, x0_b):
        sh = Shooting(mpc_t.ocp, x0, p_t)
        f, g = sh.value_and_grad(z)
        ci, Ji = sh.rows(sh.ineq)
        x0j = jnp.asarray(x0)
        for got, want in ((f, obj_j(z, x0j, p_j)), (g, grad_j(z, x0j, p_j)),
                          (ci(z), con_j(z, x0j)), (Ji(z), jac_j(z, x0j))):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9,
                                       atol=1e-9)

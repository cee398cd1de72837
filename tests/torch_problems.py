"""The port's kernel test problems, made from seeded numpy, free of JAX.

One builder for each problem, so that every check of a kernel runs on the
same data: the parity tests build the JAX package's twin of a problem by
passing that package's modules to the builders here
(tests/test_torch_kernels.py, tests/test_torch_generic_kernels.py,
tests/test_torch_riccati.py), while tests/test_torch_cuda.py and
``chip_smoke.py`` use the port's side alone.  A CUDA kernel is then held
against its plain version on the inputs on which that plain version is
held against the JAX package.

Nothing here imports JAX or the JAX package.
"""

import numpy as np
import torch

from mmmpc_tpu_torch import controllers as _ctl
from mmmpc_tpu_torch.models import obstacles as _obstacles
from mmmpc_tpu_torch.models import robots as _robots
from mmmpc_tpu_torch.utils.configs import SolverConfig

B, N = 64, 5
# the arm's backward at the JAX test's batch (tests/test_generic_bwd.py):
# its p99 form is set for a batch where the ill-conditioned scenarios are
# the tail
ARM_BATCH = 1024
# the generic kernels' formulations: arm_cart is the arm with the Cartesian
# reference (is_cartesian_ref=True)
FORMULATIONS = ("demo", "base", "arm", "arm_cart", "endpoint")
# the formulations with the arm's 1e6 wedge slack, whose gains are held in
# the p99 / float64 form
ARMS = ("arm", "arm_cart")
# gains tolerance (atol) of each generic backward pass; rtol 1e-4 (the arms
# are held in the p99 / float64 form instead)
BWD_ATOL = {"demo": 1e-5, "base": 1e-3, "endpoint": 2e-4}
# the wedge of half-planes of the bench, so the arm's 1e6 slack is active on
# part of the batch
WEDGE = ([np.array([[1 / np.sqrt(2), 0, 1 / np.sqrt(2)]]),
          np.array([[-1 / np.sqrt(2), 0, 1 / np.sqrt(2)]])],
         np.array([0.0, 0.0, 0.35]))
GENERIC_CFG = dict(al_iters=2, ilqr_iters=4, n_alpha=3, alpha_decay=0.4)
QREF_CFG = dict(GENERIC_CFG, cost_scale=1e5)
# (controllers, obstacles, robots) of the port; the parity tests pass the
# JAX package's three modules of the same names
PORT = (_ctl, _obstacles, _robots)


def generic_controller(name, cfg=None, modules=PORT):
    """The controller of formulation ``name`` (demo, base with two ground
    obstacles, arm with WEDGE, joint-space or Cartesian (the problem of
    tests/test_generic_bwd.py::_arm_problem), whole-body endpoint with one
    ground obstacle), built from ``modules`` with solver config ``cfg``
    (default: the port's of GENERIC_CFG)."""
    ctl, obs, robots = modules
    cfg = SolverConfig(**GENERIC_CFG) if cfg is None else cfg
    if name == "demo":
        return ctl.MPC(robots.RobotDemo(0.1), N=N, solver_config=cfg)
    if name == "base":
        return ctl.MPCBase(robots.Base(0.1),
                           [obs.Obstacles(1.2, 0.15, 0.3),
                            obs.Obstacles(0.4, -0.4, 0.25)],
                           N=N, solver_config=cfg)
    if name in ARMS:
        return ctl.MPCManipulator3DoF(robots.ManipulatorPanda3DoF(0.1),
                                      *WEDGE, N=N, solver_config=cfg,
                                      is_cartesian_ref=name == "arm_cart")
    return ctl.MPCWholeBodyEndpoint(robots.MobileManipulator(0.1),
                                    [obs.Obstacles(1.0, 0.2, 0.3)], N=N,
                                    solver_config=cfg)


def generic_params(mpc, name):
    """``mpc``'s params for formulation ``name``'s reference, as float64
    numpy."""
    if name == "demo":
        traj, nu = np.linspace([0.0, 0.0], [3.0, 0.0], N + 1), 1
    elif name == "base":
        traj = np.linspace(np.zeros(6), np.array([2.0, 0.4, 0.5, 0, 0, 0]),
                           N + 1)
        nu = 2
    elif name == "arm":
        traj, nu = np.linspace([0.3, -1.2, 1.2], [0.0, -0.6, 0.9], N + 1), 3
    elif name == "arm_cart":
        # end-point positions in the arm frame
        traj, nu = np.linspace([0.45, 0.0, 0.5], [0.35, 0.0, 0.6], N + 1), 3
    else:
        traj = np.linspace([0.6, 0.1, 1.1, 0.0], [0.8, 0.2, 1.0, 0.3], N + 1)
        nu = 5
    extra = ({"U_last": np.zeros((N, nu))}
             if name in (*ARMS, "endpoint") else {})
    return {k: np.asarray(v, np.float64) for k, v in dict(
        mpc.make_params(traj, np.zeros((N, nu))), **extra).items()}


def generic_problem(name, batch=B, cfg=None):
    """The port's problem of formulation ``name``: (controller, starts
    x0_b (batch, nx), inputs U0_b (batch, N, nu), params as float64
    numpy)."""
    mpc = generic_controller(name, cfg)
    rng = np.random.default_rng(0)
    if name == "demo":
        x0_b = np.stack([rng.uniform(-2, 2, batch),
                         rng.uniform(-0.9, 0.9, batch)], axis=1)
    elif name == "base":
        x0_b = rng.standard_normal((batch, 6)) * np.array(
            [0.4, 0.4, 0.6, 0.2, 0.2, 0.2])
    elif name in ARMS:
        q0 = np.array([0.3, -1.2, 1.2])
        x0_b = np.clip(q0[None] + rng.standard_normal((batch, 3)) * 0.2,
                       mpc.qlim[0] + 1e-3, mpc.qlim[1] - 1e-3)
    else:
        x0 = np.zeros(9)
        x0[6:] = [-np.pi / 4, -np.pi / 2, np.pi / 2]
        x0_b = x0[None] + 0.05 * rng.standard_normal((batch, 9)) * np.array(
            [1, 1, 0.5, 0.2, 0.2, 0.2, 0.3, 0.3, 0.3])
    U0_b = 0.3 * rng.standard_normal((batch, N, mpc.NU))
    return mpc, x0_b, U0_b, generic_params(mpc, name)


def moving_table(horizon=N):
    """A (horizon+1, 1, 3) obstacle table for the moving qref problem: the
    obstacle of ``qref_problem`` closing in on the robot's start, its
    radius growing, so that every row differs and the circle is live at the
    late stages only (a slipped row index changes the costs)."""
    k = np.arange(horizon + 1, dtype=float)
    return np.stack([1.0 - 0.12 * k, 0.2 - 0.03 * k, 0.3 + 0.01 * k],
                    axis=-1)[:, None, :]


def qref_problem(eq_mask=0.0, cfg=None, modules=PORT, moving=False):
    """The whole-body qref problem of tests/test_fwd_lanes.py (one ground
    obstacle and one half-plane, with ``eq_mask`` the terminal position
    equality), built from ``modules`` with solver config ``cfg`` (default:
    the port's of QREF_CFG): (controller, x0_b (B, 9), U0_b (B, N, 5),
    params as float64 numpy).  With ``moving`` the controller is
    ``MPCWholeBodyMovingObs`` over the obstacle table ``moving_table()``."""
    ctl, obs, robots = modules
    cfg = SolverConfig(**QREF_CFG) if cfg is None else cfg
    cls = ctl.MPCWholeBodyMovingObs if moving else ctl.MPCWholeBody
    mpc = cls(robots.MobileManipulator(0.1), [obs.Obstacles(1.0, 0.2, 0.3)],
              [(np.array([0.8, 0.1, 1.0]), np.array([[1.0, 0.0, 0.0]]))],
              N=N, solver_config=cfg)
    if moving:
        mpc.set_obstacle_prediction(moving_table())
    if eq_mask:
        mpc.add_terminal_position_constraint()
    rng = np.random.default_rng(7)
    x0 = np.zeros(9)
    x0[6:] = [-np.pi / 4, -np.pi / 2, np.pi / 2]
    x0_b = x0[None] + 0.02 * rng.standard_normal((B, 9)) * np.array(
        [1, 1, 0.2, 0, 0, 0, 0.1, 0.1, 0.1])
    U0_b = 0.1 * rng.standard_normal((B, N, 5))
    target = np.concatenate([[0.5, 0.1, 0, 0, 0, 0], x0[6:]])
    traj = np.linspace(x0, target, N + 1)
    params = {k: np.asarray(v, np.float64) for k, v in dict(
        mpc.make_params(traj, np.zeros((N, 5))),
        U_last=np.zeros((N, 5))).items()}
    return mpc, x0_b, U0_b, params


# The arm folded back with its end point at the self-collision check point
# j2 / 2 (the base at the world origin): the sphere's row reads +0.049
# there, so the terminal self-collision rows are live at x_N and at the
# stage states before it.  The fixed terminal formulation's problem holds
# the fold, at cost_scale 1.0 (the closed loop's): what moves between the
# two settings of replicate_terminal_selfcol_bug is S relu(max)^2 of one
# group, S = 1e5 times at most 0.05^2.
FOLDED_Q = np.array([1.3614, -2.0944, 1.7279])
SELFCOL_CFG = dict(GENERIC_CFG, cost_scale=1.0)


def selfcol_problem(bug_compat=False, cfg=None, modules=PORT, horizon=N,
                    batch=B):
    """The whole-body problem of the fixed terminal formulation
    (``replicate_terminal_selfcol_bug=bug_compat``): ``qref_problem``'s
    ground obstacle and half-plane, the robot at the world origin with the
    arm held at ``FOLDED_Q``, so that the self-collision rows of the
    terminal state are positive on much of the batch; built from
    ``modules`` with solver config ``cfg`` (default: the port's of
    SELFCOL_CFG): (controller, x0_b (batch, 9), U0_b (batch, horizon, 5),
    params as float64 numpy)."""
    ctl, obs, robots = modules
    cfg = SolverConfig(**SELFCOL_CFG) if cfg is None else cfg
    mpc = ctl.MPCWholeBody(
        robots.MobileManipulator(0.1), [obs.Obstacles(1.0, 0.2, 0.3)],
        [(np.array([0.8, 0.1, 1.0]), np.array([[1.0, 0.0, 0.0]]))],
        N=horizon, solver_config=cfg,
        replicate_terminal_selfcol_bug=bug_compat)
    rng = np.random.default_rng(13)
    x0 = np.zeros(9)
    x0[6:] = FOLDED_Q
    x0_b = x0[None] + 0.02 * rng.standard_normal((batch, 9)) * np.array(
        [1, 1, 0.5, 0, 0, 0, 1, 1, 1])
    U0_b = 0.1 * rng.standard_normal((batch, horizon, 5))
    traj = np.tile(x0, (horizon + 1, 1))
    params = {k: np.asarray(v, np.float64) for k, v in dict(
        mpc.make_params(traj, np.zeros((horizon, 5))),
        U_last=np.zeros((horizon, 5))).items()}
    return mpc, x0_b, U0_b, params


def long_problem(horizon, batch=B):
    """``bench_longhorizon``'s problem (scenario 1, the JAX script's
    schedule) at ``horizon`` and ``batch``: (controller, x0_b (batch, 9),
    U0_b (batch, horizon, 5) small random, params as float64 numpy)."""
    from mmmpc_tpu_torch.bench_longhorizon import build_numpy
    mpc, x0_b, params = build_numpy(horizon, batch)
    U0_b = 0.1 * np.random.default_rng(11).standard_normal(
        (batch, horizon, 5))
    return mpc, x0_b, U0_b, {k: np.asarray(v, np.float64)
                             for k, v in params.items()}


# the per-scenario entries of the fleet (ops/wholebody_fwd.py PS_BITS)
FLEET_KEYS = ("U_last", "X_ref", "U_ref", "Q", "P", "eq_mask")


def fleet_params(params, batch, keys=FLEET_KEYS, seed=9):
    """``params`` (a qref problem's, float64 numpy) with each entry of
    ``keys`` one value a scenario, batch-last, as the fleet solves:
    X_ref the shared reference plus noise (N+1, 9, batch), U_ref and U_last
    small random (N, 5, batch), Q and P rows of the task weight table
    (sim/batch_task_engine.py W_TABLE, drawn apart; 9, 9, batch), eq_mask 0
    and 1 mixed (batch,).  Every entry is drawn whichever ``keys`` are
    kept, so a subset has the values of the full set."""
    from mmmpc_tpu_torch.sim.batch_task_engine import W_TABLE
    rng = np.random.default_rng(seed)
    n = params["U_last"].shape[0]
    drawn = {
        "X_ref": params["X_ref"][..., None]
        + 0.05 * rng.standard_normal(params["X_ref"].shape + (batch,)),
        "U_ref": 0.05 * rng.standard_normal((n, 5, batch)),
        "U_last": 0.1 * rng.standard_normal((n, 5, batch)),
        "Q": np.moveaxis(W_TABLE[rng.integers(0, 3, batch)], 0, -1),
        "P": np.moveaxis(W_TABLE[rng.integers(0, 3, batch)], 0, -1),
        "eq_mask": (rng.random(batch) < 0.5).astype(np.float64),
    }
    return dict(params, **{k: drawn[k] for k in keys})


def spd_blocks(nx, nu, batch=B, horizon=4):
    """The random blocks of tests/test_pallas_riccati.py (seed 3), batch-major
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


def batch_last(a, device=None):
    """Batch-major numpy -> batch-last contiguous tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)),
                           device=device)


def drift_gate(got, ref, truth, rtol, atol, window=32):
    """The float64 gate of a float32 kernel over a long horizon, slice by
    slice of the leading axis (the stage; the step size for A's xlast and
    cost): on every slice the kernel's largest error against the float64
    plain version ``truth`` at most twice the largest error of the float32
    plain version (``ref``) on the slices within ``window`` of it, or at
    most the bench tolerance there (atol + rtol max |truth|).  Over
    hundreds of stages two float32 orders of one rollout or sweep drift
    apart by a random walk of roundings, so neither is the truth entry by
    entry, and the two walks peak at different stages
    (``long_horizon_drift.py`` measures both forms on the card; PERF.md);
    a kernel wrong on a few stages or on their small entries still leaves
    its slices' bounds.  Returns (the largest ratio of a
    slice's error to its bound, that slice's index); the gate holds when
    the ratio is at most 1."""
    n = got.shape[0]
    t = truth.double().reshape(n, -1)
    e_k = (got.double().reshape(n, -1) - t).abs().amax(1)
    e_p = (ref.double().reshape(n, -1) - t).abs().amax(1)
    near = torch.nn.functional.max_pool1d(e_p[None, None], 2 * window + 1,
                                          1, window)[0, 0]
    bound = torch.maximum(2.0 * near, atol + rtol * t.abs().amax(1))
    ratio = e_k / bound
    worst = int(ratio.argmax())
    return ratio[worst].item(), worst

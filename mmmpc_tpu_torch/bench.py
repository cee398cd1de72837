"""The benchmark problem of ``bench.py``, built for the port.

Whole-body qref MPC on scenario 1 (3 ground circles, 3 half-planes, the
self-collision spheres, state / input / input-rate boxes), N=20, a batch of
manipulate-phase starts near the table jittered with numpy
``default_rng(0)``, solved by the two-stage refined schedule: 5 AL rounds of
(16, 10, 10, 10, 12) sweeps, then the 1024 worst re-solved for 3 x 12 with
the penalty continued.  Everything is built from numpy and moved onto the
device in one dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from mmmpc_tpu_torch.controllers import MPCWholeBody
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import MobileManipulator
from mmmpc_tpu_torch.solver.refine import continue_mu
from mmmpc_tpu_torch.utils.configs import SolverConfig, make_scenario
from mmmpc_tpu_torch.utils.convert import params_from_numpy

N = 20
BATCH = 8192
SOLVER_CFG = SolverConfig(al_iters=5, ilqr_iters=16, ilqr_iters_later=10,
                          ilqr_iters_final=12,
                          cost_scale=1e5, constraint_tol=1e-3, n_alpha=3,
                          alpha_decay=0.35)
REFINE_ROUNDS, REFINE_SWEEPS = 3, 12
REFINE_CFG = continue_mu(SOLVER_CFG, SOLVER_CFG.al_iters,
                         al_iters=REFINE_ROUNDS, ilqr_iters=REFINE_SWEEPS,
                         ilqr_iters_later=REFINE_SWEEPS,
                         ilqr_iters_final=None)


def build_problem_numpy(batch: int, N: int = N,
                        solver_config: SolverConfig = SOLVER_CFG,
                        replicate_terminal_selfcol_bug: bool = True):
    """(mpc, x0_b (batch, 9), params) as host data: the perturbed
    manipulate-phase starts (the hard regime: every constraint family
    active) and the joint-space reference towards q_target;
    ``replicate_terminal_selfcol_bug=False`` builds the controller of the
    fixed terminal formulation."""
    sc = make_scenario(1, N=N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    mpc = MPCWholeBody(MobileManipulator(sc.dt), obstacles, hp, N=N,
                       solver_config=solver_config,
                       replicate_terminal_selfcol_bug=(
                           replicate_terminal_selfcol_bug))

    rng = np.random.default_rng(0)
    x0 = np.array([4.45, 5.06, -np.pi, 0, 0, 0, -np.pi / 4, -np.pi, np.pi])
    jitter = rng.standard_normal((batch, 9)) * np.array(
        [0.05, 0.05, 0.02, 0.01, 0.01, 0.01, 0.05, 0.05, 0.05])
    x0_b = np.clip(x0[None] + jitter, mpc.xlim[0], mpc.xlim[1])
    q_target = np.array([0.3, -1.0, 1.0])
    traj = np.linspace(x0, np.concatenate([x0[:6], q_target]), N + 1)
    params = dict(mpc.make_params(traj, np.zeros((N, 5))),
                  U_last=np.zeros((N, 5)))
    return mpc, x0_b, params


def build_problem(batch: int, device,
                  solver_config: SolverConfig = SOLVER_CFG,
                  replicate_terminal_selfcol_bug: bool = True, N: int = N):
    """(mpc, x0_b (batch, 9), U0_b (batch, N, 5), params) in float32 on
    ``device``, the kernels' dtype; ``solver_config`` is the stage-1
    schedule (``dataclasses.replace(SOLVER_CFG, use_fused_backward=False)``
    for the unfused backward path)."""
    mpc, x0_b, params = build_problem_numpy(
        batch, N=N, solver_config=solver_config,
        replicate_terminal_selfcol_bug=replicate_terminal_selfcol_bug)
    kw = dict(dtype=torch.float32, device=device)
    return (mpc, torch.as_tensor(x0_b, **kw), torch.zeros(batch, N, 5, **kw),
            params_from_numpy(params, device, torch.float32))

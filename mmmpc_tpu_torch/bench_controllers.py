"""Batched throughput of every ported MPC formulation (counterpart of
``scripts/bench_controllers.py``).

    python -m mmmpc_tpu_torch.bench_controllers [batch] [names...] [--device cpu] [--unfused]

One JSON row per formulation: controller, batch, horizon, solves_per_s
(over 10 solves after a warm-up, each batch synchronised), converged_frac,
max_violation and the device.  It runs on the card and raises when there is
no CUDA unless ``--device cpu`` is given.  ``--unfused`` solves every row
with ``use_fused_backward=False`` (the AL expansion in plain PyTorch, then
the Riccati sweep kernel) and adds ``"backward": "unfused"`` to each row.

``problems`` builds the JAX script's problems from numpy in the same
``default_rng(0)`` order (demo -> base -> arm -> endpoint -> qref), so every
row sees the JAX script's starts.  demo, base, arm and endpoint run the
generic fused kernels, qref the whole-body ones (at the JAX script's
unrefined schedule).  The JAX script's ``wholebody_moving_obs`` row is left
out: the whole-body kernels have no moving-obstacle tables yet.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from mmmpc_tpu_torch.controllers import (
    MPC, MPCBase, MPCManipulator3DoF, MPCWholeBody, MPCWholeBodyEndpoint,
)
from mmmpc_tpu_torch.models.mobile_manipulator import wholebody_fk
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import (
    Base, ManipulatorPanda3DoF, MobileManipulator, RobotDemo,
)
from mmmpc_tpu_torch.parallel.data_parallel import controller_batched_fn
from mmmpc_tpu_torch.utils.configs import SolverConfig, make_scenario
from mmmpc_tpu_torch.utils.convert import params_from_numpy

DT = 0.1
N = 20
REPS = 10
# the flagship production schedule; endpoint and qref use it
CFG = SolverConfig(al_iters=8, ilqr_iters=20, ilqr_iters_later=12,
                   cost_scale=1e5, constraint_tol=1e-3, n_alpha=3,
                   alpha_decay=0.35)
# the small formulations' costs are O(1): no cost scale
CFG_SMALL = SolverConfig(al_iters=8, ilqr_iters=20, ilqr_iters_later=12,
                         constraint_tol=1e-3, n_alpha=3, alpha_decay=0.35)
NAMES = ("demo_1d", "base_only", "arm_only", "wholebody_endpoint",
         "wholebody_qref")


def problems_numpy(batch):
    """Yield (name, mpc, x0_b (batch, nx), params) per formulation as host
    data, with ``params["U_last"]`` zero."""
    rng = np.random.default_rng(0)

    demo = MPC(RobotDemo(DT), N=N, solver_config=CFG_SMALL)
    x0d = np.stack([rng.uniform(-2, 2, batch), rng.uniform(-0.5, 0.5, batch)],
                   axis=1)
    trajd = np.linspace([0.0, 0.0], [3.0, 0.0], N + 1)
    yield "demo_1d", demo, x0d, demo.make_params(trajd, np.zeros((N, 1)))

    base = MPCBase(Base(DT), [Obstacles(1.2, 0.15, 0.3)], N=N,
                   solver_config=CFG_SMALL)
    x0b = rng.standard_normal((batch, 6)) * np.array(
        [0.1, 0.1, 0.05, 0.02, 0.02, 0.02])
    trajb = np.linspace(np.zeros(6), np.array([2.5, 0.3, 0, 0, 0, 0]), N + 1)
    yield "base_only", base, x0b, base.make_params(trajb, np.zeros((N, 2)))

    # wedge obstacle in front of the arm
    arm = MPCManipulator3DoF(
        ManipulatorPanda3DoF(DT),
        [np.array([[1 / np.sqrt(2), 0, 1 / np.sqrt(2)]]),
         np.array([[-1 / np.sqrt(2), 0, 1 / np.sqrt(2)]])],
        np.array([0.0, 0.0, 0.35]), N=N, solver_config=CFG_SMALL)
    q0 = np.array([0.3, -1.2, 1.2])
    x0a = np.clip(q0[None] + rng.standard_normal((batch, 3)) * 0.05,
                  arm.qlim[0] + 1e-3, arm.qlim[1] - 1e-3)
    x0a[:, 1] = np.minimum(x0a[:, 1], -1e-3)
    traja = np.linspace(q0, np.array([0.0, -0.6, 0.9]), N + 1)
    yield "arm_only", arm, x0a, dict(arm.make_params(traja, np.zeros((N, 3))),
                                     U_last=np.zeros((N, 3)))

    sc = make_scenario(1, N=N)
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    epc = MPCWholeBodyEndpoint(MobileManipulator(DT), obstacles, N=N,
                               solver_config=CFG)
    # feasible start inside the endpoint controller's tighter arm bounds
    x0e = np.zeros(9)
    x0e[6:] = [0.0, -0.6, 0.8]
    x0e_b = x0e[None] + rng.standard_normal((batch, 9)) * np.array(
        [0.05, 0.05, 0.02, 0.0, 0.0, 0.0, 0.03, 0.03, 0.03])
    x0e_b = np.clip(x0e_b, epc.xlim[0] + 1e-3, epc.xlim[1] - 1e-3)
    pose0 = wholebody_fk(torch.as_tensor(x0e))[0].numpy()
    traje = np.linspace(pose0, pose0 + np.array([0.3, 0.0, 0.1, 0.0]), N + 1)
    yield "wholebody_endpoint", epc, x0e_b, dict(
        epc.make_params(traje, np.zeros((N, 5))), U_last=np.zeros((N, 5)))

    x0w = np.array([4.45, 5.06, -np.pi, 0, 0, 0, -np.pi / 4, -np.pi, np.pi])
    x0w_b = x0w[None] + rng.standard_normal((batch, 9)) * np.array(
        [0.05, 0.05, 0.02, 0.01, 0.01, 0.01, 0.05, 0.05, 0.05])
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    qref = MPCWholeBody(MobileManipulator(DT), obstacles, hp, N=N,
                        solver_config=CFG)
    trajq = np.linspace(x0w, np.concatenate([x0w[:6], [0.3, -1.0, 1.0]]),
                        N + 1)
    yield "wholebody_qref", qref, np.clip(x0w_b, qref.xlim[0], qref.xlim[1]), \
        dict(qref.make_params(trajq, np.zeros((N, 5))),
             U_last=np.zeros((N, 5)))


def problems(batch, device="cuda"):
    """Yield (name, mpc, x0_b, U0_b, params) per formulation, in float32 on
    ``device`` (U0_b zero)."""
    kw = dict(dtype=torch.float32, device=device)
    for name, mpc, x0_b, params in problems_numpy(batch):
        yield (name, mpc, torch.as_tensor(x0_b, **kw),
               torch.zeros(batch, N, mpc.NU, **kw),
               params_from_numpy(params, device, torch.float32))


def bench_one(name, mpc, x0_b, U0_b, params, reps=REPS):
    """One row: a warm-up solve, then ``reps`` solves timed together."""
    run = controller_batched_fn(mpc)
    sync = (torch.cuda.synchronize if x0_b.device.type == "cuda"
            else lambda: None)
    run(x0_b, U0_b, params)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        res, stats = run(x0_b, U0_b, params)
    sync()
    dt = time.perf_counter() - t0
    batch = x0_b.shape[0]
    return {
        "controller": name, "batch": batch, "horizon": N,
        "solves_per_s": round(batch * reps / dt, 1),
        "converged_frac": round(float(stats.n_converged)
                                / float(stats.n_solved), 4),
        "max_violation": float(stats.max_violation),
        "device": (torch.cuda.get_device_name(x0_b.device)
                   if x0_b.device.type == "cuda" else "cpu"),
    }


def main(argv):
    device = "cuda"
    unfused = "--unfused" in argv
    argv = [a for a in argv if a != "--unfused"]
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu to run the "
                           "plain versions on the CPU)")
    batch = int(argv[0]) if argv else 4096
    names = set(argv[1:])
    for name, mpc, x0_b, U0_b, params in problems(batch, device):
        if names and name not in names:
            continue
        if unfused:
            mpc.solver_config = dataclasses.replace(mpc.solver_config,
                                                    use_fused_backward=False)
        row = bench_one(name, mpc, x0_b, U0_b, params)
        if unfused:
            row["backward"] = "unfused"
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

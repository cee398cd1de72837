"""Batched task state machine: thousands of full move -> press-button tasks
in one loop on the device (counterpart of
``mmmpc_tpu/sim/batch_task_engine.py``).

The reference runs its task state machine on the host, one scenario per
process (interface_wholebody_qref.py:146-228): move -> approach (inject the
terminal position equality) -> rotate (weight switch) -> move finish (IK +
joint-space plan + weight switch) -> manipulate -> manipulate finish.  Here
the whole fleet's tasks advance together, a tick at a time:

- the phase is per-robot integer data, and everything that depends on it
  (the weight row, the terminal-equality mask, the local reference) is a
  batched select over it;
- the IK at the rotate -> manipulate switch is the batched projected
  Levenberg-Marquardt (``models/arm.py::arm_ik``), run each tick for every
  robot and used only by those that switch;
- one batched solve a tick, with per-robot X_ref, U_last, Q, P and eq_mask
  (kernels A and B read them per scenario); the inputs and the multipliers
  carry over from tick to tick, robot by robot.

Every tick is batched tensor ops on the device: no loop over robots, and
nothing inside a tick waits for the device (no host data copied to it, no
value read back).

Phases: 0 move, 1 approach, 2 rotate, 3 manipulate, 4 done.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mmmpc_tpu_torch.models.arm import arm_ik
from mmmpc_tpu_torch.models.mobile_manipulator import wholebody_fk
from mmmpc_tpu_torch.sim.batch_engine import post_solve, zero_multipliers
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.utils.configs import (
    BASELINK2JOINT1_X, BASELINK2JOINT1_Z, SolverConfig, WORKING_RADIUS,
)
from mmmpc_tpu_torch.utils.convert import device_constant
from mmmpc_tpu_torch.utils.math import angle_diff

PHASE_MOVE, PHASE_APPROACH, PHASE_ROTATE, PHASE_MANIP, PHASE_DONE = range(5)

# the weight schedule (reference interface:175-185, 204-216): row 0 for
# move / approach, 1 for rotate, 2 for manipulate.  Float64 here; a solve
# takes it in the dtype of its inputs.
W_TABLE = np.stack([
    5.0 * np.diag([5, 5, 0, 0, 0, 1, 1, 1, 1.0]),
    np.diag([5, 5, 5, 0, 0, 1, 1, 1, 1.0]),
    np.diag([500, 500, 500, 0, 0, 1, 1, 1, 1.0]),
])


class TaskRolloutLog(NamedTuple):
    X: torch.Tensor          # (B, T+1, nx)
    U: torch.Tensor          # (B, T, nu) applied commands
    phase: torch.Tensor      # (B, T) int32 phase AFTER each tick
    cost: torch.Tensor       # (B, T)
    violation: torch.Tensor  # (B, T)
    done_at: torch.Tensor    # (B,) tick of task completion (T if never)
    fallback: torch.Tensor   # (B, T) bool: the tick used the shifted inputs


def stand_off_target(x_start, global_pose_target):
    """Each robot's base target in front of its button (interface:24-32):
    x_start (..., 9), global_pose_target (..., 4) -> (..., 9)."""
    gx, gy, gpsi = (global_pose_target[..., 0], global_pose_target[..., 1],
                    global_pose_target[..., 3])
    zeros = torch.zeros_like(gx)
    return torch.stack([
        gx - WORKING_RADIUS * torch.cos(gpsi),
        gy - WORKING_RADIUS * torch.sin(gpsi),
        gpsi, zeros, zeros, zeros,
        x_start[..., 6], x_start[..., 7], x_start[..., 8],
    ], dim=-1)


def _window(traj, x, cols, N):
    """Each robot's N+1 rows of ``traj`` (B, T+1, nx) from its nearest
    point to x (B, nx) over the state components ``cols`` (a slice)."""
    d = traj[..., cols] - x[:, None, cols]
    mi = torch.argmin(torch.sum(d * d, dim=-1), dim=-1)
    rows = torch.clamp(mi[:, None] + torch.arange(N + 1, device=x.device),
                       max=traj.shape[1] - 1)
    return torch.take_along_dim(traj, rows[..., None], dim=1)


def make_batch_task_loop(ocp, cfg: SolverConfig, shared_params,
                         t_move: float, t_manipulate: float, dt: float,
                         n_ticks: int, ik_iters: int = 60,
                         rotate_exit_pos_tol: float = 0.01,
                         rotate_exit_yaw_tol: float = 0.5 * np.pi / 180.0,
                         aim_at_button: bool = False,
                         stuck_ticks: int = 25,
                         host_parity_solver: bool = False):
    """Build run(x_start_b, global_pose_target_b, carry0=None) ->
    (TaskRolloutLog, carry).

    ocp: the whole-body qref OCP (``MPCWholeBody(...).ocp``); shared_params:
    the controller's params as tensors on the device, without X_ref / U_ref
    / U_last / Q / P / eq_mask, which the state machine sets per robot each
    tick.

    Straggler recovery (off by default: the host loop's behaviour): part of
    a joint-jittered fleet stalls in the rotate phase, its base settled 1-2.5
    cm off the stand-off point, past the reference's 1 cm / 0.5 deg exit
    tolerances (interface_wholebody_qref.py:192-197), as the host loop
    stalls from the same states.  Relaxing ``rotate_exit_pos_tol`` alone is
    not safe with the parity yaw target: the arm moves in the base's x-z
    plane, so a base displaced sideways leaves a lateral miss that the 1 cm
    press check never passes.  The recovery is ``aim_at_button=True`` with
    a relaxed position tolerance: in the rotate phase, near the stand-off
    point, the yaw target (reference and exit check) is the button's
    bearing from the robot's actual position, the exit also asks the button
    to lie 0.55-0.68 m away, and with ``stuck_ticks`` a robot whose end
    effector stops closing in for that many ticks drops back to rotate (and
    one that circles in rotate for three times as many to approach).

    ``host_parity_solver=True`` pinned the JAX solve to its vmapped
    per-scenario lowering, which the port does not have: it raises.
    """
    if host_parity_solver:
        raise ValueError("host_parity_solver: the port has no vmapped "
                         "per-scenario solve; the fleet runs the batched "
                         "solve on kernels A and B")
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    T_move = int(round(t_move / dt))
    T_man = int(round(t_manipulate / dt))

    def fsm_pre(x, phase, traj_move, traj_man, gpt, x_target, aux, Wtab):
        """Each robot's transitions and references, before the solve.
        Returns the new (phase, traj_man, aux) and the tick's per-robot
        X_ref (B, N+1, nx), weight rows (B, nx, nx) and eq_mask (B,)."""
        best_err, stale, rot_ticks = aux
        # ---- transitions (the host loop's order, interface:152-213)
        in_move = phase == PHASE_MOVE
        in_appr = phase == PHASE_APPROACH
        in_rot = phase == PHASE_ROTATE
        in_man = phase == PHASE_MANIP
        near2 = ((torch.abs(x[:, 0] - x_target[:, 0]) <= 2.0)
                 & (torch.abs(x[:, 1] - x_target[:, 1]) <= 2.0))
        pos_err = torch.sqrt((x[:, 0] - x_target[:, 0]) ** 2
                             + (x[:, 1] - x_target[:, 1]) ** 2)
        phase = torch.where(in_move & near2, PHASE_APPROACH, phase)
        phase = torch.where((in_move | in_appr) & (pos_err <= 0.2),
                            PHASE_ROTATE, phase)
        yaw_tgt = x_target[:, 2]
        exit_pos_ok = pos_err <= rotate_exit_pos_tol
        if aim_at_button:
            # re-aim only in rotate and near the stand-off point
            bearing = torch.atan2(gpt[:, 1] - x[:, 1], gpt[:, 0] - x[:, 0])
            near = pos_err <= 3.0 * rotate_exit_pos_tol
            yaw_tgt = torch.where(in_rot & near, bearing, yaw_tgt)
            # the button in the IK-reachable, collision-safe annulus
            range_b = torch.sqrt((gpt[:, 0] - x[:, 0]) ** 2
                                 + (gpt[:, 1] - x[:, 1]) ** 2)
            exit_pos_ok = exit_pos_ok & (range_b >= 0.55) & (range_b <= 0.68)
        yaw_ok = torch.abs(angle_diff(x[:, 2], yaw_tgt)) <= rotate_exit_yaw_tol
        to_manip = in_rot & yaw_ok & exit_pos_ok
        phase = torch.where(to_manip, PHASE_MANIP, phase)

        # move finish: IK to the button-relative pose, a joint-space
        # linspace (interface:188-216); used on the switching tick only
        local_target = torch.stack([
            torch.sqrt((gpt[:, 0] - x[:, 0]) ** 2 + (gpt[:, 1] - x[:, 1]) ** 2)
            - BASELINK2JOINT1_X,
            torch.zeros_like(x[:, 0]),
            gpt[:, 2] - BASELINK2JOINT1_Z,
        ], dim=-1)
        q_goal = arm_ik(x[:, 6:9], local_target, iters=ik_iters)
        x_goal = torch.cat([x[:, :6], q_goal], dim=-1)
        frac = torch.linspace(0.0, 1.0, T_man + 1, dtype=x.dtype,
                              device=x.device)
        traj_new = x[:, None] + (x_goal - x)[:, None] * frac[None, :, None]
        traj_man = torch.where(to_manip[:, None, None], traj_new, traj_man)

        ee = wholebody_fk(x)[0][:, :3]
        ee_err = torch.linalg.norm(ee - gpt[:, :3], dim=-1)
        done = in_man & (ee_err <= 0.01)
        phase = torch.where(done, PHASE_DONE, phase)

        if aim_at_button and stuck_ticks:
            # manipulate-phase stuck detector: no improvement of the end
            # effector's error for stuck_ticks ticks drops back to rotate,
            # whose re-aim and next switch re-plan from the current joints
            improved = ee_err < best_err - 1e-4
            stale = torch.where(in_man & ~improved & ~done, stale + 1, 0)
            re_approach = in_man & (stale >= stuck_ticks) & ~done
            phase = torch.where(re_approach, PHASE_ROTATE, phase)
            best_err = torch.where(
                in_man & improved, ee_err,
                torch.where(re_approach | ~in_man,
                            torch.full_like(best_err, 1e9), best_err))
            stale = torch.where(re_approach, 0, stale)
            # rotate-orbit escape: after 3x the stuck budget in rotate, back
            # to approach, whose weight row has no yaw term
            still_rot = phase == PHASE_ROTATE
            rot_ticks = torch.where(still_rot, rot_ticks + 1, 0)
            orbit = still_rot & (rot_ticks >= 3 * stuck_ticks)
            phase = torch.where(orbit, PHASE_APPROACH, phase)
            rot_ticks = torch.where(orbit, 0, rot_ticks)
        aux = (best_err, stale, rot_ticks)

        # ---- phase-dependent references
        ref_move = _window(traj_move, x, slice(0, 2), N)
        # the pose tile with continuous yaw (runtime/reference.local_ref_pose)
        pose = torch.cat([x_target[:, :2],
                          (x[:, 2] + angle_diff(yaw_tgt, x[:, 2]))[:, None],
                          x_target[:, 3:]], dim=-1)
        ref_pose = pose[:, None].expand(-1, N + 1, -1)
        ref_man = _window(traj_man, x, slice(6, 9), N)
        ph = phase[:, None, None]
        X_ref = torch.where(ph == PHASE_MOVE, ref_move,
                            torch.where(ph >= PHASE_MANIP, ref_man, ref_pose))
        widx = torch.where(phase >= PHASE_MANIP, 2,
                           torch.where(phase == PHASE_ROTATE, 1, 0))
        eq_mask = (phase >= PHASE_APPROACH).to(x.dtype)
        return phase, traj_man, aux, X_ref, Wtab[widx], eq_mask

    def run(x_start_b, global_pose_target_b, carry0=None, tick_hook=None):
        """One n_ticks segment of the fleet's tasks.

        carry0=None starts afresh; the carry a segment returns continues
        it (the fleet runs in bounded segments, and the carry is its
        checkpoint).  Returns (TaskRolloutLog of this segment, carry).
        ``tick_hook()``, if given, is called after each tick's ops are
        issued (a timer may record an event there; it must not wait).

        Carry: the 6-tuple (x, U, lams, phase, traj_man, aux), aux the
        stuck detectors' (best_err, stale, rot_ticks); a legacy 5-tuple
        without aux is upgraded with a fresh one.
        """
        B = x_start_b.shape[0]
        dtype, dev = x_start_b.dtype, x_start_b.device
        gpt = global_pose_target_b
        Wtab = device_constant(W_TABLE, dtype, dev)
        x_target_b = stand_off_target(x_start_b, gpt)
        steps = torch.linspace(0.0, 1.0, T_move + 1, dtype=dtype, device=dev)
        traj_move_b = (x_start_b[:, None]
                       + (x_target_b - x_start_b)[:, None] * steps[None, :,
                                                                   None])
        fresh_aux = (torch.full((B,), 1e9, dtype=dtype, device=dev),
                     torch.zeros(B, dtype=torch.int32, device=dev),
                     torch.zeros(B, dtype=torch.int32, device=dev))
        if carry0 is None:
            carry0 = (x_start_b, x_start_b.new_zeros(B, N, nu),
                      zero_multipliers(ocp, shared_params, B, x_start_b),
                      torch.full((B,), PHASE_MOVE, dtype=torch.int32,
                                 device=dev),
                      x_start_b[:, None].expand(-1, T_man + 1, -1).clone(),
                      fresh_aux)
        elif len(carry0) == 5:
            carry0 = (*carry0, fresh_aux)
        x, U, lams, phase, traj_man, aux = carry0
        U_ref = x_start_b.new_zeros(N, nu)
        Xs, Us, phases, costs, viols, fbs = [], [], [], [], [], []
        for _ in range(n_ticks):
            phase, traj_man, aux, X_ref, QP, eq_mask = fsm_pre(
                x, phase, traj_move_b, traj_man, gpt, x_target_b, aux, Wtab)
            QP_bl = QP.permute(1, 2, 0)
            params_b = dict(shared_params, X_ref=X_ref.permute(1, 2, 0),
                            U_ref=U_ref, U_last=U.permute(1, 2, 0), Q=QP_bl,
                            P=QP_bl, eq_mask=eq_mask)
            res = al_ilqr_solve_batched(ocp, x, U, params_b, cfg,
                                        lam0_b=lams)
            U, lams, ok = post_solve(U, lams, res, 1.0)
            # a finished robot holds its state (the reference ends its run)
            is_done = (phase == PHASE_DONE)[:, None]
            u0 = torch.where(is_done, 0.0, U[:, 0])
            x = torch.where(is_done, x, ocp.dynamics(x, U[:, 0]))
            Xs.append(x)
            Us.append(u0)
            phases.append(phase)
            costs.append(res.cost)
            viols.append(res.max_violation)
            fbs.append(~ok)
            if tick_hook is not None:
                tick_hook()
        carry = (x, U, lams, phase, traj_man, aux)
        phase_t = torch.stack(phases, dim=1)                   # (B, T)
        done_mask = phase_t == PHASE_DONE
        done_at = torch.where(done_mask.any(dim=1),
                              done_mask.to(torch.int32).argmax(dim=1),
                              n_ticks)
        return TaskRolloutLog(
            X=torch.cat([carry0[0][:, None], torch.stack(Xs, dim=1)], dim=1),
            U=torch.stack(Us, dim=1), phase=phase_t,
            cost=torch.stack(costs, dim=1),
            violation=torch.stack(viols, dim=1), done_at=done_at,
            fallback=torch.stack(fbs, dim=1)), carry

    return run

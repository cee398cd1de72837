"""Closed-loop orchestrator: timers, observation, task state machine,
actuation, logs (counterpart of ``mmmpc_tpu/runtime/interface.py``).

- pseudo-timer: one MPC solve every int(dt / sim_dt) sim steps (10:1 by
  default);
- task phases 'move' -> 'approach' -> 'rotate' -> 'move finish' ->
  'manipulate' -> 'manipulate finish', with the reference's thresholds,
  weight switches and the injected terminal position equality;
- global planners are linspace interpolants; the manipulate plan runs the
  arm's Levenberg-Marquardt IK (``models/arm.py::arm_ik``);
- observation / actuation keep the simulator's sign and frame conventions;
- one structured metrics record per tick.

Everything here runs on the host in float64 numpy: the controller's
``solve`` is the one call that reaches the device.  physical_sim=False
replays the reference's model-only plant (current_state = f(x, u) through
the robot model on the host); physical_sim=True steps the kinematic plant
(``sim/kinematic_plant.py``) through the observation / actuation path.
The ``plot*`` methods draw the logs with matplotlib, imported only when a
plot is drawn.
"""

from __future__ import annotations

import copy

import numpy as np

import mmmpc_tpu_torch.sim.kinematic_plant as sim
from mmmpc_tpu_torch.runtime.metrics import MetricsLog
from mmmpc_tpu_torch.runtime.reference import local_ref_pose, local_ref_traj
from mmmpc_tpu_torch.utils.configs import (
    BASELINK2JOINT1_X, BASELINK2JOINT1_Z, WORKING_RADIUS,
)
from mmmpc_tpu_torch.utils.math import angle_diff


class Interface:
    def __init__(self, dt, t_move, t_manipulate, x_start, global_pose_target,
                 controller, physical_sim=False, sim_dt=0.01,
                 max_mpc_steps=2000):
        self.dt = dt
        self.desired_t_move = t_move
        self.desired_t_manipulate = t_manipulate
        self.global_pose_target = np.asarray(global_pose_target, dtype=float)
        self.local_pose_target = None
        self.working_radius = WORKING_RADIUS
        # stand-off base target in front of the button (reference :24-32)
        self.x_target = np.array([
            self.global_pose_target[0]
            - self.working_radius * np.cos(self.global_pose_target[3]),
            self.global_pose_target[1]
            - self.working_radius * np.sin(self.global_pose_target[3]),
            self.global_pose_target[3],
            0, 0, 0,
            x_start[6], x_start[7], x_start[8],
        ])
        self.x_start = np.asarray(x_start, dtype=float)
        self.controller = controller
        self.physical_sim = physical_sim
        self.max_mpc_steps = max_mpc_steps

        self.manipulator_pose_log = []
        self.endpoint_relative_pos_log = []
        self.x_log = []
        self.u_log = []
        self.metrics = MetricsLog()

        self.sim_dt = sim_dt
        self.timer_counter = 0
        self.mpc_step_counter = 0
        self.is_active = False
        self.traj_ref = None
        self.u_ref = None
        self.command = np.zeros(controller.ocp.nu)

        if self.physical_sim:
            # 12-dim sim state [x, y, yaw, joint1..7, fingers]
            init_state = np.array([0.0, 0.0, 0.0, np.pi, 0, 0, 0, 0, 0,
                                   0, 0, 0])
            self.idx_3dof = sim.IDX_3DOF_STATE
            self.idx_base = sim.IDX_BASE
            init_state[self.idx_base] = self.x_start[: len(self.idx_base)]
            init_state[self.idx_3dof] = self.x_start[-len(self.idx_3dof):]
            self.env, self.ob = sim.setup_environment(
                render=False, reconfigure_camera=False, obstacles=True,
                mode="vel", initial_state=init_state, dt=self.sim_dt)
            self.vel_command_base = np.zeros(2)

    # ------------------------------------------------------------- loop
    def run(self):
        self.current_state = (self.x_start if not self.physical_sim else None)
        self.task_flag = "move"
        self.is_active = True
        self.mpc_step_counter = 0
        while self.is_active and self.mpc_step_counter < self.max_mpc_steps:
            self.pseudoTimer()

    def pseudoTimer(self):
        """One sim tick; fires the MPC callback every dt/sim_dt ticks
        (reference interface:84-98)."""
        if int(self.dt / self.sim_dt) <= 1:
            self.timerCallback()
            return
        if self.timer_counter == 0:
            self.timerCallback()
        else:
            self.actuate()
        self.timer_counter += 1
        if self.timer_counter == int(self.dt / self.sim_dt):
            self.timer_counter = 0

    def timerCallback(self):
        self.mpc_step_counter += 1

        if self.physical_sim:
            self.observationCallback()
        self.x_log.append(copy.deepcopy(self.current_state))
        pose_ee, j2, j3 = self.controller.robot_model.forward_tranformation(
            self.current_state)
        self.current_joints_pose = np.concatenate(
            [np.asarray(pose_ee), np.asarray(j2), np.asarray(j3)])
        self.manipulator_pose_log.append(self.current_joints_pose.copy())
        self.endpoint_relative_pos_log.append(np.asarray(
            self.controller.robot_model.manipulator.forward_tranformation(
                self.current_state[-3:])[0]))

        self.is_active = self.stateMachineUpdate()
        if not self.is_active:
            return

        self.metrics.start_solve()
        self.command = self.controller.solve(
            self.current_state, self.local_traj_ref, self.local_u_ref)
        self.metrics.end_solve(self.mpc_step_counter, self.task_flag,
                               self.controller.last_result)
        self.u_log.append(np.asarray(self.command).copy())

        if self.physical_sim:
            self.actuate()
        else:
            # model-only plant (reference interface:142-143)
            self.current_state = np.asarray(
                self.controller.robot_model.f_kinematics(
                    self.current_state, self.command))

    # -------------------------------------------------------------- FSM
    def stateMachineUpdate(self):
        robot_status = True
        if self.task_flag == "move" and self.traj_ref is None:
            self.globalPlan2D()

        if self.task_flag in ("move", "approach"):
            if (abs(self.current_state[0] - self.traj_ref[-1, 0]) <= 2
                    and abs(self.current_state[1] - self.traj_ref[-1, 1]) <= 2
                    and self.task_flag == "move"):
                self.task_flag = "approach"
                # the reference appends a hard constraint to the live Opti
                # (interface:167); here it's a runtime mask flip
                self.controller.add_terminal_position_constraint()

            if (np.linalg.norm(self.current_state[0:2]
                               - self.traj_ref[-1, 0:2]) <= 0.2):
                self.task_flag = "rotate"
                self.controller.setWeight(
                    P=np.diag([5, 5, 5, 0, 0, 1, 1, 1, 1.0]),
                    Q=np.diag([5, 5, 5, 0, 0, 1, 1, 1, 1.0]))
            else:
                if self.task_flag == "move":
                    self.calcLocalRefTraj([0, 1])
                else:
                    self.calcLocalRefPose()

        if self.task_flag == "rotate":
            if (abs(float(angle_diff(self.current_state[2],
                                     self.traj_ref[-1, 2])))
                    <= 0.5 * np.pi / 180
                    and np.linalg.norm(self.current_state[0:2]
                                       - self.traj_ref[-1, 0:2]) <= 0.01):
                self.task_flag = "move finish"
            else:
                self.calcLocalRefPose()

        if self.task_flag == "move finish":
            self.task_flag = "manipulate"
            self.local_pose_target = np.array([
                np.sqrt((self.global_pose_target[0]
                         - self.current_state[0]) ** 2
                        + (self.global_pose_target[1]
                           - self.current_state[1]) ** 2)
                - BASELINK2JOINT1_X,   # +0.007 in the reference (:207)
                0.0,
                self.global_pose_target[2] - BASELINK2JOINT1_Z,
            ])
            self.globalPlanManipulator()
            self.controller.setWeight(
                P=np.diag([500, 500, 500, 0, 0, 1, 1, 1, 1.0]),
                Q=np.diag([500, 500, 500, 0, 0, 1, 1, 1, 1.0]))

        if self.task_flag == "manipulate":
            if (np.linalg.norm(self.current_joints_pose[:3]
                               - self.global_pose_target[:3]) <= 0.01):
                self.task_flag = "manipulate finish"
                robot_status = False
            else:
                self.calcLocalRefTraj([6, 7, 8])

        return robot_status

    # ---------------------------------------------------------- planners
    def globalPlan2D(self):
        """Straight-line joint-space plan for the move phase
        (reference interface:247-266)."""
        traj_length = int(self.desired_t_move / self.dt)
        self.traj_ref = np.linspace(self.x_start, self.x_target,
                                    traj_length + 1)
        self.u_ref = np.zeros((traj_length, self.controller.ocp.nu))

    def globalPlanManipulator(self):
        """IK to the local pose target, then linspace in joint space
        (reference interface:269-295; the IK is ``models/arm.py::arm_ik``
        instead of an IPOPT call)."""
        traj_length = int(self.desired_t_manipulate / self.dt)
        q_goal = np.asarray(
            self.controller.robot_model.manipulator.inverse_transformation(
                self.current_state[-3:], self.local_pose_target))
        x_target = np.hstack((self.current_state[:6], q_goal))
        self.traj_ref = np.linspace(self.current_state, x_target,
                                    traj_length + 1)
        self.u_ref = np.zeros((traj_length, self.controller.ocp.nu))

    def globalPlan1D(self):
        """1-D position linspace (reference interface:231-244)."""
        traj_length = int(self.desired_t_move / self.dt)
        self.traj_ref = np.stack([
            np.linspace(self.x_start[0], self.x_target[0], traj_length + 1),
            np.zeros(traj_length + 1),
        ], axis=1)
        self.u_ref = np.zeros((traj_length, 1))

    def globalPlan3D(self):
        """End-effector pose linspace for the endpoint-reference controller
        (reference interface:297-309)."""
        traj_length = int(self.desired_t_move / self.dt)
        pose_start = np.asarray(
            self.controller.robot_model.forward_tranformation(
                self.x_start)[0])
        self.traj_ref = np.linspace(pose_start, self.global_pose_target,
                                    traj_length + 1)
        self.u_ref = np.zeros((traj_length, self.controller.ocp.nu))

    # ------------------------------------------------------ finish checks
    def checkFinish1D(self):
        """Reference interface:312-318."""
        if (abs(self.current_state[0] - self.traj_ref[-1, 0]) <= 0.5
                and abs(self.current_state[1] - self.u_ref[-1, 0]) <= 1e-2):
            self.task_flag = "finish"

    def checkFinish2D(self):
        """Reference interface:321-330."""
        threshold = 0.1
        if (abs(self.current_state[0] - self.traj_ref[-1, 0]) <= threshold
                and abs(self.current_state[1]
                        - self.traj_ref[-1, 1]) <= threshold):
            self.task_flag = "finish"

    def checkFinishManipulator(self):
        """Reference interface:333-338."""
        if (np.linalg.norm(self.current_joints_pose[:3]
                           - self.local_pose_target) <= 0.02):
            self.task_flag = "finish"

    def checkFinish3D(self):
        """Reference interface:340-351 (endpoint-pose task variant)."""
        if (np.linalg.norm(self.current_joints_pose[:4]
                           - self.global_pose_target) <= 1
                and self.task_flag == "move"):
            self.task_flag = "approach"
        if (np.linalg.norm(self.current_joints_pose[:4]
                           - self.global_pose_target) <= 0.1):
            self.task_flag = "finish"

    # --------------------------------------------------------- references
    def calcLocalRefTraj(self, distance_index, different_space=False):
        self.local_traj_ref, self.local_u_ref = local_ref_traj(
            self.traj_ref, self.u_ref, self.current_state, distance_index,
            self.controller.N,
            current_pose=(self.current_joints_pose
                          if different_space else None),
            different_space=different_space)

    def calcLocalRefPose(self):
        self.local_traj_ref, self.local_u_ref = local_ref_pose(
            self.traj_ref, self.u_ref, self.current_state[2],
            self.controller.N, angle_diff)

    # --------------------------------------------------- sim I/O adapters
    def observationCallback(self):
        """Sim observation -> MPC state, undoing the simulator's sign and
        frame conventions (reference interface:413-441)."""
        ob = self.ob[0] if isinstance(self.ob, tuple) else self.ob
        js = ob["robot_0"]["joint_state"]
        self.current_state = np.hstack([
            js["position"][self.idx_base],
            js["velocity"][self.idx_base],
            js["position"][self.idx_3dof],
        ])
        self.current_state[3] *= -1
        self.current_state[4] *= -1
        offset = sim.CENTER_OFFSET
        self.current_state[0] += offset * np.cos(self.current_state[2])
        self.current_state[1] += offset * np.sin(self.current_state[2])

    def actuate(self):
        """Integrate acceleration commands into velocity commands and step
        the sim (reference interface:467-478; V's sign is reversed)."""
        if not self.physical_sim:
            return
        action = np.zeros(self.env.n())
        self.vel_command_base += (self.sim_dt * np.asarray(self.command[0:2])
                                  * np.array([-1.0, 1.0]))
        action[[0, 1]] = self.vel_command_base
        action[sim.IDX_3DOF_ACTION] = np.asarray(self.command[2:])
        self.ob = sim.run_step(self.env, action)

    def actuateBase(self):
        if not self.physical_sim:
            return
        action = np.zeros(self.env.n())
        self.vel_command_base += self.sim_dt * np.asarray(self.command)
        action[[0, 1]] = self.vel_command_base
        self.ob = sim.run_step(self.env, action)

    def actuate3DoFManipulator(self, command=None):
        if not self.physical_sim:
            return
        action = np.zeros(self.env.n())
        action[sim.IDX_3DOF_ACTION] = np.asarray(self.command)
        self.ob = sim.run_step(self.env, action)

    # ------------------------------------------------------------- plots
    def _plt(self):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt

    def plot1D(self, save_path=None):
        """Reference interface:480-510 (the 1-D demo's p/v/a panels)."""
        plt = self._plt()
        x_log = np.asarray(self.x_log)
        u_log = np.asarray(self.u_log)
        t = np.arange(len(x_log))
        fig, axes = plt.subplots(4, 1, figsize=(8, 9))
        axes[0].plot(t, x_log[:, 0]); axes[0].set_ylabel("p")
        axes[1].plot(t, x_log[:, 1]); axes[1].set_ylabel("v")
        axes[2].plot(t[: len(u_log)], u_log[:, 0]); axes[2].set_ylabel("a")
        axes[3].plot(np.arange(self.traj_ref.shape[0]), self.traj_ref[:, 0])
        axes[3].set_ylabel("p ref")
        for ax in axes:
            ax.grid(True)
        if save_path:
            fig.savefig(save_path)
        plt.close(fig)

    def plot2D(self, save_path=None):
        plt = self._plt()
        x_log = np.asarray(self.x_log)
        u_log = np.asarray(self.u_log)
        t = np.arange(len(x_log))
        fig, axes = plt.subplots(3, 2, figsize=(11, 8))
        for i, (idx, name) in enumerate(
                [(0, "x"), (1, "y"), (2, "psi"),
                 (3, "dx"), (4, "dy"), (5, "dpsi")]):
            ax = axes[i % 3, i // 3]
            ax.plot(t, x_log[:, idx])
            ax.set_ylabel(name)
            ax.grid(True)
        if save_path:
            fig.savefig(save_path)
        plt.close(fig)
        fig2, ax = plt.subplots(figsize=(7, 7))
        ax.plot(x_log[:, 0], x_log[:, 1], label="actual position")
        ref_line = np.linspace(self.x_start[:2], self.x_target[:2])
        ax.plot(ref_line[:, 0], ref_line[:, 1], label="reference position")
        for obs in getattr(self.controller, "obstacle_list", []):
            ax.add_artist(plt.Circle((obs.x, obs.y), obs.radius,
                                     color="green", fill=False))
        ax.set_aspect("equal", adjustable="box")
        ax.legend()
        ax.grid(True)
        if save_path:
            fig2.savefig(str(save_path).replace(".png", "_xy.png"))
        plt.close(fig2)
        return u_log

    def plotManipulator(self, is_mobile=False, save_path=None):
        plt = self._plt()
        x_log = np.asarray(self.x_log)
        pose_log = np.asarray(self.manipulator_pose_log)
        t = np.arange(len(x_log))
        off = 6 if is_mobile else 0
        fig, axes = plt.subplots(1, 2, figsize=(11, 4))
        for j, name in enumerate(["q1", "q2", "q3"]):
            axes[0].plot(t, x_log[:, j + off], label=name)
        axes[0].legend(); axes[0].grid(True)
        axes[1].plot(t, pose_log[:, 0], label="ee x")
        axes[1].plot(t, pose_log[:, 2], label="ee z")
        axes[1].legend(); axes[1].grid(True)
        if save_path:
            fig.savefig(save_path)
        plt.close(fig)

    def plotEndpoint(self, save_path=None):
        plt = self._plt()
        xs = [p[0] for p in self.endpoint_relative_pos_log]
        zs = [p[2] for p in self.endpoint_relative_pos_log]
        fig, ax = plt.subplots(figsize=(7, 7))
        ax.plot(xs, zs, marker="o", linewidth=2, label="endpoint trajectory")
        if self.local_pose_target is not None:
            ax.scatter([self.local_pose_target[0]],
                       [self.local_pose_target[2]], color="red", marker="^",
                       s=100, label="target")
        ax.legend(); ax.grid(True)
        if save_path:
            fig.savefig(save_path)
        plt.close(fig)

    def plot3D(self, save_dir=None, animate=False):
        """2-D panel family (reference interface:711-716) plus a genuine 3-D
        scene rendering (``runtime/scene3d.py``) and, with ``animate``, the
        GIF animation artifact the reference publishes."""
        prefix = str(save_dir) + "/" if save_dir else ""
        self.plot2D(save_path=f"{prefix}base.png" if save_dir else None)
        self.plotManipulator(
            is_mobile=True,
            save_path=f"{prefix}manipulator.png" if save_dir else None)
        self.plotEndpoint(
            save_path=f"{prefix}endpoint.png" if save_dir else None)
        if save_dir:
            from mmmpc_tpu_torch.runtime.scene3d import (
                scene3d_animation, scene3d_plot,
            )
            hp = getattr(self.controller, "obstacle_manipulation_list", [])
            scene3d_plot(
                np.asarray(self.x_log),
                obstacles=getattr(self.controller, "obstacle_list", []),
                halfplanes=hp, target=self.global_pose_target[:3],
                save_path=f"{prefix}scene3d.png")
            if animate:
                scene3d_animation(
                    np.asarray(self.x_log),
                    obstacles=getattr(self.controller, "obstacle_list", []),
                    halfplanes=hp, target=self.global_pose_target[:3],
                    save_path=f"{prefix}scene3d.gif")

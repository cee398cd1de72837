"""Kinematic plant: the simulated world of the closed loop (counterpart of
``mmmpc_tpu/sim/kinematic_plant.py``).

It is not the controller: it runs on the host, one sim step of ``dt``
(0.01 s by default), in float64 -- ``KinematicPlant`` in numpy, as the JAX
package's closed loop uses it, and the pure functions ``plant_step`` /
``plant_observation`` on float64 tensors.  A velocity-driven unicycle plus
a joint integrator with the interface contract of the reference's PyBullet
adapter:

- action layout (11,): [v, w, joint1..joint7, finger_l, finger_r]
  (only v, w and joints 3/5/7 are used);
- the sim drives the base with the REVERSED forward velocity, and its
  observed dx, dy are negated: the reference's observation / actuation
  code undoes both, so both sign quirks are kept;
- observations expose the geometric centre, ``CENTER_OFFSET`` = 0.157 m
  behind the base control point along the heading, while the unicycle
  integrates the control point (the wheel-axle point the MPC's model
  describes);
- the observation dict has the urdfenvs shape
  ob["robot_0"]["joint_state"]["position" | "velocity"], both (12,):
  [x, y, yaw, joint1..7, finger_l, finger_r].
"""

from __future__ import annotations

import numpy as np
import torch

# geometric-center offset along heading (reference interface:439)
CENTER_OFFSET = 0.157

# observation indices (reference interface:53-54)
IDX_BASE = np.array([0, 1, 2])
IDX_3DOF_STATE = np.array([4, 6, 8])    # q1 q2 q3 in the 12-dim obs
IDX_3DOF_ACTION = np.array([3, 5, 7])   # dq1 dq2 dq3 in the 11-dim action
N_OBS = 12
N_ACTION = 11


def plant_step(state, action, dt):
    """One sim step of the velocity-driven plant.

    state: (12,) tensor [x, y, yaw, j1..j7, f1, f2] where (x, y) is the base
    CONTROL point (wheel axle) in world frame;
    action: (11,) [v, w, j1..j7 velocities, f1, f2 velocities].
    The base moves with forward velocity -v (the reference's reversed sim
    convention) and rotates about the control point.
    """
    x, y, yaw = state[0], state[1], state[2]
    v, w = action[0], action[1]
    v_eff = -v  # sim drives backwards for positive commanded v
    x_next = x + dt * v_eff * torch.cos(yaw)
    y_next = y + dt * v_eff * torch.sin(yaw)
    yaw_next = yaw + dt * w
    joints_next = state[3:] + dt * action[2:]
    return torch.cat(
        [torch.stack([x_next, y_next, yaw_next]), joints_next])


def plant_observation(state, action):
    """(position, velocity) observations in the sim's conventions.

    position: geometric center = control point - CENTER_OFFSET * heading
    (the reference's observationCallback adds the offset back).
    velocity: world control-point velocities NEGATED (the urdfenvs
    convention the reference undoes at interface:436-437), yaw rate in slot
    2, joint velocities after.
    """
    yaw = state[2]
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    pos = torch.cat([
        torch.stack([state[0] - CENTER_OFFSET * cy,
                   state[1] - CENTER_OFFSET * sy,
                   yaw]),
        state[3:],
    ])
    v_eff = -action[0]
    vel = torch.cat([
        torch.stack([-v_eff * cy, -v_eff * sy, action[1]]),
        action[2:],
    ])
    return pos, vel


class KinematicPlant:
    """Stateful wrapper with the urdfenvs observation-dict contract.

    ``initial_state[0:3]`` is the spawn pose of the geometric center (what
    PyBullet observes), matching the reference's init path where x_start is
    written straight into the spawn state (interface:51-56) — including the
    resulting 0.157 m initial offset between where the MPC thinks the base
    center is and where it was spawned.
    """

    def __init__(self, initial_state, dt):
        self.dt = dt
        state = np.zeros(N_OBS)
        state[: len(initial_state)] = np.asarray(initial_state, dtype=float)
        # convert the observed (geometric) spawn pose to the control point
        state[0] += CENTER_OFFSET * np.cos(state[2])
        state[1] += CENTER_OFFSET * np.sin(state[2])
        self._state = state
        self._last_action = np.zeros(N_ACTION)

    def n(self):
        """Action dimension (urdfenvs env.n())."""
        return N_ACTION

    def observation(self):
        # numpy twin of plant_observation: the host steps the plant every
        # 10 ms of sim time
        s, a = self._state, self._last_action
        yaw = s[2]
        cy, sy = np.cos(yaw), np.sin(yaw)
        pos = np.concatenate([
            [s[0] - CENTER_OFFSET * cy, s[1] - CENTER_OFFSET * sy, yaw],
            s[3:],
        ])
        v_eff = -a[0]
        vel = np.concatenate([[-v_eff * cy, -v_eff * sy, a[1]], a[2:]])
        return {
            "robot_0": {
                "joint_state": {"position": pos, "velocity": vel}
            }
        }

    def step(self, action):
        action = np.asarray(action, dtype=float)
        s = self._state
        yaw = s[2]
        v_eff = -action[0]
        self._state = np.concatenate([
            [s[0] + self.dt * v_eff * np.cos(yaw),
             s[1] + self.dt * v_eff * np.sin(yaw),
             yaw + self.dt * action[1]],
            s[3:] + self.dt * action[2:],
        ])
        self._last_action = action
        return self.observation()


def setup_environment(render=False, reconfigure_camera=False, goal=False,
                      obstacles=True, mode="vel", initial_state=None,
                      dt=0.01):
    """API mirror of the reference adapter
    (the reference's simulation/albert_robot.py:17-66): returns (env, ob)
    where ob follows the gymnasium reset convention (obs_dict, info).
    render/camera/obstacle flags are accepted for signature parity; the
    kinematic plant has no renderer."""
    if initial_state is None:
        initial_state = np.zeros(N_OBS)
    env = KinematicPlant(initial_state, dt)
    return env, (env.observation(), {})


def run_step(env, action):
    """Mirror of simulation/albert_robot.py:68-71."""
    return env.step(action)

"""Whole-body MPC with dynamic (moving) ground obstacles (counterpart of
``mmmpc_tpu/controllers/moving_obs.py``).

The qref formulation of ``controllers/wholebody_qref.py`` with its ground
obstacles promoted to a per-stage table (N+1, n_obs, 3) that is set before
each solve (``moving_obstacles=True``): stage k's circles are row k's, the
terminal group's row N's.  On the card the whole-body kernels A and B read
the table from their packed params (``csrc/wholebody_{fwd,bwd}.cu``).
``predict_obstacle_trajectory`` supplies the constant-velocity prediction,
on the host in float64.
"""

from __future__ import annotations

import numpy as np

from mmmpc_tpu_torch.controllers.wholebody_qref import MPCWholeBody


def predict_obstacle_trajectory(obstacles, velocities, N, dt):
    """Constant-velocity obstacle prediction over the horizon.

    obstacles: (n_obs, 3) rows [x, y, radius]; velocities: (n_obs, 2).
    Returns (N+1, n_obs, 3) with the radii held constant.
    """
    obstacles = np.asarray(obstacles, dtype=float)
    velocities = np.asarray(velocities, dtype=float)
    ts = np.arange(N + 1)[:, None, None] * dt             # (N+1, 1, 1)
    xy = obstacles[None, :, :2] + ts * velocities[None, :, :]
    r = np.broadcast_to(obstacles[None, :, 2:], (N + 1,) + obstacles[:, 2:].shape)
    return np.concatenate([xy, r], axis=-1)


class MPCWholeBodyMovingObs(MPCWholeBody):
    """qref whole-body MPC over predicted obstacle trajectories."""

    def __init__(self, robot, obstacle_list, obstacle_manipulation_list,
                 N=10, **kwargs):
        super().__init__(robot, obstacle_list, obstacle_manipulation_list,
                         N=N, moving_obstacles=True, **kwargs)
        # until told otherwise the obstacles stand still: the table is their
        # rows tiled over the horizon
        self.obstacles_value = np.tile(self.obstacles_value[None],
                                       (N + 1, 1, 1))

    def set_obstacle_prediction(self, obstacle_traj):
        """Set the (N+1, n_obs, 3) predicted obstacle trajectory for the next
        solve (each tick, from fresh observations)."""
        self.set_obstacles(obstacle_traj)

    def observe_obstacles(self, positions, velocities):
        """The constant-velocity prediction from one observation: positions
        (n_obs, 2), velocities (n_obs, 2); the radii are kept."""
        obs = self.obstacles_value[0].copy()
        obs[:, :2] = np.asarray(positions, dtype=float)
        self.set_obstacle_prediction(
            predict_obstacle_trajectory(obs, velocities, self.N, self.dt))

"""The dynamic-obstacle closed-loop demo on the port (counterpart of the
repository's ``demo_wholebody_separate.py``): the whole-body task of
``demo_wholebody_qref.py`` with a ground obstacle that crosses the robot's
path.  Each tick the obstacle moves one control period, and the controller
(``MPCWholeBodyMovingObs``) gets a constant-velocity prediction of it over
the horizon before its warm-started solve on the card (kernels A and B at
batch 1, an obstacle row a stage).

    python -m mmmpc_tpu_torch.demo_wholebody_separate [--device cpu]
"""

import argparse

import numpy as np

from mmmpc_tpu_torch.controllers import MPCWholeBodyMovingObs
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import MobileManipulator
from mmmpc_tpu_torch.runtime.interface import Interface

DT = 0.1
N = 20
T_MOVE = 5
T_MANIPULATE = 2


class MovingObstacleInterface(Interface):
    """Interface that advances the obstacles and refreshes the controller's
    per-stage obstacle prediction each control tick.  ``obstacle_log[i]``
    holds the obstacles' positions (n_obs, 2) at tick i, the tick whose
    state is ``x_log[i]``."""

    def __init__(self, *args, obstacle_velocity, **kwargs):
        super().__init__(*args, **kwargs)
        self.obstacle_velocity = np.asarray(obstacle_velocity, dtype=float)
        self.obstacle_positions = np.asarray(
            [[o.x, o.y] for o in self.controller.obstacle_list], dtype=float)
        self.obstacle_log = []

    def timerCallback(self):
        # world update: the obstacles move one control period per tick
        self.obstacle_positions = (self.obstacle_positions
                                   + self.dt * self.obstacle_velocity)
        self.obstacle_log.append(self.obstacle_positions.copy())
        self.controller.observe_obstacles(self.obstacle_positions,
                                          self.obstacle_velocity)
        super().timerCallback()


def build_world(physical_sim=False, device=None):
    """The demo's controller and closed loop; the controller solves on
    ``device`` (the card unless named)."""
    x_start = np.array([0, 0, 0, 0, 0, 0, -np.pi / 4, -np.pi, np.pi])
    global_pose_target = np.array([5 - 0.6, 5, 0.606 + 0.333 + 0.5, -np.pi])
    # an obstacle that will cross the straight-line path mid-transit
    obstacle_list = [Obstacles(2.5, -0.5, 0.5)]
    obstacle_velocity = np.array([[0.0, 0.6]])

    robot = MobileManipulator(DT)
    controller = MPCWholeBodyMovingObs(robot, obstacle_list, [], N=N,
                                       device=device)
    return MovingObstacleInterface(
        DT, T_MOVE, T_MANIPULATE, x_start, global_pose_target, controller,
        physical_sim=physical_sim, obstacle_velocity=obstacle_velocity)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the solve (default: the card)")
    args = ap.parse_args(argv)

    world = build_world(device=args.device)
    world.run()
    print("task finished:", world.task_flag,
          "after", world.mpc_step_counter, "MPC steps")
    print("metrics:", world.metrics.summary())


if __name__ == "__main__":
    main()

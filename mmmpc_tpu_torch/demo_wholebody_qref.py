"""The closed-loop demo on the port (counterpart of the repository's
``demo_wholebody_qref.py``): one mobile manipulator driven tick by tick
through move -> approach -> rotate -> manipulate until its end effector
presses the button, each tick a warm-started solve of ``MPCWholeBody`` on
the card (kernels A and B at batch 1).

    python -m mmmpc_tpu_torch.demo_wholebody_qref [scenario] [--model-only]
        [--device cpu] [--plots DIR [--animate]]

scenario: 1 (table corner, default), 2 (wedge obstacle), 0 (debug).
``--plots DIR`` writes the run's plots into DIR after it ends (the 2-D
panels and the 3-D scene, ``Interface.plot3D``; matplotlib), ``--animate``
the 3-D scene's GIF too.
"""

import argparse
import os

from mmmpc_tpu_torch.controllers import MPCWholeBody
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.models.robots import MobileManipulator
from mmmpc_tpu_torch.runtime.interface import Interface
from mmmpc_tpu_torch.utils.configs import make_scenario


def build_world(experiment_scenario=1, dt=0.1, N=20, t_move=5,
                t_manipulate=2, physical_sim=True, device=None):
    """The scenario's controller and closed loop; the controller solves on
    ``device`` (the card unless named)."""
    sc = make_scenario(experiment_scenario, dt=dt, N=N, t_move=t_move,
                       t_manipulate=t_manipulate)
    obstacle_manipulation_list = [
        (sc.hp_points[j], sc.hp_normals[j][None, :])
        for j in range(int(sc.hp_mask.sum()))
    ]
    obstacle_list = [Obstacles(*row) for row in sc.ground_obstacles]

    robot = MobileManipulator(dt)
    controller = MPCWholeBody(robot, obstacle_list,
                              obstacle_manipulation_list, N=N, device=device)
    return Interface(dt, t_move, t_manipulate, sc.x_start,
                     sc.global_pose_target, controller,
                     physical_sim=physical_sim)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scenario", nargs="?", type=int, default=1)
    ap.add_argument("--physical-sim", action="store_true", default=True)
    ap.add_argument("--model-only", dest="physical_sim",
                    action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device of the solve (default: the card)")
    ap.add_argument("--plots", default=None,
                    help="directory to write result plots into")
    ap.add_argument("--animate", action="store_true",
                    help="also write the 3-D scene GIF (scene3d.gif)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.plots:
        os.makedirs(args.plots, exist_ok=True)
    world = build_world(args.scenario, physical_sim=args.physical_sim,
                        device=args.device)
    world.run()
    print("task finished:", world.task_flag,
          "after", world.mpc_step_counter, "MPC steps")
    print("metrics:", world.metrics.summary())
    if args.plots:
        world.plot3D(save_dir=args.plots, animate=args.animate)


if __name__ == "__main__":
    main()

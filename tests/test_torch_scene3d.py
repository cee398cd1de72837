"""The port's 3-D scene, simulation obstacle records, host FK twin and the
interface's plots against the JAX package's, on the CPU (matplotlib Agg).

- ``mmmpc_tpu_torch/sim/obstacles.py`` equals ``mmmpc_tpu/sim/obstacles.py``
  record by record and field by field, ``DEFAULT_SCENE`` too;
- ``models/arm.py::arm_fk_np`` and ``runtime/scene3d.py::_robot_geometry``
  equal the JAX ones at atol 1e-12 on 20 seeded states;
- ``scene3d_plot`` and ``scene3d_animation`` write their artifacts, and
  ``Interface.plot3D(save_dir, animate=True)`` on the fake logs of
  tests/test_scene3d.py writes the same set of files as the JAX
  ``Interface.plot3D`` on the same logs;
- the demo parses ``--plots DIR --animate``;
- every controller that the JAX package gives an ``obstacle_list`` (the
  list ``plot2D`` draws) keeps it in the port too.

Nothing here compiles a JAX program.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mmmpc_tpu import controllers as ctl_j
from mmmpc_tpu.models import robots as robots_j
from mmmpc_tpu.models.arm import arm_fk_np as arm_fk_np_j
from mmmpc_tpu.models.obstacles import Obstacles as ObstaclesJ
from mmmpc_tpu.runtime import scene3d as scene3d_j
from mmmpc_tpu.sim import obstacles as sim_obstacles_j
from mmmpc_tpu_torch import controllers as ctl_t
from mmmpc_tpu_torch import demo_wholebody_qref as demo_t
from mmmpc_tpu_torch.models import robots as robots_t
from mmmpc_tpu_torch.models.arm import arm_fk_np
from mmmpc_tpu_torch.models.obstacles import Obstacles
from mmmpc_tpu_torch.runtime import scene3d
from mmmpc_tpu_torch.sim import obstacles as sim_obstacles

torch.set_num_threads(1)


def test_sim_obstacles_match_jax():
    names = [k for k, v in vars(sim_obstacles_j).items()
             if isinstance(v, sim_obstacles_j.SimObstacle)]
    assert len(names) == 8
    for name in names:
        rec = getattr(sim_obstacles, name)
        assert isinstance(rec, sim_obstacles.SimObstacle), name
        assert dataclasses.asdict(rec) == dataclasses.asdict(
            getattr(sim_obstacles_j, name)), name
    assert ([dataclasses.asdict(r) for r in sim_obstacles.DEFAULT_SCENE]
            == [dataclasses.asdict(r) for r in sim_obstacles_j.DEFAULT_SCENE])
    assert ([f.name for f in dataclasses.fields(sim_obstacles.SimObstacle)]
            == [f.name for f in dataclasses.fields(
                sim_obstacles_j.SimObstacle)])


def test_arm_fk_np_and_robot_geometry_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        state = np.concatenate([
            rng.uniform([-5, -5, -np.pi], [5, 5, np.pi]), np.zeros(3),
            rng.uniform([-np.pi / 2, -np.pi, 0], [np.pi / 2, 0, 1.5 * np.pi])])
        for a, b in zip(arm_fk_np(state[6:]), arm_fk_np_j(state[6:])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        for a, b in zip(scene3d._robot_geometry(state),
                        scene3d_j._robot_geometry(state)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def _fake_log(T=12):
    """tests/test_scene3d.py's fake 9-state log."""
    t = np.linspace(0, 1, T)
    x = np.zeros((T, 9))
    x[:, 0] = 3 * t
    x[:, 1] = 0.5 * np.sin(2 * t)
    x[:, 2] = 0.3 * t
    x[:, 6] = -0.5 * t
    x[:, 7] = -1.0 + 0.4 * t
    x[:, 8] = 1.0 + 0.5 * t
    return x


def test_scene3d_plot_writes_artifact(tmp_path):
    path = tmp_path / "scene3d.png"
    scene3d.scene3d_plot(
        _fake_log(), obstacles=[Obstacles(1.5, 0.5, 0.3)],
        halfplanes=[(np.array([2.0, 0.0, 1.2]),
                     np.array([[0.0, 0.0, 1.0]]))],
        target=np.array([3.2, 0.4, 1.1]), save_path=str(path))
    assert path.exists() and path.stat().st_size > 10_000


def test_scene3d_animation_writes_gif(tmp_path):
    path = tmp_path / "scene3d.gif"
    scene3d.scene3d_animation(_fake_log(8), obstacles=[Obstacles(1.0, 0.0, 0.2)],
                              target=np.array([2.5, 0.0, 1.0]),
                              save_path=str(path), fps=5, stride=2)
    assert path.exists() and path.stat().st_size > 5_000


def _fake_logs(world):
    world.x_log = list(_fake_log())
    world.u_log = list(np.zeros((11, 5)))
    world.manipulator_pose_log = [np.zeros(10)] * 12
    world.endpoint_relative_pos_log = [np.zeros(3)] * 12
    return world


def test_interface_plot3d_writes_the_jax_files(tmp_path):
    from demo_wholebody_qref import build_world as build_world_j

    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for d in dirs.values():
        d.mkdir()
    _fake_logs(build_world_j(0, physical_sim=False)).plot3D(
        save_dir=str(dirs["jax"]), animate=True)
    world = _fake_logs(demo_t.build_world(0, physical_sim=False,
                                          device="cpu"))
    world.plot3D(save_dir=str(dirs["port"]), animate=True)
    files = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
    assert files["port"] == files["jax"]
    assert {"scene3d.png", "scene3d.gif", "base_xy.png"} <= set(files["port"])
    assert all((dirs["port"] / f).stat().st_size > 0 for f in files["port"])


def test_demo_parses_plot_flags():
    args = demo_t.parse_args(["2", "--model-only", "--plots", "out",
                              "--animate"])
    assert (args.scenario, args.physical_sim, args.plots, args.animate) == (
        2, False, "out", True)
    args = demo_t.parse_args([])
    assert (args.plots, args.animate) == (None, False)


# each controller and its constructor's arguments after the robot
CONTROLLERS = {
    "MPC": ("RobotDemo", lambda obs: ()),
    "MPCBase": ("Base", lambda obs: (obs,)),
    "MPCManipulator3DoF": ("ManipulatorPanda3DoF", lambda obs: ([], [])),
    "MPCWholeBody": ("MobileManipulator", lambda obs: (obs, [])),
    "MPCWholeBodyEndpoint": ("MobileManipulator", lambda obs: (obs,)),
    "MPCWholeBodyMovingObs": ("MobileManipulator", lambda obs: (obs, [])),
}


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_controllers_keep_obstacle_list_as_jax(name):
    robot, args = CONTROLLERS[name]
    obs_j, obs_t = [ObstaclesJ(1.0, 2.0, 0.3)], [Obstacles(1.0, 2.0, 0.3)]
    jax_ctl = getattr(ctl_j, name)(getattr(robots_j, robot)(0.1),
                                   *args(obs_j), N=4)
    port_ctl = getattr(ctl_t, name)(getattr(robots_t, robot)(0.1),
                                    *args(obs_t), N=4, device="cpu")
    assert hasattr(port_ctl, "obstacle_list") == hasattr(jax_ctl,
                                                         "obstacle_list")
    if hasattr(jax_ctl, "obstacle_list"):
        assert port_ctl.obstacle_list is obs_t

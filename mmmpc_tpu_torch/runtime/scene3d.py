"""True 3-D scene rendering of a closed-loop run: base path, arm links,
ground-cylinder obstacles, half-plane patches and the button target
(counterpart of ``mmmpc_tpu/runtime/scene3d.py``).

The reference publishes PyBullet-rendered GIFs; its matplotlib ``plot3D``
only composes 2-D panels.  This module gives the 3-D artifacts without a
physics renderer: a matplotlib 3-D scene plot of the whole run plus a GIF
animation, both derived from the state log alone through the same
whole-body FK the controller optimizes (``models/arm.py::arm_fk_np``, the
base's footprint of ``models/base.py``, the arm's mount of
``utils/configs.py``).

Everything here is host-side matplotlib on numpy arrays; nothing touches a
tensor, and matplotlib is imported only when a plot is drawn.
"""

from __future__ import annotations

import numpy as np

from mmmpc_tpu_torch.models.arm import arm_fk_np
from mmmpc_tpu_torch.models.base import BASE_LENGTH, BASE_WIDTH
from mmmpc_tpu_torch.utils.configs import BASELINK2JOINT1_X, BASELINK2JOINT1_Z


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _robot_geometry(state):
    """World-frame drawables for one 9-state: (base rectangle (5,3),
    arm polyline (5,3) = mount->joint1->joint2->joint3->ee)."""
    px, py, psi = float(state[0]), float(state[1]), float(state[2])
    q = np.asarray(state[6:9], dtype=float)
    c, s = np.cos(psi), np.sin(psi)
    R = np.array([[c, -s], [s, c]])
    hl, hw = BASE_LENGTH / 2, BASE_WIDTH / 2
    corners = np.array([[hl, hw], [hl, -hw], [-hl, -hw], [-hl, hw], [hl, hw]])
    rect = corners @ R.T + np.array([px, py])
    rect3 = np.concatenate([rect, np.zeros((5, 1))], axis=1)

    ee, j2, j3 = arm_fk_np(q)

    def lift(p_arm):
        r = p_arm[0] + BASELINK2JOINT1_X
        return np.array([px + r * c, py + r * s, p_arm[2] + BASELINK2JOINT1_Z])

    mount = np.array([px + BASELINK2JOINT1_X * c, py + BASELINK2JOINT1_X * s,
                      BASELINK2JOINT1_Z])
    base_top = np.array([mount[0], mount[1], 0.0])
    arm = np.stack([base_top, mount, lift(j2), lift(j3), lift(ee)])
    return rect3, arm


def _draw_cylinder(ax, x, y, radius, height=0.5, color="tab:green",
                   alpha=0.35):
    th = np.linspace(0, 2 * np.pi, 24)
    z = np.linspace(0, height, 2)
    TH, Z = np.meshgrid(th, z)
    ax.plot_surface(x + radius * np.cos(TH), y + radius * np.sin(TH), Z,
                    color=color, alpha=alpha, linewidth=0)


def _draw_halfplane(ax, point, normal, size=0.5, color="tab:gray",
                    alpha=0.35):
    """A square patch of the half-plane boundary around its anchor point."""
    n = np.asarray(normal, dtype=float).reshape(3)
    n = n / (np.linalg.norm(n) + 1e-12)
    a = np.cross(n, [0.0, 0.0, 1.0])
    if np.linalg.norm(a) < 1e-6:
        a = np.cross(n, [0.0, 1.0, 0.0])
    a = a / np.linalg.norm(a)
    b = np.cross(n, a)
    p = np.asarray(point, dtype=float).reshape(3)
    corners = np.stack([p + size * (sa * a + sb * b)
                        for sa, sb in ((1, 1), (1, -1), (-1, -1), (-1, 1))])
    try:
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection
        ax.add_collection3d(Poly3DCollection([corners], color=color,
                                             alpha=alpha))
    except Exception:  # pragma: no cover - backend quirk fallback
        ax.plot(corners[[0, 1, 2, 3, 0], 0], corners[[0, 1, 2, 3, 0], 1],
                corners[[0, 1, 2, 3, 0], 2], color=color, alpha=alpha)


def _setup_scene(ax, x_log, obstacles, halfplanes, target):
    for obs in obstacles or []:
        _draw_cylinder(ax, float(obs.x), float(obs.y), float(obs.radius))
    for (p, n) in halfplanes or []:
        _draw_halfplane(ax, np.asarray(p).reshape(3),
                        np.asarray(n).reshape(-1)[:3])
    if target is not None:
        t = np.asarray(target, dtype=float)
        ax.scatter([t[0]], [t[1]], [t[2]], color="red", marker="*", s=140,
                   label="button target")
    lo = x_log[:, :2].min(axis=0) - 1.2
    hi = x_log[:, :2].max(axis=0) + 1.2
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(0, 1.8)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    try:
        ax.set_box_aspect((hi[0] - lo[0], hi[1] - lo[1], 1.8))
    except Exception:  # pragma: no cover - old matplotlib
        pass


def scene3d_plot(x_log, obstacles=None, halfplanes=None, target=None,
                 save_path=None, n_snapshots=6):
    """Static 3-D scene: full base path + end-effector path, robot drawn at
    `n_snapshots` evenly spaced states, obstacles and target."""
    plt = _plt()
    x_log = np.asarray(x_log, dtype=float)
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    _setup_scene(ax, x_log, obstacles, halfplanes, target)

    ax.plot(x_log[:, 0], x_log[:, 1], np.zeros(len(x_log)),
            color="tab:blue", linewidth=2, label="base path")
    ee_path = np.stack([_robot_geometry(x)[1][-1] for x in x_log])
    ax.plot(ee_path[:, 0], ee_path[:, 1], ee_path[:, 2],
            color="tab:orange", linewidth=1.5, label="end-effector path")

    idx = np.unique(np.linspace(0, len(x_log) - 1,
                                max(2, n_snapshots)).astype(int))
    for frac, i in zip(np.linspace(0.25, 1.0, len(idx)), idx):
        rect, arm = _robot_geometry(x_log[i])
        ax.plot(rect[:, 0], rect[:, 1], rect[:, 2], color="k", alpha=frac)
        ax.plot(arm[:, 0], arm[:, 1], arm[:, 2], color="tab:red",
                marker="o", markersize=3, alpha=frac)
    ax.legend(loc="upper left")
    if save_path:
        fig.savefig(save_path, dpi=110)
    plt.close(fig)
    return save_path


def scene3d_animation(x_log, obstacles=None, halfplanes=None, target=None,
                      save_path="scene3d.gif", fps=10, stride=2):
    """GIF animation of the run (the artifact family the reference
    publishes).  One frame per `stride` MPC steps."""
    plt = _plt()
    from matplotlib.animation import PillowWriter

    x_log = np.asarray(x_log, dtype=float)
    frames = x_log[::max(1, int(stride))]
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    writer = PillowWriter(fps=fps)
    with writer.saving(fig, str(save_path), dpi=80):
        for i, x in enumerate(frames):
            ax.cla()
            _setup_scene(ax, x_log, obstacles, halfplanes, target)
            k = i * max(1, int(stride)) + 1
            ax.plot(x_log[:k, 0], x_log[:k, 1], np.zeros(k),
                    color="tab:blue", linewidth=2)
            rect, arm = _robot_geometry(x)
            ax.plot(rect[:, 0], rect[:, 1], rect[:, 2], color="k")
            ax.plot(arm[:, 0], arm[:, 1], arm[:, 2], color="tab:red",
                    marker="o", markersize=3)
            writer.grab_frame()
    plt.close(fig)
    return save_path

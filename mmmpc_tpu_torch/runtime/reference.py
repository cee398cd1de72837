"""Local reference extraction (numpy; a copy of
``mmmpc_tpu/runtime/reference.py``, which holds no JAX but whose package
loads it).

The nearest point of the global trajectory is one vectorised argmin, and
the horizon window is gathered with clamped indices (the reference's
repeat-last padding).
"""

from __future__ import annotations

import numpy as np


def nearest_index(traj_ref, point, distance_index):
    """Index of the trajectory row closest to ``point`` over the selected
    state components (reference interface:363-375)."""
    d = traj_ref[:, distance_index] - np.asarray(point)[distance_index]
    return int(np.argmin(np.einsum("ij,ij->i", d, d)))


def local_ref_traj(traj_ref, u_ref, current, distance_index, N,
                   current_pose=None, different_space=False):
    """Window of N+1 reference states / N reference inputs starting at the
    nearest point, repeating the last row past the end
    (reference interface:353-396)."""
    if different_space:
        d = traj_ref[:, distance_index] - np.asarray(current_pose)[:3]
        min_idx = int(np.argmin(np.einsum("ij,ij->i", d, d)))
    else:
        min_idx = nearest_index(traj_ref, current, np.asarray(distance_index))
    idx = np.minimum(np.arange(min_idx, min_idx + N + 1),
                     traj_ref.shape[0] - 1)
    idx_u = np.minimum(np.arange(min_idx, min_idx + N), u_ref.shape[0] - 1)
    local_traj = traj_ref[idx]
    local_u = u_ref[idx_u]
    assert local_traj.shape[0] == N + 1
    assert local_u.shape[0] == N
    return local_traj, local_u


def local_ref_pose(traj_ref, u_ref, current_psi, N, angle_diff):
    """Tile the final reference pose over the horizon, making the yaw
    reference continuous with the current yaw
    (reference interface:398-410)."""
    local_traj = np.tile(traj_ref[-1], (N + 1, 1))
    local_u = np.tile(u_ref[-1], (N, 1))
    psi_ref = traj_ref[-1, 2]
    local_traj[:, 2] = current_psi + float(angle_diff(psi_ref, current_psi))
    return local_traj, local_u

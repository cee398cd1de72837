"""Obstacle records (counterpart of ``mmmpc_tpu/models/obstacles.py``)."""

from __future__ import annotations

import numpy as np


class Obstacles:
    """API-compatible single ground obstacle record (x, y, radius)."""

    def __init__(self, x, y, radius):
        self.x = x
        self.y = y
        self.radius = radius


def ground_obstacle_array(obstacle_list) -> np.ndarray:
    """Stack Obstacles records (or (x, y, r) tuples) into an (n, 3) array."""
    rows = []
    for obs in obstacle_list:
        if isinstance(obs, Obstacles):
            rows.append([obs.x, obs.y, obs.radius])
        else:
            rows.append(list(obs))
    if not rows:
        return np.zeros((0, 3))
    return np.asarray(rows, dtype=float)

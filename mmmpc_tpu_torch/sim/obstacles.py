"""Simulation obstacle definitions (counterpart of
``mmmpc_tpu/sim/obstacles.py``).

Mirror of the reference's mpscenes obstacle dicts
(the reference's simulation/obstacles.py) as plain records: the kinematic
plant has no collision engine (collision avoidance is the MPC's job), but
scenario construction, plotting and parity checks consume the same objects
the reference declares.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimObstacle:
    kind: str                     # "sphere" | "cylinder" | "box"
    position: Tuple[float, ...]
    radius: float = 0.0
    height: float = 0.0
    size: Tuple[float, ...] = ()
    movable: bool = False
    name: str = "obstacle"


# reference simulation/obstacles.py:7-13
movable_sphere1 = SimObstacle("sphere", (1.0, -2.0, 2.0), radius=0.2,
                              movable=True, name="simpleSphere")
# :15-25
static_cylinder = SimObstacle("cylinder", (-1.0, -3.0, 0.0), radius=0.3,
                              height=2.0, name="cylinder_obstacle")
# :27-37 — the two big ground cylinders the base must avoid
static_cylinder_2 = SimObstacle("cylinder", (2.5, 3.0, 0.0), radius=0.6,
                                height=0.5, name="cylinder_obstacle")
# :39-49
static_cylinder_3 = SimObstacle("cylinder", (2.5, 1.0, 0.0), radius=0.6,
                                height=0.5, name="cylinder_obstacle")
# :51-61 — button marker at (5, 5)
static_cylinder_4 = SimObstacle("cylinder", (5.0, 5.0, 0.0), radius=0.1,
                                height=0.5, name="cylinder_obstacle")
# :63-74 — stand-off marker at (4.4, 5)
static_cylinder_5 = SimObstacle("cylinder", (5 - 0.6, 5.0, 0.0), radius=0.1,
                                height=0.5, name="cylinder_obstacle")
# :76-100
static_box1 = SimObstacle("box", (0.5, -2.0, 0.5), size=(0.5, 0.5, 0.5),
                          name="movable_box")
movable_box1 = SimObstacle("box", (0.5, -0.5, 1.5), size=(0.5, 0.5, 0.5),
                           movable=True, name="movable_box")

DEFAULT_SCENE = [static_cylinder_2, static_cylinder_3, static_cylinder_5]

"""Config dataclasses: solver settings and benchmark scenarios (pure numpy).

Counterpart of ``mmmpc_tpu/utils/configs.py``.  That module holds no JAX, but
importing it runs ``mmmpc_tpu/__init__.py``, which loads JAX, so the port keeps
its own copy.  The values here are held equal to the JAX package's by
``tests/test_torch_models.py``.

``use_fused_backward`` is kept: it selects between the two backward paths
of the batched solver, the OCP's fused backward kernel or the AL expansion
in plain PyTorch followed by the Riccati sweep kernel
(``solver/batched.py``), as in the JAX package.  The solver picks the
unfused path by itself for an OCP without a ``lanes_bwd_factory``; the
field is the JAX config's, and for an OCP that has a fused kernel it is
the only way to run, measure and hold that general path against the fused
one on the same problem (the fused path is faster on every measured
problem, so it stays the default).  The JAX config's other path
switches (``scan_unroll``, ``force_kernel``, ``use_pallas_*``,
``use_assoc_scan``, ``matmul_precision``) have no counterpart: the port's
kernels are chosen by the device of the tensors they are given, and float32
matmul precision is pinned when the package is imported
(``mmmpc_tpu_torch/__init__.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

PI = math.pi

# Frame offsets between the Albert base link and the arm mount (joint 1).
# The -0.007 x-offset is the reference's known sign quirk, kept for parity.
BASELINK2JOINT1_X = -0.007
BASELINK2JOINT1_Z = 0.606 + 0.333

# Stand-off distance between the base target and the button.
WORKING_RADIUS = 0.6


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Fixed-shape AL-iLQR solver settings.

    A fixed number of augmented-Lagrangian outer rounds, each with a fixed
    number of iLQR sweeps: the first round gets ``ilqr_iters``, middle rounds
    ``ilqr_iters_later`` and the last round ``ilqr_iters_final`` (each None
    falls back to the previous one).
    """

    al_iters: int = 6
    ilqr_iters: int = 10
    ilqr_iters_later: int | None = None
    ilqr_iters_final: int | None = None
    mu_init: float = 10.0
    mu_scale: float = 5.0
    mu_max: float = 1e6
    reg_init: float = 1e-6
    reg_scale: float = 10.0
    reg_max: float = 1e6
    n_alpha: int = 8
    alpha_decay: float = 0.5
    cost_tol: float = 1e-7
    constraint_tol: float = 1e-5
    # The AL objective is divided by this factor so that float32 keeps the
    # ~1e5-magnitude slack costs inside its mantissa; solutions are unchanged.
    cost_scale: float = 1.0
    # Run the AL expansion fused into the OCP's backward kernel when it has
    # one; False (or an OCP without ``lanes_bwd_factory``) runs the
    # expansion in plain PyTorch and then the Riccati sweep kernel, which
    # reads ~291 floats of precomputed blocks per (9, 5) stage.
    use_fused_backward: bool = True


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One benchmark scenario; half-planes are padded to ``n_hp_pad`` rows
    with a liveness mask."""

    name: str
    dt: float
    N: int
    t_move: float
    t_manipulate: float
    x_start: np.ndarray             # (9,)
    global_pose_target: np.ndarray  # (4,) x y z psi of the end effector
    ground_obstacles: np.ndarray    # (n_obs, 3) columns x, y, radius
    hp_points: np.ndarray           # (n_hp, 3)
    hp_normals: np.ndarray          # (n_hp, 3)
    hp_mask: np.ndarray             # (n_hp,) 1.0 for live half-planes

    @property
    def n_halfplanes(self) -> int:
        return int(self.hp_mask.sum())


def _hp_arrays(pairs, n_pad):
    """Stack (point, normal) pairs into padded arrays + mask."""
    pts = np.zeros((n_pad, 3))
    nrm = np.zeros((n_pad, 3))
    msk = np.zeros((n_pad,))
    for j, (p, n) in enumerate(pairs):
        pts[j] = np.asarray(p, dtype=float).reshape(3)
        nrm[j] = np.asarray(n, dtype=float).reshape(3)
        msk[j] = 1.0
    return pts, nrm, msk


# Ground obstacles common to all demo scenarios.
_GROUND_OBSTACLES = np.array(
    [
        [2.5, 3.0, 0.6],
        [2.5, 1.0, 0.6],
        [5 - 0.6, 5.0, 0.1],
    ]
)


def make_scenario(experiment_scenario: int = 1, dt: float = 0.1, N: int = 20,
                  t_move: float = 5.0, t_manipulate: float = 2.0,
                  n_hp_pad: int = 3) -> Scenario:
    """The reference demo's three scenarios.

    scenario 1: table-corner avoidance (3 half-planes around the button),
    scenario 2: wedge obstacle during base motion (2 half-planes),
    scenario 0: debug — no half-plane obstacles, trivial backwards target.
    """
    if experiment_scenario == 1:
        x_start = np.array([0, 0, 0, 0, 0, 0, -PI / 4, -PI, PI], dtype=float)
        target = np.array([5 - 0.6, 5, 0.606 + 0.333 + 0.5, -PI])
        hp = [
            (np.array([5.007 - 0.43, 5, 0.27 + 0.606 + 0.333]), np.array([0, 0, -1.0])),
            (np.array([5.007 - 0.43, 5, 0.27 + 0.606 + 0.333]), np.array([-1.0, 0, 0])),
            (np.array([5.007 - 0.43, 5, 0.27 + 0.606 + 0.333]), np.array([0, 1.0, 0])),
        ]
    elif experiment_scenario == 2:
        x_start = np.zeros(9)
        target = np.array([5 - 0.6, 5, 0.606 + 0.333 + 0.5, -PI])
        s2 = 1.0 / math.sqrt(2.0)
        hp = [
            (np.array([2.5, 2, 0.35 + 0.606 + 0.333]), np.array([s2, 0, s2])),
            (np.array([2.5, 2, 0.35 + 0.606 + 0.333]), np.array([-s2, 0, s2])),
        ]
    else:  # debug scenario 0
        x_start = np.zeros(9)
        target = np.array([-0.6, 0, 0.606 + 0.333 + 0.5, -PI])
        hp = []

    pts, nrm, msk = _hp_arrays(hp, n_hp_pad)
    return Scenario(
        name=f"scenario{experiment_scenario}",
        dt=dt, N=N, t_move=t_move, t_manipulate=t_manipulate,
        x_start=x_start, global_pose_target=target,
        ground_obstacles=_GROUND_OBSTACLES.copy(),
        hp_points=pts, hp_normals=nrm, hp_mask=msk,
    )

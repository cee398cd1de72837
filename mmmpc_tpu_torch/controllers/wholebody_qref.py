"""Whole-body MPC with joint-space reference — the main controller.

Counterpart of ``mmmpc_tpu/controllers/wholebody_qref.py``: 9-state / 5-input
MPC with

- state / input / input-rate quadratic tracking costs (Q, R, W), terminal P,
- ground circles, half-plane-union link obstacles and self-collision spheres
  folded into the exact slack penalty S * relu(max g)^2,
- hard state boxes, input boxes (clamped in every rollout) and input-rate
  boxes, plus a runtime-maskable terminal position equality,
- the reference's terminal-block bug (terminal self-collision constrained
  against the stale stage slack s[N-1]), as the JAX controller's default
  ``replicate_terminal_selfcol_bug=True`` has it: the self-collision values
  of x_N = f(x_{N-1}, u_{N-1}) ride stage N-1's slack group, and the
  terminal slack group has no self-collision rows.  With
  ``replicate_terminal_selfcol_bug=False`` (the fixed formulation) stage
  N-1's group is a stage group like the others and the terminal group
  holds the self-collision rows of x_N, after its ground circles and
  half-planes, in the JAX controller's order.

The JAX controller differentiates the slack group with ``jax.value_and_grad``;
here its gradient is closed form (world-point Jacobians of the FK, the even
tie split of the max as in the VJP of ``jnp.max``), the same algebra as the
fused backward kernel.  ``tests/test_torch_qref.py`` holds it against JAX and
against ``torch.func.jacfwd``.

With ``moving_obstacles=True`` the ground obstacles are a per-stage table
(N+1, n_obs, 3): stage k's slack group reads row k and the terminal group
row N, as in the JAX controller, and the fused kernels take the table
(``controllers/moving_obs.py`` fills it with a prediction).

The fleet (``sim/batch_task_engine.py``) solves with per-scenario U_last,
X_ref, U_ref, Q, P and eq_mask (``OCP.per_scenario_keys``, the JAX
controller's ``lanes_per_scenario_keys``): the callables take them
batch-first (``ocp/spec.py``), and the fused kernels read them per scenario.
The Gauss-Newton residual forms read the square-root weights Q_s, P_s as
given, shared.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mmmpc_tpu_torch.controllers.common import (
    ControllerBase, as_weight_matrix, finite_bound_masks, mv, outer, quad,
    scalar_weight, weight_sqrt,
)
from mmmpc_tpu_torch.models.arm import arm_fk_partials
from mmmpc_tpu_torch.models.mobile_manipulator import (
    wholebody_fk, wholebody_jacobians, wholebody_step,
)
from mmmpc_tpu_torch.models.obstacles import ground_obstacle_array
from mmmpc_tpu_torch.ocp.constraints import (
    NEG_BIG, box_g, ground_circle_g, ground_circle_g_grad, halfplane_union_g,
    halfplane_union_g_grad, manipulator_sample_points, relu_max,
    relu_max_grad, self_collision_g, sphere_g_grad,
)
from mmmpc_tpu_torch.ocp.spec import OCP
from mmmpc_tpu_torch.ops.wholebody_bwd import BwdFused
from mmmpc_tpu_torch.ops.wholebody_fwd import FwdLinesearch
from mmmpc_tpu_torch.utils.configs import (
    BASELINK2JOINT1_X, BASELINK2JOINT1_Z, SolverConfig,
)
from mmmpc_tpu_torch.utils.convert import device_constant

PI = math.pi

_DEFAULT_Q = 5 * np.diag([5, 5, 0, 0, 0, 1, 1, 1, 1.0])
_DEFAULT_R = np.diag([0.1, 0.1, 0.0, 0.0, 0.0])
_DEFAULT_S = np.diag([1e5])
_DEFAULT_W = np.diag([0, 0, 1e-1, 1e-1, 1e-1])
_DEFAULT_ULIM = np.array([[-2, -PI, -1, -1, -1], [2, PI, 1, 1, 1.0]])
_DEFAULT_XLIM = np.array([
    [-100, -100, -np.inf, -2, -2, -PI, -PI / 2, -PI, 0],
    [100, 100, np.inf, 2, 2, PI, PI / 2, 0, 3 * PI / 2],
])
_DEFAULT_DULIM = np.array([
    [-np.inf, -np.inf, -0.5, -0.5, -0.5],
    [np.inf, np.inf, 0.5, 0.5, 0.5],
])

# Rows of coefficients over the world points (j2, j3, ee).  Self-collision:
# check point minus ee, for the checks [world origin, j2/2, j2, (j2+j3)/2].
_SELF_DIFF = ((0.0, 0.0, -1.0), (0.5, 0.0, -1.0), (1.0, 0.0, -1.0),
              (0.5, 0.5, -1.0))
# The six sampled link points [j2/2, j2, (j2+j3)/2, j3, (j3+ee)/2, ee].
_HP_POINTS = ((0.5, 0.0, 0.0), (1.0, 0.0, 0.0), (0.5, 0.5, 0.0),
              (0.0, 1.0, 0.0), (0.0, 0.5, 0.5), (0.0, 0.0, 1.0))


def _world_points_jacobian(x):
    """World (j2, j3, ee) as (..., 3, 3) and their Jacobians w.r.t. the state
    (..., 3, 3, 9): the arm-frame partials of ``models/arm.py::
    arm_fk_partials`` lifted by the base pose (only px, py, psi and q
    enter)."""
    px, py, psi = x[..., 0], x[..., 1], x[..., 2]
    ax, az, ax_q, az_q = arm_fk_partials(x[..., 6:9])
    r = ax + BASELINK2JOINT1_X
    cp = torch.cos(psi)[..., None]
    sp = torch.sin(psi)[..., None]
    pts = torch.stack([px[..., None] + r * cp, py[..., None] + r * sp,
                       az + BASELINK2JOINT1_Z], dim=-1)
    one, zr = torch.ones_like(r), torch.zeros_like(r)
    jx = torch.cat([torch.stack([one, zr, -r * sp, zr, zr, zr], -1),
                    cp[..., None] * ax_q], -1)
    jy = torch.cat([torch.stack([zr, one, r * cp, zr, zr, zr], -1),
                    sp[..., None] * ax_q], -1)
    jz = torch.cat([torch.stack([zr] * 6, -1), az_q], -1)
    return pts, torch.stack([jx, jy, jz], dim=-2)


def _combine(coefs, pts, jac):
    """Linear combinations of the world points and of their Jacobians."""
    C = device_constant(coefs, pts.dtype, pts.device)
    return (torch.einsum("rk,...kc->...rc", C, pts),
            torch.einsum("rk,...kcj->...rcj", C, jac))


def _slack_rows_with_grad(x, p, obs, base_radius,
                          families=("ground", "self", "hp")):
    """Slack-group values (..., G) and their state gradients (..., G, 9):
    the rows of each of ``families`` in its order, of the ground circles
    (of the obstacle rows ``obs``), the self-collision spheres and the
    half-plane unions."""
    pts, J = _world_points_jacobian(x)
    rows = []
    for family in families:
        if family == "ground":
            v, g = ground_circle_g_grad(x[..., 0], x[..., 1], obs,
                                        base_radius)
            rows.append((v, torch.nn.functional.pad(g, (0, 7))))
        elif family == "self":
            rows.append(sphere_g_grad(*_combine(_SELF_DIFF, pts, J)))
        else:
            rows.append(halfplane_union_g_grad(
                *_combine(_HP_POINTS, pts, J), p["hp_points"],
                p["hp_normals"], p["hp_mask"]))
    return (torch.cat([v for v, _ in rows], dim=-1),
            torch.cat([g for _, g in rows], dim=-2))


def _rows(p, key, k):
    """Row(s) k of the reference table ``key`` (X_ref, U_ref, U_last): of
    the shared (rows, n), or of a per-scenario (B, rows, n) -> (B, *k.shape,
    n), whose batch axis falls on x's."""
    t = p[key]
    return t[:, k] if t.dim() == 3 else t[k]


def _weight(p, key, k=None):
    """Weight ``key`` (Q, P): the shared (n, n), or a per-scenario (B, n, n)
    with a unit axis for each axis of the stage index ``k`` (none at the
    terminal), so that it broadcasts against x's batch axis."""
    t = p[key]
    if t.dim() == 2:
        return t
    kd = k.dim() if torch.is_tensor(k) else 0
    return t.reshape(t.shape[:1] + (1,) * kd + t.shape[1:])


def _mv(M, v):
    """M v for a shared or a per-scenario (``_weight``) matrix M."""
    return mv(M, v) if M.dim() == 2 else (M @ v[..., None])[..., 0]


def _quad(e, M):
    return torch.sum(_mv(M, e) * e, dim=-1)


def _eq_mask(p, trailing):
    """The terminal equality's mask: the shared 0-d, or a per-scenario (B,)
    with ``trailing`` unit axes."""
    m = p["eq_mask"]
    return m if m.dim() == 0 else m.reshape(m.shape + (1,) * trailing)


class MPCWholeBody(ControllerBase):
    NX, NU = 9, 5

    def __init__(self, robot, obstacle_list, obstacle_manipulation_list,
                 N=10, Q=_DEFAULT_Q, P=_DEFAULT_Q, R=_DEFAULT_R,
                 S=_DEFAULT_S, W=_DEFAULT_W,
                 ulim=_DEFAULT_ULIM, xlim=_DEFAULT_XLIM, dulim=_DEFAULT_DULIM,
                 solver_config: SolverConfig | None = None, device=None,
                 replicate_terminal_selfcol_bug: bool = True,
                 moving_obstacles: bool = False):
        self.robot_model = robot
        self.dt = robot.dt
        self.base_radius = robot.base.base_radius()
        self.moving_obstacles = moving_obstacles
        self.replicate_terminal_selfcol_bug = replicate_terminal_selfcol_bug

        # runtime weight state (reference setWeight mechanism)
        self.Q_value = as_weight_matrix(Q, self.NX)
        self.P_value = as_weight_matrix(P, self.NX)
        self.R_value = as_weight_matrix(R, self.NU)
        self.W_value = as_weight_matrix(W, self.NU)
        self.S_value = scalar_weight(S)

        self.ulim = np.asarray(ulim, dtype=float)
        self.xlim = np.asarray(xlim, dtype=float)
        self.dulim = np.asarray(dulim, dtype=float)

        self.obstacle_list = obstacle_list
        self.obstacle_manipulation_list = obstacle_manipulation_list
        self.obstacles_value = ground_obstacle_array(obstacle_list)
        self.n_obs = self.obstacles_value.shape[0]
        self.n_hp = max(len(obstacle_manipulation_list), 1)
        self.hp_points_value = np.zeros((self.n_hp, 3))
        self.hp_normals_value = np.zeros((self.n_hp, 3))
        self.hp_mask_value = np.zeros((self.n_hp,))
        for j, (pt, nvec) in enumerate(obstacle_manipulation_list):
            self.hp_points_value[j] = np.asarray(pt, dtype=float).reshape(3)
            self.hp_normals_value[j] = np.asarray(nvec, dtype=float).reshape(3)
            self.hp_mask_value[j] = 1.0

        # FSM-injected terminal position equality, off by default
        self.terminal_eq_mask = 0.0

        self.x_bounds = finite_bound_masks(self.xlim)
        self.du_bounds = finite_bound_masks(self.dulim)
        super().__init__(self._build_ocp(N), solver_config or SolverConfig(),
                         device)

    # ------------------------------------------------------------------
    def _build_ocp(self, N):
        dt = self.dt
        base_radius = self.base_radius
        nx, nu = self.NX, self.NU
        x_lo, x_hi, x_mlo, x_mhi = self.x_bounds
        du_lo, du_hi, du_mlo, du_mhi = self.du_bounds
        moving = self.moving_obstacles
        bug_compat = self.replicate_terminal_selfcol_bug

        def dynamics(x, u):
            return wholebody_step(x, u, dt)

        def last_stage(k, x):
            """k == N-1 as a bool tensor with a trailing unit axis."""
            k = torch.as_tensor(k, dtype=torch.long, device=x.device)
            return (k == N - 1)[..., None]

        def stage_obs(p, k, x):
            """Stage k's obstacle rows: row k of a moving table (k an int
            or a tensor of stages, broadcasting against x's leading axes),
            else the one table."""
            if not moving:
                return p["obstacles"]
            return p["obstacles"][torch.as_tensor(k, dtype=torch.long,
                                                  device=x.device)]

        def terminal_obs(p):
            return p["obstacles"][N] if moving else p["obstacles"]

        def slack_group(x, p, obs):
            pose_ee, j2, j3 = wholebody_fk(x)
            ee = pose_ee[..., :3]
            return (ground_circle_g(x[..., 0], x[..., 1], obs, base_radius),
                    self_collision_g(ee, j2, j3),
                    halfplane_union_g(manipulator_sample_points(ee, j2, j3),
                                      p["hp_points"], p["hp_normals"],
                                      p["hp_mask"]))

        def terminal_selfcol(x):
            pose_ee, j2, j3 = wholebody_fk(x)
            return self_collision_g(pose_ee[..., :3], j2, j3)

        def stage_slack_g(x, u, k, p):
            g = slack_group(x, p, stage_obs(p, k, x))
            if bug_compat:
                # terminal self-collision rides stage N-1's slack (the
                # reference's stale loop index)
                g += (torch.where(last_stage(k, x),
                                  terminal_selfcol(dynamics(x, u)), NEG_BIG),)
            return torch.cat(g, dim=-1)

        def terminal_slack_g(x, p):
            g_ground, g_self, g_hp = slack_group(x, p, terminal_obs(p))
            return torch.cat([g_ground, g_hp]
                             + ([] if bug_compat else [g_self]), dim=-1)

        def stage_slack_grad(x, u, k, p):
            """(smax, d smax / d[x; u]) of the stage slack group."""
            vals, gx = _slack_rows_with_grad(x, p, stage_obs(p, k, x),
                                             base_radius)
            gu = torch.zeros(gx.shape[:-1] + (nu,), dtype=x.dtype,
                             device=x.device)
            if bug_compat:
                tv, tg = _slack_rows_with_grad(dynamics(x, u), p, None,
                                               base_radius, ("self",))
                A, Bm = wholebody_jacobians(x, u, dt)
                last = last_stage(k, x)
                vals = torch.cat([vals, torch.where(last, tv, NEG_BIG)], -1)
                # chain rule through the dynamics step
                gx = torch.cat([gx, torch.where(last[..., None], tg @ A,
                                                0.0)], -2)
                gu = torch.cat([gu, torch.where(last[..., None], tg @ Bm,
                                                0.0)], -2)
            return relu_max_grad(vals, torch.cat([gx, gu], dim=-1))

        def terminal_slack_grad(x, p):
            vals, gx = _slack_rows_with_grad(
                x, p, terminal_obs(p), base_radius,
                ("ground", "hp") if bug_compat else ("ground", "hp", "self"))
            return relu_max_grad(vals, gx)

        def errors(x, u, k, p):
            return (x - _rows(p, "X_ref", k), u - _rows(p, "U_ref", k),
                    u - _rows(p, "U_last", k))

        def stage_cost(x, u, k, p):
            ex, eu, edu = errors(x, u, k, p)
            smax = relu_max(stage_slack_g(x, u, k, p))
            return (_quad(ex, _weight(p, "Q", k)) + quad(eu, p["R"])
                    + quad(edu, p["W"]) + p["S"] * smax * smax)

        def terminal_cost(x, p):
            ex = x - _rows(p, "X_ref", N)
            smax = relu_max(terminal_slack_g(x, p))
            return _quad(ex, _weight(p, "P")) + p["S"] * smax * smax

        def stage_residuals(x, u, k, p):
            """cost == ||residuals||^2 exactly (Gauss-Newton factorisation)."""
            ex, eu, edu = errors(x, u, k, p)
            smax = relu_max(stage_slack_g(x, u, k, p))
            return torch.cat([mv(p["Q_s"], ex), mv(p["R_s"], eu),
                              mv(p["W_s"], edu),
                              (p["S_sqrt"] * smax)[..., None]], dim=-1)

        def terminal_residuals(x, p):
            ex = x - _rows(p, "X_ref", N)
            smax = relu_max(terminal_slack_g(x, p))
            return torch.cat([mv(p["P_s"], ex),
                              (p["S_sqrt"] * smax)[..., None]], dim=-1)

        def stage_ineq(x, u, k, p):
            gx = box_g(x, x_lo, x_hi, x_mlo, x_mhi)
            gdu = box_g(u - _rows(p, "U_last", k), du_lo, du_hi, du_mlo,
                        du_mhi)
            return torch.cat([gx, gdu], dim=-1)

        def terminal_ineq(x, p):
            return box_g(x, x_lo, x_hi, x_mlo, x_mhi)

        def terminal_eq(x, p):
            return _eq_mask(p, 1) * (x[..., :2] - _rows(p, "X_ref", N)[..., :2])

        # ---- hand Jacobians: box rows are constant +-selection rows ----
        Jc_np = np.zeros((2 * nx + 2 * nu, nx + nu))
        for i in range(nx):
            Jc_np[i, i] = 1.0 if x_mhi[i] else 0.0
            Jc_np[nx + i, i] = -1.0 if x_mlo[i] else 0.0
        for i in range(nu):
            Jc_np[2 * nx + i, nx + i] = 1.0 if du_mhi[i] else 0.0
            Jc_np[2 * nx + nu + i, nx + i] = -1.0 if du_mlo[i] else 0.0
        Jeq_np = np.zeros((2, nx))
        Jeq_np[0, 0] = Jeq_np[1, 1] = 1.0

        def const(a, like, batch):
            t = torch.as_tensor(a, dtype=like.dtype, device=like.device)
            return t.expand(batch + t.shape)

        def stage_gn(x, u, k, p):
            ex, eu, edu = errors(x, u, k, p)
            smax, sgrad = stage_slack_grad(x, u, k, p)
            r = torch.cat([mv(p["Q_s"], ex), mv(p["R_s"], eu),
                           mv(p["W_s"], edu),
                           (p["S_sqrt"] * smax)[..., None]], dim=-1)
            Jq = torch.zeros(2 * nu + nx, nx + nu, dtype=x.dtype,
                             device=x.device)
            Jq[:nx, :nx] = p["Q_s"]
            Jq[nx:nx + nu, nx:] = p["R_s"]
            Jq[nx + nu:, nx:] = p["W_s"]
            J = torch.cat([Jq.expand(sgrad.shape[:-1] + Jq.shape),
                           (p["S_sqrt"] * sgrad)[..., None, :]], dim=-2)
            return r, J

        def terminal_gn(x, p):
            ex = x - _rows(p, "X_ref", N)
            smax, sx = terminal_slack_grad(x, p)
            r = torch.cat([mv(p["P_s"], ex),
                           (p["S_sqrt"] * smax)[..., None]], dim=-1)
            J = torch.cat([p["P_s"].expand(sx.shape[:-1] + (nx, nx)),
                           (p["S_sqrt"] * sx)[..., None, :]], dim=-2)
            return r, J

        def stage_ineq_jac(x, u, k, p):
            c = stage_ineq(x, u, k, p)
            return c, const(Jc_np, x, c.shape[:-1])

        def terminal_ineq_jac(x, p):
            c = terminal_ineq(x, p)
            return c, const(Jc_np[:2 * nx, :nx], x, c.shape[:-1])

        def terminal_eq_jac(x, p):
            h = terminal_eq(x, p)
            return h, _eq_mask(p, 2) * const(Jeq_np, x, h.shape[:-1])

        def dynamics_jacobians(x, u):
            return wholebody_jacobians(x, u, dt)

        # ---- fully structured AL expansion (no Jacobian materialised) ----
        # stage_ineq rows: [x_hi(9), x_lo(9), du_hi(5), du_lo(5)];
        # terminal_ineq rows: [x_hi(9), x_lo(9)].  Box rows are +-unit
        # vectors, so their PHR terms are diagonal; the slack row is rank 1.
        def stage_al_expansion(x, u, k, p, lam_k, mu, inv_scale):
            ex, eu, edu = errors(x, u, k, p)
            smax, sgrad = stage_slack_grad(x, u, k, p)
            sx, su = sgrad[..., :nx], sgrad[..., nx:]
            S = p["S"]
            two_s = 2.0 * inv_scale
            Ssm = (S * smax)[..., None]
            Q = _weight(p, "Q", k)
            gx = two_s * (_mv(Q, ex) + Ssm * sx)
            gu = two_s * (mv(p["R"], eu) + mv(p["W"], edu) + Ssm * su)
            Hxx = two_s * (Q + S * outer(sx, sx))
            Huu = two_s * (p["R"] + p["W"] + S * outer(su, su))
            Hux = two_s * (S * outer(su, sx))

            z = lam_k + mu * stage_ineq(x, u, k, p)
            t = torch.clamp(z, min=0.0)
            act = (z > 0).to(x.dtype)
            gx = gx + t[..., :nx] - t[..., nx:2 * nx]
            gu = gu + t[..., 2 * nx:2 * nx + nu] - t[..., 2 * nx + nu:]
            Hxx = Hxx + torch.diag_embed(
                mu * (act[..., :nx] + act[..., nx:2 * nx]))
            Huu = Huu + torch.diag_embed(
                mu * (act[..., 2 * nx:2 * nx + nu] + act[..., 2 * nx + nu:]))
            return gx, gu, Hxx, Huu, Hux

        def terminal_al_expansion(x, p, lam_t, lam_e, mu, inv_scale):
            ex = x - _rows(p, "X_ref", N)
            smax, sx = terminal_slack_grad(x, p)
            S = p["S"]
            two_s = 2.0 * inv_scale
            P = _weight(p, "P")
            gx = two_s * (_mv(P, ex) + (S * smax)[..., None] * sx)
            Hxx = two_s * (P + S * outer(sx, sx))

            z = lam_t + mu * terminal_ineq(x, p)
            t = torch.clamp(z, min=0.0)
            act = (z > 0).to(x.dtype)
            gx = gx + t[..., :nx] - t[..., nx:]
            Hxx = Hxx + torch.diag_embed(mu * (act[..., :nx] + act[..., nx:]))

            # maskable terminal position equality h = m * (x[:2] - ref)
            m = _eq_mask(p, 1)
            geq = m * (lam_e + mu * terminal_eq(x, p))
            gx = gx + torch.nn.functional.pad(geq, (0, nx - 2))
            e2 = torch.zeros(nx, dtype=x.dtype, device=x.device)
            e2[:2] = 1.0
            m = _eq_mask(p, 2)
            Hxx = Hxx + torch.diag(e2) * (mu * m * m)
            return gx, Hxx

        # ---- fused kernels (ops/wholebody_fwd.py, ops/wholebody_bwd.py) ----
        kernel_cfg = dict(dt=dt, base_radius=base_radius, n_obs=self.n_obs,
                          n_hp=self.n_hp, x_bounds=self.x_bounds,
                          du_bounds=self.du_bounds, moving=moving,
                          bug_compat=bug_compat)

        def lanes_fwd_factory(cfg, params):
            alphas = [cfg.alpha_decay ** i for i in range(cfg.n_alpha)]
            return FwdLinesearch(
                self.ocp, params, u_clamp=(self.ulim[0], self.ulim[1]),
                alphas=alphas, inv_scale=1.0 / cfg.cost_scale, **kernel_cfg)

        def lanes_bwd_factory(cfg, params):
            return BwdFused(self.ocp, params, inv_scale=1.0 / cfg.cost_scale,
                            **kernel_cfg)

        return OCP(
            nx=nx, nu=nu, N=N, dynamics=dynamics,
            stage_cost=stage_cost, terminal_cost=terminal_cost,
            stage_ineq=stage_ineq, terminal_ineq=terminal_ineq,
            terminal_eq=terminal_eq,
            u_lower=self.ulim[0], u_upper=self.ulim[1],
            lanes_fwd_factory=lanes_fwd_factory,
            lanes_bwd_factory=lanes_bwd_factory,
            stage_al_expansion=stage_al_expansion,
            terminal_al_expansion=terminal_al_expansion,
            dynamics_jacobians=dynamics_jacobians,
            stage_residuals=stage_residuals,
            terminal_residuals=terminal_residuals,
            stage_gn=stage_gn, terminal_gn=terminal_gn,
            stage_ineq_jac=stage_ineq_jac,
            terminal_ineq_jac=terminal_ineq_jac,
            terminal_eq_jac=terminal_eq_jac,
            per_scenario_keys=frozenset(
                {"U_last", "X_ref", "U_ref", "Q", "P", "eq_mask"}))

    # ------------------------------------------------------------------
    def reset(self):
        """Clear the warm start (the problem is parameterised: nothing to
        rebuild)."""
        self.reset_warmstart()

    def setWeight(self, Q=None, R=None, P=None, S=None, W=None):
        """Runtime weight mutation (takes effect at the next make_params)."""
        if Q is not None:
            self.Q_value = as_weight_matrix(Q, self.NX)
        if R is not None:
            self.R_value = as_weight_matrix(R, self.NU)
        if P is not None:
            self.P_value = as_weight_matrix(P, self.NX)
        if S is not None:
            self.S_value = scalar_weight(S)
        if W is not None:
            self.W_value = as_weight_matrix(W, self.NU)

    def add_terminal_position_constraint(self):
        """Enable the FSM-injected terminal equality X[N, :2] == X_ref[N, :2]
        (a runtime mask)."""
        self.terminal_eq_mask = 1.0

    def set_obstacles(self, obstacles):
        """Update the ground-obstacle table, same count: rows (x, y, radius)
        as (n_obs, 3), or with moving obstacles a row a stage as
        (N+1, n_obs, 3)."""
        obstacles = np.asarray(obstacles, dtype=float)
        shape = ((self.N + 1,) if self.moving_obstacles else ()) + (
            self.n_obs, 3)
        if obstacles.shape != shape:
            raise ValueError(f"obstacles: expected shape {shape}, got "
                             f"{obstacles.shape}")
        self.obstacles_value = obstacles

    def make_params(self, traj_ref, u_ref) -> dict[str, np.ndarray]:
        """The per-problem data as host arrays; move them onto a device with
        ``utils.convert.params_from_numpy``."""
        return {
            "X_ref": np.asarray(traj_ref, dtype=float),
            "U_ref": np.asarray(u_ref, dtype=float),
            "Q": self.Q_value, "R": self.R_value, "P": self.P_value,
            "S": np.asarray(self.S_value), "W": self.W_value,
            "Q_s": weight_sqrt(self.Q_value),
            "R_s": weight_sqrt(self.R_value),
            "P_s": weight_sqrt(self.P_value),
            "W_s": weight_sqrt(self.W_value),
            "S_sqrt": np.sqrt(np.asarray(self.S_value)),
            "obstacles": self.obstacles_value,
            "hp_points": self.hp_points_value,
            "hp_normals": self.hp_normals_value,
            "hp_mask": self.hp_mask_value,
            "eq_mask": np.asarray(self.terminal_eq_mask),
        }

    def solve(self, x_init, traj_ref, u_ref):
        """One receding-horizon tick on the controller's device; returns u[0]
        as a numpy (5,) array."""
        x_init = np.asarray(x_init, dtype=float).copy()
        # clamp infeasible sensor feedback into the state box
        x_init = np.clip(x_init, self.xlim[0], self.xlim[1])
        if not (x_init[7] <= 0 and x_init[8] >= 0):
            raise ValueError(f"arm joints q2 = {x_init[7]} > 0 or "
                             f"q3 = {x_init[8]} < 0 after the clamp")
        return self._solve_impl(x_init, self.make_params(traj_ref, u_ref))

    def angleDiff(self, a, b):
        from mmmpc_tpu_torch.utils.math import angle_diff
        return angle_diff(a, b)

"""Shared controller plumbing (counterpart of
``mmmpc_tpu/controllers/common.py``).

The closed loop's single-scenario warm-started solve (``_solve_impl``,
``solve_fn``) runs the batched solver of ``solver/batched.py`` at batch 1,
so on the card each iLQR iteration launches the OCP's fused kernels once,
as a batch does.  The JAX package runs a separate single-scenario solver
(``al_ilqr_solve``: the generic Gauss-Newton expansion and a scanned
Riccati sweep); the port holds its batch-1 solve against that one by cost
and feasibility (``tests/test_torch_closed_loop.py``)."""

from __future__ import annotations

import numpy as np
import torch

from mmmpc_tpu_torch.solver.al_ilqr import SolveResult, shift_multipliers
from mmmpc_tpu_torch.utils.configs import SolverConfig
from mmmpc_tpu_torch.utils.convert import params_from_numpy


def finite_bound_masks(lim):
    """Split a (2, n) [lower; upper] bound array into dense values + masks;
    infinite entries are masked out (emitted as always-satisfied rows)."""
    lo = np.asarray(lim[0], dtype=float)
    hi = np.asarray(lim[1], dtype=float)
    mask_lo = np.isfinite(lo)
    mask_hi = np.isfinite(hi)
    return (np.where(mask_lo, lo, 0.0), np.where(mask_hi, hi, 0.0),
            mask_lo, mask_hi)


def as_weight_matrix(value, n):
    """Scalars, diagonals or full matrices -> an (n, n) matrix."""
    v = np.asarray(value, dtype=float)
    if v.ndim == 0:
        return v * np.eye(n)
    if v.ndim == 1:
        return np.diag(v)
    return v


def scalar_weight(value):
    """The reference's slack weights arrive as np.diag([w])."""
    return np.asarray(value, dtype=float).reshape(-1)[0]


def weight_sqrt(W):
    """Symmetric PSD square root of a weight matrix:
    e @ W @ e == ||sqrt(W) @ e||^2."""
    W = np.asarray(W, dtype=float)
    d = np.diag(W)
    if np.allclose(W, np.diag(d)):
        return np.diag(np.sqrt(np.maximum(d, 0.0)))
    vals, vecs = np.linalg.eigh(W)
    return vecs @ np.diag(np.sqrt(np.maximum(vals, 0.0))) @ vecs.T


def mv(M, v):
    """M @ v for a shared matrix M and batched vectors v (..., n)."""
    return v @ M.mT


def outer(a, b):
    return a[..., :, None] * b[..., None, :]


def quad(e, M):
    """e^T M e over the last axis."""
    return torch.sum(mv(M, e) * e, dim=-1)


# Per-scenario params (``ocp/spec.py``): the callables take a reference
# table or a weight either shared, or batch-first with one value a
# scenario.  The helpers below read both; on a shared entry they are the
# plain indexing, ``mv`` and ``quad`` above.

# The entries a generic controller (demo, base, arm, endpoint) takes one
# value a scenario: its callables and its line search (kernel C's
# per-scenario instance) read them, its fused backward (D) does not.  The
# arm and the endpoint, which penalise the change from U_last, take U_last
# so too.
GENERIC_PER_SCENARIO_KEYS = frozenset({"X_ref", "U_ref", "Q", "P"})


def ref_rows(p, key, k):
    """Row(s) k of the reference table ``key`` (X_ref, U_ref, U_last): of
    the shared (rows, n), or of a per-scenario (B, rows, n) -> (B, *k.shape,
    n), whose batch axis falls on x's."""
    t = p[key]
    return t[:, k] if t.dim() == 3 else t[k]


def weight(p, key, k=None):
    """Weight ``key`` (Q, P): the shared (n, n), or a per-scenario (B, n, n)
    with a unit axis for each axis of the stage index ``k`` (none at the
    terminal), so that it broadcasts against x's batch axis."""
    t = p[key]
    if t.dim() == 2:
        return t
    kd = k.dim() if torch.is_tensor(k) else 0
    return t.reshape(t.shape[:1] + (1,) * kd + t.shape[1:])


def wmv(M, v):
    """M v for a shared or a per-scenario (``weight``) matrix M."""
    return mv(M, v) if M.dim() == 2 else (M @ v[..., None])[..., 0]


def wquad(e, M):
    """e^T M e over the last axis, M shared or per scenario."""
    return torch.sum(wmv(M, e) * e, dim=-1)


def no_rows(x, *_):
    """An empty constraint group: (..., 0)."""
    return x.new_zeros(x.shape[:-1] + (0,))


def constraint_dims(ocp, params):
    """(nc, nct, ne): the widths of an OCP's stage inequality, terminal
    inequality and terminal equality groups."""
    like = params["X_ref"]
    zx = like.new_zeros(ocp.nx)
    zu = like.new_zeros(ocp.nu)
    return (ocp.stage_ineq(zx, zu, 0, params).shape[-1],
            ocp.terminal_ineq(zx, params).shape[-1],
            ocp.terminal_eq(zx, params).shape[-1])


class ControllerBase:
    """The OCP, its solver schedule, the device it solves on and the
    closed loop's warm start.

    ``device`` is where ``solve`` computes: the first CUDA device unless the
    caller names another (the tests pass ``"cpu"``, where the kernels' plain
    versions run).  The warm start -- the last solve's inputs ``u_latest``
    (N, nu) and its shifted, damped multipliers ``lam_latest`` -- stays on
    that device between ticks, in float32, the kernels' dtype."""

    def __init__(self, ocp, solver_config: SolverConfig | None = None,
                 device=None):
        self.ocp = ocp
        self.solver_config = solver_config or SolverConfig()
        self.N = ocp.N
        self.device = torch.device("cuda" if device is None else device)
        self.u_latest = None
        self.lam_latest = None
        self.last_result = None

    def solve_fn(self):
        """(x0 (nx,), U0 (N, nu), params, lam0=None) -> the batch-free
        SolveResult of one scenario, solved at batch 1 on the tensors'
        device; ``lam0`` the multiplier warm start
        (lam_stage (N, nc), lam_term (nct,), lam_eq (ne,)), zero when
        omitted (the JAX package's ``solve_fn(x0, U0, params)``)."""
        from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
        ocp, cfg = self.ocp, self.solver_config

        def solve(x0, U0, params, lam0=None):
            lam0_b = None if lam0 is None else tuple(v[None] for v in lam0)
            res = al_ilqr_solve_batched(ocp, x0[None], U0[None], params, cfg,
                                        lam0_b=lam0_b)
            return SolveResult(*(f[0] for f in res))

        return solve

    def batch_solve_fn(self):
        """(x0_b (B, nx), U0_b (B, N, nu), params) -> batch-major SolveResult
        of the batched solve (``solver/batched.py``)."""
        from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
        ocp, cfg = self.ocp, self.solver_config
        return lambda x0_b, U0_b, params: al_ilqr_solve_batched(
            ocp, x0_b, U0_b, params, cfg)

    def batch_solve_refined_fn(self, refine_cfg=None, refine_size=None):
        """(x0_b (B, nx), U0_b (B, N, nu), params) -> batch-major SolveResult,
        with two-stage straggler refinement (``solver/refine.py``)."""
        from mmmpc_tpu_torch.solver.refine import al_ilqr_solve_refined
        ocp, cfg = self.ocp, self.solver_config
        return lambda x0_b, U0_b, params: al_ilqr_solve_refined(
            ocp, x0_b, U0_b, params, cfg, refine_cfg=refine_cfg,
            refine_size=refine_size)

    def reset_warmstart(self):
        self.u_latest = None
        self.lam_latest = None

    def _solve_impl(self, x_init, params):
        """One warm-started tick: ``params`` (host arrays of
        ``make_params``) go onto the device in float32 with
        ``U_last = u_latest``; ``solve_fn`` runs from ``x_init`` with the
        warm inputs and multipliers; its inputs and shifted multipliers
        become the next tick's warm start, its batch-free result
        ``last_result``.  Returns u[0] as a numpy (nu,) array, the tick's
        one wait for the device."""
        kw = dict(dtype=torch.float32, device=self.device)
        if self.u_latest is None:
            self.u_latest = torch.zeros(self.N, self.ocp.nu, **kw)
        p = params_from_numpy(params, self.device, torch.float32)
        p["U_last"] = self.u_latest
        if self.lam_latest is None:
            nc, nct, ne = constraint_dims(self.ocp, p)
            self.lam_latest = (torch.zeros(self.N, nc, **kw),
                               torch.zeros(nct, **kw), torch.zeros(ne, **kw))
        x0 = torch.as_tensor(np.asarray(x_init), **kw)
        res = self.solve_fn()(x0, self.u_latest, p, self.lam_latest)
        self.u_latest = res.U
        self.lam_latest = shift_multipliers(res.lam_stage, res.lam_term,
                                            res.lam_eq)
        self.last_result = res
        return res.U[0].cpu().numpy()

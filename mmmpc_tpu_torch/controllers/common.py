"""Shared controller plumbing (counterpart of
``mmmpc_tpu/controllers/common.py``; the single-scenario warm-started
``solve`` of the closed loop is not ported yet)."""

from __future__ import annotations

import numpy as np
import torch

from mmmpc_tpu_torch.utils.configs import SolverConfig


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


def no_rows(x, *_):
    """An empty constraint group: (..., 0)."""
    return x.new_zeros(x.shape[:-1] + (0,))


class ControllerBase:
    """The OCP and its solver schedule."""

    def __init__(self, ocp, solver_config: SolverConfig | None = None):
        self.ocp = ocp
        self.solver_config = solver_config or SolverConfig()
        self.N = ocp.N

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

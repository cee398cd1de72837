"""The Riccati stage step (counterpart of
``mmmpc_tpu/ops/entry_algebra.py::riccati_stage``).

The JAX module folds literal zeros of the sparse dynamics Jacobians at trace
time; that folding lives in the CUDA kernel's explicit sparse products
(``csrc/wholebody_common.cuh``).  Here the step is plain batched matmuls: the
backward kernel's plain version runs it once per stage.
"""

from __future__ import annotations

import torch

from mmmpc_tpu_torch.solver.linalg_small import chol_solve_unrolled


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def riccati_stage(lx, lu, lxx, luu, lux, A, Bm, Vx, Vxx, reg):
    """One backward Riccati step on batched blocks — lx (..., nx),
    lxx (..., nx, nx), A (..., nx, nx), Bm (..., nx, nu), reg (...) — from the
    next stage's value function (Vx, Vxx).  Returns (kff, K, Vx_new, Vxx_new);
    Vxx_new is not symmetrised here.  Cholesky of Quu + reg I; the value
    update uses Quu without reg."""
    At, Bt = A.mT, Bm.mT
    Qx = lx + _mv(At, Vx)
    Qu = lu + _mv(Bt, Vx)
    VA = Vxx @ A
    Qxx = lxx + At @ VA
    Quu = luu + Bt @ (Vxx @ Bm)
    Qux = lux + Bt @ VA

    nu = Quu.shape[-1]
    eye = torch.eye(nu, dtype=Quu.dtype, device=Quu.device)
    sol = chol_solve_unrolled(Quu + reg[..., None, None] * eye,
                              torch.cat([Qu[..., None], Qux], dim=-1))
    kff = -sol[..., 0]
    K = -sol[..., 1:]

    Kt = K.mT
    Vx_n = Qx + _mv(Kt, _mv(Quu, kff) + Qu) + _mv(Qux.mT, kff)
    Vxx_n = Qxx + Kt @ Quu @ K + Kt @ Qux + Qux.mT @ K
    return kff, K, Vx_n, Vxx_n

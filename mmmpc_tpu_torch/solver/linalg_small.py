"""Tiny-matrix linear algebra, unrolled (counterpart of
``mmmpc_tpu/solver/linalg_small.py``).

For the single-digit sizes here (nu = 5) an unrolled Cholesky with
triangular solves is a short chain of elementwise ops over the batch.
"""

from __future__ import annotations

import torch


def chol_solve_unrolled(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for SPD A: A (..., n, n), B (..., n, m) -> (..., n, m)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]

    # forward substitution L Y = B, one row of all columns at a time
    Y = []
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * Y[k]
        Y.append(s / L[i][i][..., None])

    # back substitution L^T X = Y
    X = [None] * n
    for i in reversed(range(n)):
        s = Y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * X[k]
        X[i] = s / L[i][i][..., None]
    return torch.stack(X, dim=-2)

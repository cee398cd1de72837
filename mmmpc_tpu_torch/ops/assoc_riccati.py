"""Associative-scan (parallel-prefix) Riccati backward sweep.

Counterpart of ``mmmpc_tpu/ops/assoc_riccati.py`` (pure JAX there, no
Pallas kernel: nothing here is a hand kernel either).  The sequential sweep
(``ops/riccati.py``, or the fused backward kernels) runs N dependent
stages; at long horizons and small batches that depth, not the work, sets
its time.  This module evaluates the same backward pass as an associative
composition over the stages in O(log N) sequential depth (temporal
parallelisation of the LQ tracker, Särkkä and García-Fernández).

An element over an interval of stages is e = (A, b, C, eta, J): the
interval's state map x_j = A x_i + b with the C-weighted slack, and its
value 1/2 x_i^T J x_i - eta^T x_i.  Two adjacent elements (earlier e1,
later e2) compose as

    M   = (I + C1 J2)^-1
    A   = A2 M A1
    b   = A2 M (b1 + C1 eta2) + b2
    C   = A2 M C1 A2^T + C2
    eta = A1^T M^T (eta2 - J2 b1) + eta1
    J   = A1^T M^T J2 A1 + J1        (symmetrised)

A stage's element comes from its expansion with the input eliminated
(complete the square in u, with the regularisation reg in the input block);
the terminal element is (0, 0, 0, -term_g, term_H).  The composition of the
suffix that starts at stage k gives V_k: Vxx_k = J, Vx_k = -eta; the gains
of every stage then follow in parallel, with the formulas of the sequential
sweep.  The JAX module composes with ``lax.associative_scan``; torch has
no eager counterpart, so the suffixes here are formed by doubling
(Hillis-Steele: after round d every stage holds the composition of the
2^d stages from it on), ceil(log2(N + 1)) rounds of batched 9 x 9
products and solves.  It composes in another order than JAX's, so it is
held to JAX's result at a tolerance, not to its bits.

Two entries: ``assoc_riccati_backward`` with the JAX function's
single-scenario signature, and ``assoc_riccati_backward_bm`` on the
batch-last blocks that ``ops/riccati.py::riccati_backward_bm`` takes, the
form the batched solver calls (``solver/batched.py``).  Both run on any
device and float dtype; ``CALLS`` counts the batched entry's calls, on
CUDA tensors (``cuda``) and on CPU tensors (``plain``).
"""

from __future__ import annotations

import torch

from mmmpc_tpu_torch.ops._cuda import LaunchCounter

CALLS = LaunchCounter()


def _solve(A, B):
    """A^-1 B, batched; no check of the factorisation (``solve_ex``), so a
    call on the card does not wait for it."""
    return torch.linalg.solve_ex(A, B)[0]


def _combine(e1, e2):
    """Compose adjacent interval elements (earlier e1, later e2), batched
    over any leading axes."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    nx = A1.shape[-1]
    eye = torch.eye(nx, dtype=A1.dtype, device=A1.device)
    M = _solve(eye + C1 @ J2, eye.expand_as(C1))
    AM = A2 @ M
    A = AM @ A1
    b = (AM @ (b1 + (C1 @ eta2[..., None])[..., 0])[..., None])[..., 0] + b2
    C = AM @ C1 @ A2.mT + C2
    AtMt = (M @ A1).mT
    eta = (AtMt @ (eta2 - (J2 @ b1[..., None])[..., 0])[..., None])[..., 0] \
        + eta1
    J = AtMt @ J2 @ A1 + J1
    return A, b, C, eta, 0.5 * (J + J.mT)


def _suffixes(elems):
    """Inclusive suffix compositions over axis 1 (the stages):
    out[:, k] = e_k o e_{k+1} o ... o e_last, by doubling."""
    n = elems[0].shape[1]
    off = 1
    while off < n:
        head = _combine(tuple(e[:, :n - off] for e in elems),
                        tuple(e[:, off:] for e in elems))
        elems = tuple(torch.cat([h, e[:, n - off:]], dim=1)
                      for h, e in zip(head, elems))
        off *= 2
    return elems


def _backward_bf(lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg):
    """The sweep, batch-first: lx (S, N, nx), lu (S, N, nu), lxx
    (S, N, nx, nx), luu (S, N, nu, nu), lux (S, N, nu, nx), A (S, N, nx, nx),
    Bm (S, N, nx, nu), term_g (S, nx), term_H (S, nx, nx), reg (S,) ->
    kff (S, N, nu), K (S, N, nu, nx)."""
    S, N, nx = lx.shape
    nu = lu.shape[-1]
    eye_u = torch.eye(nu, dtype=lx.dtype, device=lx.device)
    r = reg[:, None, None, None] * eye_u

    # eliminate u (and the cross term) at every stage at once
    sol = _solve(luu + r, torch.cat([lux, lu[..., None], Bm.mT], dim=-1))
    Kc, kc, LB = sol[..., :nx], sol[..., nx], sol[..., nx + 1:]
    F = A - Bm @ Kc
    b = -(Bm @ kc[..., None])[..., 0]
    C = Bm @ LB
    lx_eff = lx - (Kc.mT @ lu[..., None])[..., 0]
    lxx_eff = lxx - Kc.mT @ lux
    lxx_eff = 0.5 * (lxx_eff + lxx_eff.mT)

    # the stages' elements, then the terminal one
    zx = lx.new_zeros(S, 1, nx, nx)
    elems = (torch.cat([F, zx], 1), torch.cat([b, lx.new_zeros(S, 1, nx)], 1),
             torch.cat([C, zx], 1), torch.cat([-lx_eff, -term_g[:, None]], 1),
             torch.cat([lxx_eff, term_H[:, None]], 1))
    _, _, _, eta_s, J_s = _suffixes(elems)
    Vx, Vxx = -eta_s[:, 1:], J_s[:, 1:]       # V of stage k + 1

    # the gains of every stage, as the sequential sweep forms them
    Bt = Bm.mT
    Qu = lu + (Bt @ Vx[..., None])[..., 0]
    Quu = luu + Bt @ (Vxx @ Bm)
    Qux = lux + Bt @ (Vxx @ A)
    sol = _solve(Quu + r, torch.cat([Qu[..., None], Qux], dim=-1))
    return -sol[..., 0], -sol[..., 1:]


def assoc_riccati_backward(lx, lu, lxx, luu, lux, A, B, term_g, term_H,
                           reg=0.0):
    """One scenario, the JAX function's signature: lx (N, nx), lu (N, nu),
    lxx (N, nx, nx), luu (N, nu, nu), lux (N, nu, nx), A (N, nx, nx),
    B (N, nx, nu), term_g (nx,), term_H (nx, nx), reg a float ->
    kff (N, nu), K (N, nu, nx)."""
    kff, K = _backward_bf(*(t[None] for t in (
        lx, lu, lxx, luu, lux, A, B, term_g, term_H)),
        torch.full((1,), float(reg), dtype=lx.dtype, device=lx.device))
    return kff[0], K[0]


def assoc_riccati_backward_bm(lx, lu, lxx, luu, lux, A, Bm, term_g, term_H,
                              reg):
    """The arguments of ``ops/riccati.py::riccati_backward_bm``, batch-last:
    lx (N, nx, B), lu (N, nu, B), lxx (N, nx, nx, B), luu (N, nu, nu, B),
    lux (N, nu, nx, B), A (N, nx, nx, B), Bm (N, nx, nu, B), term_g (nx, B),
    term_H (nx, nx, B), reg (B,) or a scalar -> kff (N, nu, B),
    K (N, nu, nx, B)."""
    B = lx.shape[-1]
    if not torch.is_tensor(reg) or reg.dim() == 0:
        reg = torch.full((B,), float(reg), dtype=lx.dtype, device=lx.device)
    if lx.device.type == "cuda":
        CALLS.cuda += 1
    else:
        CALLS.plain += 1
    kff, K = _backward_bf(*(t.movedim(-1, 0) for t in (
        lx, lu, lxx, luu, lux, A, Bm, term_g, term_H)), reg)
    return (kff.movedim(0, -1).contiguous(), K.movedim(0, -1).contiguous())

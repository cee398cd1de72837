"""Batched Riccati backward sweep on precomputed expansion blocks.

Counterpart of ``mmmpc_tpu/ops/riccati.py::riccati_backward_bm`` (the Pallas
TPU kernel ``_kernel``), the sweep the batched solver runs wherever the fused
backward is off.  Batch-last, as the JAX interface: from the terminal
gradient / Hessian it runs backward over the stages, one Riccati step each
(Cholesky of Quu + reg I giving kff = -Quu^-1 Qu and K = -Quu^-1 Qux, the
value update with Quu without reg), with Vxx symmetrised after every step.

On CUDA tensors the call launches ``ric_bwd_<nx>x<nu>`` (``csrc/riccati.cu``)
at any (nx, nu), as the JAX function takes it from its operands: the
kernel library holds the pairs of the ported controllers, and any other
pair is compiled into a library of its own on its first call
(``ops/_cuda.py::RICCATI``); a failed build raises.  On CPU tensors it runs
``plain_riccati_bm``: ``ops.entry_algebra.riccati_stage`` in a loop over
the stages.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from mmmpc_tpu_torch.ops._cuda import (
    RICCATI, LaunchCounter, check_launch, check_tensor,
)
from mmmpc_tpu_torch.ops.entry_algebra import riccati_stage

# dispatches per (nx, nu), each pair's counter made on its first use
LAUNCHES = collections.defaultdict(LaunchCounter)


def launch_geometry(nx, nu, B, entries=RICCATI):
    """{team, threads, blocks, smem_bytes, blocks_per_sm}: the lanes a
    scenario, threads a block, blocks and dynamic shared-memory bytes with
    which ``ric_bwd_<nx>x<nu>`` launches at batch ``B``, and the blocks of
    it that one SM of the card holds, as ``ric_geometry_<nx>x<nu>`` reports
    them (on the card: it asks the CUDA runtime for the occupancy)."""
    out = (ctypes.c_int * 5)()
    check_launch(f"riccati_bwd.{nx}x{nu} geometry",
                 entries.geometry(nx, nu)(B, out))
    return dict(team=out[0], threads=out[1], blocks=out[2],
                smem_bytes=out[3], blocks_per_sm=out[4])


def plain_riccati_bm(lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg):
    """The sweep in plain PyTorch (any device, any float dtype), on the
    arguments of ``riccati_backward_bm`` with ``reg`` of shape (B,)."""
    N = lx.shape[0]

    def bf(a):                      # (..., B) -> (B, ...)
        return a.movedim(-1, 0)

    Vx, Vxx = bf(term_g), bf(term_H)
    kffs, Ks = [None] * N, [None] * N
    for k in reversed(range(N)):
        kffs[k], Ks[k], Vx, Vxx = riccati_stage(
            bf(lx[k]), bf(lu[k]), bf(lxx[k]), bf(luu[k]), bf(lux[k]),
            bf(A[k]), bf(Bm[k]), Vx, Vxx, reg)
        Vxx = 0.5 * (Vxx + Vxx.mT)
    return (torch.stack(kffs).permute(0, 2, 1).contiguous(),
            torch.stack(Ks).permute(0, 2, 3, 1).contiguous())


def riccati_backward_bm(lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg):
    """lx (N, nx, B), lu (N, nu, B), lxx (N, nx, nx, B), luu (N, nu, nu, B),
    lux (N, nu, nx, B), A (N, nx, nx, B), Bm (N, nx, nu, B), term_g (nx, B),
    term_H (nx, nx, B), reg (B,) or a scalar -> kff (N, nu, B),
    K (N, nu, nx, B)."""
    N, nx, B = lx.shape
    nu = lu.shape[1]
    dev = lx.device
    if not torch.is_tensor(reg) or reg.dim() == 0:
        reg = torch.full((B,), float(reg), dtype=lx.dtype, device=dev)
    if dev.type == "cuda":
        return _launch(lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg)
    if dev.type != "cpu":
        raise ValueError(f"no riccati_backward_bm for device {dev}")
    LAUNCHES[(nx, nu)].plain += 1
    return plain_riccati_bm(lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg)


def _launch(lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg):
    """Launch ``ric_bwd_<nx>x<nu>`` on the current stream."""
    N, nx, B = lx.shape
    nu = lu.shape[1]
    dev = lx.device
    shapes = {"lx": (N, nx, B), "lu": (N, nu, B), "lxx": (N, nx, nx, B),
              "luu": (N, nu, nu, B), "lux": (N, nu, nx, B),
              "A": (N, nx, nx, B), "Bm": (N, nx, nu, B), "term_g": (nx, B),
              "term_H": (nx, nx, B), "reg": (B,)}
    ptrs = [check_tensor(name, t, shape, dev) for (name, shape), t in zip(
        shapes.items(), (lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg))]
    kw = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty(N, nu, B, **kw), torch.empty(N, nu, nx, B, **kw))
    entry = RICCATI.get(nx, nu)
    with torch.cuda.device(dev):
        err = entry(*ptrs, *(o.data_ptr() for o in outs), N, B,
                    torch.cuda.current_stream().cuda_stream)
    check_launch(f"riccati_bwd.{nx}x{nu}", err)
    LAUNCHES[(nx, nu)].cuda += 1
    return outs

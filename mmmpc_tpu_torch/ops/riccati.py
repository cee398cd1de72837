"""Batched Riccati backward sweep on precomputed expansion blocks.

Counterpart of ``mmmpc_tpu/ops/riccati.py::riccati_backward_bm`` (the Pallas
TPU kernel ``_kernel``), the sweep the batched solver runs wherever the fused
backward is off.  Batch-last, as the JAX interface: from the terminal
gradient / Hessian it runs backward over the stages, one Riccati step each
(Cholesky of Quu + reg I giving kff = -Quu^-1 Qu and K = -Quu^-1 Qux, the
value update with Quu without reg), with Vxx symmetrised after every step.

On CUDA tensors the call launches ``ric_bwd_<nx>x<nu>`` of the kernel library
(``csrc/riccati.cu``, one instance per (nx, nu) of the ported controllers);
on CPU tensors it runs ``plain_riccati_bm``: ``ops.entry_algebra.
riccati_stage`` in a loop over the stages.
"""

from __future__ import annotations

import torch

from mmmpc_tpu_torch.ops._cuda import (
    LIBRARY, RICCATI_INSTANCES, LaunchCounter, check_launch, check_tensor,
)
from mmmpc_tpu_torch.ops.entry_algebra import riccati_stage

# dispatches per (nx, nu) instance
LAUNCHES = {pair: LaunchCounter() for pair in RICCATI_INSTANCES}


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
    if (nx, nu) in LAUNCHES:
        LAUNCHES[(nx, nu)].plain += 1
    return plain_riccati_bm(lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg)


def _launch(lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg):
    """Launch ``ric_bwd_<nx>x<nu>`` on the current stream."""
    N, nx, B = lx.shape
    nu = lu.shape[1]
    if (nx, nu) not in LAUNCHES:
        raise ValueError(f"riccati_backward_bm: no CUDA instance for (nx, nu) "
                         f"= {(nx, nu)}; instances: {list(LAUNCHES)}")
    dev = lx.device
    shapes = {"lx": (N, nx, B), "lu": (N, nu, B), "lxx": (N, nx, nx, B),
              "luu": (N, nu, nu, B), "lux": (N, nu, nx, B),
              "A": (N, nx, nx, B), "Bm": (N, nx, nu, B), "term_g": (nx, B),
              "term_H": (nx, nx, B), "reg": (B,)}
    ptrs = [check_tensor(name, t, shape, dev) for (name, shape), t in zip(
        shapes.items(), (lx, lu, lxx, luu, lux, A, Bm, term_g, term_H, reg))]
    kw = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty(N, nu, B, **kw), torch.empty(N, nu, nx, B, **kw))
    lib = LIBRARY.get()
    with torch.cuda.device(dev):
        err = getattr(lib, f"ric_bwd_{nx}x{nu}")(
            *ptrs, *(o.data_ptr() for o in outs), N, B,
            torch.cuda.current_stream().cuda_stream)
    check_launch(f"riccati_bwd.{nx}x{nu}", err)
    LAUNCHES[(nx, nu)].cuda += 1
    return outs

"""Fused forward rollout + parallel line search of the whole-body qref MPC.

Counterpart of ``mmmpc_tpu/ops/wholebody_fwd.py::make_fwd_linesearch`` (the
Pallas TPU kernel ``_kernel``), as ``FwdLinesearch``. For every scenario and
every step size alpha, one pass over the horizon computes

    u_k     = clamp(U_k + alpha * kff_k + K_k (x_k - X_k))
    cost   += stage_cost(x_k, u_k) / cost_scale + PHR(stage_ineq, lam_k, mu)
    x_{k+1} = f(x_k, u_k)

and adds the terminal AL cost (P tracking, terminal slack groups, PHR on the
terminal boxes, the maskable position equality) at the end, so the returned
per-candidate costs are complete.

On CUDA tensors the call launches the hand-written kernel
``csrc/wholebody_fwd.cu``; on CPU tensors it runs the plain PyTorch version,
``ops/generic_fwd.py::plain_fwd``, built from the OCP's own callables.  There
is no fallback between them.

This module also owns the two parameter blocks both fused kernels read:
``pack_params`` (the per-problem tensors, one flat buffer on the device) and
``statics_block`` (bounds, masks, step sizes and constants, passed by value
as a kernel argument).  Their layouts are ``param_layout`` and the ``ST_*``
offsets of ``csrc/wholebody_common.cuh``; before every launch the wrappers
hold the sizes of both against the ones the compiled library reports.
"""

from __future__ import annotations

import numpy as np
import torch

from mmmpc_tpu_torch.ops._cuda import (
    LIBRARY, MAX_ALPHA, LaunchCounter, check_launch, check_layout,
    check_tensor, pack_buffer, unpack_buffer,
)
from mmmpc_tpu_torch.ops.generic_fwd import plain_fwd

NX, NU = 9, 5
NC = 2 * NX + 2 * NU

LAUNCHES = LaunchCounter()

# ---- the packed per-problem buffer (Par* offsets in the CUDA header) ----
def _packed_shapes(N, n_obs, n_hp):
    return {"S": (), "eq_mask": (), "Q": (NX, NX), "R": (NU, NU),
            "W": (NU, NU), "P": (NX, NX), "X_ref": (N + 1, NX),
            "U_ref": (N, NU), "U_last": (N, NU), "obstacles": (n_obs, 3),
            "hp_points": (n_hp, 3), "hp_normals": (n_hp, 3),
            "hp_mask": (n_hp,)}


def pack_params(params, N, n_obs, n_hp) -> torch.Tensor:
    """The shared per-problem tensors as one contiguous buffer (dtype and
    device of ``params``).  Per-scenario entries are not supported."""
    return pack_buffer(_packed_shapes(N, n_obs, n_hp), params)


def unpack_params(flat, N, n_obs, n_hp) -> dict[str, torch.Tensor]:
    """Views of ``flat`` under the keys of the controller's params."""
    return unpack_buffer(_packed_shapes(N, n_obs, n_hp), flat)


# ---- the statics block (St* offsets in the CUDA header) ----
_STATIC_FIELDS = (("dt", 1), ("inv_scale", 1), ("base_radius", 1),
                  ("n_alpha", 1), ("n_obs", 1), ("n_hp", 1), ("x_lo", NX), ("x_hi", NX), ("x_mlo", NX),
                  ("x_mhi", NX), ("du_lo", NU), ("du_hi", NU),
                  ("du_mlo", NU), ("du_mhi", NU), ("u_lo", NU), ("u_hi", NU),
                  ("alphas", MAX_ALPHA))


def statics_block(*, dt, inv_scale, base_radius, n_obs, n_hp, x_bounds,
                  du_bounds, u_clamp=None, alphas=()) -> np.ndarray:
    """Host float32 block of everything static to a solve."""
    if len(alphas) > MAX_ALPHA:
        raise ValueError(f"at most {MAX_ALPHA} step sizes, got {len(alphas)}")
    u_lo, u_hi = u_clamp if u_clamp is not None else (
        np.full(NU, -np.inf), np.full(NU, np.inf))
    values = dict(dt=dt, inv_scale=inv_scale, base_radius=base_radius,
                  n_alpha=len(alphas), n_obs=n_obs, n_hp=n_hp, u_lo=u_lo, u_hi=u_hi,
                  alphas=np.pad(np.asarray(alphas, float),
                                (0, MAX_ALPHA - len(alphas))))
    for name, b in zip(("x_lo", "x_hi", "x_mlo", "x_mhi"), x_bounds):
        values[name] = b
    for name, b in zip(("du_lo", "du_hi", "du_mlo", "du_mhi"), du_bounds):
        values[name] = b
    return np.concatenate([
        np.asarray(values[name], dtype=np.float32).reshape(n)
        for name, n in _STATIC_FIELDS])


class FwdLinesearch:
    """The fused rollout + line search of one problem (the JAX package's
    ``make_fwd_linesearch``): static data (bounds, masks, clamp limits,
    alphas, dt) from the keyword arguments, runtime data (weights,
    references, geometry) from ``params``, packed once; multipliers and mu
    are call arguments."""

    def __init__(self, ocp, params, *, dt, base_radius, n_obs, n_hp,
                 x_bounds, du_bounds, u_clamp, alphas, inv_scale):
        if (ocp.nx, ocp.nu) != (NX, NU):
            raise ValueError("the whole-body kernels take nx=9, nu=5")
        self.ocp = ocp
        self.N, self.n_obs, self.n_hp = ocp.N, n_obs, n_hp
        self.alphas = tuple(float(a) for a in alphas)
        self.inv_scale = float(inv_scale)
        self.flat = pack_params(params, ocp.N, n_obs, n_hp)
        self.statics = statics_block(
            dt=dt, inv_scale=inv_scale, base_radius=base_radius,
            n_obs=n_obs, n_hp=n_hp, x_bounds=x_bounds, du_bounds=du_bounds,
            u_clamp=u_clamp, alphas=self.alphas)

    def __call__(self, X, U, kff, K, lam, lamt, lame, mu):
        """X (N, nx, B) stage states, U (N, nu, B), kff (N, nu, B),
        K (N, nu, nx, B), lam (N, nc, B), lamt (2 nx, B), lame (2, B) ->
        Xc (N, n_alpha, nx, B), Uc (N, n_alpha, nu, B), xlast (n_alpha, nx, B),
        cost (n_alpha, B) including the terminal AL cost."""
        if X.device.type == "cuda":
            return self.cuda(X, U, kff, K, lam, lamt, lame, mu)
        if X.device.type != "cpu":
            raise ValueError(f"no wholebody_fwd for device {X.device}")
        LAUNCHES.plain += 1
        return self.plain(X, U, kff, K, lam, lamt, lame, mu)

    def plain(self, X, U, kff, K, lam, lamt, lame, mu):
        """``ops/generic_fwd.py::plain_fwd`` on the packed params (any
        device, any float dtype)."""
        return plain_fwd(self.ocp, unpack_params(self.flat, self.N, self.n_obs,
                                                 self.n_hp),
                         self.alphas, self.inv_scale, X, U, kff, K, lam, lamt,
                         lame, mu)

    def cuda(self, X, U, kff, K, lam, lamt, lame, mu):
        """Launch ``csrc/wholebody_fwd.cu`` on the current stream."""
        N, B, na = self.N, X.shape[-1], len(self.alphas)
        ptrs = [check_tensor("params", self.flat, (self.flat.numel(),),
                             X.device),
                check_tensor("X", X, (N, NX, B), X.device),
                check_tensor("U", U, (N, NU, B), X.device),
                check_tensor("kff", kff, (N, NU, B), X.device),
                check_tensor("K", K, (N, NU, NX, B), X.device),
                check_tensor("lam", lam, (N, NC, B), X.device),
                check_tensor("lam_term", lamt, (2 * NX, B), X.device),
                check_tensor("lam_eq", lame, (2, B), X.device)]
        kw = dict(dtype=torch.float32, device=X.device)
        outs = (torch.empty(N, na, NX, B, **kw), torch.empty(N, na, NU, B, **kw),
                torch.empty(na, NX, B, **kw), torch.empty(na, B, **kw))
        lib = LIBRARY.get()
        check_layout(lib, self.statics, self.flat, N, self.n_obs, self.n_hp)
        with torch.cuda.device(X.device):
            err = lib.wb_fwd_launch(
                self.statics.ctypes.data, *ptrs, *(o.data_ptr() for o in outs),
                float(mu), N, B, torch.cuda.current_stream().cuda_stream)
        check_launch("wholebody_fwd", err)
        LAUNCHES.cuda += 1
        return outs


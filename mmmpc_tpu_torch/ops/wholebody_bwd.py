"""Fused AL expansion + Riccati backward sweep of the whole-body qref MPC.

Counterpart of ``mmmpc_tpu/ops/wholebody_bwd.py::make_bwd_fused`` (the Pallas
TPU kernel ``_kernel``), as ``BwdFused``. From the terminal AL expansion (->
Vx, Vxx) it runs backward over the stages: at each stage the Gauss-Newton
gradient and Hessian of the tracking, input and rate costs, the slack-group
gradient, the PHR rows of the boxes, the sparse dynamics Jacobians, then one
Riccati step (Cholesky of Quu + reg I) giving kff = -Quu^-1 Qu and K = -Quu^-1
Qux. Vxx is symmetrised after every step, as the TPU kernel does.

On CUDA tensors the call launches the hand-written kernel
``csrc/wholebody_bwd.cu``; on CPU tensors it runs the plain PyTorch version,
``ops/generic_bwd.py::plain_bwd``: the controller's hand AL expansion at
every stage, then the plain Riccati sweep ``ops/riccati.py::
plain_riccati_bm``.
"""

from __future__ import annotations

import torch

from mmmpc_tpu_torch.ops._cuda import (
    LIBRARY, LaunchCounter, check_launch, check_layout, check_tensor,
)
from mmmpc_tpu_torch.ops.generic_bwd import plain_bwd
from mmmpc_tpu_torch.ops.wholebody_fwd import (
    NC, NU, NX, pack_params, statics_block, unpack_params,
)

LAUNCHES = LaunchCounter()


class BwdFused:
    """The fused backward sweep of one problem (the JAX package's
    ``make_bwd_fused``): static data from the keyword arguments, runtime
    data from ``params``, packed once."""

    def __init__(self, ocp, params, *, dt, base_radius, n_obs, n_hp,
                 x_bounds, du_bounds, inv_scale):
        if (ocp.nx, ocp.nu) != (NX, NU):
            raise ValueError("the whole-body kernels take nx=9, nu=5")
        self.ocp = ocp
        self.N, self.n_obs, self.n_hp = ocp.N, n_obs, n_hp
        self.inv_scale = float(inv_scale)
        self.flat = pack_params(params, ocp.N, n_obs, n_hp)
        self.statics = statics_block(
            dt=dt, inv_scale=inv_scale, base_radius=base_radius,
            n_obs=n_obs, n_hp=n_hp, x_bounds=x_bounds, du_bounds=du_bounds)

    def __call__(self, X, U, lam, lamt, lame, mu, reg):
        """X (N+1, nx, B), U (N, nu, B), lam (N, nc, B), lamt (2 nx, B),
        lame (2, B), reg (B,) -> kff (N, nu, B), K (N, nu, nx, B)."""
        if X.device.type == "cuda":
            return self.cuda(X, U, lam, lamt, lame, mu, reg)
        if X.device.type != "cpu":
            raise ValueError(f"no wholebody_bwd for device {X.device}")
        LAUNCHES.plain += 1
        return self.plain(X, U, lam, lamt, lame, mu, reg)

    def plain(self, X, U, lam, lamt, lame, mu, reg):
        """``ops/generic_bwd.py::plain_bwd`` on the packed params (any
        device, any float dtype)."""
        return plain_bwd(self.ocp, unpack_params(self.flat, self.N, self.n_obs,
                                                 self.n_hp),
                         self.inv_scale, X, U, lam, lamt, lame, mu, reg)

    def cuda(self, X, U, lam, lamt, lame, mu, reg):
        """Launch ``csrc/wholebody_bwd.cu`` on the current stream."""
        N, B = self.N, X.shape[-1]
        ptrs = [check_tensor("params", self.flat, (self.flat.numel(),),
                             X.device),
                check_tensor("X", X, (N + 1, NX, B), X.device),
                check_tensor("U", U, (N, NU, B), X.device),
                check_tensor("lam", lam, (N, NC, B), X.device),
                check_tensor("lam_term", lamt, (2 * NX, B), X.device),
                check_tensor("lam_eq", lame, (2, B), X.device),
                check_tensor("reg", reg, (B,), X.device)]
        kw = dict(dtype=torch.float32, device=X.device)
        outs = (torch.empty(N, NU, B, **kw), torch.empty(N, NU, NX, B, **kw))
        lib = LIBRARY.get()
        check_layout(lib, self.statics, self.flat, N, self.n_obs, self.n_hp)
        with torch.cuda.device(X.device):
            err = lib.wb_bwd_launch(
                self.statics.ctypes.data, *ptrs, *(o.data_ptr() for o in outs),
                float(mu), N, B, torch.cuda.current_stream().cuda_stream)
        check_launch("wholebody_bwd", err)
        LAUNCHES.cuda += 1
        return outs


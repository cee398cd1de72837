"""Fused AL expansion + Riccati backward sweep of the whole-body qref MPC.

Counterpart of ``mmmpc_tpu/ops/wholebody_bwd.py::make_bwd_fused`` (the Pallas
TPU kernel ``_kernel``), as ``BwdFused``. From the terminal AL expansion (->
Vx, Vxx) it runs backward over the stages: at each stage the Gauss-Newton
gradient and Hessian of the tracking, input and rate costs, the slack-group
gradient, the PHR rows of the boxes, the sparse dynamics Jacobians, then one
Riccati step (Cholesky of Quu + reg I) giving kff = -Quu^-1 Qu and K = -Quu^-1
Qux. Vxx is symmetrised after every step, as the TPU kernel does.  With
``moving`` obstacles the params' obstacle table is (N+1, n_obs, 3): stage
k's circles are row k's, the terminal expansion's row N's.  Per-scenario
U_last, X_ref, U_ref, Q, P and eq_mask (a trailing batch axis; any subset)
are read per scenario, Q and P as their diagonals, as in
``ops/wholebody_fwd.py``.

On CUDA tensors the call launches the hand-written kernel
``csrc/wholebody_bwd.cu``: a team of 8 lanes per scenario (the
rows of the stage's slack group split over the lanes and merged by
shuffles, then rows of the Riccati step and one column of the triangular
solves a lane), the packed params and a two-stage buffer of the stage
inputs in shared memory, each stage's inputs loaded one stage ahead; the
note at the head of the source gives the design.  On CPU tensors
it runs the plain PyTorch version, ``ops/generic_bwd.py::plain_bwd``: the
controller's hand AL expansion at every stage, then the plain Riccati sweep
``ops/riccati.py::plain_riccati_bm``.
"""

from __future__ import annotations

import ctypes

import torch

from mmmpc_tpu_torch.ops._cuda import (
    LIBRARY, LaunchCounter, check_launch, check_layout, check_shared_memory,
    check_tensor,
)
from mmmpc_tpu_torch.ops.generic_bwd import plain_bwd
from mmmpc_tpu_torch.ops.wholebody_fwd import (
    NC, NU, NX, Operands, pack_params, statics_block, unpack_params,
)

LAUNCHES = LaunchCounter()


def launch_geometry(lib, N, n_obs, n_hp, B, moving=False, per_scenario=0):
    """{team, threads, blocks, smem_bytes}: the lanes a scenario, threads a
    block, blocks and dynamic shared-memory bytes with which the library's
    ``wb_bwd_launch`` launches the kernel at batch ``B`` (``moving``: an
    obstacle row a stage; ``per_scenario``: the mask of per-scenario
    entries), as its ``wb_bwd_geometry`` reports them."""
    out = (ctypes.c_int * 4)()
    lib.wb_bwd_geometry(N, n_obs, n_hp, int(moving), per_scenario, B, out)
    return dict(team=out[0], threads=out[1], blocks=out[2], smem_bytes=out[3])


def blocks_per_sm(lib, N, n_obs, n_hp, moving=False, per_scenario=0,
                  bug_compat=True):
    """The blocks of the launch of ``launch_geometry`` that one SM of the
    current card holds, for the instance of ``per_scenario`` and
    ``bug_compat``, as the library's ``wb_bwd_occupancy`` asks the CUDA
    runtime."""
    out = (ctypes.c_int * 1)()
    check_launch("wholebody_bwd occupancy", lib.wb_bwd_occupancy(
        N, n_obs, n_hp, int(moving), per_scenario, int(bug_compat), out))
    return out[0]


class BwdFused:
    """The fused backward sweep of one problem (the JAX package's
    ``make_bwd_fused``): static data from the keyword arguments, runtime
    data from ``params``, the shared entries packed once, the per-scenario
    ones kept as operands (``moving``: an obstacle row a stage;
    ``bug_compat``: the terminal self-collision rows on stage N-1)."""

    def __init__(self, ocp, params, *, dt, base_radius, n_obs, n_hp,
                 x_bounds, du_bounds, inv_scale, moving=False,
                 bug_compat=True):
        if (ocp.nx, ocp.nu) != (NX, NU):
            raise ValueError("the whole-body kernels take nx=9, nu=5")
        self.ocp = ocp
        self.N, self.n_obs, self.n_hp = ocp.N, n_obs, n_hp
        self.moving = bool(moving)
        self.bug_compat = bool(bug_compat)
        self.inv_scale = float(inv_scale)
        self.flat = pack_params(params, ocp.N, n_obs, n_hp, self.moving)
        self.ps = Operands(params)
        self.fits = set()    # the devices whose shared memory a block fits
        self.statics = statics_block(
            dt=dt, inv_scale=inv_scale, base_radius=base_radius,
            n_obs=n_obs, n_hp=n_hp, x_bounds=x_bounds, du_bounds=du_bounds,
            moving=self.moving, bug_compat=self.bug_compat,
            per_scenario=self.ps.mask)

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
        return plain_bwd(self.ocp, self.ps.params(unpack_params(
            self.flat, self.N, self.n_obs, self.n_hp, self.moving)),
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
                *self.ps.ptrs(N, B, X.device),
                check_tensor("reg", reg, (B,), X.device)]
        kw = dict(dtype=torch.float32, device=X.device)
        outs = (torch.empty(N, NU, B, **kw), torch.empty(N, NU, NX, B, **kw))
        lib = LIBRARY.get()
        check_layout(lib, self.statics, self.flat, N, self.n_obs, self.n_hp,
                     moving=self.moving)
        if X.device not in self.fits:
            # a block's bytes do not depend on the batch
            geo = launch_geometry(lib, N, self.n_obs, self.n_hp, B,
                                  self.moving, self.ps.mask)
            check_shared_memory("wholebody_bwd", N, geo["smem_bytes"],
                                X.device)
            self.fits.add(X.device)
        with torch.cuda.device(X.device):
            err = lib.wb_bwd_launch(
                self.statics.ctypes.data, *ptrs, *(o.data_ptr() for o in outs),
                float(mu), N, B, torch.cuda.current_stream().cuda_stream)
        check_launch("wholebody_bwd", err)
        LAUNCHES.cuda += 1
        return outs


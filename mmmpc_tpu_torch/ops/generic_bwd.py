"""Generic fused AL expansion + Riccati backward sweep, for any OCP the
kernels have a formulation of.

Counterpart of ``mmmpc_tpu/ops/generic_bwd.py::make_generic_bwd_fused`` (the
Pallas TPU kernel ``kernel``, driven by a controller's ``BwdHooks``), as
``GenericBwdFused``.  From the terminal AL expansion (-> Vx, Vxx) it runs
backward over the stages: at each stage the scaled Gauss-Newton model of the
stage cost, the PHR rows of its constraints (masked rows skipped), the
dynamics Jacobians, then one Riccati step (Cholesky of Quu + reg I) giving
kff = -Quu^-1 Qu and K = -Quu^-1 Qux; Vxx is symmetrised after every step.

On CUDA tensors the call launches ``gen_bwd_<name>`` of the kernel library,
the template ``csrc/generic_bwd.cuh`` instantiated with the formulation
struct of ``csrc/generic_<name>.cu``: the arm's and the endpoint's on the
team Riccati step (``csrc/riccati_team.cuh``), the demo's and the base's
one thread a scenario with their stage inputs loaded one stage ahead; on
CPU tensors it runs ``plain_bwd``:
the controller's structured AL expansion at every stage
(``solver.al_ilqr.stage_al_blocks``), then the plain Riccati sweep
(``ops.riccati.plain_riccati_bm``), the two halves of the unfused path.
"""

from __future__ import annotations

import ctypes

import torch

from mmmpc_tpu_torch.ops._cuda import (
    FORMULATIONS, LIBRARY, LaunchCounter, check_launch, check_layout,
    check_tensor,
)
from mmmpc_tpu_torch.ops.generic_fwd import Formulation
from mmmpc_tpu_torch.ops.riccati import plain_riccati_bm
from mmmpc_tpu_torch.solver.al_ilqr import stage_al_blocks, terminal_al_blocks

LAUNCHES = {name: LaunchCounter() for name in FORMULATIONS}


def launch_geometry(lib, name, N, n_obs, n_hp, B):
    """{team, threads, blocks, smem_bytes}: the lanes a scenario, threads a
    block, blocks and dynamic shared-memory bytes with which the library's
    ``gen_bwd_<name>`` launches at batch ``B``, as its
    ``gen_bwd_geometry_<name>`` reports them."""
    out = (ctypes.c_int * 4)()
    getattr(lib, f"gen_bwd_geometry_{name}")(N, n_obs, n_hp, B, out)
    return dict(team=out[0], threads=out[1], blocks=out[2], smem_bytes=out[3])


def plain_bwd(ocp, params, inv_scale, X, U, lam, lamt, lame, mu, reg):
    """The OCP's structured AL expansion of every stage, then the plain
    Riccati sweep (any device, any float dtype).  X (N+1, nx, B),
    U (N, nu, B), lam (N, nc, B), lamt (nct, B), lame (ne, B), reg (B,) ->
    kff (N, nu, B), K (N, nu, nx, B)."""
    return plain_riccati_bm(
        *stage_al_blocks(ocp, params, inv_scale, X[:-1], U, lam, mu),
        *terminal_al_blocks(ocp, params, inv_scale, X[-1], lamt, lame, mu),
        reg)


class GenericBwdFused:
    """The fused backward sweep of one problem: statics from the
    formulation and the cost scale, runtime data from ``params``, packed
    once."""

    def __init__(self, form: Formulation, ocp, params, *, inv_scale):
        self.form, self.ocp = form, ocp
        self.inv_scale = float(inv_scale)
        self.flat = form.pack(params)
        self.statics = form.statics(inv_scale=self.inv_scale)

    def __call__(self, X, U, lam, lamt, lame, mu, reg):
        """X (N+1, nx, B), U (N, nu, B), lam (N, nc, B), lamt (nct, B),
        lame (ne, B), reg (B,) -> kff (N, nu, B), K (N, nu, nx, B)."""
        if X.device.type == "cuda":
            return self.cuda(X, U, lam, lamt, lame, mu, reg)
        if X.device.type != "cpu":
            raise ValueError(f"no generic_bwd for device {X.device}")
        LAUNCHES[self.form.name].plain += 1
        return self.plain(X, U, lam, lamt, lame, mu, reg)

    def plain(self, X, U, lam, lamt, lame, mu, reg):
        """``plain_bwd`` on the packed params (any device, any float dtype)."""
        return plain_bwd(self.ocp, self.form.unpack(self.flat),
                         self.inv_scale, X, U, lam, lamt, lame, mu, reg)

    def cuda(self, X, U, lam, lamt, lame, mu, reg):
        """Launch ``gen_bwd_<name>`` on the current stream."""
        f, dev = self.form, X.device
        N, nx, nu, B = self.ocp.N, self.ocp.nx, self.ocp.nu, X.shape[-1]
        ptrs = [check_tensor("params", self.flat, (self.flat.numel(),), dev),
                check_tensor("X", X, (N + 1, nx, B), dev),
                check_tensor("U", U, (N, nu, B), dev),
                check_tensor("lam", lam, (N, f.nc, B), dev),
                check_tensor("lam_term", lamt, (f.nct, B), dev),
                check_tensor("lam_eq", lame, (0, B), dev),
                check_tensor("reg", reg, (B,), dev)]
        kw = dict(dtype=torch.float32, device=dev)
        outs = (torch.empty(N, nu, B, **kw), torch.empty(N, nu, nx, B, **kw))
        lib = LIBRARY.get()
        check_layout(lib, self.statics, self.flat, N, f.n_obs, f.n_hp, f.name)
        with torch.cuda.device(dev):
            err = getattr(lib, f"gen_bwd_{f.name}")(
                self.statics.ctypes.data, *ptrs, *(o.data_ptr() for o in outs),
                float(mu), N, B, torch.cuda.current_stream().cuda_stream)
        check_launch(f"generic_bwd.{f.name}", err)
        LAUNCHES[f.name].cuda += 1
        return outs

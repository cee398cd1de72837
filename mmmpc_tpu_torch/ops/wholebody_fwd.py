"""Fused forward rollout + parallel line search of the whole-body qref MPC.

Counterpart of ``mmmpc_tpu/ops/wholebody_fwd.py::make_fwd_linesearch`` (the
Pallas TPU kernel ``_kernel``), as ``FwdLinesearch``. For every scenario and
every step size alpha, one pass over the horizon computes

    u_k     = clamp(U_k + alpha * kff_k + K_k (x_k - X_k))
    cost   += stage_cost(x_k, u_k) / cost_scale + PHR(stage_ineq, lam_k, mu)
    x_{k+1} = f(x_k, u_k)

and adds the terminal AL cost (P tracking, terminal slack groups, PHR on the
terminal boxes, the maskable position equality) at the end, so the returned
per-candidate costs are complete.  With ``moving`` obstacles the params'
obstacle table is (N+1, n_obs, 3): stage k's circles are row k's, the
terminal group's row N's (the JAX kernel's ``moving`` branch); otherwise it
is (n_obs, 3), one row for every stage.  Any subset of U_last, X_ref,
U_ref, Q, P and eq_mask may carry a trailing batch axis, one value per
scenario (the fleet's references, weights, mask and previous inputs; the
JAX kernel's ``ps_*`` operands): the kernel then reads them per scenario,
Q and P as their diagonals (nx, B), as the JAX kernel does.

On CUDA tensors the call launches the hand-written kernel
``csrc/wholebody_fwd.cu``: a team of 2 lanes per candidate (scenario, step
size), the candidates of a scenario in one block; the control rows, the
FK's sincos, the slack rows and the rows of the cost split over the lanes
and merged by shuffles; the packed params and a two-stage buffer of the
stage inputs in shared memory, each scenario's inputs loaded once for all
its candidates and one stage ahead; the note at the head of the source
gives the design.  On CPU tensors it runs the plain PyTorch version,
``ops/generic_fwd.py::plain_fwd``, built from the OCP's own callables.
There is no fallback between them.

This module also owns the parameter blocks both fused kernels read:
``pack_params`` (the shared per-problem tensors, one flat buffer on the
device), ``statics_block`` (bounds, masks, step sizes and constants, passed
by value as a kernel argument) and ``Operands`` (the per-scenario entries,
one device operand each).  The layouts of the first two are
``param_layout`` and the ``ST_*`` offsets of ``csrc/wholebody_common.cuh``;
before every launch the wrappers hold the sizes of both against the ones
the compiled library reports.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mmmpc_tpu_torch.ops._cuda import (
    LIBRARY, MAX_ALPHA, LaunchCounter, check_launch, check_layout,
    check_shared_memory, check_tensor, pack_buffer, unpack_buffer,
)
from mmmpc_tpu_torch.ocp.spec import per_scenario_keys
from mmmpc_tpu_torch.ops.generic_fwd import plain_fwd

NX, NU = 9, 5
NC = 2 * NX + 2 * NU
# the per-scenario entries in the order of the kernels' operands, and their
# bit in the statics' per_scenario mask (PS_* of csrc/wholebody_common.cuh)
PS_BITS = {"U_last": 1, "X_ref": 2, "U_ref": 4, "Q": 8, "P": 16, "eq_mask": 32}

LAUNCHES = LaunchCounter()


def launch_geometry(lib, N, n_obs, n_hp, n_alpha, B, moving=False,
                    per_scenario=0):
    """{team, threads, blocks, smem_bytes}: the lanes a candidate, threads a
    block, blocks and dynamic shared-memory bytes with which the library's
    ``wb_fwd_launch`` launches the kernel at batch ``B`` with ``n_alpha``
    step sizes (``moving``: an obstacle row a stage; ``per_scenario``: the
    mask of per-scenario entries), as its ``wb_fwd_geometry`` reports
    them."""
    out = (ctypes.c_int * 4)()
    lib.wb_fwd_geometry(N, n_obs, n_hp, int(moving), per_scenario, n_alpha,
                        B, out)
    return dict(team=out[0], threads=out[1], blocks=out[2], smem_bytes=out[3])


def blocks_per_sm(lib, N, n_obs, n_hp, n_alpha, moving=False,
                  per_scenario=0, bug_compat=True):
    """The blocks of the launch of ``launch_geometry`` that one SM of the
    current card holds, for the instance of ``per_scenario`` and
    ``bug_compat``, as the library's ``wb_fwd_occupancy`` asks the CUDA
    runtime."""
    out = (ctypes.c_int * 1)()
    check_launch("wholebody_fwd occupancy", lib.wb_fwd_occupancy(
        N, n_obs, n_hp, int(moving), per_scenario, int(bug_compat), n_alpha,
        out))
    return out[0]


class Operands:
    """The per-scenario entries of one problem's params (the keys with a
    trailing batch axis), as the kernels read them: U_last / U_ref
    (N, nu, B), X_ref (N+1, nx, B), the diagonals of Q / P (nx, B), eq_mask
    (B,), each contiguous in the params' dtype and on their device."""

    def __init__(self, params):
        self.keys = per_scenario_keys(params)
        self.mask = sum(PS_BITS[k] for k in self.keys)
        self.t = {k: (torch.diagonal(params[k], dim1=0, dim2=1).T
                      if k in ("Q", "P") else params[k]).contiguous()
                  for k in self.keys}

    def params(self, shared: dict) -> dict:
        """``shared`` (the unpacked shared entries) with the per-scenario
        entries as the OCP callables take them, batch-first: the kernels'
        function on any device, Q and P the diagonal matrices of their
        diagonals."""
        p = dict(shared)
        for k, v in self.t.items():
            p[k] = (torch.diag_embed(v.T) if k in ("Q", "P")
                    else v.movedim(-1, 0))
        return p

    def ptrs(self, N, B, device) -> list[int]:
        """The six operand pointers of a launch at batch ``B``, in the
        order of ``PS_BITS``, 0 for a shared entry; raises unless each is a
        contiguous float32 tensor of its shape on the CUDA ``device``."""
        shapes = {"U_last": (N, NU, B), "X_ref": (N + 1, NX, B),
                  "U_ref": (N, NU, B), "Q": (NX, B), "P": (NX, B),
                  "eq_mask": (B,)}
        return [check_tensor(k, self.t[k], shapes[k], device)
                if k in self.t else 0 for k in PS_BITS]

# ---- the packed per-problem buffer (param_layout in the CUDA header) ----
def _packed_shapes(N, n_obs, n_hp, moving):
    return {"S": (), "eq_mask": (), "Q": (NX, NX), "R": (NU, NU),
            "W": (NU, NU), "P": (NX, NX), "X_ref": (N + 1, NX),
            "U_ref": (N, NU), "U_last": (N, NU),
            "obstacles": (N + 1, n_obs, 3) if moving else (n_obs, 3),
            "hp_points": (n_hp, 3), "hp_normals": (n_hp, 3),
            "hp_mask": (n_hp,)}


def pack_params(params, N, n_obs, n_hp, moving=False) -> torch.Tensor:
    """The shared per-problem tensors as one contiguous buffer (dtype and
    device of ``params``); ``moving``: the obstacle table has a row a stage.
    A per-scenario entry's slot is kept, zero-filled (``Operands`` carries
    it)."""
    return pack_buffer(_packed_shapes(N, n_obs, n_hp, moving), params,
                       per_scenario_keys(params))


def unpack_params(flat, N, n_obs, n_hp, moving=False) -> dict[str,
                                                               torch.Tensor]:
    """Views of ``flat`` under the keys of the controller's params."""
    return unpack_buffer(_packed_shapes(N, n_obs, n_hp, moving), flat)


# ---- the statics block (ST_* offsets in the CUDA header) ----
_STATIC_FIELDS = (("dt", 1), ("inv_scale", 1), ("base_radius", 1),
                  ("n_alpha", 1), ("n_obs", 1), ("n_hp", 1), ("x_lo", NX),
                  ("x_hi", NX), ("x_mlo", NX), ("x_mhi", NX), ("du_lo", NU),
                  ("du_hi", NU), ("du_mlo", NU), ("du_mhi", NU), ("u_lo", NU),
                  ("u_hi", NU), ("alphas", MAX_ALPHA), ("moving", 1),
                  ("bug_compat", 1), ("per_scenario", 1))


def statics_block(*, dt, inv_scale, base_radius, n_obs, n_hp, x_bounds,
                  du_bounds, u_clamp=None, alphas=(), moving=False,
                  bug_compat=True, per_scenario=0) -> np.ndarray:
    """Host float32 block of everything static to a solve
    (``bug_compat``: the terminal self-collision rows ride stage N-1's
    slack group, else the terminal group's; ``per_scenario``: the mask of
    ``PS_BITS``)."""
    if len(alphas) > MAX_ALPHA:
        raise ValueError(f"at most {MAX_ALPHA} step sizes, got {len(alphas)}")
    u_lo, u_hi = u_clamp if u_clamp is not None else (
        np.full(NU, -np.inf), np.full(NU, np.inf))
    values = dict(dt=dt, inv_scale=inv_scale, base_radius=base_radius,
                  n_alpha=len(alphas), n_obs=n_obs, n_hp=n_hp, u_lo=u_lo,
                  u_hi=u_hi, alphas=np.pad(np.asarray(alphas, float),
                                           (0, MAX_ALPHA - len(alphas))),
                  moving=float(moving), bug_compat=float(bug_compat),
                  per_scenario=float(per_scenario))
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
    alphas, dt, ``moving``: an obstacle row a stage, ``bug_compat``: the
    terminal self-collision rows on stage N-1) from the keyword arguments,
    runtime data (weights, references, geometry) from ``params``, the
    shared entries packed once, the per-scenario ones (``Operands``) kept
    as operands; multipliers and mu are call arguments."""

    def __init__(self, ocp, params, *, dt, base_radius, n_obs, n_hp,
                 x_bounds, du_bounds, u_clamp, alphas, inv_scale,
                 moving=False, bug_compat=True):
        if (ocp.nx, ocp.nu) != (NX, NU):
            raise ValueError("the whole-body kernels take nx=9, nu=5")
        self.ocp = ocp
        self.N, self.n_obs, self.n_hp = ocp.N, n_obs, n_hp
        self.moving = bool(moving)
        self.bug_compat = bool(bug_compat)
        self.alphas = tuple(float(a) for a in alphas)
        self.inv_scale = float(inv_scale)
        self.flat = pack_params(params, ocp.N, n_obs, n_hp, self.moving)
        self.ps = Operands(params)
        self.fits = set()    # the devices whose shared memory a block fits
        self.statics = statics_block(
            dt=dt, inv_scale=inv_scale, base_radius=base_radius,
            n_obs=n_obs, n_hp=n_hp, x_bounds=x_bounds, du_bounds=du_bounds,
            u_clamp=u_clamp, alphas=self.alphas, moving=self.moving,
            bug_compat=self.bug_compat, per_scenario=self.ps.mask)

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
        return plain_fwd(self.ocp, self.ps.params(unpack_params(
            self.flat, self.N, self.n_obs, self.n_hp, self.moving)),
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
                check_tensor("lam_eq", lame, (2, B), X.device),
                *self.ps.ptrs(N, B, X.device)]
        kw = dict(dtype=torch.float32, device=X.device)
        outs = (torch.empty(N, na, NX, B, **kw), torch.empty(N, na, NU, B, **kw),
                torch.empty(na, NX, B, **kw), torch.empty(na, B, **kw))
        lib = LIBRARY.get()
        check_layout(lib, self.statics, self.flat, N, self.n_obs, self.n_hp,
                     moving=self.moving)
        if X.device not in self.fits:
            # a block's bytes do not depend on the batch
            geo = launch_geometry(lib, N, self.n_obs, self.n_hp, na, B,
                                  self.moving, self.ps.mask)
            check_shared_memory("wholebody_fwd", N, geo["smem_bytes"],
                                X.device)
            self.fits.add(X.device)
        with torch.cuda.device(X.device):
            err = lib.wb_fwd_launch(
                self.statics.ctypes.data, *ptrs, *(o.data_ptr() for o in outs),
                float(mu), N, B, torch.cuda.current_stream().cuda_stream)
        check_launch("wholebody_fwd", err)
        LAUNCHES.cuda += 1
        return outs


"""Generic fused forward rollout + parallel line search, for any OCP the
kernels have a formulation of.

Counterpart of ``mmmpc_tpu/ops/generic_fwd.py::make_generic_fwd_linesearch``
(the Pallas TPU kernel ``kernel``, driven by a controller's ``LanesHooks``),
as ``GenericFwdLinesearch``.  For every scenario and every step size alpha,
one pass over the horizon computes

    u_k     = clamp(U_k + alpha * kff_k + K_k (x_k - X_k))
    cost   += stage_cost(x_k, u_k) * inv_scale + PHR(stage_ineq, lam_k, mu)
    x_{k+1} = f(x_k, u_k)

and adds the terminal AL cost, so the returned per-candidate costs are
complete.  On CUDA tensors the call launches ``gen_fwd_<name>`` of the
kernel library, a kernel of ``csrc/generic_fwd.cuh`` instantiated with the
formulation struct of ``csrc/generic_<name>.cu`` and chosen by its
``FWD_TEAM``: the demo's one thread a candidate, the base's, the arm's and
the endpoint's a team of lanes a candidate (``launch_geometry`` reports the
launch); on CPU tensors it runs ``plain_fwd``, built from the OCP's own
callables.  There is no fallback between them.

A controller describes its instance as a ``Formulation``: the C name, the
packed per-problem buffer's layout and the formulation's own statics (both
written in the same order in the C struct), and the common statics.  Before
every launch the wrapper holds the sizes of both blocks against the ones the
compiled library reports.

Per-scenario params (an entry of ``ocp.per_scenario_keys`` with a trailing
batch axis: the generic controllers' X_ref, U_ref, Q, P and the arm's and
the endpoint's U_last, each robot its own) select kernel C's per-scenario
instance (K5), ``gen_fwd_ps_<name>``, counted in ``LAUNCHES_PS``.  It takes
the packed buffer of the shared entries, once (a per-scenario entry's slot
kept, zero-filled), and each per-scenario entry as an operand of its own,
batch-last (``PS_OPERANDS``): the params' own tensor where it is
contiguous, so the wrapper copies nothing a robot.  The kernel streams each
robot's reference rows through its stage ring and holds its Q and P beside
it.  Its plain version is ``plain_fwd`` on the params' batch-first view,
the callables' (``ocp/spec.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mmmpc_tpu_torch.ops._cuda import (
    FORMULATIONS, LIBRARY, MAX_ALPHA, LaunchCounter, check_launch,
    check_layout, check_tensor, pack_buffer, unpack_buffer,
)
from mmmpc_tpu_torch.ocp.spec import batch_first, per_scenario_keys
from mmmpc_tpu_torch.solver.al_ilqr import _al_penalty_eq, _al_penalty_ineq

LAUNCHES = {name: LaunchCounter() for name in FORMULATIONS}
# the per-scenario instance of each formulation (K5)
LAUNCHES_PS = {name: LaunchCounter() for name in FORMULATIONS}
# the entries a robot may own, in the order of gen_fwd_ps_<name>'s operands
# (null where shared)
PS_OPERANDS = ("U_last", "X_ref", "U_ref", "Q", "P")


def launch_geometry(lib, name, N, n_obs, n_hp, n_alpha, B,
                    per_scenario=False):
    """{team, threads, blocks, smem_bytes}: the lanes a candidate, threads a
    block, blocks and dynamic shared-memory bytes with which the library's
    ``gen_fwd_<name>`` (``per_scenario``: ``gen_fwd_ps_<name>``) launches at
    batch ``B`` with ``n_alpha`` step sizes, as its
    ``gen_fwd_geometry_<name>`` (``gen_fwd_ps_geometry_<name>``) reports
    them."""
    out = (ctypes.c_int * 4)()
    ps = "ps_" if per_scenario else ""
    getattr(lib, f"gen_fwd_{ps}geometry_{name}")(N, n_obs, n_hp, n_alpha, B,
                                                 out)
    return dict(team=out[0], threads=out[1], blocks=out[2], smem_bytes=out[3])


def blocks_per_sm(lib, name, N, n_obs, n_hp, n_alpha, per_scenario=False):
    """The blocks of the launch of ``launch_geometry`` that one SM of the
    current card holds, as the library's ``gen_fwd_occupancy_<name>`` asks
    the CUDA runtime."""
    out = (ctypes.c_int * 1)()
    check_launch(f"generic_fwd.{name} occupancy",
                 getattr(lib, f"gen_fwd_occupancy_{name}")(
                     N, n_obs, n_hp, n_alpha, int(per_scenario), out))
    return out[0]


@dataclasses.dataclass(frozen=True)
class Formulation:
    """One OCP's instance of the generic kernels.

    ``name`` selects the C entries ``gen_{fwd,bwd}_<name>``; ``shapes`` is
    the packed buffer's layout (key -> shape, in the order of the C struct's
    ``layout``); ``extra`` the formulation's own statics (the C struct's
    ``S_*`` order); ``nc, nct`` its stage and terminal inequality widths
    (the generic kernels take no terminal equality)."""
    name: str
    shapes: dict
    extra: np.ndarray
    dt: float
    u_clamp: tuple
    nc: int
    nct: int
    n_obs: int = 0
    n_hp: int = 0

    def statics(self, alphas=(), inv_scale=1.0) -> np.ndarray:
        """The host float32 statics block: [dt, inv_scale, n_alpha, n_obs,
        n_hp, alphas (padded to MAX_ALPHA), u_lo, u_hi, extra]."""
        if len(alphas) > MAX_ALPHA:
            raise ValueError(f"at most {MAX_ALPHA} step sizes, got "
                             f"{len(alphas)}")
        return np.concatenate([
            [self.dt, inv_scale, len(alphas), self.n_obs, self.n_hp],
            np.pad(np.asarray(alphas, float), (0, MAX_ALPHA - len(alphas))),
            self.u_clamp[0], self.u_clamp[1], self.extra]).astype(np.float32)

    def pack(self, params, per_scenario=()) -> torch.Tensor:
        """The per-problem tensors as one contiguous buffer (dtype and
        device of ``params``); the slot of an entry named in
        ``per_scenario`` (shape + (B,)) kept, zero-filled."""
        return pack_buffer(self.shapes, params, per_scenario)

    def unpack(self, flat) -> dict[str, torch.Tensor]:
        """Views of ``flat`` under the keys of the controller's params."""
        return unpack_buffer(self.shapes, flat)


def plain_fwd(ocp, params, alphas, inv_scale, X, U, kff, K, lam, lamt, lame,
              mu):
    """The batched rollout of all step sizes with the AL cost, from the
    OCP's callables (any device, any float dtype), on ``params`` as the
    callables take them: shared, or with per-scenario entries batch-first
    (the plain version of kernel C's per-scenario instance).  X (N, nx, B)
    stage states, U / kff (N, nu, B), K (N, nu, nx, B), lam (N, nc, B), lamt
    (nct, B), lame (ne, B) -> Xc (N, n_alpha, nx, B), Uc (N, n_alpha, nu, B),
    xlast (n_alpha, nx, B), cost (n_alpha, B)."""
    B = X.shape[-1]
    al = torch.tensor(alphas, dtype=X.dtype, device=X.device)[:, None, None]
    x = X[0].T.expand(len(alphas), B, ocp.nx)        # (n_alpha, B, nx)
    cost = torch.zeros(len(alphas), B, dtype=X.dtype, device=X.device)
    Xs, Us = [], []
    for k in range(ocp.N):
        fb = torch.einsum("bij,abj->abi", K[k].permute(2, 0, 1), x - X[k].T)
        u = ocp.clamp_u(U[k].T + al * kff[k].T + fb)
        cost = (cost + ocp.stage_cost(x, u, k, params) * inv_scale
                + _al_penalty_ineq(ocp.stage_ineq(x, u, k, params), lam[k].T,
                                   mu))
        Xs.append(x)
        Us.append(u)
        x = ocp.dynamics(x, u)
    cost = (cost + ocp.terminal_cost(x, params) * inv_scale
            + _al_penalty_ineq(ocp.terminal_ineq(x, params), lamt.T, mu)
            + _al_penalty_eq(ocp.terminal_eq(x, params), lame.T, mu))
    return (torch.stack(Xs).permute(0, 1, 3, 2).contiguous(),
            torch.stack(Us).permute(0, 1, 3, 2).contiguous(),
            x.permute(0, 2, 1).contiguous(), cost)


class GenericFwdLinesearch:
    """The fused rollout + line search of one problem: statics from the
    formulation, the step sizes and the cost scale; runtime data (weights,
    references, geometry) from ``params``, the shared entries packed once
    and each per-scenario entry an operand (``operands``, batch-last);
    multipliers and mu are call arguments."""

    def __init__(self, form: Formulation, ocp, params, *, alphas, inv_scale):
        self.form, self.ocp = form, ocp
        self.alphas = tuple(float(a) for a in alphas)
        self.inv_scale = float(inv_scale)
        self.ps_keys = per_scenario_keys(params)
        unknown = set(self.ps_keys) - ocp.per_scenario_keys
        if unknown:
            raise ValueError(f"params {sorted(unknown)} carry a batch axis, "
                             f"but the {form.name} line search takes them "
                             f"shared only")
        self.flat = form.pack(params, self.ps_keys)
        self.operands = {k: params[k].contiguous() for k in self.ps_keys}
        if self.ps_keys:
            self.batch = params[self.ps_keys[0]].shape[-1]
            self.params = batch_first({k: params[k] for k in form.shapes})
        else:
            self.batch = None
        self.statics = form.statics(self.alphas, self.inv_scale)

    @property
    def counter(self) -> LaunchCounter:
        """This instance's launch counter: ``LAUNCHES_PS`` with
        per-scenario params, else ``LAUNCHES``."""
        return (LAUNCHES_PS if self.ps_keys else LAUNCHES)[self.form.name]

    def __call__(self, X, U, kff, K, lam, lamt, lame, mu):
        """X (N, nx, B) stage states, U (N, nu, B), kff (N, nu, B),
        K (N, nu, nx, B), lam (N, nc, B), lamt (nct, B), lame (ne, B) ->
        Xc (N, n_alpha, nx, B), Uc (N, n_alpha, nu, B), xlast (n_alpha, nx, B),
        cost (n_alpha, B) including the terminal AL cost."""
        if X.device.type == "cuda":
            return self.cuda(X, U, kff, K, lam, lamt, lame, mu)
        if X.device.type != "cpu":
            raise ValueError(f"no generic_fwd for device {X.device}")
        self.counter.plain += 1
        return self.plain(X, U, kff, K, lam, lamt, lame, mu)

    def plain(self, X, U, kff, K, lam, lamt, lame, mu):
        """``plain_fwd`` on the packed params, or on the batch-first view of
        the per-scenario ones (any device, any float dtype)."""
        params = self.params if self.ps_keys else self.form.unpack(self.flat)
        return plain_fwd(self.ocp, params, self.alphas, self.inv_scale, X, U,
                         kff, K, lam, lamt, lame, mu)

    def cuda(self, X, U, kff, K, lam, lamt, lame, mu):
        """Launch ``gen_fwd_<name>`` (``gen_fwd_ps_<name>`` with
        per-scenario params) on the current stream."""
        f, dev = self.form, X.device
        N, nx, nu = self.ocp.N, self.ocp.nx, self.ocp.nu
        B, na = X.shape[-1], len(self.alphas)
        if self.ps_keys and B != self.batch:
            raise ValueError(f"generic_fwd.{f.name}: per-scenario params of "
                             f"batch {self.batch}, inputs of batch {B}")
        ptrs = [check_tensor("params", self.flat, (self.flat.numel(),), dev)]
        if self.ps_keys:
            ptrs += [check_tensor(k, self.operands[k],
                                  (*f.shapes[k], B), dev)
                     if k in self.operands else 0 for k in PS_OPERANDS]
        ptrs += [check_tensor("X", X, (N, nx, B), dev),
                 check_tensor("U", U, (N, nu, B), dev),
                 check_tensor("kff", kff, (N, nu, B), dev),
                 check_tensor("K", K, (N, nu, nx, B), dev),
                 check_tensor("lam", lam, (N, f.nc, B), dev),
                 check_tensor("lam_term", lamt, (f.nct, B), dev),
                 check_tensor("lam_eq", lame, (0, B), dev)]
        kw = dict(dtype=torch.float32, device=dev)
        outs = (torch.empty(N, na, nx, B, **kw), torch.empty(N, na, nu, B, **kw),
                torch.empty(na, nx, B, **kw), torch.empty(na, B, **kw))
        lib = LIBRARY.get()
        check_layout(lib, self.statics, self.flat, N, f.n_obs, f.n_hp, f.name)
        entry = f"gen_fwd_{'ps_' if self.ps_keys else ''}{f.name}"
        with torch.cuda.device(dev):
            err = getattr(lib, entry)(
                self.statics.ctypes.data, *ptrs, *(o.data_ptr() for o in outs),
                float(mu), N, B, torch.cuda.current_stream().cuda_stream)
        check_launch(f"generic_fwd.{f.name}"
                     f"{'.per_scenario' if self.ps_keys else ''}", err)
        self.counter.cuda += 1
        return outs

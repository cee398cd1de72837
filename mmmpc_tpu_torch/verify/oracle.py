"""CPU oracle: the same OCP solved by scipy, an independent yardstick for the
controllers (counterpart of ``mmmpc_tpu/verify/oracle.py``).

scipy ``trust-constr`` (an interior-point method, IPOPT's family) and
L-BFGS-B run on the *same* OCP callables that the batched solver and the
kernels' plain versions take, in float64 on the CPU, with exact derivatives
from ``torch.autograd``: the objective's gradient by reverse mode, the
constraints' Jacobian by ``torch.func.jacrev``.  Agreement between two
unrelated solvers on one problem is the fidelity evidence
(``fidelity_dossier.py``).

Decision variables are the inputs only (single shooting): the dynamics are
eliminated by rollout, the input box becomes scipy ``Bounds``, the other
hard constraints ``NonlinearConstraint`` blocks.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize as sopt
import torch

from mmmpc_tpu_torch.ocp.spec import OCP
from mmmpc_tpu_torch.solver.al_ilqr import _objective

DTYPE = torch.float64


def _plain_rollout(ocp: OCP, x0, U):
    """x0 (nx,), U (N, nu) -> X (N+1, nx): the dynamics from x0 under U as
    given (no clamp: the oracles keep U inside the input box)."""
    xs = [x0]
    for k in range(ocp.N):
        xs.append(ocp.dynamics(xs[-1], U[k]))
    return torch.stack(xs)


class Shooting:
    """One scenario's single-shooting functions of the flat inputs z
    (N * nu,), float64 on the CPU: the original objective, the stacked
    stage and terminal inequality rows, the terminal equality rows, and
    their exact derivatives as numpy."""

    def __init__(self, ocp: OCP, x0, params):
        self.ocp = ocp
        self.x0 = torch.as_tensor(np.asarray(x0, np.float64))
        self.params = {k: torch.as_tensor(np.asarray(v, np.float64))
                       for k, v in params.items()}
        self.ks = torch.arange(ocp.N)

    def _U(self, z):
        return z.reshape(self.ocp.N, self.ocp.nu)

    def rollout(self, z):
        return _plain_rollout(self.ocp, self.x0, self._U(z))

    def objective(self, z):
        U = self._U(z)
        X = self.rollout(z)
        return _objective(self.ocp, X[..., None], U[..., None],
                          self.params)[0]

    def ineq(self, z):
        X, U = self.rollout(z), self._U(z)
        cs = self.ocp.stage_ineq(X[:-1], U, self.ks, self.params)
        return torch.cat([cs.reshape(-1),
                          self.ocp.terminal_ineq(X[-1], self.params)])

    def eq(self, z):
        return self.ocp.terminal_eq(self.rollout(z)[-1], self.params)

    def value_and_grad(self, z):
        """(objective, its gradient) at numpy z."""
        zt = torch.tensor(z, dtype=DTYPE, requires_grad=True)
        f = self.objective(zt)
        (g,) = torch.autograd.grad(f, zt)
        return float(f.detach()), g.numpy()

    def rows(self, fn, keep=None):
        """numpy (value, Jacobian) callables of the rows ``fn`` (their
        ``keep`` subset)."""
        sel = (lambda z: fn(z)) if keep is None else (lambda z: fn(z)[keep])
        jac = torch.func.jacrev(sel)

        def value(z):
            with torch.no_grad():
                return sel(torch.as_tensor(z, dtype=DTYPE)).numpy()

        return value, lambda z: jac(torch.as_tensor(z, dtype=DTYPE)).numpy()


def _input_bounds(ocp: OCP):
    lo = np.tile(np.asarray(ocp.u_lower, np.float64), ocp.N)
    hi = np.tile(np.asarray(ocp.u_upper, np.float64), ocp.N)
    return sopt.Bounds(lo, hi)


def _result(sh: Shooting, z):
    """(U (N, nu), X (N+1, nx), cost) of the flat inputs z, float64."""
    zt = torch.as_tensor(z, dtype=DTYPE)
    with torch.no_grad():
        return sh._U(zt), sh.rollout(zt), float(sh.objective(zt))


def scipy_solve(ocp: OCP, x0, U_init, params, maxiter: int = 1000,
                gtol: float = 1e-9, xtol: float = 1e-12):
    """trust-constr on the OCP from ``U_init`` (N, nu); ``params`` as host
    arrays, ``U_last`` included.  Returns (U, X, cost, scipy_result), U and
    X float64 tensors."""
    sh = Shooting(ocp, x0, params)
    z0 = np.asarray(U_init, np.float64).reshape(-1)
    constraints = []
    with torch.no_grad():
        c_probe = sh.ineq(torch.as_tensor(z0)).numpy()
        n_eq = sh.eq(torch.as_tensor(z0)).shape[0]
    # Masked-out constraint rows are the constant -1e9 "satisfied by a wide
    # margin" sentinel (ocp/constraints.py); their zero Jacobian rows make
    # trust-constr's projections singular: drop them.
    keep = np.where(c_probe > -1e8)[0]
    if keep.size:
        ci, Ji = sh.rows(sh.ineq, torch.as_tensor(keep))
        constraints.append(sopt.NonlinearConstraint(ci, -np.inf, 0.0,
                                                    jac=Ji))
    if n_eq:
        ce, Je = sh.rows(sh.eq)
        constraints.append(sopt.NonlinearConstraint(ce, 0.0, 0.0, jac=Je))
    res = sopt.minimize(
        sh.value_and_grad, z0, jac=True, method="trust-constr",
        bounds=_input_bounds(ocp), constraints=constraints,
        options={"maxiter": maxiter, "gtol": gtol, "xtol": xtol})
    return (*_result(sh, res.x), res)


def lbfgs_solve(ocp: OCP, x0, U_init, params, maxiter: int = 5000):
    """Second, independent oracle: L-BFGS-B on the single-shooting objective
    with the input box as bounds.

    Exact when no other hard constraint is active at the optimum (the
    objective already holds the reference's soft slack penalties); a lower
    bound (a relaxation) otherwise, since state and rate boxes are ignored.
    Returns (U, X, cost, scipy_result), U and X float64 tensors."""
    sh = Shooting(ocp, x0, params)
    res = sopt.minimize(
        sh.value_and_grad, np.asarray(U_init, np.float64).reshape(-1),
        jac=True, method="L-BFGS-B", bounds=_input_bounds(ocp),
        options={"maxiter": maxiter, "ftol": 1e-14, "gtol": 1e-12})
    U, X, _ = _result(sh, res.x)
    return U, X, float(res.fun), res

"""Parity of the port's whole-body qref controller with the JAX package.

Every OCP callable of ``MPCWholeBody`` — costs, constraints, Gauss-Newton
residuals, hand Jacobians and the fully structured AL expansions — on the
bench problem (scenario 1) at random states around the bench start, where
every constraint family is live, in float64 with atol 1e-9 (the same closed
forms; the slack gradient is AD in JAX and closed form in the port, equal up
to float64 rounding).  The hand Jacobians are also held against
``torch.func.jacfwd``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu.controllers import MPCWholeBody as MPCWholeBodyJ
from mmmpc_tpu.models.obstacles import Obstacles as ObstaclesJ
from mmmpc_tpu.models.robots import MobileManipulator as MobileManipulatorJ
from mmmpc_tpu_torch.bench import build_problem_numpy
from mmmpc_tpu_torch.utils.convert import params_from_numpy

ATOL = 1e-9
N = 20
M = 48          # (state, input, stage) samples


@pytest.fixture(scope="module")
def problem():
    mpc_t, x0_b, params = build_problem_numpy(M, N=N)
    mpc_t.add_terminal_position_constraint()
    params = dict(params, eq_mask=np.asarray(1.0))
    mpc_j = MPCWholeBodyJ(
        MobileManipulatorJ(0.1),
        [ObstaclesJ(*r) for r in mpc_t.obstacles_value],
        [(p, n[None]) for p, n in zip(mpc_t.hp_points_value,
                                      mpc_t.hp_normals_value)], N=N)
    mpc_j.add_terminal_position_constraint()
    rng = np.random.default_rng(4)
    params["U_last"] = 0.2 * rng.standard_normal((N, 5))
    # states around the bench starts, spread so that ground circles,
    # half-planes, self-collision and the boxes are all live somewhere
    x = x0_b + rng.standard_normal((M, 9)) * np.array(
        [0.15, 0.15, 0.5, 1.0, 1.0, 1.5, 0.6, 0.8, 0.8])
    u = rng.standard_normal((M, 5)) * np.array([1.5, 2.0, 0.8, 0.8, 0.8])
    k = np.arange(M) % N                       # includes the stage N-1 rows
    lam = np.abs(rng.standard_normal((M, 28)))
    lam_t = np.abs(rng.standard_normal((M, 18)))
    lam_e = rng.standard_normal((M, 2))
    return mpc_t, mpc_j, params, dict(x=x, u=u, k=k, lam=lam, lam_t=lam_t,
                                      lam_e=lam_e)


def test_make_params_matches_jax(problem):
    mpc_t, mpc_j, params, _ = problem
    traj, uref = params["X_ref"], params["U_ref"]
    pj = mpc_j.make_params(traj, uref)
    pt = mpc_t.make_params(traj, uref)
    assert set(pj) == set(pt)
    for key in pj:
        np.testing.assert_array_equal(np.asarray(pj[key], float), pt[key], key)


STAGE = ["stage_cost", "stage_ineq", "stage_residuals", "stage_gn",
         "stage_ineq_jac", "stage_al_expansion", "dynamics_jacobians"]
TERMINAL = ["terminal_cost", "terminal_ineq", "terminal_eq",
            "terminal_residuals", "terminal_gn", "terminal_ineq_jac",
            "terminal_eq_jac", "terminal_al_expansion"]


def _call(ocp, name, s, p, lib):
    """Call OCP callable ``name`` on the samples, batched (torch) or vmapped
    (JAX)."""
    if lib == "torch":
        T = lambda a: torch.as_tensor(a)  # noqa: E731
        x, u, k = T(s["x"]), T(s["u"]), T(s["k"])
        fn = getattr(ocp, name)
        extra = {"stage_al_expansion": (T(s["lam"]), 10.0, 1e-5),
                 "terminal_al_expansion": (T(s["lam_t"]), T(s["lam_e"]),
                                           10.0, 1e-5)}.get(name, ())
        if name == "dynamics_jacobians":
            return fn(x, u)
        if name.startswith("stage"):
            if name == "stage_al_expansion":
                return fn(x, u, k, p, *extra)
            return fn(x, u, k, p)
        return fn(x, p, *extra)
    J = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
    fn = getattr(ocp, name)
    x, u, k = J(s["x"]), J(s["u"]), jnp.asarray(s["k"])
    if name == "dynamics_jacobians":
        f, args = fn, (x, u)
    elif name == "stage_al_expansion":
        f, args = (lambda x, u, k, l: fn(x, u, k, p, l, 10.0, 1e-5),
                   (x, u, k, J(s["lam"])))
    elif name.startswith("stage"):
        f, args = (lambda x, u, k: fn(x, u, k, p)), (x, u, k)
    elif name == "terminal_al_expansion":
        f, args = (lambda x, lt, le: fn(x, p, lt, le, 10.0, 1e-5),
                   (x, J(s["lam_t"]), J(s["lam_e"])))
    else:
        f, args = (lambda x: fn(x, p)), (x,)
    return jax.jit(jax.vmap(f))(*args)


@pytest.mark.parametrize("name", STAGE + TERMINAL)
def test_qref_callable_matches_jax(problem, name):
    mpc_t, mpc_j, params, s = problem
    pt = params_from_numpy(params, "cpu", torch.float64)
    pj = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    out_t = _call(mpc_t.ocp, name, s, pt, "torch")
    out_j = _call(mpc_j.ocp, name, s, pj, "jax")
    if not isinstance(out_t, tuple):
        out_t, out_j = (out_t,), (out_j,)
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        b = np.broadcast_to(np.asarray(b), tuple(a.shape))
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL)
    if name == "stage_gn":
        # the slack row is live for some samples (else the test is vacuous)
        assert (out_t[1][:, -1].abs().amax(-1) > 0).float().mean() > 0.2


@pytest.mark.parametrize("pair", [("stage_residuals", "stage_gn"),
                                  ("terminal_residuals", "terminal_gn"),
                                  ("stage_ineq", "stage_ineq_jac"),
                                  ("terminal_eq", "terminal_eq_jac"),
                                  ("dynamics", "dynamics_jacobians")])
def test_hand_jacobians_match_jacfwd(problem, pair):
    from torch.func import jacfwd
    mpc_t, _, params, s = problem
    ocp = mpc_t.ocp
    p = params_from_numpy(params, "cpu", torch.float64)
    value_fn, jac_fn = (getattr(ocp, n) for n in pair)
    for i in range(0, M, 6):
        x, u = torch.as_tensor(s["x"][i]), torch.as_tensor(s["u"][i])
        k = int(s["k"][i])
        z = torch.cat([x, u])
        if pair[0] == "dynamics":
            A, Bm = jac_fn(x, u)
            J = torch.cat([A, Bm], dim=-1)
            J_ad = jacfwd(lambda zz: value_fn(zz[:9], zz[9:]))(z)
        elif pair[0].startswith("stage"):
            J = jac_fn(x, u, k, p)[1]
            J_ad = jacfwd(lambda zz: value_fn(zz[:9], zz[9:], k, p))(z)
        else:
            J = jac_fn(x, p)[1]
            J_ad = jacfwd(lambda xx: value_fn(xx, p))(x)
        np.testing.assert_allclose(J.numpy(), J_ad.numpy(), rtol=0, atol=ATOL)

"""The port's FK and end-point Jacobian (``models/arm.py::arm_fk``,
``ee_jacobian``, float64) against the independent classical-DH derivation
of the port's ``utils/dh_codegen.py`` (sympy, lambdified), at
``tests/test_kinematics.py``'s tolerances: 1e-12 on positions, 1e-10 on
the Jacobian.  The port's derivation equals the JAX module's, expression
for expression.  No JAX program.
"""

import numpy as np
import pytest
import sympy as sp
import torch

from mmmpc_tpu.utils import dh_codegen as dh_j
from mmmpc_tpu_torch.models.arm import arm_fk, ee_jacobian
from mmmpc_tpu_torch.utils import dh_codegen as dh

RNG = np.random.default_rng(0)


def random_q(n):
    lo = np.array([-np.pi / 2, -np.pi, 0.0])
    hi = np.array([np.pi / 2, 0.0, 1.5 * np.pi])
    return RNG.uniform(lo, hi, size=(n, 3))


def test_arm_fk_matches_dh_oracle():
    q_syms, *points = dh.panda3dof_positions()
    fs = [sp.lambdify(q_syms, p, "numpy") for p in points]
    q = random_q(50)
    ee, j2, j3 = arm_fk(torch.as_tensor(q))
    for i, qi in enumerate(q):
        for got, f in zip((j2, j3, ee), fs):
            np.testing.assert_allclose(got[i].numpy(),
                                       np.asarray(f(*qi)).ravel(),
                                       rtol=0, atol=1e-12)


def test_ee_jacobian_matches_dh_jacobian():
    q_syms = sp.symbols("q1 q2 q3", real=True)
    J_sym = dh.geometric_jacobian(dh.panda3dof_dh_table(*q_syms), [1, 3, 5])
    Jf = sp.lambdify(q_syms, J_sym[:3, :], "numpy")
    q = random_q(20)
    J = ee_jacobian(torch.as_tensor(q))
    for i, qi in enumerate(q):
        np.testing.assert_allclose(J[i].numpy(), np.asarray(Jf(*qi)),
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("what", ["positions", "jacobian"])
def test_dh_codegen_matches_jax(what):
    for name in ("DH_A2", "DH_A3", "DH_A5", "DH_A6", "DH_A7"):
        assert getattr(dh, name) == getattr(dh_j, name)
    if what == "positions":
        assert dh.panda3dof_positions() == dh_j.panda3dof_positions()
    else:
        q = sp.symbols("q1 q2 q3", real=True)
        assert (dh.geometric_jacobian(dh.panda3dof_dh_table(*q), [1, 3, 5])
                == dh_j.geometric_jacobian(dh_j.panda3dof_dh_table(*q),
                                           [1, 3, 5]))

"""Offline DH -> FK/Jacobian derivation (sympy) used as an independent oracle
(a copy of ``mmmpc_tpu/utils/dh_codegen.py``).

Mirrors the role of the reference's codegen script
(``utils/dh_to_kinematics.py``): a classical-DH pipeline for the Panda-3DoF
arm whose symbolic output the hand-written FK must match.  The port's
closed-form FK lives in ``mmmpc_tpu_torch/models/arm.py`` (angle-sum form)
and in the kernels' ``csrc/wholebody_common.cuh``;
``tests/test_torch_dh_codegen.py`` lambdifies the matrices produced here
and asserts agreement to machine precision, so the FK is validated against
an independent derivation, not against itself.

It needs sympy, which the GPU machine does not have: no module of the
port's paths, and nothing ``chip_smoke.py`` runs, imports it.  Tests only.

Run standalone to print the symbolic transforms and Jacobian:
    python -m mmmpc_tpu_torch.utils.dh_codegen
"""

import sympy as sp

# DH constants of the reduced Panda arm (reference manipulator_3DoF.py:18-22).
DH_A2 = 0.316
DH_A3 = 0.0825
DH_A5 = 0.384
DH_A6 = 0.088
DH_A7 = 0.107


def classical_dh_matrix(theta, d, a, alpha):
    """Homogeneous transform of one classical-DH row."""
    ct, st = sp.cos(theta), sp.sin(theta)
    ca, sa = sp.cos(alpha), sp.sin(alpha)
    return sp.Matrix([
        [ct, -st * ca, st * sa, a * ct],
        [st, ct * ca, -ct * sa, a * st],
        [0, sa, ca, d],
        [0, 0, 0, 1],
    ])


def panda3dof_dh_table(q1, q2, q3, a2=None, a3=None, a5=None, a6=None, a7=None):
    """The 7-row classical DH table of the reduced Panda
    (reference dh_to_kinematics.py:106-114; actuated rows are 1, 3, 5)."""
    a2 = DH_A2 if a2 is None else a2
    a3 = DH_A3 if a3 is None else a3
    a5 = DH_A5 if a5 is None else a5
    a6 = DH_A6 if a6 is None else a6
    a7 = DH_A7 if a7 is None else a7
    return [
        (0, 0, 0, -sp.pi / 2),
        (q1 - sp.pi / 2, 0, a2, 0),
        (sp.pi / 2, 0, a3, sp.pi),
        (q2, 0, -a3, 0),
        (sp.pi / 2, 0, a5, 0),
        (q3 - sp.pi / 2, 0, a6, 0),
        (-sp.pi / 2, 0, a7, -sp.pi / 2),
    ]


def chain_transforms(dh_table):
    """Cumulative transforms T_0..T_k for each DH-row prefix."""
    T = sp.eye(4)
    Ts = [T]
    for theta, d, a, alpha in dh_table:
        T = T * classical_dh_matrix(theta, d, a, alpha)
        # no simplify here: full simplify is orders of magnitude slower and
        # downstream users lambdify the raw product anyway
        Ts.append(T)
    return Ts


def panda3dof_positions():
    """Symbolic joint2 / joint3 / end-point positions in the arm base frame.

    joint2 is the prefix through DH row 2 (the a3 shoulder offset), joint3
    through row 4 (the a5 forearm), the end point is the full chain — the
    same frames whose translations the reference pasted into
    manipulator_3DoF.py:29-77.
    Returns (q_symbols, p_joint2, p_joint3, p_ee), positions as 3x1 Matrices.
    """
    q1, q2, q3 = sp.symbols("q1 q2 q3", real=True)
    Ts = chain_transforms(panda3dof_dh_table(q1, q2, q3))
    return (q1, q2, q3), Ts[3][:3, 3], Ts[5][:3, 3], Ts[7][:3, 3]


def geometric_jacobian(dh_table, actuated_rows):
    """6xN geometric Jacobian via z_i x (t_ee - t_i) over actuated rows."""
    Ts = chain_transforms(dh_table)
    t_ee = Ts[-1][:3, 3]
    J = sp.zeros(6, len(actuated_rows))
    for i, row in enumerate(actuated_rows):
        z = Ts[row][:3, 2]
        t = Ts[row][:3, 3]
        J[:3, i] = z.cross(t_ee - t)
        J[3:, i] = z
    return J


if __name__ == "__main__":
    (q1, q2, q3), p2, p3, pe = panda3dof_positions()
    print("joint2 position:", sp.simplify(p2.T))
    print("joint3 position:", sp.simplify(p3.T))
    print("endpoint position:", sp.simplify(pe.T))
    J = geometric_jacobian(panda3dof_dh_table(q1, q2, q3), [1, 3, 5])
    print("geometric Jacobian:", sp.simplify(J))

"""Joint-space dynamics: mass matrix, nonlinear effects, energies
(model/dynamics.py counterpart).

Replaces Pinocchio ``crba`` + ``nonLinearEffects`` as used by the reference
WBC (bipedal_wbc/src/WbcBase.cpp:92-103).  The generalized coordinates are
true Lagrangian coordinates (the base's velocity is the Euler-angle rate), so
the nonlinear effects follow from the Lagrangian identity

    nle(q, v) = d/dt(M(q)) v  -  grad_q (1/2 v^T M(q) v)  +  grad_q PE(q)

with both derivatives taken by automatic differentiation (``torch.func.jvp``
and ``torch.func.grad``, as the reference's ``jax.jvp`` and ``jax.grad``),
and the mass matrix is assembled from body com Jacobians:

    M(q) = sum_b [ m_b Jv_b^T Jv_b  +  Jw_b^T (R_b I_b R_b^T) Jw_b ]

Every function takes any number of leading batch dimensions on q and v: the
samples are independent, so the gradient of the summed scalar is each
sample's own gradient.  The analytic recursions of model/host_dynamics.py
compute the same quantities on the host; the device WBC differentiates, as
the reference's does.
"""
from __future__ import annotations

import torch

from ..ops.contract import mv, quad
from .kinematics import BodyKin, body_com_positions, forward_kinematics, stacked_point_jacobians
from .robot_model import RobotModel

GRAVITY = 9.81


def _body_com_jacobians(model: RobotModel, kin: BodyKin):
    """(..., nb, 6, nv) Jacobians at every body's com."""
    coms = body_com_positions(model, kin)
    return stacked_point_jacobians(model, kin, coms, model.ancestor_mask())


def mass_matrix(model: RobotModel, q):
    """(..., nv, nv) joint-space inertia matrix: two einsums over the
    stacked body Jacobians."""
    kin = forward_kinematics(model, q)
    J = _body_com_jacobians(model, kin)  # (..., nb, 6, nv)
    Jv, Jw = J[..., :3, :], J[..., 3:, :]
    I_w = torch.einsum("...bij,bjk,...blk->...bil", kin.R, model.body_inertia, kin.R)
    M = torch.einsum("b,...biv,...biw->...vw", model.body_mass, Jv, Jv)
    return M + torch.einsum("...biv,...bij,...bjw->...vw", Jw, I_w, Jw)


def potential_energy(model: RobotModel, q):
    kin = forward_kinematics(model, q)
    coms = body_com_positions(model, kin)
    return GRAVITY * (model.body_mass * coms[..., 2]).sum(-1)


def kinetic_energy(model: RobotModel, q, v):
    return 0.5 * quad(v, mass_matrix(model, q), v)


def gravity_vector(model: RobotModel, q):
    """g(q) = grad_q PE."""
    return torch.func.grad(lambda qq: potential_energy(model, qq).sum())(q)


def nonlinear_effects(model: RobotModel, q, v):
    """C(q,v) v + g(q)  (Coriolis/centrifugal + gravity)."""
    Mdot_v = torch.func.jvp(lambda qq: mv(mass_matrix(model, qq), v), (q,), (v,))[1]
    dKE_dq = torch.func.grad(lambda qq: (0.5 * quad(v, mass_matrix(model, qq), v)).sum())(q)
    return Mdot_v - dKE_dq + gravity_vector(model, q)


def inverse_dynamics(model: RobotModel, q, v, vdot):
    """tau = M(q) vdot + nle(q, v)."""
    return mv(mass_matrix(model, q), vdot) + nonlinear_effects(model, q, v)


def forward_dynamics(model: RobotModel, q, v, tau):
    """vdot = M(q)^{-1} (tau - nle)."""
    rhs = tau - nonlinear_effects(model, q, v)
    return torch.linalg.solve(mass_matrix(model, q), rhs[..., None])[..., 0]

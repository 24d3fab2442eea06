"""Structured node linearization and node evaluation (ocp/linearize.py
counterpart), batched over any leading (scenario, node) dimensions.

The flow map and the contact constraints depend on the model only through
T(q) = (p_ee (nc,3), com (3), A (6,nv), J_ee (nc,3,nv)); their q-Jacobians
come from velocity-field algebra (model/second_order.py), and every Jacobian
block is assembled in closed form:

    hdot_lin = g + sum F / m
    hdot_ang = sum (p_i - com) x F_i / m
    v_b      = A_b^{-1} (m h - A_j v_j)
    v_ee     = J_ee v

RK2 uses exact values and the same-point sensitivity unless
``exact_rk2_sensitivity`` is set.  SingleRigidBodyDynamics (model_type 1)
takes the momentum quantities at the nominal joint pose.  This is plain
PyTorch: the JAX package computes it with XLA outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..model.centroidal import (
    CentroidalModelInfo,
    cmm_info_from_kin,
    get_contact_forces,
    get_joint_velocities,
    get_normalized_momentum,
    kinematics_info,
)
from ..model.kinematics import body_com_positions, frame_position, stacked_point_jacobians
from ..model.robot_model import RobotModel
from ..model.second_order import FieldData, cmm_v_derivative, velocity_fields
from ..ops.contract import mm, mv, quad
from ..ops.linalg import inv6_block
from ..utils.device import constant
from ..utils.rotations import skew
from .problem import (
    NUM_CONTACTS,
    LinearizedNode,
    NodeRefs,
    OcpSettings,
    _barrier_hessian_u,
    friction_cone_values,
    relaxed_barrier,
    relaxed_barrier_derivatives,
)

GRAVITY = (0.0, 0.0, -9.81)


class ConfigTerms(NamedTuple):
    p_ee: torch.Tensor  # (..., nc, 3)
    com: torch.Tensor  # (..., 3)
    A: torch.Tensor  # (..., 6, nv)
    J_ee: torch.Tensor  # (..., nc, 3, nv) linear rows


def _contact_anc(model, info):
    return model.ancestor_mask()[[model.frame_body[fid] for fid in info.contact_frame_ids]]


def config_terms(model: RobotModel, info: CentroidalModelInfo, q) -> ConfigTerms:
    # momentum quantities (com, A) at the model-type configuration: actual q
    # for FullCentroidalDynamics, nominal joints for SingleRigidBodyDynamics
    return _config_terms(model, info, *kinematics_info(model, info, q))


def _config_terms(model, info: CentroidalModelInfo, kin, kin_m) -> ConfigTerms:
    p_ee = torch.stack([frame_position(model, kin, fid) for fid in info.contact_frame_ids], dim=-2)
    coms = body_com_positions(model, kin_m)
    com = (model.body_mass[:, None] * coms).sum(-2) / model.total_mass
    J_ee = stacked_point_jacobians(model, kin, p_ee, _contact_anc(model, info))[..., :3, :]
    return ConfigTerms(p_ee=p_ee, com=com, A=cmm_info_from_kin(model, info, kin_m), J_ee=J_ee)


class FlowJac(NamedTuple):
    f: torch.Tensor  # (..., nx) flow value
    Jx: torch.Tensor  # (..., nx, nx)
    Ju: torch.Tensor  # (..., nx, nu)
    terms: ConfigTerms
    v: torch.Tensor  # (..., nv) generalized velocity
    Ab_inv: torch.Tensor  # (..., 6, 6)
    fields: FieldData
    dA_v: torch.Tensor  # (..., 6, nv) directional CMM derivative


def _terms_and_dq(model, info: CentroidalModelInfo, q):
    """ConfigTerms and their q-Jacobians by velocity-field algebra
    (model/second_order.py), with no forward-AD tangents through FK.

    Returns (terms, dterms, fields, kin_m, fields_m).  dterms carries dp_ee/dq
    (the linear contact Jacobian itself) and dcom/dq (A_lin / m); dA/dq and
    dJ_ee/dq are never formed: their only consumers contract them with the
    generalized velocity (cmm_v_derivative on kin_m, fields_m, and
    _eq_jacobians on fields)."""
    # momentum quantities at the model-type configuration (SRBD: nominal
    # joints, zero joint columns, zero joint-coordinate derivatives)
    kin, kin_m = kinematics_info(model, info, q)
    terms = _config_terms(model, info, kin, kin_m)
    fields = velocity_fields(model, kin)
    fields_m = fields if kin_m is kin else velocity_fields(model, kin_m)
    dterms = ConfigTerms(p_ee=terms.J_ee, com=terms.A[..., :3, :] / info.robot_mass, A=None, J_ee=None)
    return terms, dterms, fields, kin_m, fields_m


def _terms_and_dq_ad(model, info: CentroidalModelInfo, q):
    """(config_terms, their q-Jacobians) by torch.func.jacfwd over the
    leading batch dims (the test oracle of :func:`_terms_and_dq`): each
    field of the second ConfigTerms has a trailing nv axis."""
    fn = lambda qq: config_terms(model, info, qq)
    lead = q.shape[:-1]
    flat = q.reshape(-1, q.shape[-1])
    val, jac = torch.func.vmap(lambda qq: (fn(qq), torch.func.jacfwd(fn)(qq)))(flat)
    unflat = lambda t: ConfigTerms(*(a.reshape(lead + a.shape[1:]) for a in t))
    return unflat(val), unflat(jac)


def _flow_with_jacobians(model, info: CentroidalModelInfo, x, u) -> FlowJac:
    nx, nu = info.state_dim, info.input_dim
    nv = info.generalized_dim
    nj = info.nj
    m = info.robot_mass
    dtype, device = x.dtype, x.device
    lead = x.shape[:-1]
    q = x[..., 6:]
    h = m * get_normalized_momentum(x)
    forces = get_contact_forces(u, info)  # (..., nc, 3)
    v_j = get_joint_velocities(u, info)

    terms, _, fields, kin_m, fields_m = _terms_and_dq(model, info, q)
    p_ee, com, A, J_ee = terms

    A_b, A_j = A[..., :6], A[..., 6:]
    Ab_inv = inv6_block(A_b)
    v_b = mv(Ab_inv, h - mv(A_j, v_j))
    v = torch.cat([v_b, v_j], dim=-1)
    if info.model_type == 1:
        # SRBD: A's joint columns are zero (contract with [v_b, 0]) and A
        # depends on q only through the base coordinates (zero joint columns)
        v_m = torch.cat([v_b, torch.zeros_like(v_j)], dim=-1)
        dA_v = cmm_v_derivative(model, kin_m, fields_m, v_m)
        dA_v = torch.cat([dA_v[..., :6], torch.zeros(lead + (6, nv - 6), dtype=dtype, device=device)], dim=-1)
    else:
        dA_v = cmm_v_derivative(model, kin_m, fields_m, v)

    g = constant(GRAVITY, dtype, device)
    hdot_lin = g + forces.sum(-2) / m
    rel = p_ee - com[..., None, :]
    hdot_ang = torch.linalg.cross(rel, forces).sum(-2) / m
    f = torch.cat([hdot_lin, hdot_ang, v_b, v_j], dim=-1)

    # Jx w.r.t. x = [h/m (6), q (nv)]; dp_ee/dq = J_ee, dcom/dq = A_lin / m
    Jx = torch.zeros(lead + (nx, nx), dtype=dtype, device=device)
    drel = J_ee - (A[..., None, :3, :] / m)  # (..., nc, 3, nv)
    cross_dq = torch.linalg.cross(
        drel.transpose(-1, -2), forces[..., :, None, :].expand(drel.shape[:-2] + (drel.shape[-1], 3))
    )  # (..., nc, nv, 3)
    Jx[..., 3:6, 6:] = cross_dq.sum(-3).transpose(-1, -2) / m
    Jx[..., 6:12, 0:6] = m * Ab_inv
    Jx[..., 6:12, 6:] = -mm(Ab_inv, dA_v)

    # Ju w.r.t. u = [F (3nc), v_j (nj)]
    Ju = torch.zeros(lead + (nx, nu), dtype=dtype, device=device)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    Ju[..., 0:3, : 3 * NUM_CONTACTS] = (eye3 / m).repeat(1, NUM_CONTACTS)
    skews = skew(rel) / m  # (..., nc, 3, 3)
    Ju[..., 3:6, : 3 * NUM_CONTACTS] = torch.cat([skews[..., i, :, :] for i in range(NUM_CONTACTS)], dim=-1)
    Ju[..., 6:12, 3 * NUM_CONTACTS :] = -mm(Ab_inv, A_j)
    Ju[..., 12:, 3 * NUM_CONTACTS :] = torch.eye(nj, dtype=dtype, device=device)
    return FlowJac(f=f, Jx=Jx, Ju=Ju, terms=terms, v=v, Ab_inv=Ab_inv, fields=fields, dA_v=dA_v)


def _eq_jacobians(model, info: CentroidalModelInfo, settings: OcpSettings, x, u, refs: NodeRefs, fj: FlowJac):
    """Equality residual (..., 16) + Jacobians C, D from the stage-1 terms."""
    nx, nu = info.state_dim, info.input_dim
    m = info.robot_mass
    dtype, device = x.dtype, x.device
    lead = x.shape[:-1]
    flags = refs.contact_flags  # (..., nc)
    gain = settings.position_error_gain
    terms, v, Ab_inv = fj.terms, fj.v, fj.Ab_inv
    J = terms.J_ee  # (..., nc, 3, nv)
    e = _eq_from_terms(settings, terms, v, u, info, refs)

    # d v_ee / dq = (dJ/dq . v) + J_b dv_b/dq, with dJ/dq . v contracted
    # straight from the velocity fields:
    #   sum_k mv_k dJ[:,k,l] = sum_k mv_k dv0[k,l] + (sum_k mv_k dw[k,l]) x p
    #                          + (sum_k mv_k w_k) x J[:,l],   mv = move_mask*v
    move = np.zeros((len(info.contact_frame_ids), model.nv))
    move[:, :6] = 1.0
    move[:, 6:] = _contact_anc(model, info)
    mvv = constant(move, dtype, device) * v[..., None, :]  # (..., nc, nv)
    fd = fj.fields
    t1 = (mvv[..., :, :, None, None] * fd.dv0[..., None, :, :, :]).sum(-3)  # (..., nc, nv_l, 3)
    dwv = (mvv[..., :, :, None, None] * fd.dw[..., None, :, :, :]).sum(-3)
    t2 = torch.linalg.cross(dwv, terms.p_ee[..., :, None, :].expand_as(dwv))
    wv = (mvv[..., :, :, None] * fd.w[..., None, :, :]).sum(-2)  # (..., nc, 3)
    Jt = J.transpose(-1, -2)  # (..., nc, nv, 3)
    t3 = torch.linalg.cross(wv[..., :, None, :].expand_as(Jt), Jt)
    dJ_v = (t1 + t2 + t3).transpose(-1, -2)  # (..., nc, 3, nv)
    dv_b_dq = -mm(Ab_inv, fj.dA_v)  # (..., 6, nv)
    J6 = J[..., :6]  # (..., nc, 3, 6)
    dv_ee_dq = dJ_v + J6 @ dv_b_dq[..., None, :, :]
    dv_ee_dh = J6 @ (m * Ab_inv)[..., None, :, :]  # (..., nc, 3, 6)
    dv_b_dvj = -mm(Ab_inv, terms.A[..., 6:])
    dv_ee_dvj = J6 @ dv_b_dvj[..., None, :, :] + J[..., 6:]

    zsel = constant((0.0, 0.0, 1.0), dtype, device)
    dzv_dq = dv_ee_dq + gain * (J * zsel[:, None])  # dp_ee/dq = J_ee
    fl3 = flags[..., :, None, None]
    C_pc = torch.cat([fl3 * dv_ee_dh, fl3 * dzv_dq], dim=-1).reshape(lead + (3 * NUM_CONTACTS, nx))
    sw = (1.0 - flags)[..., :, None]
    C_nv = torch.cat([sw * dv_ee_dh[..., 2, :], sw * (dv_ee_dq[..., 2, :] + gain * J[..., 2, :])], dim=-1)
    C = torch.cat([C_pc, C_nv], dim=-2)

    nfc = 3 * NUM_CONTACTS
    eyeF = torch.eye(nfc, dtype=dtype, device=device).reshape(NUM_CONTACTS, 3, nfc)
    D_pc_F = (1.0 - fl3) * eyeF
    D_pc_vj = fl3 * dv_ee_dvj
    D_pc = torch.cat([D_pc_F, D_pc_vj], dim=-1).reshape(lead + (nfc, nu))
    D_nv = torch.cat(
        [torch.zeros(lead + (NUM_CONTACTS, nfc), dtype=dtype, device=device), sw * dv_ee_dvj[..., 2, :]],
        dim=-1,
    )
    D = torch.cat([D_pc, D_nv], dim=-2)
    return e, C, D


def _flow_from_terms(info: CentroidalModelInfo, terms: ConfigTerms, x, u):
    """Flow value + generalized velocity from precomputed ConfigTerms."""
    m = info.robot_mass
    h = m * get_normalized_momentum(x)
    forces = get_contact_forces(u, info)
    v_j = get_joint_velocities(u, info)
    A_b, A_j = terms.A[..., :6], terms.A[..., 6:]
    v_b = mv(inv6_block(A_b), h - mv(A_j, v_j))
    g = constant(GRAVITY, x.dtype, x.device)
    hdot_lin = g + forces.sum(-2) / m
    hdot_ang = torch.linalg.cross(terms.p_ee - terms.com[..., None, :], forces).sum(-2) / m
    f = torch.cat([hdot_lin, hdot_ang, v_b, v_j], dim=-1)
    return f, torch.cat([v_b, v_j], dim=-1)


def _barrier_grad_u(settings: OcpSettings, info: CentroidalModelInfo, u, refs: NodeRefs):
    """dt-scaled gradient of the masked cone barriers w.r.t. u (closed form
    of the reference's jax.grad: pen'(h) dh/dF on each contact's slots)."""
    forces = get_contact_forces(u, info)
    fx, fy = forces[..., 0], forces[..., 1]
    ft = torch.sqrt(fx**2 + fy**2 + settings.cone_regularization)
    h = friction_cone_values(settings, u, info)
    d1, _ = relaxed_barrier_derivatives(h, settings.barrier_mu, settings.barrier_delta)
    w = refs.dt[..., None] * refs.contact_flags * d1  # (..., nc)
    gF = torch.stack([-fx / ft, -fy / ft, torch.full_like(ft, settings.friction_coefficient)], dim=-1)
    g = torch.zeros_like(u)
    g[..., : 3 * NUM_CONTACTS] = (w[..., None] * gF).flatten(-2)
    return g


def _cost_terms(info, settings, Q, R, x, u, refs: NodeRefs):
    dt = refs.dt
    dx_dev = x - refs.x_nom
    du_dev = u - refs.u_nom
    cones = friction_cone_values(settings, u, info)
    pen = relaxed_barrier(cones, settings.barrier_mu, settings.barrier_delta)
    cost = dt * (
        0.5 * quad(dx_dev, Q, dx_dev) + 0.5 * quad(du_dev, R, du_dev) + (refs.contact_flags * pen).sum(-1)
    )
    return dx_dev, du_dev, cost


def linearize_node_structured(
    model: RobotModel, info: CentroidalModelInfo, settings: OcpSettings, Q, R, x, u, x_next, refs: NodeRefs
) -> LinearizedNode:
    """Gauss-Newton data for every node of the leading (scenario, node) axes."""
    dt = refs.dt[..., None]
    dtm = refs.dt[..., None, None]
    nx = info.state_dim
    eye = torch.eye(nx, dtype=x.dtype, device=x.device)

    fj0 = _flow_with_jacobians(model, info, x, u)
    if settings.integrator == "euler":
        F = x + dt * fj0.f
        A = eye + dtm * fj0.Jx
        B = dtm * fj0.Ju
    elif settings.integrator == "rk2":
        x1 = x + 0.5 * dt * fj0.f
        inner = eye + 0.5 * dtm * fj0.Jx
        if settings.exact_rk2_sensitivity:
            fj1 = _flow_with_jacobians(model, info, x1, u)
            F = x + dt * fj1.f
            A = eye + dtm * mm(fj1.Jx, inner)
            B = dtm * (0.5 * dtm * mm(fj1.Jx, fj0.Ju) + fj1.Ju)
        else:
            f1, _ = _flow_from_terms(info, config_terms(model, info, x1[..., 6:]), x1, u)
            F = x + dt * f1
            A = eye + dtm * mm(fj0.Jx, inner)
            B = dtm * (0.5 * dtm * mm(fj0.Jx, fj0.Ju) + fj0.Ju)
    else:
        raise NotImplementedError(f"structured linearization for {settings.integrator}")
    c = F - x_next

    e, C, D = _eq_jacobians(model, info, settings, x, u, refs, fj0)
    return LinearizedNode(A, B, c, C, D, e, *cost_quadratics(info, settings, Q, R, x, u, refs))


def cost_quadratics(info: CentroidalModelInfo, settings: OcpSettings, Q, R, x, u, refs: NodeRefs):
    """The FK-free node data (Qxx, Quu, Qux, qx, qu, cost): dt-scaled
    tracking quadratics and the cone barrier's exact u-derivatives."""
    dt = refs.dt[..., None]
    dtm = refs.dt[..., None, None]
    dx_dev, du_dev, cost_val = _cost_terms(info, settings, Q, R, x, u, refs)
    Qxx = dtm * Q
    Quu = dtm * R + _barrier_hessian_u(settings, info, u, refs)
    Qux = torch.zeros(x.shape[:-1] + (u.shape[-1], x.shape[-1]), dtype=x.dtype, device=x.device)
    qx = dt * mv(Q, dx_dev)
    qu = dt * mv(R, du_dev) + _barrier_grad_u(settings, info, u, refs)
    return Qxx, Quu, Qux, qx, qu, cost_val


def _eq_from_terms(settings: OcpSettings, terms: ConfigTerms, v, u, info, refs: NodeRefs):
    flags = refs.contact_flags
    gain = settings.position_error_gain
    forces = get_contact_forces(u, info)
    v_ee = (terms.J_ee * v[..., None, None, :]).sum(-1)
    zsel = constant((0.0, 0.0, 1.0), u.dtype, u.device)
    zero_vel = v_ee + gain * (terms.p_ee * zsel)
    fl = flags[..., :, None]
    per_contact = fl * zero_vel + (1.0 - fl) * forces
    nvel = (1.0 - flags) * (v_ee[..., 2] - refs.swing_vref + gain * (terms.p_ee[..., 2] - refs.swing_pref))
    return torch.cat([per_contact.flatten(-2), nvel], dim=-1)


def node_defect_eq(model, info: CentroidalModelInfo, settings: OcpSettings, x, u, x_next, refs: NodeRefs):
    """(defect (..., nx), masked eq (..., 16)): the FK-dependent part of
    :func:`node_eval`, with two FK/CMM passes per node (RK2 stages; the
    equality residual reuses the first).  Reads only refs.dt, contact_flags,
    swing_vref and swing_pref."""
    dt = refs.dt[..., None]
    terms0 = config_terms(model, info, x[..., 6:])
    f0, v0 = _flow_from_terms(info, terms0, x, u)
    if settings.integrator == "euler":
        F = x + dt * f0
    else:
        # RK2 for every other integrator, "rk4" included: the reference's
        # node_eval does the same (its else branch), and the port matches it
        x1 = x + 0.5 * dt * f0
        f1, _ = _flow_from_terms(info, config_terms(model, info, x1[..., 6:]), x1, u)
        F = x + dt * f1
    defect = F - x_next

    eq = _eq_from_terms(settings, terms0, v0, u, info, refs)
    ones = torch.ones(refs.contact_flags.shape[:-1] + (12,), dtype=x.dtype, device=x.device)
    eq = torch.cat([ones, 1.0 - refs.contact_flags], dim=-1) * eq
    return defect, eq


def node_eval(model, info: CentroidalModelInfo, settings: OcpSettings, Q, R, x, u, x_next, refs: NodeRefs):
    """(cost (...,), defect (..., nx), masked eq (..., 16))."""
    defect, eq = node_defect_eq(model, info, settings, x, u, x_next, refs)
    _, _, cost = _cost_terms(info, settings, Q, R, x, u, refs)
    return cost, defect, eq

"""Analytic second-order kinematics (model/second_order.py counterpart):
velocity fields, d(Jacobian)/dq, d(CMM)/dq and the directional CMM
derivative d/dq (A(q) v).

Every generalized coordinate k defines a rigid velocity field
v_k(p) = v0_k + w_k x p with world-frame (w_k, v0_k):
    translation   : w = 0,        v0 = e_k
    Euler i       : w = E[:, i],  v0 = -E[:, i] x p_base
    revolute j    : w = a_j,      v0 = -a_j x p_j
    prismatic j   : w = 0,        v0 = a_j
Their q-derivatives follow from static masks (which coordinate rotates which
axis / moves which anchor).  Leading batch dimensions are carried through,
and the masks are cached device constants, so nothing here copies from the
host (a CUDA graph may capture every function).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import constant
from .kinematics import BodyKin, _joint_world_axes, body_com_positions, stacked_point_jacobians
from .robot_model import RobotModel
from .urdf import JOINT_REVOLUTE


class FieldData(NamedTuple):
    w: torch.Tensor  # (..., nv, 3) angular field direction
    v0: torch.Tensor  # (..., nv, 3) linear field at the world origin
    dw: torch.Tensor  # (..., nv, nv, 3) dw_k/dq_l  (k, l, 3)
    dv0: torch.Tensor  # (..., nv, nv, 3)


def _static_masks(model: RobotModel):
    """(rot_mask (nv,nv), move_mask (nb,nv), body_rot (nb,nv)) static numpy.

    rot_mask[k,l]: coordinate l rotates the axis of coordinate k.
    move_mask[b,l]: l moves body b.  body_rot[b,l]: l rotates body b.
    """
    nv, nj, nb = model.nv, model.nj, model.nb
    move = np.zeros((nb, nv), dtype=bool)
    move[:, 0:6] = True
    move[:, 6:] = model.ancestor_mask()
    body_rot = move.copy()
    body_rot[:, 0:3] = False
    rot = np.zeros((nv, nv), dtype=bool)
    for i in range(3):
        for l in range(i):
            rot[3 + i, 3 + l] = True
    for j in range(nj):
        rot[6 + j, :] = body_rot[j + 1, :]
        rot[6 + j, 6 + j] = False
    return rot, move, body_rot


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def velocity_fields(model: RobotModel, kin: BodyKin) -> FieldData:
    dtype, device = kin.p.dtype, kin.p.device
    f = lambda a: constant(np.asarray(a, dtype=np.float64), dtype, device)
    nv = model.nv
    rot_mask, move_mask, _ = _static_masks(model)
    rot_f = f(rot_mask)
    axes, anchors = _joint_world_axes(model, kin)  # (..., nj, 3)
    rev = f([t == JOINT_REVOLUTE for t in model.joint_type])
    p_b = kin.p[..., 0, :]
    ET = kin.E.transpose(-1, -2)
    lead = p_b.shape[:-1]
    eye3 = torch.eye(3, dtype=dtype, device=device)

    w = torch.cat(
        [torch.zeros(lead + (3, 3), dtype=dtype, device=device), ET, rev[:, None] * axes], dim=-2
    )  # (..., nv, 3)
    v0_euler = -_cross(ET, p_b[..., None, :])
    v0_joint = rev[:, None] * (-_cross(axes, anchors)) + (1 - rev)[:, None] * axes
    v0 = torch.cat([eye3.expand(lead + (3, 3)), v0_euler, v0_joint], dim=-2)

    # dw[k, l] = rot(k,l) * (w_l x w_k)
    dw = rot_f[:, :, None] * _cross(w[..., None, :, :], w[..., :, None, :])

    # anchor motion: joint anchors move with the fields of their body's movers
    move_j = f(move_mask[1:, :])  # (nj, nv)
    v_l_at_anchor = v0[..., None, :, :] + _cross(w[..., None, :, :], anchors[..., :, None, :])
    danchor = move_j[:, :, None] * v_l_at_anchor  # (..., nj, nv, 3)
    dp_b = torch.cat([eye3, torch.zeros(nv - 3, 3, dtype=dtype, device=device)], dim=0)  # (nv, 3)

    # Euler rows k = 3 + i: v0_k = -w_k x p_b
    term = -_cross(dw[..., 3:6, :, :], p_b[..., None, None, :]) - _cross(
        w[..., 3:6, None, :], dp_b[None, :, :]
    )
    # joint rows: revolute v0 = -a x p -> -da x p - a x dp; prismatic v0 = a -> da
    rotj = rot_f[6:, :]
    da = rotj[:, :, None] * _cross(w[..., None, :, :], axes[..., :, None, :])  # (..., nj, nv, 3)
    dv0_rev = -_cross(da, anchors[..., :, None, :]) - _cross(axes[..., :, None, :], danchor)
    dv0_j = rev[:, None, None] * dv0_rev + (1 - rev)[:, None, None] * da
    dv0 = torch.cat(
        [torch.zeros(lead + (3, nv, 3), dtype=dtype, device=device), term, dv0_j], dim=-3
    )
    return FieldData(w=w, v0=v0, dw=dw, dv0=dv0)


def cmm_v_derivative(model: RobotModel, kin: BodyKin, fields: FieldData, v):
    """Directional CMM derivative d/dq (A(q) v) at fixed v: (..., 6, nv) with
    [:, l] = sum_k dA[:, k, l] v_k, computed body-wise:

        d cdot_b / dq_l = P_b[l] + W_b[l] x c_b + omega_b x Jv_b[:, l]
        P_b = (move_b . v) @ dv0,  W_b = (move_b . v) @ dw
        d(I_b w_b)/dq_l = rot(b,l) [w_l x (I w_b) - I (w_l x w_b)] + I W_b[l]
    """
    dtype, device = kin.p.dtype, kin.p.device
    _, move_mask, body_rot = _static_masks(model)
    move_f = constant(move_mask.astype(np.float64), dtype, device)
    rot_f = constant(body_rot.astype(np.float64), dtype, device)
    m_b = model.body_mass
    coms = body_com_positions(model, kin)  # (..., nb, 3)
    com = (m_b[:, None] * coms).sum(-2) / model.total_mass
    rel = coms - com[..., None, :]
    w, v0, dw, dv0 = fields.w, fields.v0, fields.dw, fields.dv0

    # ancestor-masked sums S_b = sum_k move(b,k) v_k X[k] by a walk down the tree
    P_l = [(v[..., :6, None, None] * dv0[..., :6, :, :]).sum(-3)]
    W_l = [(v[..., :6, None, None] * dw[..., :6, :, :]).sum(-3)]
    om_l = [(v[..., 3:6, None] * w[..., 3:6, :]).sum(-2)]
    v0_l = [(v[..., :6, None] * v0[..., :6, :]).sum(-2)]
    for b in range(1, model.nb):
        j = b - 1
        par = int(model.joint_parent_body[j])
        vj = v[..., 6 + j]
        P_l.append(P_l[par] + vj[..., None, None] * dv0[..., 6 + j, :, :])
        W_l.append(W_l[par] + vj[..., None, None] * dw[..., 6 + j, :, :])
        om_l.append(om_l[par] + vj[..., None] * w[..., 6 + j, :])
        v0_l.append(v0_l[par] + vj[..., None] * v0[..., 6 + j, :])
    P = torch.stack(P_l, dim=-3)  # (..., nb, nv, 3)
    W = torch.stack(W_l, dim=-3)
    omega = torch.stack(om_l, dim=-2)  # (..., nb, 3)
    cdot = torch.stack(v0_l, dim=-2) + _cross(omega, coms)
    Jv = move_f[:, :, None] * (v0[..., None, :, :] + _cross(w[..., None, :, :], coms[..., :, None, :]))
    dcdot = P + _cross(W, coms[..., :, None, :]) + _cross(omega[..., :, None, :], Jv)

    dp = (m_b[:, None, None] * dcdot).sum(-3)  # (..., nv, 3)
    dcom = (m_b[:, None, None] * Jv).sum(-3) / model.total_mass

    from .centroidal import rotate_inertia

    I_w = rotate_inertia(kin.R, model.body_inertia)  # (..., nb, 3, 3)
    Iom = (I_w @ omega[..., None]).squeeze(-1)  # (..., nb, 3)
    wxom = _cross(w[..., None, :, :], omega[..., :, None, :])  # (..., nb, nv, 3)
    dI_om = rot_f[:, :, None] * (
        _cross(w[..., None, :, :], Iom[..., :, None, :]) - wxom @ I_w.transpose(-1, -2)
    )
    I_dom = W @ I_w.transpose(-1, -2)
    dL = (
        dI_om
        + I_dom
        + m_b[:, None, None]
        * (
            _cross(Jv - dcom[..., None, :, :], cdot[..., :, None, :])
            + _cross(rel[..., :, None, :], dcdot)
        )
    ).sum(-3)  # (..., nv, 3)
    return torch.cat([dp.transpose(-1, -2), dL.transpose(-1, -2)], dim=-2)


def point_jacobian_derivatives(model: RobotModel, fields: FieldData, points, dpoints, move_masks):
    """d/dq of stacked point Jacobians.

    points (..., m, 3); dpoints (..., m, 3, nv) = dp/dq (the points' linear
    Jacobians); move_masks: static (m, nv) bool "coordinate k moves point".
    Returns (dJv, dJw): (..., m, 3, nv, nv) with [i, :, k, l] = d J[:,k] / dq_l.
    """
    mask = constant(np.asarray(move_masks, dtype=np.float64), points.dtype, points.device)
    # dcol_k/dq_l = dv0[k,l] + dw[k,l] x p + w_k x dp/dq_l
    term_field = fields.dv0[..., None, :, :, :] + _cross(
        fields.dw[..., None, :, :, :], points[..., :, None, None, :]
    )  # (..., m, nv_k, nv_l, 3)
    term_motion = _cross(fields.w[..., None, :, None, :], dpoints.transpose(-1, -2)[..., :, None, :, :])
    dJv = (term_field + term_motion) * mask[:, :, None, None]
    dJw = fields.dw[..., None, :, :, :] * mask[:, :, None, None]
    # (..., m, nv_k, nv_l, 3) -> (..., m, 3, nv_k, nv_l)
    return dJv.movedim(-1, -3), dJw.movedim(-1, -3)


def cmm_derivative(model: RobotModel, kin: BodyKin, fields: FieldData):
    """dA/dq: (..., 6, nv, nv) with [:, k, l] = d A[:, k] / dq_l, body-wise."""
    from .centroidal import rotate_inertia

    dtype, device = kin.p.dtype, kin.p.device
    _, move_mask, body_rot = _static_masks(model)
    m_b = model.body_mass
    coms = body_com_positions(model, kin)  # (..., nb, 3)
    com = (m_b[:, None] * coms).sum(-2) / model.total_mass
    J = stacked_point_jacobians(model, kin, coms, model.ancestor_mask())  # (..., nb, 6, nv)
    Jv, Jw = J[..., :3, :], J[..., 3:, :]
    dJv, dJw = point_jacobian_derivatives(model, fields, coms, Jv, move_mask)  # (..., nb, 3, nv, nv)
    I_w = rotate_inertia(kin.R, model.body_inertia)  # (..., nb, 3, 3)
    body_rot_f = constant(body_rot.astype(np.float64), dtype, device)
    # dI_w/dq_l = rot(b,l) ([w_l] I - I [w_l])
    wt = _skew_batch(fields.w)  # (..., nv, 3, 3)
    comm = wt[..., None, :, :, :] @ I_w[..., :, None, :, :] - I_w[..., :, None, :, :] @ wt[..., None, :, :, :]
    dI = body_rot_f[:, :, None, None] * comm  # (..., nb, nv_l, 3, 3)

    dA_lin = (m_b[:, None, None, None] * dJv).sum(-4)  # (..., 3, nv, nv)
    # term1[i,k,l] = sum_{b,j} dI[b,l,i,j] Jw[b,j,k]
    term1 = (dI @ Jw[..., :, None, :, :]).sum(-4).permute(*range(dI.dim() - 4), -2, -1, -3)
    # term2[i,k,l] = sum_{b,j} I_w[b,i,j] dJw[b,j,k,l]
    term2 = (I_w[..., :, :, :, None, None] * dJw[..., :, None, :, :, :]).sum((-5, -3))
    rel = coms - com[..., None, :]  # (..., nb, 3)
    drel = Jv - (m_b[:, None, None] * Jv).sum(-3, keepdim=True) / model.total_mass
    # d[rel x Jv_k]/dq_l = drel_l x Jv_k + rel x dJv_kl
    cross1 = _cross(drel.transpose(-1, -2)[..., :, None, :, :], Jv.transpose(-1, -2)[..., :, :, None, :])
    cross2 = _cross(rel[..., :, None, None, :], dJv.movedim(-3, -1))  # (..., nb, nv_k, nv_l, 3)
    dA_ang = term1 + term2 + (m_b[:, None, None, None] * (cross1 + cross2)).sum(-4).movedim(-1, -3)
    return torch.cat([dA_lin, dA_ang], dim=-3)


def _pair_tables(mask: np.ndarray):
    """Static (nv, nv) tables for pairwise-masked subtree sums.

    For tree-structured column masks (column k = the bodies moved or rotated
    by coordinate k), the elementwise AND of two columns is either empty or
    exactly the deeper column.  Returns (idx, valid): the pair sum over
    mask[:,k] & mask[:,l] == subtree_sum[idx[k,l]] * valid[k,l]."""
    mask = np.asarray(mask, dtype=bool)
    nv = mask.shape[1]
    idx = np.zeros((nv, nv), dtype=np.int64)
    valid = np.zeros((nv, nv))
    for k in range(nv):
        for l in range(nv):
            inter = mask[:, k] & mask[:, l]
            if not inter.any():
                continue
            if (inter == mask[:, k]).all():
                idx[k, l], valid[k, l] = k, 1.0
            elif (inter == mask[:, l]).all():
                idx[k, l], valid[k, l] = l, 1.0
            else:  # non-tree masks (never happens for ancestor columns)
                raise ValueError("pair mask is not a subtree column")
    return idx, valid


def cmm_derivative_fast(model: RobotModel, kin: BodyKin, fields: FieldData):
    """dA/dq equal to :func:`cmm_derivative` without any (nb, nv, nv, 3)
    intermediate: every body sum collapses to per-coordinate subtree
    aggregates, and the pairwise-masked sums to static gathers of them
    (:func:`_pair_tables`).  Identities (a, b, c, d three-vectors):
        a x (b x c)         = b (a.c) - c (a.b)
        (a x c) x (b x c)   = c ((a x b) . c)
        sum m rel x (d x c) = d tr(T) - T^T d,   T = sum m rel c^T
    """
    from .centroidal import rotate_inertia

    dtype, device = kin.p.dtype, kin.p.device
    _, move_mask, body_rot = _static_masks(model)
    m_b = model.body_mass  # (nb,)
    coms = body_com_positions(model, kin)  # (..., nb, 3)
    com = (m_b[:, None] * coms).sum(-2) / model.total_mass
    rel = coms - com[..., None, :]
    I_w = rotate_inertia(kin.R, model.body_inertia)  # (..., nb, 3, 3)
    w, v0, dw, dv0 = fields.w, fields.v0, fields.dw, fields.dv0

    move_f = constant(move_mask.astype(np.float64), dtype, device)  # (nb, nv)
    rot_f = constant(body_rot.astype(np.float64), dtype, device)
    mw = m_b[:, None] * move_f  # (nb, nv)

    # per-coordinate subtree aggregates (axis -1 of the masks = coordinate k)
    msub = mw.sum(0)  # (nv,)
    csub = (mw[:, :, None] * coms[..., :, None, :]).sum(-3)  # (..., nv, 3)
    ssub = csub - msub[:, None] * com[..., None, :]
    Tsub = (mw[:, :, None, None] * rel[..., :, None, :, None] * coms[..., :, None, None, :]).sum(-4)  # (..., nv, 3, 3)
    CCsub = (mw[:, :, None, None] * coms[..., :, None, :, None] * coms[..., :, None, None, :]).sum(-4)
    Isub_move = (move_f[:, :, None, None] * I_w[..., :, None, :, :]).sum(-4)  # (..., nv, 3, 3)
    Isub_rot = (rot_f[:, :, None, None] * I_w[..., :, None, :, :]).sum(-4)

    # pairwise gathers (static index tables)
    idx_mv, val_mv = _pair_tables(move_mask)
    idx_rt, val_rt = _pair_tables(body_rot)
    vmv = constant(val_mv, dtype, device)
    vrt = constant(val_rt, dtype, device)
    take = lambda X, idx, lead_dims: X[(slice(None),) * lead_dims + (idx,)]
    ld = coms.dim() - 2
    mpair = msub[idx_mv] * vmv  # (k, l)
    cpair = take(csub, idx_mv, ld) * vmv[..., None]  # (..., k, l, 3)
    spair = take(ssub, idx_mv, ld) * vmv[..., None]
    Tpair = take(Tsub, idx_mv, ld) * vmv[..., None, None]  # (..., k, l, 3, 3)
    CCpair = take(CCsub, idx_mv, ld) * vmv[..., None, None]
    Irot_pair = take(Isub_rot, idx_rt, ld) * vrt[..., None, None]

    dot = lambda a, b: (a * b).sum(-1)
    wk = w[..., :, None, :]  # (..., k, 1, 3)
    wl = w[..., None, :, :]  # (..., 1, l, 3)
    v0l = v0[..., None, :, :]
    v0k = v0[..., :, None, :]

    # dA_lin[:, k, l] = msub_k dv0[k,l] + dw[k,l] x csub_k + w_k x (mpair v0_l + w_l x cpair)
    dA_lin = msub[:, None, None] * dv0 + _cross(dw, csub[..., :, None, :]) + _cross(
        wk, mpair[..., None] * v0l + _cross(wl, cpair)
    )  # (..., k, l, 3)

    # term A: sum_b dI[b,l] Jw[b,:,k] = w_l x (Irot_pair w_k) - Irot_pair (w_l x w_k)
    Ipw = (Irot_pair * wk[..., :, :, None, :]).sum(-1)  # (..., k, l, 3)
    termA = _cross(wl, Ipw) - (Irot_pair * _cross(wl, wk)[..., :, :, None, :]).sum(-1)
    # term B: sum_b I_w[b] dJw[b,:,k,l] = Isub_move[k] dw[k,l]
    termB = (Isub_move[..., :, None, :, :] * dw[..., :, :, None, :]).sum(-1)
    # term C: sum m drel_l x Jv_k
    E1 = mpair[..., None] * _cross(v0l, v0k)
    E2 = wk * dot(v0l, cpair)[..., None] - cpair * dot(v0l, wk)[..., None]
    E3 = -(wl * dot(v0k, cpair)[..., None] - cpair * dot(v0k, wl)[..., None])
    E4 = (CCpair * _cross(wl, wk)[..., :, :, None, :]).sum(-1)
    Acol = msub[:, None] * v0 + _cross(w, csub)  # (..., nv, 3): A_lin columns
    termC = E1 + E2 + E3 + E4 - _cross(Acol[..., None, :, :] / model.total_mass, Acol[..., :, None, :])
    # term D: sum m rel x dJv[b,:,k,l]
    trT = Tsub.diagonal(dim1=-2, dim2=-1).sum(-1)  # (..., nv)
    D1 = _cross(ssub[..., :, None, :], dv0)
    D2 = trT[..., :, None, None] * dw - (Tsub.transpose(-1, -2)[..., :, None, :, :] * dw[..., :, :, None, :]).sum(-1)
    relxc = torch.stack(
        [
            Tpair[..., 1, 2] - Tpair[..., 2, 1],
            Tpair[..., 2, 0] - Tpair[..., 0, 2],
            Tpair[..., 0, 1] - Tpair[..., 1, 0],
        ],
        dim=-1,
    )  # (..., k, l, 3) = sum m pair (rel x c)
    relV = dot(spair, v0l) - dot(wl, relxc)
    TpT_wk = (Tpair * wk[..., :, :, :, None]).sum(-2)  # Tpair^T w_k
    sumV_relwk = v0l * dot(spair, wk)[..., None] + _cross(wl, TpT_wk)
    D3 = wk * relV[..., None] - sumV_relwk
    termD = D1 + D2 + D3

    dA_ang = termA + termB + termC + termD  # (..., k, l, 3)
    return torch.cat([dA_lin.movedim(-1, -3), dA_ang.movedim(-1, -3)], dim=-3)


def _skew_batch(v):
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )

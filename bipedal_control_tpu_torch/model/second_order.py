"""Analytic second-order kinematics (model/second_order.py counterpart):
velocity fields and the directional CMM derivative d/dq (A(q) v).

Every generalized coordinate k defines a rigid velocity field
v_k(p) = v0_k + w_k x p with world-frame (w_k, v0_k):
    translation   : w = 0,        v0 = e_k
    Euler i       : w = E[:, i],  v0 = -E[:, i] x p_base
    revolute j    : w = a_j,      v0 = -a_j x p_j
    prismatic j   : w = 0,        v0 = a_j
Their q-derivatives follow from static masks (which coordinate rotates which
axis / moves which anchor).  Leading batch dimensions are carried through.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .kinematics import BodyKin, _joint_world_axes, body_com_positions
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
    f = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
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
    move_f = torch.as_tensor(move_mask.astype(np.float64), dtype=dtype, device=device)
    rot_f = torch.as_tensor(body_rot.astype(np.float64), dtype=dtype, device=device)
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

"""Forward kinematics and frame Jacobians (model/kinematics.py counterpart).

Every function takes any number of leading batch dimensions on q.  The tree
is walked by a Python loop over its (static) joints.  Nothing here reads a
value back to the host or copies from it (the masks are cached constants),
so every function can run inside a CUDA graph.

Jacobian convention: rows = [linear(3); angular(3)], world-aligned axes, at
the point ("LOCAL_WORLD_ALIGNED").  ``frame_jacobian_dot`` is the exact
d/dt of that Jacobian along (q, v), a forward-mode derivative
(``torch.func.jvp``, as the reference's ``jax.jvp``), so
``a_classical = J @ vdot + Jdot @ v``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.contract import mm, mv
from ..utils.device import constant
from ..utils.rotations import euler_rate_map_zyx, rotmat_from_zyx, skew
from .robot_model import RobotModel
from .urdf import JOINT_PRISMATIC, JOINT_REVOLUTE


class BodyKin(NamedTuple):
    """World placement of every body frame, plus the base Euler-rate map."""

    R: torch.Tensor  # (..., nb, 3, 3)
    p: torch.Tensor  # (..., nb, 3)
    E: torch.Tensor  # (..., 3, 3) world angular velocity = E @ theta_dot


def _joint_motion(jtype: int, axis, q_i):
    """Rotation (..., 3, 3) and translation (..., 3) of one joint's motion."""
    if jtype == JOINT_REVOLUTE:
        c, s = torch.cos(q_i)[..., None, None], torch.sin(q_i)[..., None, None]
        K = skew(axis)
        eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
        R = eye + s * K + (1.0 - c) * (K @ K)
        return R, None
    if jtype == JOINT_PRISMATIC:
        return None, axis * q_i[..., None]
    raise ValueError(f"bad joint type {jtype}")


def forward_kinematics(model: RobotModel, q) -> BodyKin:
    """World placements of all body frames for configuration q (..., nq)."""
    theta = q[..., 3:6]
    R_list = [rotmat_from_zyx(theta)]
    p_list = [q[..., 0:3]]
    for j in range(model.nj):
        parent = model.joint_parent_body[j]
        R_parent, p_parent = R_list[parent], p_list[parent]
        R_joint = mm(R_parent, model.joint_offset_R[j])
        p_joint = p_parent + mv(R_parent, model.joint_offset_p[j])
        R_m, p_m = _joint_motion(model.joint_type[j], model.joint_axis[j], q[..., 6 + j])
        if R_m is not None:
            R_list.append(mm(R_joint, R_m))
            p_list.append(p_joint)
        else:
            R_list.append(R_joint)
            p_list.append(p_joint + mv(R_joint, p_m))
    return BodyKin(
        R=torch.stack(R_list, dim=-3), p=torch.stack(p_list, dim=-2), E=euler_rate_map_zyx(theta)
    )


def frame_transform(model: RobotModel, kin: BodyKin, frame_id: int):
    b = model.frame_body[frame_id]
    R_b, p_b = kin.R[..., b, :, :], kin.p[..., b, :]
    return mm(R_b, model.frame_R[frame_id]), p_b + mv(R_b, model.frame_p[frame_id])


def frame_position(model: RobotModel, kin: BodyKin, frame_id: int):
    return frame_transform(model, kin, frame_id)[1]


def _joint_world_axes(model: RobotModel, kin: BodyKin):
    """(..., nj, 3) world axis and (..., nj, 3) world anchor of each joint."""
    axes = (kin.R[..., 1:, :, :] * model.joint_axis[:, None, :]).sum(-1)
    return axes, kin.p[..., 1:, :]


def stacked_point_jacobians(model: RobotModel, kin: BodyKin, points, ancestor_mask):
    """(..., m, 6, nv) world-aligned Jacobians of m points.

    points: (..., m, 3) world positions; ancestor_mask: static (m, nj) bool
    (joint j moves point i)."""
    dtype, device = points.dtype, points.device
    axes, anchors = _joint_world_axes(model, kin)  # (..., nj, 3)
    mask = constant(np.asarray(ancestor_mask, dtype=np.float64), dtype, device)
    rev = constant([float(t == JOINT_REVOLUTE) for t in model.joint_type], dtype, device)
    rel = points[..., :, None, :] - anchors[..., None, :, :]  # (..., m, nj, 3)
    jv_rev = torch.linalg.cross(axes[..., None, :, :].expand_as(rel), rel)
    jv_joint = rev[:, None] * jv_rev + (1.0 - rev)[:, None] * axes[..., None, :, :]
    jv_joint = jv_joint * mask[:, :, None]  # (..., m, nj, 3)
    jw_joint = (rev[:, None] * axes)[..., None, :, :] * mask[:, :, None]

    m = points.shape[-2]
    r = points - kin.p[..., 0:1, :]  # (..., m, 3)
    ET = kin.E.transpose(-1, -2)[..., None, :, :]  # (..., 1, 3cols, 3)
    jv_base_e = torch.linalg.cross(ET.expand(r.shape[:-1] + (3, 3)), r[..., :, None, :].expand(r.shape[:-1] + (3, 3)))
    lead = points.shape[:-2]
    eye = torch.eye(3, dtype=dtype, device=device).expand(lead + (m, 3, 3))
    Jv = torch.cat(
        [eye, jv_base_e.transpose(-1, -2), jv_joint.transpose(-1, -2)], dim=-1
    )  # (..., m, 3, nv)
    Jw = torch.cat(
        [
            torch.zeros(lead + (m, 3, 3), dtype=dtype, device=device),
            kin.E[..., None, :, :].expand(lead + (m, 3, 3)),
            jw_joint.transpose(-1, -2),
        ],
        dim=-1,
    )
    return torch.cat([Jv, Jw], dim=-2)


def body_com_positions(model: RobotModel, kin: BodyKin):
    """(..., nb, 3) world com of every body."""
    return kin.p + (kin.R * model.body_com[:, None, :]).sum(-1)


def point_jacobian(model: RobotModel, kin: BodyKin, body_idx: int, p_world):
    """(..., 6, nv) world-aligned Jacobian of the point ``p_world`` (..., 3)
    rigidly attached to body ``body_idx``."""
    anc = model.ancestor_mask()[body_idx : body_idx + 1]  # (1, nj)
    return stacked_point_jacobians(model, kin, p_world[..., None, :], anc)[..., 0, :, :]


def frame_jacobian(model: RobotModel, q, frame_id: int):
    """(..., 6, nv) LOCAL_WORLD_ALIGNED Jacobian of a named frame."""
    kin = forward_kinematics(model, q)
    _, p = frame_transform(model, kin, frame_id)
    return point_jacobian(model, kin, model.frame_body[frame_id], p)


def frame_jacobian_dot(model: RobotModel, q, v, frame_id: int):
    """Exact time derivative of :func:`frame_jacobian` along (q, v); with
    leading batch dimensions each sample's tangent is its own v."""
    return torch.func.jvp(lambda qq: frame_jacobian(model, qq, frame_id), (q,), (v,))[1]


def frame_velocity(model: RobotModel, q, v, frame_id: int):
    """World linear+angular velocity (..., 6) of a frame."""
    return mv(frame_jacobian(model, q, frame_id), v)


def com_position(model: RobotModel, kin: BodyKin):
    """Whole-robot com (..., 3) in the world frame."""
    coms = body_com_positions(model, kin)
    return (model.body_mass[:, None] * coms).sum(-2) / model.total_mass


def frame_jacobians(model: RobotModel, q, frame_ids):
    """(..., m, 6, nv): :func:`frame_jacobian` of several frames from one
    forward-kinematics pass (each frame's Jacobian is the same elementwise
    computation as its own call's)."""
    kin = forward_kinematics(model, q)
    points = torch.stack([frame_transform(model, kin, f)[1] for f in frame_ids], dim=-2)
    anc = model.ancestor_mask()[[model.frame_body[f] for f in frame_ids]]
    return stacked_point_jacobians(model, kin, points, anc)


def frame_jacobians_and_dot(model: RobotModel, q, v, frame_ids):
    """(J, Jdot) of :func:`frame_jacobians`, both from one forward-mode pass."""
    return torch.func.jvp(lambda qq: frame_jacobians(model, qq, frame_ids), (q,), (v,))

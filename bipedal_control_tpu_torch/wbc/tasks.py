"""Whole-body-control task formulation (wbc/tasks.py counterpart; WbcBase).

Decision vector  x = [vdot (6+nj); F_contact (12); tau (nj)]
(bipedal_wbc/src/WbcBase.cpp:37).

Every task is (a, b, d, f): equality a x = b, inequality d x <= f.  Tasks
keep static shapes: rows that depend on the contact mode are masked (the
flags multiply them) instead of resized, so the QP (wbc/qp.py) has one shape
for every mode and batches.  Every function takes any number of leading
batch dimensions on its measured and desired inputs, and none reads a value
back to the host or copies from it (constants come from
utils/device.py::constant), so the device WBC runs inside a CUDA graph.

Conventions match WbcBase.cpp: measured quantities from rbdState
(Euler-rate generalized velocities), desired quantities from the MPC
(x*, u*) through the centroidal mapping, LOCAL_WORLD_ALIGNED Jacobians.
The host WBC (wbc/host_wbc.py) builds the same rows in numpy from
:class:`WbcTaskConfig`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..model.centroidal import (
    CentroidalModelInfo,
    base_kinematics_from_centroidal,
    generalized_from_rbd,
    generalized_velocity_from_state_input,
    get_contact_forces,
    get_generalized_coordinates,
)
from ..model.dynamics import mass_matrix, nonlinear_effects
from ..model.kinematics import frame_jacobians, frame_jacobians_and_dot, frame_position, forward_kinematics
from ..ops.contract import mv
from ..utils.device import constant
from ..utils.rotations import global_angular_velocity_from_zyx_rates, rotation_error_in_world, rotmat_from_zyx

NUM_CONTACTS = 4


@dataclasses.dataclass(frozen=True)
class WbcTaskConfig:
    """task.info WBC blocks (torqueLimitsTask .. weight, task.info:289-342)."""

    torque_limit_per_leg: tuple  # (nj/2,)
    friction_coefficient: float = 0.3
    swing_kp: float = 350.0
    swing_kd: float = 37.0
    base_kp: tuple = (40.0, 40.0, 20.0, 20.0, 20.0, 20.0)
    base_kd: tuple = (4.0, 4.0, 3.0, 3.0, 3.0, 3.0)
    no_contact_motion_tolerance: float = 5.0
    weight_swing_leg: float = 100.0
    weight_base_accel: float = 1.0
    weight_contact_force: float = 0.01
    # Null-space regularization: in full stance no weighted task touches the
    # joint accelerations (the +-tolerance no-contact band leaves them free),
    # so the QP optimum is degenerate.  qpOASES's zero-initialized active-set
    # implicitly returns a small solution; the ADMM needs the preference made
    # explicit or the null space fills with tens of rad/s^2 that leak into
    # the torques through the EoM.
    accel_reg: float = 1e-2
    force_reg: float = 1e-6
    torque_reg: float = 1e-6


class Task(NamedTuple):
    a: torch.Tensor  # (..., ra, ndec)
    b: torch.Tensor  # (..., ra)
    d: torch.Tensor  # (..., rd, ndec)
    f: torch.Tensor  # (..., rd)


def concat_tasks(tasks):
    """Rows of all tasks stacked; tasks without batch dimensions (the
    constant ones) are broadcast to the others'."""
    lead = torch.broadcast_shapes(*(t.a.shape[:-2] for t in tasks), *(t.d.shape[:-2] for t in tasks))
    cat = lambda xs, k: torch.cat([x.expand(lead + x.shape[x.dim() - k:]) for x in xs], dim=-k)
    return Task(
        a=cat([t.a for t in tasks], 2),
        b=cat([t.b for t in tasks], 1),
        d=cat([t.d for t in tasks], 2),
        f=cat([t.f for t in tasks], 1),
    )


class WbcKinematics(NamedTuple):
    """Measured- and desired-side quantities shared across tasks."""

    q_m: torch.Tensor
    v_m: torch.Tensor
    M: torch.Tensor  # (..., nv, nv)
    nle: torch.Tensor  # (..., nv)
    Jc: torch.Tensor  # (..., nc, 3, nv) contact Jacobians (linear rows)
    dJc: torch.Tensor  # (..., nc, 3, nv)
    base_J: torch.Tensor  # (..., 6, nv)
    base_dJ: torch.Tensor  # (..., 6, nv)
    p_contact_m: torch.Tensor  # (..., nc, 3)
    v_contact_m: torch.Tensor  # (..., nc, 3)
    # desired side
    q_d: torch.Tensor
    v_d: torch.Tensor
    p_contact_d: torch.Tensor
    v_contact_d: torch.Tensor
    base_pose_d: torch.Tensor  # (..., 6)
    base_vel_d: torch.Tensor  # (..., 6) world [v; omega]
    base_acc_d: torch.Tensor  # (..., 6)
    forces_d: torch.Tensor  # (..., nc, 3)


def num_decision_vars(info: CentroidalModelInfo) -> int:
    return info.generalized_dim + 3 * NUM_CONTACTS + info.nj


def compute_wbc_kinematics(model, info: CentroidalModelInfo, x_des, u_des, rbd_measured) -> WbcKinematics:
    """updateMeasured + updateDesired (WbcBase.cpp:59-158).  The contact and
    base Jacobians and their time derivatives come from one forward-mode
    pass over all five frames (model/kinematics.py::frame_jacobians_and_dot)
    where the reference calls frame_jacobian and frame_jacobian_dot per
    frame: the same quantities."""
    cids = tuple(info.contact_frame_ids)
    base_fid = model.frame_index(model.frame_names[0])  # root link frame
    q_m, v_m = generalized_from_rbd(info, rbd_measured)
    kin_m = forward_kinematics(model, q_m)
    M = mass_matrix(model, q_m)
    nle = nonlinear_effects(model, q_m, v_m)
    J, dJ = frame_jacobians_and_dot(model, q_m, v_m, cids + (base_fid,))  # (..., nc + 1, 6, nv)
    Jc, dJc = J[..., :NUM_CONTACTS, :3, :], dJ[..., :NUM_CONTACTS, :3, :]
    p_m = torch.stack([frame_position(model, kin_m, fid) for fid in cids], dim=-2)

    q_d = get_generalized_coordinates(x_des)
    v_d = generalized_velocity_from_state_input(model, info, x_des, u_des)
    kin_d = forward_kinematics(model, q_d)
    Jc_d = frame_jacobians(model, q_d, cids)[..., :3, :]
    p_d = torch.stack([frame_position(model, kin_d, fid) for fid in cids], dim=-2)
    zero_accel = torch.zeros(x_des.shape[:-1] + (info.nj,), dtype=x_des.dtype, device=x_des.device)
    pose_d, vel_d, acc_d = base_kinematics_from_centroidal(model, info, x_des, u_des, zero_accel)
    return WbcKinematics(
        q_m=q_m, v_m=v_m, M=M, nle=nle,
        Jc=Jc, dJc=dJc,
        base_J=J[..., NUM_CONTACTS, :, :], base_dJ=dJ[..., NUM_CONTACTS, :, :],
        p_contact_m=p_m, v_contact_m=mv(Jc, v_m[..., None, :]),
        q_d=q_d, v_d=v_d,
        p_contact_d=p_d, v_contact_d=mv(Jc_d, v_d[..., None, :]),
        base_pose_d=pose_d, base_vel_d=vel_d, base_acc_d=acc_d,
        forces_d=get_contact_forces(u_des, info),
    )


def _selector(rows: int, ndec: int, col: int, block, like) -> torch.Tensor:
    """(rows, ndec) constant: ``block`` (rows, w) at columns col..col+w."""
    s = np.zeros((rows, ndec))
    block = np.asarray(block, dtype=np.float64)
    s[:, col : col + block.shape[1]] = block
    return constant(s, like.dtype, like.device)


def _no_rows(ndec: int, like) -> tuple:
    """(d, f) of a task without inequality rows."""
    return like.new_zeros((0, ndec)), like.new_zeros((0,))


def _velocity_rows(J, ndec: int):
    """(..., r, ndec): J (..., r, nv) in the vdot columns."""
    return torch.cat([J, J.new_zeros(J.shape[:-1] + (ndec - J.shape[-1],))], dim=-1)


# -------------------------------------------------------------- constraints
def floating_base_eom_task(info, kin: WbcKinematics) -> Task:
    """M vdot + nle = Jc^T F + S^T tau (WbcBase::formulateFloatingBaseEomTask)."""
    nv, nj = info.generalized_dim, info.nj
    Jc_flat = kin.Jc.reshape(kin.Jc.shape[:-3] + (3 * NUM_CONTACTS, nv))
    S_T = constant(np.concatenate([np.zeros((6, nj)), np.eye(nj)]), kin.M.dtype, kin.M.device)
    a = torch.cat([kin.M, -Jc_flat.transpose(-1, -2), (-S_T).expand(kin.M.shape[:-2] + (nv, nj))], dim=-1)
    return Task(a, -kin.nle, *_no_rows(num_decision_vars(info), kin.M))


def torque_limits_task(info, cfg: WbcTaskConfig, like) -> Task:
    """|tau| <= limits, per-leg pattern (WbcBase::formulateTorqueLimitsTask).
    ``like``: a tensor of the WBC's dtype and device."""
    nj = info.nj
    ndec = num_decision_vars(info)
    eye = np.zeros((nj, ndec))
    eye[:, info.generalized_dim + 3 * NUM_CONTACTS :] = np.eye(nj)
    limits = np.tile(np.asarray(cfg.torque_limit_per_leg, dtype=np.float64), 2)
    d = constant(np.concatenate([eye, -eye]), like.dtype, like.device)
    f = constant(np.concatenate([limits, limits]), like.dtype, like.device)
    return Task(like.new_zeros((0, ndec)), like.new_zeros((0,)), d, f)


def friction_cone_task(info, cfg: WbcTaskConfig, contact_flags) -> Task:
    """Swing contacts: F = 0 (equality); stance contacts: 5-row friction
    pyramid (WbcBase::formulateFrictionConeTask), masked by flags."""
    ndec = num_decision_vars(info)
    off = info.generalized_dim
    mu = cfg.friction_coefficient
    pyramid = [[0.0, 0.0, -1.0], [1.0, 0.0, -mu], [-1.0, 0.0, -mu], [0.0, 1.0, -mu], [0.0, -1.0, -mu]]
    a_rows, d_rows = [], []
    for i in range(NUM_CONTACTS):
        stance = contact_flags[..., i, None, None]
        a_rows.append((1.0 - stance) * _selector(3, ndec, off + 3 * i, np.eye(3), contact_flags))
        d_rows.append(stance * _selector(5, ndec, off + 3 * i, pyramid, contact_flags))
    a, d = torch.cat(a_rows, dim=-2), torch.cat(d_rows, dim=-2)
    return Task(a, a.new_zeros(a.shape[:-1]), d, d.new_zeros(d.shape[:-1]))


def no_contact_motion_task(info, cfg: WbcTaskConfig, kin: WbcKinematics, contact_flags) -> Task:
    """Stance-foot no-motion: Jc vdot = -dJc v per stance contact (equality).

    The reference's active implementation builds a +-tolerance band whose
    second block carries a sign error (WbcBase.cpp:176-208); the
    commented-out equality version, the original legged_control
    formulation, is the one implemented here, as in the JAX package."""
    ndec = num_decision_vars(info)
    m = contact_flags[..., :, None]  # (..., nc, 1)
    a = (m[..., None] * _velocity_rows(kin.Jc, ndec)).flatten(-3, -2)
    b = (m * (-mv(kin.dJc, kin.v_m[..., None, :]))).flatten(-2)
    return Task(a, b, *_no_rows(ndec, a))


# -------------------------------------------------------------- weighted tasks
def swing_leg_task(info, cfg: WbcTaskConfig, kin: WbcKinematics, contact_flags) -> Task:
    """PD acceleration tracking for swing feet (WbcBase::formulateSwingLegTask),
    masked by swing flags."""
    ndec = num_decision_vars(info)
    swing = 1.0 - contact_flags[..., :, None]  # (..., nc, 1)
    accel = cfg.swing_kp * (kin.p_contact_d - kin.p_contact_m) + cfg.swing_kd * (
        kin.v_contact_d - kin.v_contact_m
    )
    a = (swing[..., None] * _velocity_rows(kin.Jc, ndec)).flatten(-3, -2)
    b = (swing * (accel - mv(kin.dJc, kin.v_m[..., None, :]))).flatten(-2)
    return Task(a, b, *_no_rows(ndec, a))


def base_accel_pd_task(info, cfg: WbcTaskConfig, kin: WbcKinematics) -> Task:
    """World-frame PD on the base (WbcBase::formulateBaseAccelPDTask).  The
    angular-velocity error is the actual one (the reference computes it
    from the linear rows, WbcBase.cpp:280, as the JAX package notes)."""
    ndec = num_decision_vars(info)
    lin = _selector(3, ndec, 0, np.eye(3), kin.M)
    a = torch.cat([lin.expand(kin.base_J.shape[:-2] + (3, ndec)), _velocity_rows(kin.base_J[..., 3:6, :], ndec)],
                  dim=-2)
    theta_m = kin.q_m[..., 3:6]
    omega_m = global_angular_velocity_from_zyx_rates(theta_m, kin.v_m[..., 3:6])
    kp = constant(cfg.base_kp, kin.M.dtype, kin.M.device)
    kd = constant(cfg.base_kd, kin.M.dtype, kin.M.device)
    pos_err = kin.base_pose_d[..., :3] - kin.q_m[..., :3]
    vel_err = kin.base_vel_d[..., :3] - kin.v_m[..., :3]
    rot_err = rotation_error_in_world(rotmat_from_zyx(kin.base_pose_d[..., 3:6]), rotmat_from_zyx(theta_m))
    omega_err = kin.base_vel_d[..., 3:] - omega_m
    b_lin = kin.base_acc_d[..., :3] + kp[:3] * pos_err + kd[:3] * vel_err
    b_ang = kin.base_acc_d[..., 3:] + kp[3:] * rot_err + kd[3:] * omega_err - mv(kin.base_dJ[..., 3:6, :], kin.v_m)
    return Task(a, torch.cat([b_lin, b_ang], dim=-1), *_no_rows(ndec, a))


def contact_force_task(info, kin: WbcKinematics) -> Task:
    """F == F_desired for every contact (WbcBase::formulateContactForceTask)."""
    ndec = num_decision_vars(info)
    nfc = 3 * NUM_CONTACTS
    a = _selector(nfc, ndec, info.generalized_dim, np.eye(nfc), kin.M)
    return Task(a, kin.forces_d.flatten(-2), *_no_rows(ndec, a))


def scale_task(task: Task, w) -> Task:
    return Task(a=w * task.a, b=w * task.b, d=task.d, f=task.f)

"""Centroidal model: momentum matrix, flow map, state access
(model/centroidal.py counterpart).

    state  x = [h_com/m (6: v_com, L/m), basePose (6: xyz + euler-zyx), q_j (nj)]
    input  u = [F_contact (3*n_c, world frame), v_joints (nj)]

The centroidal momentum matrix A(q) maps the generalized velocity (Euler-rate
convention) to [linear; angular] momentum about the whole-body com:

    A(q) = sum_b [ m_b Jv_cb ; R_b I_b R_b^T Jw_b + m_b skew(c_b - c) Jv_cb ]

Every function takes any number of leading batch dimensions, and none reads
a value back to the host, so each can run inside a CUDA graph.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.contract import mv
from ..ops.linalg import inv6_block
from ..utils.device import constant
from ..utils.rotations import (
    euler_rate_map_zyx,
    global_angular_velocity_from_zyx_rates,
    zyx_rates_from_global_angular_velocity,
)
from .kinematics import (
    body_com_positions,
    forward_kinematics,
    frame_position,
    frame_transform,
    stacked_point_jacobians,
)
from .robot_model import RobotModel

GRAVITY_VECTOR = (0.0, 0.0, -9.81)


@dataclasses.dataclass(frozen=True)
class CentroidalModelInfo:
    """Static problem-size metadata (reference: CentroidalModelInfo).

    model_type mirrors task.info centroidalModelType: 0 =
    FullCentroidalDynamics (momentum matrix at the actual configuration), 1 =
    SingleRigidBodyDynamics (momentum matrix at the nominal joint
    configuration ``q_j_nominal`` with zero joint columns: the robot's
    momentum is that of one rigid body locked at the default pose, while the
    contact kinematics use the true joint angles)."""

    nj: int
    contact_frame_ids: tuple[int, ...]
    robot_mass: float
    model_type: int = 0
    q_j_nominal: tuple[float, ...] = ()

    @property
    def num_contacts(self) -> int:
        return len(self.contact_frame_ids)

    @property
    def state_dim(self) -> int:
        return 12 + self.nj

    @property
    def input_dim(self) -> int:
        return 3 * self.num_contacts + self.nj

    @property
    def generalized_dim(self) -> int:
        return 6 + self.nj


def make_info(
    model: RobotModel,
    contact_frame_names: list[str],
    model_type: int = 0,
    q_j_nominal: tuple[float, ...] = (),
) -> CentroidalModelInfo:
    if model_type == 1 and len(q_j_nominal) != model.nj:
        raise ValueError("SingleRigidBodyDynamics needs a nominal joint configuration")
    return CentroidalModelInfo(
        nj=model.nj,
        contact_frame_ids=tuple(model.frame_index(n) for n in contact_frame_names),
        robot_mass=float(model.total_mass),
        model_type=model_type,
        q_j_nominal=tuple(float(v) for v in q_j_nominal),
    )


def momentum_coordinates(info: CentroidalModelInfo, q):
    """Configuration at which the momentum quantities (CMM, com) are
    evaluated: q itself for the full model, [basePose, q_j_nominal] for
    SRBD."""
    if info.model_type == 1:
        nominal = constant(info.q_j_nominal, q.dtype, q.device)
        return torch.cat([q[..., :6], nominal.expand(q.shape[:-1] + nominal.shape)], dim=-1)
    return q


def centroidal_momentum_matrix_info(model: RobotModel, info: CentroidalModelInfo, q):
    """Model-type-aware A(q): SRBD locks the inertia at the nominal joint
    pose and carries no joint momentum (zero joint columns)."""
    return cmm_info_from_kin(model, info, forward_kinematics(model, momentum_coordinates(info, q)))


def cmm_info_from_kin(model: RobotModel, info: CentroidalModelInfo, kin_m):
    """:func:`centroidal_momentum_matrix_info` from the forward kinematics
    at the momentum coordinates."""
    A = _cmm_from_kin(model, kin_m)
    if info.model_type == 1:
        A = torch.cat([A[..., :6], torch.zeros_like(A[..., 6:])], dim=-1)
    return A


# ---------------------------------------------------------------- access
def get_normalized_momentum(x):
    return x[..., 0:6]


def get_base_pose(x):
    return x[..., 6:12]


def get_generalized_coordinates(x):
    """q = [base pos, euler-zyx, q_j] from the centroidal state."""
    return x[..., 6:]


def get_joint_positions(x, info: CentroidalModelInfo):
    return x[..., 12 : 12 + info.nj]


def get_contact_force(u, contact_index: int):
    return u[..., 3 * contact_index : 3 * contact_index + 3]


def get_contact_forces(u, info: CentroidalModelInfo):
    return u[..., : 3 * info.num_contacts].reshape(*u.shape[:-1], info.num_contacts, 3)


def get_joint_velocities(u, info: CentroidalModelInfo):
    return u[..., 3 * info.num_contacts :]


def assemble_state(h_norm, base_pose, q_j):
    return torch.cat([h_norm, base_pose, q_j], dim=-1)


def assemble_input(forces_flat, v_j):
    return torch.cat([forces_flat, v_j], dim=-1)


# ---------------------------------------------------------------- CMM
def rotate_inertia(R, I):
    """R_b I_b R_b^T: R (..., nb, 3, 3), I (nb, 3, 3) -> (..., nb, 3, 3)."""
    return R @ I @ R.transpose(-1, -2)


def centroidal_momentum_matrix(model: RobotModel, q):
    """A(q): (..., 6, nv) from stacked body-com Jacobians."""
    return _cmm_from_kin(model, forward_kinematics(model, q))


def _cmm_from_kin(model: RobotModel, kin):
    """A at the configuration whose forward kinematics kin holds."""
    coms = body_com_positions(model, kin)  # (..., nb, 3)
    com = (model.body_mass[:, None] * coms).sum(-2) / model.total_mass
    J = stacked_point_jacobians(model, kin, coms, model.ancestor_mask())  # (..., nb, 6, nv)
    Jv, Jw = J[..., :3, :], J[..., 3:, :]
    I_w = rotate_inertia(kin.R, model.body_inertia)
    m_b = model.body_mass[:, None, None]
    A_lin = (m_b * Jv).sum(-3)
    rel = coms - com[..., None, :]  # (..., nb, 3)
    cross_term = torch.linalg.cross(
        rel[..., None, :].expand(Jv.shape[:-2] + (Jv.shape[-1], 3)), Jv.transpose(-1, -2)
    ).transpose(-1, -2)  # (..., nb, 3, nv)
    A_ang = (I_w @ Jw).sum(-3) + (m_b * cross_term).sum(-3)
    return torch.cat([A_lin, A_ang], dim=-2)


def centroidal_momentum_matrix_dot(model: RobotModel, q, v):
    """dA/dt along (q, v): replaces pinocchio::dccrba (WbcBase.cpp:225-232)."""
    return torch.func.jvp(lambda qq: centroidal_momentum_matrix(model, qq), (q,), (v,))[1]


def generalized_velocity_from_state_input(model: RobotModel, info: CentroidalModelInfo, x, u):
    """v = [v_base; v_j] with v_base = A_b^{-1} (m h_norm - A_j v_j)."""
    return _velocity(info, centroidal_momentum_matrix_info(model, info, get_generalized_coordinates(x)), x, u)


def _velocity(info: CentroidalModelInfo, A, x, u):
    h = info.robot_mass * get_normalized_momentum(x)
    v_j = get_joint_velocities(u, info)
    A_b, A_j = A[..., :6], A[..., 6:]
    v_b = mv(inv6_block(A_b), h - mv(A_j, v_j))
    return torch.cat([v_b, v_j], dim=-1)


def kinematics_info(model: RobotModel, info: CentroidalModelInfo, q):
    """(kin, kin_m): the forward kinematics at q and at the momentum
    coordinates (the same for the full model; SRBD's nominal joint pose)."""
    kin = forward_kinematics(model, q)
    return kin, kin if info.model_type == 0 else forward_kinematics(model, momentum_coordinates(info, q))


def normalized_momentum_rate(model: RobotModel, info: CentroidalModelInfo, x, u):
    """d/dt (h/m): gravity + contact forces and torques about the com."""
    return _momentum_rate(model, info, *kinematics_info(model, info, get_generalized_coordinates(x)), x, u)


def _momentum_rate(model: RobotModel, info: CentroidalModelInfo, kin, kin_m, x, u):
    # SRBD: the torque arm about the locked-inertia com (nominal joint pose)
    coms = body_com_positions(model, kin_m)
    com = (model.body_mass[:, None] * coms).sum(-2) / model.total_mass
    g = constant(GRAVITY_VECTOR, x.dtype, x.device)
    forces = get_contact_forces(u, info)  # (..., nc, 3)
    lin = g + forces.sum(-2) / info.robot_mass
    ang = torch.zeros_like(lin)
    for i, fid in enumerate(info.contact_frame_ids):
        p_i = frame_position(model, kin, fid)
        ang = ang + torch.linalg.cross(p_i - com, forces[..., i, :])
    return torch.cat([lin, ang / info.robot_mass], dim=-1)


def centroidal_flow_map(model: RobotModel, info: CentroidalModelInfo, x, u):
    """Continuous dynamics xdot = f(x, u) of the centroidal model, with one
    forward-kinematics pass shared by the momentum rate and the momentum
    matrix (two for SRBD)."""
    kin, kin_m = kinematics_info(model, info, get_generalized_coordinates(x))
    A = cmm_info_from_kin(model, info, kin_m)
    return torch.cat([_momentum_rate(model, info, kin, kin_m, x, u), _velocity(info, A, x, u)], dim=-1)


# ---------------------------------------------------------------- rbd conversions
def generalized_from_rbd(info: CentroidalModelInfo, rbd_state):
    """(q, v) generalized coordinates from an rbdState vector (..., 2 nv):
    rbdState = [euler-zyx, base pos, q_j, omega_world, v_world, dq_j]."""
    nj = info.nj
    ngen = 6 + nj
    euler = rbd_state[..., 0:3]
    pos = rbd_state[..., 3:6]
    q_j = rbd_state[..., 6 : 6 + nj]
    omega_w = rbd_state[..., ngen : ngen + 3]
    v_lin = rbd_state[..., ngen + 3 : ngen + 6]
    dq_j = rbd_state[..., ngen + 6 :]
    q = torch.cat([pos, euler, q_j], dim=-1)
    euler_rates = zyx_rates_from_global_angular_velocity(euler, omega_w)
    v = torch.cat([v_lin, euler_rates, dq_j], dim=-1)
    return q, v


def centroidal_state_from_rbd(model: RobotModel, info: CentroidalModelInfo, rbd_state):
    """rbdState -> centroidal state x
    (CentroidalModelRbdConversions::computeCentroidalStateFromRbdModel,
    consumed at BipedalController.cpp:402)."""
    q, v = generalized_from_rbd(info, rbd_state)
    A = centroidal_momentum_matrix_info(model, info, q)
    h_norm = mv(A, v) / info.robot_mass
    return torch.cat([h_norm, q], dim=-1)


def rbd_state_from_centroidal(model: RobotModel, info: CentroidalModelInfo, x, u):
    """Centroidal (x, u) -> rbdState (inverse of the above)."""
    q = get_generalized_coordinates(x)
    v = generalized_velocity_from_state_input(model, info, x, u)
    euler = q[..., 3:6]
    omega_w = global_angular_velocity_from_zyx_rates(euler, v[..., 3:6])
    return torch.cat([euler, q[..., 0:3], q[..., 6:], omega_w, v[..., 0:3], v[..., 6:]], dim=-1)


def base_kinematics_from_centroidal(model: RobotModel, info: CentroidalModelInfo, x, u, joint_accel):
    """(basePose, baseVelocity, baseAcceleration), world-frame, with the
    angular parts as true angular velocity and acceleration
    (CentroidalModelRbdConversions::computeBaseKinematicsFromCentroidalModel,
    used by the WBC's base-accel PD task, WbcBase.cpp:254-259)."""
    q = get_generalized_coordinates(x)
    v = generalized_velocity_from_state_input(model, info, x, u)
    base_pose = q[..., 0:6]
    euler, euler_rates = q[..., 3:6], v[..., 3:6]
    omega_w = global_angular_velocity_from_zyx_rates(euler, euler_rates)
    base_velocity = torch.cat([v[..., 0:3], omega_w], dim=-1)

    # differentiate h = A v: A_b vdot_b = m hdot_norm - Adot v - A_j vdot_j
    A = centroidal_momentum_matrix_info(model, info, q)
    Adot = torch.func.jvp(lambda qq: centroidal_momentum_matrix_info(model, info, qq), (q,), (v,))[1]
    h_dot = info.robot_mass * normalized_momentum_rate(model, info, x, u)
    rhs = h_dot - mv(Adot, v) - mv(A[..., 6:], joint_accel)
    # solve_ex: solve without the error check that reads a value to the host
    vdot_b = torch.linalg.solve_ex(A[..., :6], rhs[..., None])[0][..., 0]
    # omega = E(theta) theta_dot  =>  omega_dot = E theta_ddot + Edot theta_dot
    Edot = torch.func.jvp(euler_rate_map_zyx, (euler,), (euler_rates,))[1]
    omega_dot = mv(euler_rate_map_zyx(euler), vdot_b[..., 3:6]) + mv(Edot, euler_rates)
    base_acceleration = torch.cat([vdot_b[..., 0:3], omega_dot], dim=-1)
    return base_pose, base_velocity, base_acceleration


def contact_positions(model: RobotModel, info: CentroidalModelInfo, q):
    """(..., nc, 3) world positions of the contact frames."""
    kin = forward_kinematics(model, q)
    return torch.stack([frame_position(model, kin, fid) for fid in info.contact_frame_ids], dim=-2)


def contact_rotations(model: RobotModel, info: CentroidalModelInfo, q):
    """(..., nc, 3, 3) world rotations of the contact frames."""
    kin = forward_kinematics(model, q)
    return torch.stack([frame_transform(model, kin, fid)[0] for fid in info.contact_frame_ids], dim=-3)

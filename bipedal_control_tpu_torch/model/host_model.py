"""Pure-numpy host mirror of the observation kinematics for the RT tick
(model/host_model.py counterpart, a copy).

The 400-500 Hz control tick dispatches nothing to the card: the reference's
tick runs this math in C++/Eigen on the host
(CentroidalModelRbdConversions::computeCentroidalStateFromRbdModel, consumed
at BipedalController.cpp:402), and so does this package (numpy here, the C++
of native/host_model.cc through model/native_model.py).

:func:`make_host_model` reads the model's tensors to the host once; no
function of the tick path touches a tensor after that.  It mirrors
model/kinematics.py (FK) and model/centroidal.py (CMM, rbd conversions);
tests/test_torch_host_wbc.py holds it against the JAX package's twin.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .urdf import JOINT_PRISMATIC, JOINT_REVOLUTE


# ---------------------------------------------------------------- rotations
def rotmat_from_zyx_np(theta):
    """theta = [z, y, x] yaw-pitch-roll; R = Rz Ry Rx."""
    cz, sz = np.cos(theta[0]), np.sin(theta[0])
    cy, sy = np.cos(theta[1]), np.sin(theta[1])
    cx, sx = np.cos(theta[2]), np.sin(theta[2])
    Rz = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    Ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, cx, -sx], [0.0, sx, cx]])
    return Rz @ Ry @ Rx


def euler_rate_map_zyx_np(theta):
    """omega_world = E(theta) @ theta_dot for zyx rates."""
    z, y = theta[0], theta[1]
    cz, sz, cy, sy = np.cos(z), np.sin(z), np.cos(y), np.sin(y)
    return np.array(
        [
            [0.0, -sz, cz * cy],
            [0.0, cz, sz * cy],
            [1.0, 0.0, -sy],
        ]
    )


def zyx_rates_from_global_angular_velocity_np(theta, omega_world):
    return np.linalg.solve(euler_rate_map_zyx_np(theta), np.asarray(omega_world))


def skew_np(v):
    return np.array(
        [[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]]
    )


def quat_wxyz_to_rotmat_np(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def zyx_from_rotmat_np(R):
    yaw = np.arctan2(R[1, 0], R[0, 0])
    pitch = np.arctan2(-R[2, 0], np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2))
    roll = np.arctan2(R[2, 1], R[2, 2])
    return np.array([yaw, pitch, roll])


def zyx_from_quat_wxyz_np(q):
    return zyx_from_rotmat_np(quat_wxyz_to_rotmat_np(q))


def unwrap_near_np(angle, reference_angle):
    """Shift by 2*pi multiples to land nearest the reference (yaw unwrap)."""
    return reference_angle + (np.mod(angle - reference_angle + np.pi, 2 * np.pi) - np.pi)


# ---------------------------------------------------------------- model view
@dataclasses.dataclass(frozen=True)
class HostModel:
    """Numpy copy of the RobotModel arrays the tick path needs."""

    nj: int
    nb: int
    model_type: int
    nx: int
    robot_mass: float
    joint_parent_body: np.ndarray
    joint_type: tuple
    joint_axis: np.ndarray
    joint_offset_R: np.ndarray
    joint_offset_p: np.ndarray
    body_mass: np.ndarray
    body_com: np.ndarray
    body_inertia: np.ndarray
    total_mass: float
    ancestor_mask: np.ndarray  # (nb, nj) float
    revolute: np.ndarray  # (nj,) float 1/0
    q_j_nominal: np.ndarray  # (nj,) SRBD momentum configuration (empty for full)
    joint_K: np.ndarray  # (nj,3,3) precomputed axis skews (revolute axes)
    joint_K2: np.ndarray  # (nj,3,3) K @ K
    # frame data (host WBC needs contact + base frames)
    frame_body: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))
    frame_R: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3, 3)))
    frame_p: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3)))
    contact_frame_ids: tuple = ()
    base_frame_id: int = 0


def make_host_model(model, info) -> HostModel:
    """The numpy HostModel of a RobotModel and its CentroidalModelInfo: the
    model's tensors come to the host once, in float64 (the total mass is
    summed in float64 also for a float32 model)."""
    a = lambda x: x.detach().cpu().numpy().astype(np.float64)
    axes = a(model.joint_axis)
    K = np.stack([skew_np(ax) for ax in axes])
    return HostModel(
        nj=int(model.nj),
        nb=int(model.nj) + 1,
        model_type=int(info.model_type),
        nx=int(info.state_dim),
        robot_mass=float(info.robot_mass),
        joint_parent_body=np.asarray(model.joint_parent_body, dtype=np.int64),
        joint_type=tuple(int(t) for t in model.joint_type),
        joint_axis=axes,
        joint_offset_R=a(model.joint_offset_R),
        joint_offset_p=a(model.joint_offset_p),
        body_mass=a(model.body_mass),
        body_com=a(model.body_com),
        body_inertia=a(model.body_inertia),
        total_mass=float(model.body_mass.detach().cpu().double().sum()),
        ancestor_mask=model.ancestor_mask().astype(np.float64),
        revolute=np.asarray(
            [1.0 if t == JOINT_REVOLUTE else 0.0 for t in model.joint_type]
        ),
        q_j_nominal=np.asarray(info.q_j_nominal, dtype=np.float64),
        joint_K=K,
        joint_K2=np.matmul(K, K),
        frame_body=np.asarray(model.frame_body, dtype=np.int64),
        frame_R=a(model.frame_R),
        frame_p=a(model.frame_p),
        contact_frame_ids=tuple(int(i) for i in info.contact_frame_ids),
        base_frame_id=int(model.frame_index(model.frame_names[0])),
    )


# ---------------------------------------------------------------- kinematics
def forward_kinematics_np(hm: HostModel, q):
    """(R (nb,3,3), p (nb,3)) world body placements — kinematics.py twin."""
    R = np.empty((hm.nb, 3, 3))
    p = np.empty((hm.nb, 3))
    R[0] = rotmat_from_zyx_np(q[3:6])
    p[0] = q[0:3]
    qj = q[6:]
    sin_q, cos_q = np.sin(qj), np.cos(qj)
    # per-joint motion rotations in one vectorized shot (revolute Rodrigues
    # from precomputed K, K^2); prismatic entries are identity here
    R_m_all = (
        np.eye(3)[None]
        + sin_q[:, None, None] * hm.joint_K
        + (1.0 - cos_q)[:, None, None] * hm.joint_K2
    )
    for j in range(hm.nj):
        parent = hm.joint_parent_body[j]
        Rp = R[parent]
        R_joint = Rp @ hm.joint_offset_R[j]
        p_joint = p[parent] + Rp @ hm.joint_offset_p[j]
        if hm.joint_type[j] == JOINT_REVOLUTE:
            R[j + 1] = R_joint @ R_m_all[j]
            p[j + 1] = p_joint
        elif hm.joint_type[j] == JOINT_PRISMATIC:
            R[j + 1] = R_joint
            p[j + 1] = p_joint + R_joint @ (hm.joint_axis[j] * qj[j])
        else:
            raise ValueError(f"bad joint type {hm.joint_type[j]}")
    return R, p


def centroidal_momentum_matrix_np(hm: HostModel, q):
    """A(q): (6, nv) — centroidal.py::centroidal_momentum_matrix twin."""
    R, p = forward_kinematics_np(hm, q)
    coms = p + (R @ hm.body_com[:, :, None])[:, :, 0]
    com = (hm.body_mass[:, None] * coms).sum(0) / hm.total_mass
    nv = 6 + hm.nj

    # stacked point jacobians at each body com
    axes = (R[1:] @ hm.joint_axis[:, :, None])[:, :, 0]  # (nj,3) world axes
    anchors = p[1:]
    E = euler_rate_map_zyx_np(q[3:6])
    rel_j = coms[:, None, :] - anchors[None, :, :]  # (nb, nj, 3)
    jv_rev = np.cross(axes[None, :, :], rel_j)
    jv_joint = (
        hm.revolute[None, :, None] * jv_rev
        + (1.0 - hm.revolute)[None, :, None] * axes[None, :, :]
    ) * hm.ancestor_mask[:, :, None]
    jw_joint = (hm.revolute[:, None] * axes)[None, :, :] * hm.ancestor_mask[:, :, None]

    nb = hm.nb
    r = coms - p[0]
    jv_base_e = np.cross(E.T[None, :, :], r[:, None, :])  # (nb, 3cols, 3)
    Jv = np.concatenate(
        [
            np.broadcast_to(np.eye(3), (nb, 3, 3)),
            jv_base_e.transpose(0, 2, 1),
            jv_joint.transpose(0, 2, 1),
        ],
        axis=2,
    )  # (nb, 3, nv)
    Jw = np.concatenate(
        [
            np.zeros((nb, 3, 3)),
            np.broadcast_to(E, (nb, 3, 3)),
            jw_joint.transpose(0, 2, 1),
        ],
        axis=2,
    )

    # world-frame inertia per body: R I R^T
    I_w = R @ hm.body_inertia @ R.transpose(0, 2, 1)
    A_lin = (hm.body_mass[:, None, None] * Jv).sum(0)
    rel = coms - com
    cross_term = np.cross(rel[:, None, :], Jv.transpose(0, 2, 1)).transpose(0, 2, 1)
    A_ang = (I_w @ Jw).sum(0) + (hm.body_mass[:, None, None] * cross_term).sum(0)
    A = np.concatenate([A_lin, A_ang], axis=0)
    if hm.model_type == 1:  # SRBD: no joint momentum columns
        A[:, 6:] = 0.0
    return A


# ---------------------------------------------------------------- conversions
def generalized_from_rbd_np(nj: int, rbd):
    ngen = 6 + nj
    euler = rbd[0:3]
    q = np.concatenate([rbd[3:6], euler, rbd[6 : 6 + nj]])
    euler_rates = zyx_rates_from_global_angular_velocity_np(euler, rbd[ngen : ngen + 3])
    v = np.concatenate([rbd[ngen + 3 : ngen + 6], euler_rates, rbd[ngen + 6 :]])
    return q, v


def centroidal_state_from_rbd_np(hm: HostModel, rbd):
    """rbdState -> centroidal state x, pure numpy (tick fast path)."""
    rbd = np.asarray(rbd, dtype=np.float64)
    q, v = generalized_from_rbd_np(hm.nj, rbd)
    # SRBD evaluates momentum at the locked nominal joint pose
    # (momentum_coordinates) with zeroed joint columns — matching the JAX path
    q_mom = q if hm.model_type == 0 else np.concatenate([q[:6], hm.q_j_nominal])
    A = centroidal_momentum_matrix_np(hm, q_mom)
    h_norm = (A @ v) / hm.robot_mass
    return np.concatenate([h_norm, q])

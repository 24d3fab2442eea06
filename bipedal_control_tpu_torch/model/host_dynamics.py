"""Pure-numpy host dynamics for the real-time WBC tick
(model/host_dynamics.py counterpart, a copy).

The reference closes its 400-500 Hz torque QP on the host CPU
(bipedal_wbc/src/WeightedWbc.cpp:53-81 via qpOASES, driven from the 2.5 ms
tick configured at task.info:178); the model quantities it consumes come
from Pinocchio's host-side C++ (crba / nonLinearEffects / frame Jacobians
and their time variations, WbcBase.cpp:79-133).  The tick path here must
likewise never dispatch to the accelerator (model/host_model.py docstring),
so this module provides numpy twins of:

- ``mass_matrix_np`` / ``nonlinear_effects_np``  (model/dynamics.py)
- ``frame_jacobians_np`` (+ time variations)      (model/kinematics.py)
- ``centroidal_momentum_matrix_and_dot_np`` and the desired-side
  conversions (model/centroidal.py)

Where the JAX side leans on autodiff (``jax.jvp`` for every time
derivative), this side carries the analytic derivative: body angular
velocities propagate down the tree, giving world-axis rates
``a_dot = omega x a``, anchor-point velocities, and the Euler-rate-map rate
``E_dot`` — from which every Jacobian time variation follows in closed
form.  The nonlinear effects use the projected Newton-Euler identity
(exactly the Lagrangian nle for any coordinates with world velocity linear
in v):

    nle = sum_b [ Jv_b^T m_b (dJv_b v) + Jw_b^T (I_w (dJw_b v) + w x I_w w) ]
          + g * sum_b m_b Jv_b[2, :]

Performance notes (this path ticks at 400-500 Hz on a 2-core host):
kinematics is split into a positions-only pass (enough for Jacobians and
the CMM) and a velocity pass (needed only where a time derivative is);
``cross_np`` replaces ``np.cross`` (whose moveaxis plumbing dominates at
these sizes); contractions are flat matmuls, not einsum.

tests/test_torch_host_wbc.py holds every function against the JAX package's
twin in f64.  Keep the two in sync.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .host_model import (
    HostModel,
    euler_rate_map_zyx_np,
    forward_kinematics_np,
)
GRAVITY = 9.81
GRAVITY_VECTOR = np.array([0.0, 0.0, -GRAVITY])


def cross_np(a, b):
    """Fast (...,3) x (...,3) cross product (np.cross's axis plumbing costs
    more than the arithmetic at these sizes)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    c0 = a1 * b2 - a2 * b1
    out = np.empty(c0.shape + (3,))
    out[..., 0] = c0
    out[..., 1] = a2 * b0 - a0 * b2
    out[..., 2] = a0 * b1 - a1 * b0
    return out


def skew_stack_np(v):
    """(n,3) -> (n,3,3) stacked skew matrices."""
    n = v.shape[0]
    S = np.zeros((n, 3, 3))
    S[:, 0, 1] = -v[:, 2]
    S[:, 0, 2] = v[:, 1]
    S[:, 1, 0] = v[:, 2]
    S[:, 1, 2] = -v[:, 0]
    S[:, 2, 0] = -v[:, 1]
    S[:, 2, 1] = v[:, 0]
    return S


# ---------------------------------------------------------------- rotations
def euler_rate_map_dot_np(theta, theta_dot):
    """d/dt E(theta) along theta_dot (analytic; JAX side uses jvp)."""
    z, y = theta[0], theta[1]
    cz, sz, cy, sy = np.cos(z), np.sin(z), np.cos(y), np.sin(y)
    dz, dy = theta_dot[0], theta_dot[1]
    dE_dz = np.array([[0.0, -cz, -cy * sz], [0.0, -sz, cy * cz], [0.0, 0.0, 0.0]])
    dE_dy = np.array([[0.0, 0.0, -sy * cz], [0.0, 0.0, -sy * sz], [0.0, 0.0, -cy]])
    return dE_dz * dz + dE_dy * dy


def rotation_matrix_to_rotation_vector_np(R):
    """Matrix log of SO(3) (utils/rotations.py twin, same Taylor guard)."""
    trace = R[0, 0] + R[1, 1] + R[2, 2]
    cos_angle = np.clip(0.5 * (trace - 1.0), -1.0, 1.0)
    angle = np.arccos(cos_angle)
    axis_raw = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if angle < 1e-6:
        factor = 0.5 * (1.0 + angle * angle / 6.0)
    else:
        factor = 0.5 * angle / np.sin(angle)
    return factor * axis_raw


def rotation_error_in_world_np(R_desired, R_measured):
    return rotation_matrix_to_rotation_vector_np(R_desired @ R_measured.T)


# ---------------------------------------------------------------- kinematic passes
class PosKin(NamedTuple):
    """Positions-only pass: enough for Jacobians and the CMM."""

    R: np.ndarray  # (nb,3,3)
    p: np.ndarray  # (nb,3)
    E: np.ndarray  # (3,3)
    axes: np.ndarray  # (nj,3) world joint axes


class HostKin(NamedTuple):
    """Positions + body twist fields: everything a time derivative needs."""

    R: np.ndarray
    p: np.ndarray
    E: np.ndarray
    E_dot: np.ndarray
    axes: np.ndarray
    axes_dot: np.ndarray
    v_origin: np.ndarray  # (nb,3)
    omega: np.ndarray  # (nb,3)


def pos_pass_np(hm: HostModel, q) -> PosKin:
    R, p = forward_kinematics_np(hm, q)
    E = euler_rate_map_zyx_np(q[3:6])
    axes = (R[1:] @ hm.joint_axis[:, :, None])[:, :, 0]
    return PosKin(R=R, p=p, E=E, axes=axes)


def vel_pass_np(hm: HostModel, pos: PosKin, q, v) -> HostKin:
    """Body twist fields on top of a positions pass.

    Closed form instead of a per-joint recursion (the python loop costs more
    than the arithmetic): with w_j = rev_j qd_j a_j,

        omega_b = omega_0 + mask[b] @ w
        v_o[b]  = v_base + omega_0 x (p_b - p_0)
                  + (mask[b] @ w) x p_b - mask[b] @ (w x p_joint)
                  + mask[b] @ ((1 - rev) qd a)          (prismatic rates)

    which is exactly J_origin(b) @ v expanded column-wise.
    """
    theta_dot = v[3:6]
    E_dot = euler_rate_map_dot_np(q[3:6], theta_dot)
    qd = v[6:]
    p, axes, mask = pos.p, pos.axes, hm.ancestor_mask
    omega0 = pos.E @ theta_dot
    w = (hm.revolute * qd)[:, None] * axes  # (nj,3)
    W = mask @ w  # (nb,3) summed revolute rate vectors per body
    omega = omega0 + W
    v_o = (
        v[0:3]
        + cross_np(omega0, p - p[0])
        + cross_np(W, p)
        - mask @ cross_np(w, p[1:])
        + mask @ (((1.0 - hm.revolute) * qd)[:, None] * axes)
    )
    # world-axis rates: the axis is fixed in body j+1 (revolute) / its parent
    # (prismatic, where omega[j+1] == omega[parent]) -> a_dot = omega x a
    axes_dot = cross_np(omega[1:], axes)
    return HostKin(R=pos.R, p=pos.p, E=pos.E, E_dot=E_dot, axes=axes,
                   axes_dot=axes_dot, v_origin=v_o, omega=omega)


def host_kinematics_np(hm: HostModel, q, v) -> HostKin:
    return vel_pass_np(hm, pos_pass_np(hm, q), q, v)


def point_velocities_np(kin: HostKin, body_idx, points):
    """(m,3) world velocity of points rigidly attached to bodies body_idx."""
    return kin.v_origin[body_idx] + cross_np(
        kin.omega[body_idx], points - kin.p[body_idx]
    )


# ---------------------------------------------------------------- Jacobians
def stacked_point_jacobians_np(hm: HostModel, kin, points, mask):
    """(m,6,nv) world-aligned Jacobians (kinematics.py twin; mask (m,nj));
    ``kin`` may be a PosKin or HostKin."""
    m = points.shape[0]
    nv = 6 + hm.nj
    rel = points[:, None, :] - kin.p[None, 1:, :]  # (m,nj,3)
    jv_rev = cross_np(kin.axes[None, :, :], rel)
    jv_joint = (
        hm.revolute[None, :, None] * jv_rev
        + (1.0 - hm.revolute)[None, :, None] * kin.axes[None, :, :]
    ) * mask[:, :, None]
    jw_joint = (hm.revolute[:, None] * kin.axes)[None, :, :] * mask[:, :, None]

    r = points - kin.p[0]
    jv_base_e = cross_np(kin.E.T[None, :, :], r[:, None, :])  # (m,3cols,3)
    J = np.zeros((m, 6, nv))
    J[:, :3, :3] = np.eye(3)
    J[:, :3, 3:6] = jv_base_e.transpose(0, 2, 1)
    J[:, :3, 6:] = jv_joint.transpose(0, 2, 1)
    J[:, 3:, 3:6] = kin.E
    J[:, 3:, 6:] = jw_joint.transpose(0, 2, 1)
    return J


def stacked_point_jacobians_dot_np(hm: HostModel, kin: HostKin, points, v_points, mask):
    """(m,6,nv) exact d/dt of :func:`stacked_point_jacobians_np` along (q,v).

    Column rates: base translation 0; base Euler col c of Jv is
    Edot[:,c] x r + E[:,c] x rdot; revolute joint col j of Jv is
    adot_j x (p - anchor_j) + a_j x (vp - v_anchor_j); Jw Euler cols are
    Edot, revolute joint cols adot_j.  All masked like the Jacobian itself.
    """
    m = points.shape[0]
    nv = 6 + hm.nj
    rel = points[:, None, :] - kin.p[None, 1:, :]  # (m,nj,3)
    rel_dot = v_points[:, None, :] - kin.v_origin[None, 1:, :]
    djv_rev = cross_np(kin.axes_dot[None, :, :], rel) + cross_np(
        kin.axes[None, :, :], rel_dot
    )
    djv_joint = (
        hm.revolute[None, :, None] * djv_rev
        + (1.0 - hm.revolute)[None, :, None] * kin.axes_dot[None, :, :]
    ) * mask[:, :, None]
    djw_joint = (hm.revolute[:, None] * kin.axes_dot)[None, :, :] * mask[:, :, None]

    r = points - kin.p[0]
    r_dot = v_points - kin.v_origin[0]
    djv_base_e = cross_np(kin.E_dot.T[None, :, :], r[:, None, :]) + cross_np(
        kin.E.T[None, :, :], r_dot[:, None, :]
    )
    dJ = np.zeros((m, 6, nv))
    dJ[:, :3, 3:6] = djv_base_e.transpose(0, 2, 1)
    dJ[:, :3, 6:] = djv_joint.transpose(0, 2, 1)
    dJ[:, 3:, 3:6] = kin.E_dot
    dJ[:, 3:, 6:] = djw_joint.transpose(0, 2, 1)
    return dJ


def frame_points_np(hm: HostModel, kin_R, kin_p, frame_ids):
    """(m,3) world positions of the given frames."""
    b = np.asarray([hm.frame_body[f] for f in frame_ids])
    offR = np.stack([hm.frame_p[f] for f in frame_ids])
    return kin_p[b] + (kin_R[b] @ offR[:, :, None])[:, :, 0]


def frame_jacobians_pos_np(hm: HostModel, pos, frame_ids):
    """((m,6,nv) J, (m,3) p) for the given frames from a positions pass."""
    b = np.asarray([hm.frame_body[f] for f in frame_ids])
    pts = frame_points_np(hm, pos.R, pos.p, frame_ids)
    J = stacked_point_jacobians_np(hm, pos, pts, hm.ancestor_mask[b])
    return J, pts


def frame_jacobians_np(hm: HostModel, kin: HostKin, frame_ids):
    """((m,6,nv) J, (m,6,nv) Jdot, (m,3) p, (m,3) v) for the given frames."""
    b = np.asarray([hm.frame_body[f] for f in frame_ids])
    pts = frame_points_np(hm, kin.R, kin.p, frame_ids)
    vpts = point_velocities_np(kin, b, pts)
    mask = hm.ancestor_mask[b]
    J = stacked_point_jacobians_np(hm, kin, pts, mask)
    dJ = stacked_point_jacobians_dot_np(hm, kin, pts, vpts, mask)
    return J, dJ, pts, vpts


# ---------------------------------------------------------------- dynamics
def _body_com_jacobians_np(hm: HostModel, kin: HostKin):
    coms = kin.p + (kin.R @ hm.body_com[:, :, None])[:, :, 0]
    v_coms = point_velocities_np(kin, np.arange(hm.nb), coms)
    J = stacked_point_jacobians_np(hm, kin, coms, hm.ancestor_mask)
    dJ = stacked_point_jacobians_dot_np(hm, kin, coms, v_coms, hm.ancestor_mask)
    return coms, v_coms, J, dJ


def mass_matrix_np(hm: HostModel, q):
    """(nv,nv) joint-space inertia (dynamics.py::mass_matrix twin)."""
    kin = pos_pass_np(hm, q)
    coms = kin.p + (kin.R @ hm.body_com[:, :, None])[:, :, 0]
    J = stacked_point_jacobians_np(hm, kin, coms, hm.ancestor_mask)
    return _mass_from_jacobians(hm, kin.R, J)


def _mass_from_jacobians(hm: HostModel, R, J):
    nv = 6 + hm.nj
    Jv, Jw = J[:, :3, :], J[:, 3:, :]
    I_w = R @ hm.body_inertia @ R.transpose(0, 2, 1)
    mJv = hm.body_mass[:, None, None] * Jv
    M = Jv.reshape(-1, nv).T @ mJv.reshape(-1, nv)
    IJw = I_w @ Jw
    M += Jw.reshape(-1, nv).T @ IJw.reshape(-1, nv)
    return M


def mass_and_nle_np(hm: HostModel, q, v, kin: HostKin | None = None):
    """(M, nle) in one kinematics pass (the WBC needs both every tick)."""
    if kin is None:
        kin = host_kinematics_np(hm, q, v)
    nv = 6 + hm.nj
    coms, v_coms, J, dJ = _body_com_jacobians_np(hm, kin)
    Jv, Jw = J[:, :3, :], J[:, 3:, :]
    dJv, dJw = dJ[:, :3, :], dJ[:, 3:, :]
    I_w = kin.R @ hm.body_inertia @ kin.R.transpose(0, 2, 1)

    mJv = hm.body_mass[:, None, None] * Jv
    M = Jv.reshape(-1, nv).T @ mJv.reshape(-1, nv)
    IJw = I_w @ Jw
    M += Jw.reshape(-1, nv).T @ IJw.reshape(-1, nv)

    a_bias = dJv @ v  # (nb,3) com acceleration with vdot = 0
    wdot_bias = dJw @ v
    w = kin.omega
    gyro = (I_w @ wdot_bias[:, :, None])[:, :, 0] + cross_np(
        w, (I_w @ w[:, :, None])[:, :, 0]
    )
    nle = mJv.reshape(-1, nv).T @ a_bias.reshape(-1)
    nle += Jw.reshape(-1, nv).T @ gyro.reshape(-1)
    nle += GRAVITY * (hm.body_mass @ Jv[:, 2, :])
    return M, nle


def nonlinear_effects_np(hm: HostModel, q, v):
    return mass_and_nle_np(hm, q, v)[1]


# ---------------------------------------------------------------- CMM
def _cmm_from_pos(hm: HostModel, pos: PosKin):
    """A from a positions-only pass."""
    coms = pos.p + (pos.R @ hm.body_com[:, :, None])[:, :, 0]
    J = stacked_point_jacobians_np(hm, pos, coms, hm.ancestor_mask)
    Jv, Jw = J[:, :3, :], J[:, 3:, :]
    mass = hm.body_mass
    com = (mass[:, None] * coms).sum(0) / hm.total_mass
    I_w = pos.R @ hm.body_inertia @ pos.R.transpose(0, 2, 1)
    A_lin = (mass[:, None, None] * Jv).sum(0)
    Sx = skew_stack_np(coms - com)
    A_ang = (I_w @ Jw).sum(0) + (mass[:, None, None] * (Sx @ Jv)).sum(0)
    return np.concatenate([A_lin, A_ang])


def centroidal_momentum_matrix_np(hm: HostModel, q):
    return _cmm_from_pos(hm, pos_pass_np(hm, q))


def centroidal_momentum_matrix_and_dot_np(hm: HostModel, q, v, kin: HostKin | None = None):
    """(A, Adot): the CMM and its exact time derivative along (q, v)
    (centroidal.py::centroidal_momentum_matrix + jvp twin).  Pass the
    *momentum coordinates* for SRBD (joint columns zeroed by the caller)."""
    if kin is None:
        kin = host_kinematics_np(hm, q, v)
    coms, v_coms, J, dJ = _body_com_jacobians_np(hm, kin)
    Jv, Jw = J[:, :3, :], J[:, 3:, :]
    dJv, dJw = dJ[:, :3, :], dJ[:, 3:, :]
    mass = hm.body_mass
    com = (mass[:, None] * coms).sum(0) / hm.total_mass
    v_com = (mass[:, None] * v_coms).sum(0) / hm.total_mass

    I_w = kin.R @ hm.body_inertia @ kin.R.transpose(0, 2, 1)
    Wx = skew_stack_np(kin.omega)
    I_w_dot = Wx @ I_w - I_w @ Wx

    A_lin = (mass[:, None, None] * Jv).sum(0)
    dA_lin = (mass[:, None, None] * dJv).sum(0)

    Sx = skew_stack_np(coms - com)
    Sx_dot = skew_stack_np(v_coms - v_com)
    A_ang = (I_w @ Jw).sum(0) + (mass[:, None, None] * (Sx @ Jv)).sum(0)
    dA_ang = (
        (I_w_dot @ Jw).sum(0)
        + (I_w @ dJw).sum(0)
        + (mass[:, None, None] * (Sx_dot @ Jv + Sx @ dJv)).sum(0)
    )
    return np.concatenate([A_lin, A_ang]), np.concatenate([dA_lin, dA_ang])


def _momentum_coordinates_np(hm: HostModel, q):
    if hm.model_type == 1:
        return np.concatenate([q[:6], hm.q_j_nominal])
    return q


def cmm_info_np(hm: HostModel, q, pos: PosKin | None = None):
    """Model-type-aware A only (no derivative machinery).  ``pos`` may be a
    positions pass at q — reused only when the momentum coordinates are q
    itself (full model)."""
    if hm.model_type == 1:
        A = centroidal_momentum_matrix_np(hm, _momentum_coordinates_np(hm, q))
        A[:, 6:] = 0.0
        return A
    return _cmm_from_pos(hm, pos if pos is not None else pos_pass_np(hm, q))


def cmm_info_and_dot_np(hm: HostModel, q, v, kin: HostKin | None = None):
    """Model-type-aware (A, Adot): SRBD locks the joints at the nominal pose
    (so only the base part of v moves the CMM) and zeroes joint columns.
    ``kin`` may be a full pass at (q, v) — reused only for the full model."""
    if hm.model_type == 1:
        q_mom = _momentum_coordinates_np(hm, q)
        v_mom = np.concatenate([v[:6], np.zeros(hm.nj)])
        A, Adot = centroidal_momentum_matrix_and_dot_np(hm, q_mom, v_mom)
        A[:, 6:] = 0.0
        Adot[:, 6:] = 0.0
        return A, Adot
    return centroidal_momentum_matrix_and_dot_np(hm, q, v, kin=kin)


# ---------------------------------------------------------------- conversions
def generalized_velocity_from_state_input_np(hm: HostModel, x, u, pos: PosKin | None = None):
    """centroidal.py::generalized_velocity_from_state_input twin."""
    q = x[6:]
    h = hm.robot_mass * x[:6]
    v_j = u[12:]
    A = cmm_info_np(hm, q, pos=pos)
    v_b = np.linalg.solve(A[:, :6], h - A[:, 6:] @ v_j)
    return np.concatenate([v_b, v_j])


def normalized_momentum_rate_np(hm: HostModel, x, u, pos: PosKin | None = None):
    """centroidal.py::normalized_momentum_rate twin."""
    q = x[6:]
    if pos is None:
        pos = pos_pass_np(hm, q)
    R, p = pos.R, pos.p
    if hm.model_type == 0:
        R_m, p_m = R, p
    else:
        from .host_model import forward_kinematics_np as _fk

        R_m, p_m = _fk(hm, _momentum_coordinates_np(hm, q))
    coms = p_m + (R_m @ hm.body_com[:, :, None])[:, :, 0]
    com = (hm.body_mass[:, None] * coms).sum(0) / hm.total_mass
    forces = u[:12].reshape(4, 3)
    lin = GRAVITY_VECTOR + forces.sum(0) / hm.robot_mass
    p_c = frame_points_np(hm, R, p, hm.contact_frame_ids)
    ang = cross_np(p_c - com, forces).sum(0)
    return np.concatenate([lin, ang / hm.robot_mass])


def base_kinematics_from_centroidal_np(
    hm: HostModel, x, u, joint_accel=None, pos: PosKin | None = None, v=None,
    kin: HostKin | None = None,
):
    """centroidal.py::base_kinematics_from_centroidal twin.  ``pos``/``v``/
    ``kin`` may carry precomputed desired-side passes (the WBC computes them
    anyway)."""
    if joint_accel is None:
        joint_accel = np.zeros(hm.nj)
    q = x[6:]
    if pos is None:
        pos = pos_pass_np(hm, q)
    if v is None:
        v = generalized_velocity_from_state_input_np(hm, x, u, pos=pos)
    euler, euler_rates = q[3:6], v[3:6]
    E = pos.E
    omega_w = E @ euler_rates
    base_velocity = np.concatenate([v[0:3], omega_w])

    if kin is None and hm.model_type == 0:
        kin = vel_pass_np(hm, pos, q, v)
    A, Adot = cmm_info_and_dot_np(hm, q, v, kin=kin)
    h_dot = hm.robot_mass * normalized_momentum_rate_np(hm, x, u, pos=pos)
    rhs = h_dot - Adot @ v - A[:, 6:] @ joint_accel
    vdot_b = np.linalg.solve(A[:, :6], rhs)
    E_dot = euler_rate_map_dot_np(euler, euler_rates)
    omega_dot = E @ vdot_b[3:6] + E_dot @ euler_rates
    base_acceleration = np.concatenate([vdot_b[0:3], omega_dot])
    return q[0:6], base_velocity, base_acceleration


__all__ = [
    "PosKin",
    "HostKin",
    "cross_np",
    "pos_pass_np",
    "vel_pass_np",
    "host_kinematics_np",
    "stacked_point_jacobians_np",
    "stacked_point_jacobians_dot_np",
    "frame_jacobians_np",
    "frame_jacobians_pos_np",
    "mass_matrix_np",
    "mass_and_nle_np",
    "nonlinear_effects_np",
    "centroidal_momentum_matrix_and_dot_np",
    "cmm_info_np",
    "cmm_info_and_dot_np",
    "generalized_velocity_from_state_input_np",
    "normalized_momentum_rate_np",
    "base_kinematics_from_centroidal_np",
    "rotation_error_in_world_np",
    "euler_rate_map_dot_np",
]

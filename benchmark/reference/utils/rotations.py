"""Euler-ZYX rotation utilities (utils/rotations.py counterpart).

``theta = (yaw_z, pitch_y, roll_x)``; the base's generalized velocity is the
Euler-angle *rate*.  Every function takes any number of leading batch
dimensions, and none reads a value back to the host, so each can run inside
a CUDA graph.
"""
from __future__ import annotations

import math

import torch


def _matrix(rows):
    """(..., 3, 3) from a 3 x 3 nested list of (...) tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_x(a):
    c, s = torch.cos(a), torch.sin(a)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return _matrix([[one, zero, zero], [zero, c, -s], [zero, s, c]])


def rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return _matrix([[c, zero, s], [zero, one, zero], [-s, zero, c]])


def rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return _matrix([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def skew(v):
    """(..., 3) -> (..., 3, 3) with skew(a) @ b = a x b."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def rotmat_from_zyx(theta):
    """R = Rz(theta[0]) @ Ry(theta[1]) @ Rx(theta[2]), (..., 3) -> (..., 3, 3)."""
    cz, sz = torch.cos(theta[..., 0]), torch.sin(theta[..., 0])
    cy, sy = torch.cos(theta[..., 1]), torch.sin(theta[..., 1])
    cx, sx = torch.cos(theta[..., 2]), torch.sin(theta[..., 2])
    rows = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]
    return _matrix(rows)


def zyx_from_rotmat(R):
    """Inverse of :func:`rotmat_from_zyx` (pitch in (-pi/2, pi/2) branch)."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.atan2(-R[..., 2, 0], torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def euler_rate_map_zyx(theta):
    """E(theta) with omega_world = E(theta) @ theta_dot:
    columns [z_hat | Rz @ y_hat | Rz @ Ry @ x_hat]."""
    cz, sz = torch.cos(theta[..., 0]), torch.sin(theta[..., 0])
    cy, sy = torch.cos(theta[..., 1]), torch.sin(theta[..., 1])
    zero, one = torch.zeros_like(cz), torch.ones_like(cz)
    rows = [
        [zero, -sz, cy * cz],
        [zero, cz, cy * sz],
        [one, zero, -sy],
    ]
    return _matrix(rows)


def global_angular_velocity_from_zyx_rates(theta, theta_dot):
    """omega_world = E(theta) @ theta_dot, (..., 3) -> (..., 3)."""
    return (euler_rate_map_zyx(theta) @ theta_dot[..., None])[..., 0]


def zyx_rates_from_global_angular_velocity(theta, omega_world):
    """Inverse map; singular at pitch = +-pi/2 (gimbal lock), like the
    reference.  ``solve_ex`` is ``solve`` without its error check, which
    would read a value back to the host."""
    return torch.linalg.solve_ex(euler_rate_map_zyx(theta), omega_world[..., None])[0][..., 0]


def euler_rate_map_zyx_inv(theta):
    """Closed-form inverse of E(theta)."""
    cz, sz = torch.cos(theta[..., 0]), torch.sin(theta[..., 0])
    cy, sy = torch.cos(theta[..., 1]), torch.sin(theta[..., 1])
    ty = sy / cy
    zero, one = torch.zeros_like(cz), torch.ones_like(cz)
    return _matrix([[cz * ty, sz * ty, one], [-sz, cz, zero], [cz / cy, sz / cy, zero]])


def unskew(S):
    return torch.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], dim=-1)


def rotation_matrix_to_rotation_vector(R):
    """Matrix log of SO(3), Taylor-safe near the identity."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_angle = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    angle = torch.arccos(cos_angle)
    axis_raw = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1
    )
    small = angle < 1e-6
    factor = torch.where(
        small,
        0.5 * (1.0 + angle * angle / 6.0),
        0.5 * angle / torch.sin(torch.where(small, torch.ones_like(angle), angle)),
    )
    return factor[..., None] * axis_raw


def rotation_error_in_world(R_desired, R_measured):
    """World-frame orientation error of the WBC's base-accel PD task
    (reference: WbcBase.cpp:272-276)."""
    return rotation_matrix_to_rotation_vector(R_desired @ R_measured.transpose(-1, -2))


def wrap_to_pi(a):
    """The angle in [-pi, pi) (torch.remainder takes the divisor's sign, as
    jnp.mod does)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def unwrap_near(angle, reference_angle):
    """Shift ``angle`` by multiples of 2*pi to land nearest ``reference_angle``
    (yaw-unwrap semantics of BipedalController.cpp:400-403)."""
    return reference_angle + wrap_to_pi(angle - reference_angle)


def quat_wxyz_to_rotmat(q):
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _matrix(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def zyx_from_quat_wxyz(q):
    return zyx_from_rotmat(quat_wxyz_to_rotmat(q))


def rpy_to_rotmat(rpy):
    """URDF <origin rpy> fixed-axis XYZ convention: R = Rz(y) @ Ry(p) @ Rx(r)."""
    return rot_z(rpy[..., 2]) @ rot_y(rpy[..., 1]) @ rot_x(rpy[..., 0])

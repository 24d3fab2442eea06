"""Euler-ZYX rotation utilities (utils/rotations.py counterpart).

``theta = (yaw_z, pitch_y, roll_x)``; the base's generalized velocity is the
Euler-angle *rate*.  Every function takes any number of leading batch
dimensions.
"""
from __future__ import annotations

import torch


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
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


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
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def global_angular_velocity_from_zyx_rates(theta, theta_dot):
    """omega_world = E(theta) @ theta_dot, (..., 3) -> (..., 3)."""
    return (euler_rate_map_zyx(theta) @ theta_dot[..., None])[..., 0]


def zyx_rates_from_global_angular_velocity(theta, omega_world):
    """Inverse map; singular at pitch = +-pi/2 (gimbal lock), like the reference."""
    return torch.linalg.solve(euler_rate_map_zyx(theta), omega_world[..., None])[..., 0]

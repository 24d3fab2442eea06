"""Cheater (ground-truth) state estimate (estim/cheater.py counterpart, a copy).

Equivalent of FromTopicStateEstimate (bipedal_estimation/src/FromTopicEstimate.cpp):
assembles the rbdState vector from simulator ground truth
[euler_zyx, pos, q_j, omega_world, v_world, dq_j] — the layout consumed by the
WBC and the centroidal conversions (StateEstimateBase.cpp:35-64).

Pure numpy: the estimator feeds the 400-500 Hz RT tick, which launches
nothing on the card (model/host_model.py docstring).
"""
from __future__ import annotations

import numpy as np

from ..model.host_model import unwrap_near_np, zyx_from_quat_wxyz_np


def rbd_state_from_ground_truth(
    base_pos,  # (3,) world
    base_quat_wxyz,  # (4,)
    base_lin_vel_world,  # (3,)
    base_ang_vel_world,  # (3,)
    joint_pos,  # (nj,)
    joint_vel,  # (nj,)
    last_yaw=None,
):
    """Build rbdState; optionally unwraps yaw continuity against last_yaw."""
    euler = zyx_from_quat_wxyz_np(np.asarray(base_quat_wxyz))
    if last_yaw is not None:
        euler[0] = unwrap_near_np(euler[0], last_yaw)
    return np.concatenate(
        [
            euler,
            np.asarray(base_pos),
            np.asarray(joint_pos),
            np.asarray(base_ang_vel_world),
            np.asarray(base_lin_vel_world),
            np.asarray(joint_vel),
        ]
    )

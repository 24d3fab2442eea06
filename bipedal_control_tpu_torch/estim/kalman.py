"""Contact-aided linear Kalman filter for base state estimation
(estim/kalman.py counterpart).

The reference declares this estimator but ships an empty implementation
(bipedal_estimation KalmanFilterEstimate, LinearKalmanFilter.h:27-67 with a
0-byte .cpp); the JAX package's working version is ported here.

Standard legged-robot contact LKF (orientation taken from the IMU as known):

    state  z = [p_base(3), v_base(3), p_foot_i(3) * nc]       (3 + 3 + 3nc)
    predict: p += dt v + 0.5 dt^2 a_w,  v += dt a_w,  feet static
             a_w = R_wb a_imu + g
    update : per contact in stance, the leg-kinematics relative foot
             position (p_foot_i - p_base), the foot velocity
             (-J dq - omega x r) and a foot-height pseudo-measurement
             z_foot = terrain height.

Swing feet get their process and measurement noise inflated, so they
re-converge at touchdown.  The measurement matrix H does not depend on the
data: it is a cached constant.  Nothing reads a value back to the host
(the innovation solve is ``solve_ex``, whose error check is left out), so
the step runs inside a CUDA graph (estim/estimator.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..model.kinematics import forward_kinematics, frame_jacobians, frame_position
from ..ops.contract import mv
from ..utils.device import constant

NUM_CONTACTS = 4


@dataclasses.dataclass(frozen=True)
class KalmanConfig:
    dt: float = 0.0025
    sigma_accel: float = 0.5  # process accel noise
    sigma_foot_process: float = 1e-3  # stance foot random walk
    sigma_foot_swing: float = 1e2  # swing foot (decouples the measurement)
    sigma_kin_meas: float = 1e-3  # relative-position measurement noise
    sigma_vel_meas: float = 1e-2  # leg-odometry velocity measurement noise
    sigma_height_meas: float = 1e-3  # foot-height pseudo measurement
    terrain_height: float = 0.0


class KalmanState(NamedTuple):
    z: torch.Tensor  # (6 + 3nc,)
    P: torch.Tensor  # covariance


def _dim():
    return 6 + 3 * NUM_CONTACTS


def _measurement_matrix() -> np.ndarray:
    """(7 nc, n): per contact the rows of p_foot - p_base (3), v_base (3)
    and the foot's height (1)."""
    n = _dim()
    rows = []
    for i in range(NUM_CONTACTS):
        s = 6 + 3 * i
        H1 = np.zeros((3, n))
        H1[:, 0:3] = -np.eye(3)
        H1[:, s : s + 3] = np.eye(3)
        H2 = np.zeros((3, n))
        H2[:, 3:6] = np.eye(3)
        H3 = np.zeros((1, n))
        H3[0, s + 2] = 1.0
        rows += [H1, H2, H3]
    return np.concatenate(rows)


def kalman_init(p0, v0, foot_positions) -> KalmanState:
    z = torch.cat([p0, v0, foot_positions.reshape(-1)])
    return KalmanState(z=z, P=torch.eye(_dim(), dtype=z.dtype, device=z.device) * 1e-2)


def kalman_update(
    model,
    info,
    cfg: KalmanConfig,
    state: KalmanState,
    R_wb,  # (3,3) base orientation from IMU
    accel_imu,  # (3,) proper acceleration in IMU/base frame
    euler_zyx,  # (3,) base orientation (for kinematics)
    omega_world,  # (3,)
    joint_pos,  # (nj,)
    joint_vel,  # (nj,)
    contact_flags,  # (nc,) float 0/1
) -> KalmanState:
    n = _dim()
    dt = cfg.dt
    dtype, device = state.z.dtype, state.z.device
    a_w = mv(R_wb, accel_imu) + constant([0.0, 0.0, -9.81], dtype, device)

    # --- predict
    F = np.eye(n)
    F[0:3, 3:6] = dt * np.eye(3)
    F = constant(F, dtype, device)
    z = state.z
    z_pred = torch.cat([z[0:3] + (dt * z[3:6] + 0.5 * dt * dt * a_w), z[3:6] + dt * a_w, z[6:]])
    sig_feet = contact_flags * cfg.sigma_foot_process + (1 - contact_flags) * cfg.sigma_foot_swing  # (nc,)
    q_feet = ((dt * sig_feet) ** 2).repeat_interleave(3)
    q_base = constant([(0.5 * dt * dt * cfg.sigma_accel) ** 2] * 3 + [(dt * cfg.sigma_accel) ** 2] * 3, dtype, device)
    P_pred = F @ state.P @ F.T + torch.diag(torch.cat([q_base, q_feet]))

    # --- measurements: leg kinematics at the *estimated* base pose; the
    # relative foot position r_i(q_joints) in world axes (orientation known)
    q_kin = torch.cat([torch.zeros_like(euler_zyx), euler_zyx, joint_pos])
    kin = forward_kinematics(model, q_kin)
    J = frame_jacobians(model, q_kin, info.contact_frame_ids)  # (nc, 6, nv)
    y_rows, R_diag = [], []
    for i, fid in enumerate(info.contact_frame_ids):
        r_i = frame_position(model, kin, fid)  # base at origin -> relative position
        s = 6 + 3 * i
        f_i = contact_flags[i]
        # measurement 1: p_foot - p_base = r_i
        y1 = r_i - (z_pred[s : s + 3] - z_pred[0:3])
        sig1 = f_i * cfg.sigma_kin_meas + (1 - f_i) * 1e3
        # measurement 2: stance foot world velocity == 0 -> v_base = -(J_j dq + omega x r)
        v_rel = mv(J[i, :3, 6:], joint_vel) + torch.linalg.cross(omega_world, r_i)
        y2 = -v_rel - z_pred[3:6]
        sig2 = f_i * cfg.sigma_vel_meas + (1 - f_i) * 1e3
        # measurement 3: stance foot height == terrain
        y3 = cfg.terrain_height - z_pred[s + 2 : s + 3]
        sig3 = f_i * cfg.sigma_height_meas + (1 - f_i) * 1e3
        y_rows += [y1, y2, y3]
        R_diag += [(sig1**2).expand(3), (sig2**2).expand(3), (sig3**2).expand(1)]

    H = constant(_measurement_matrix(), dtype, device)
    y = torch.cat(y_rows)
    S = H @ P_pred @ H.T + torch.diag(torch.cat(R_diag))
    # solve_ex: the solve without its error check, which reads to the host
    K = torch.linalg.solve_ex(S, H @ P_pred)[0].T
    z_new = z_pred + mv(K, y)
    P_new = (torch.eye(n, dtype=dtype, device=device) - K @ H) @ P_pred
    return KalmanState(z=z_new, P=0.5 * (P_new + P_new.T))

"""Host-side state estimator producing the rbdState the controller consumes
(estim/estimator.py counterpart).

The reference's estimation layer (bipedal_estimation/) assembles rbdState
[euler_zyx, pos, q_j, omega_world, v_world, dq_j] (StateEstimateBase.cpp:35-64)
and declares a contact Kalman filter that it ships empty
(LinearKalmanFilter.h:27-67, 0-byte .cpp).  :class:`KalmanStateEstimator` is
the working version, wrapping the contact LKF of estim/kalman.py with the
sensor plumbing of the reference's MuJoCo HW (BipedalMujocoHW.cpp:116-204:
IMU quat/gyro/accelerometer and per-joint pos/vel):

- orientation comes from the IMU quaternion (the IMU rides the torso, which
  coincides with the floating base, as the reference's "base_imu" handle
  assumes);
- base position and velocity come from the LKF fusing IMU acceleration with
  stance-leg kinematics at the given contact flags (the controller passes
  the gait's planned flags, all-stance before the first policy).

The filter step runs on the model's device.  On the CPU it runs as plain
tensor code; on the card it is replayed from a CUDA graph (the counterpart
of the reference's ``jax.jit``), whose filter state lives in tensors the
graph reads and overwrites: one host-to-device copy of the sensors and one
device-to-host copy of the estimate per tick.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..model.centroidal import contact_positions
from ..utils.cuda_graph import HostCall
from ..utils.rotations import quat_wxyz_to_rotmat, zyx_from_quat_wxyz
from .kalman import KalmanConfig, KalmanState, kalman_init, kalman_update


class KalmanStateEstimator:
    """Contact-LKF estimator: sensors in, rbdState (numpy, float64) out."""

    def __init__(
        self,
        model,
        info,
        cfg: KalmanConfig | None = None,
        dt: float = 1.0 / 500.0,
        debounce_ticks: int = 0,
    ):
        self.model, self.info = model, info
        self.cfg = dataclasses.replace(cfg or KalmanConfig(), dt=dt)
        self.dtype, self.device = model.dtype, model.body_mass.device
        self.last_yaw = 0.0
        # Contact-flag debounce: hardware contact sensors chatter around
        # touch-down/lift-off (the reference's Gazebo HW reads raw booleans,
        # BipedalHWSim.cpp:239-263); a flag change must persist this many
        # consecutive ticks before the filter sees it.  0 = passthrough
        # (clean simulator flags).
        self.debounce_ticks = int(debounce_ticks)
        self._flag_state: np.ndarray | None = None
        self._flag_count = np.zeros(4, dtype=int)
        self._z: torch.Tensor | None = None  # the filter state, updated in place by each step
        self._P: torch.Tensor | None = None
        # the sensors of one tick: quat (4), gyro (3), accel (3), joint pos, joint vel, flags (4)
        self._call = HostCall(self._step, 14 + 2 * info.nj, self.dtype, self.device)

    @property
    def state(self) -> KalmanState | None:
        return None if self._z is None else KalmanState(z=self._z, P=self._P)

    def _step(self, sensors):
        """One filter step from the packed sensors; advances the filter state
        in place and returns [euler, omega_world, z[0:6]] (12,)."""
        nj = self.info.nj
        quat, gyro, accel = sensors[0:4], sensors[4:7], sensors[7:10]
        joint_pos, joint_vel, flags = sensors[10 : 10 + nj], sensors[10 + nj : 10 + 2 * nj], sensors[10 + 2 * nj :]
        R_wb = quat_wxyz_to_rotmat(quat)
        euler = zyx_from_quat_wxyz(quat)
        omega_world = R_wb @ gyro
        new = kalman_update(self.model, self.info, self.cfg, KalmanState(self._z, self._P), R_wb, accel, euler,
                            omega_world, joint_pos, joint_vel, flags)
        self._z.copy_(new.z)
        self._P.copy_(new.P)
        return torch.cat([euler, omega_world, new.z[0:6]])

    def reset(self, imu_quat_wxyz, joint_pos, base_pos_guess, base_vel_guess=None) -> None:
        """Initialize at a known or assumed base pose (bring-up hands over
        from the initial-pose controller's known configuration, so the guess
        is the task file's initial state).  Feet start at FK of that pose."""
        T = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype, device=self.device)
        euler = zyx_from_quat_wxyz(T(imu_quat_wxyz))
        p0 = T(base_pos_guess)
        v0 = torch.zeros_like(p0) if base_vel_guess is None else T(base_vel_guess)
        q = torch.cat([torch.zeros_like(p0), euler, T(joint_pos)])
        feet = p0 + contact_positions(self.model, self.info, q)
        init = kalman_init(p0, v0, feet)
        if self._z is None:
            self._z, self._P = init.z.clone(), init.P.clone()
        else:  # the graph reads these tensors: overwrite, never replace
            self._z.copy_(init.z)
            self._P.copy_(init.P)
        self.last_yaw = float(euler[0])

    def _debounce(self, flags) -> np.ndarray:
        """Hysteresis on measured contact flags (see __init__)."""
        f = np.asarray(flags, dtype=float) > 0.5
        if self.debounce_ticks <= 0:
            return f.astype(float)
        if self._flag_state is None:
            self._flag_state = f.copy()
            return f.astype(float)
        changed = f != self._flag_state
        self._flag_count = np.where(changed, self._flag_count + 1, 0)
        accept = self._flag_count >= self.debounce_ticks
        self._flag_state = np.where(accept, f, self._flag_state)
        self._flag_count = np.where(accept, 0, self._flag_count)
        return self._flag_state.astype(float)

    def update(
        self, imu_quat_wxyz, gyro_local, accel_local, joint_pos, joint_vel, contact_flags
    ) -> np.ndarray:
        """One filter step; returns rbdState (numpy, with yaw continuity)."""
        if self._z is None:
            raise RuntimeError("KalmanStateEstimator.reset must run before update")
        contact_flags = self._debounce(contact_flags)
        out = self._call(imu_quat_wxyz, gyro_local, accel_local, joint_pos, joint_vel, contact_flags)
        euler, omega_world, z = out[0:3].copy(), out[3:6], out[6:12]
        # yaw continuity: shift by 2*pi multiples to land nearest the last yaw
        euler[0] = self.last_yaw + (np.mod(euler[0] - self.last_yaw + np.pi, 2 * np.pi) - np.pi)
        self.last_yaw = float(euler[0])
        return np.concatenate(
            [euler, z[0:3], np.asarray(joint_pos, dtype=np.float64), omega_world, z[3:6],
             np.asarray(joint_vel, dtype=np.float64)]
        )

    @property
    def base_position(self) -> np.ndarray:
        return self._z[0:3].to(device="cpu", dtype=torch.float64).numpy()

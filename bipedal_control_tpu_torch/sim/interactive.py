"""Interactive sim controls: pause, slow-motion, pushes, sensor noise
(sim/interactive.py counterpart, a copy: numpy only).

The reference vendors MuJoCo's `simulate` GUI, whose control surface offers
pause/slowdown, perturbation and noise injection
(bipedal_mujoco/src/main.cc:355-365 wires ctrl-noise into the injected
controller).  The passive viewer used by `cli sim --view` natively provides
mouse perturbation (ctrl + right-drag applies wrenches); this module adds
the rest as a viewer-independent, testable state machine driven by key
callbacks:

    SPACE  pause / resume
    -      halve simulation speed (slow motion, up to 1/16x)
    =      double simulation speed back toward real time
    p      queue a lateral base push (alternating +y/-y impulse)
    n      toggle sensor-noise injection (IMU gyro/accel + joint encoders)

`cli sim --view` forwards GLFW key codes here and consults the state each
control tick.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_KEY_SPACE = 32
_MIN_SPEED = 1.0 / 16.0


@dataclasses.dataclass
class NoiseConfig:
    """1-sigma magnitudes, roughly hardware-grade IMU/encoder noise."""

    gyro: float = 0.05  # rad/s
    accel: float = 0.3  # m/s^2
    joint_pos: float = 1e-3  # rad
    joint_vel: float = 0.05  # rad/s


class SimInteraction:
    """Pause / speed / push / noise state machine (viewer-independent)."""

    def __init__(self, push_force: float = 120.0, push_duration: float = 0.15,
                 noise: NoiseConfig | None = None, seed: int = 0):
        self.paused = False
        self.speed = 1.0  # 1.0 = real time, 0.5 = half speed, ...
        self.noise_on = False
        self.noise_cfg = noise or NoiseConfig()
        self.push_force = push_force
        self.push_duration = push_duration
        self._push_until = None
        self._push_sign = 1.0
        self._push_queued = False
        self._rng = np.random.default_rng(seed)

    # ------------------------------------------------------------- keys
    def key_callback(self, keycode: int) -> None:
        ch = chr(keycode) if 0 <= keycode < 256 else ""
        if keycode == _KEY_SPACE:
            self.paused = not self.paused
        elif ch == "-":
            self.speed = max(_MIN_SPEED, self.speed * 0.5)
        elif ch in ("=", "+"):
            self.speed = min(1.0, self.speed * 2.0)
        elif ch in ("p", "P"):
            self._push_queued = True
        elif ch in ("n", "N"):
            self.noise_on = not self.noise_on

    # ------------------------------------------------------------- push
    def push_wrench(self, t: float):
        """(6,) world wrench to apply to the base this tick, or None.
        A queued push becomes a constant lateral force for push_duration
        seconds, alternating direction per press."""
        if self._push_queued:
            self._push_queued = False
            self._push_until = t + self.push_duration
            self._push_sign = -self._push_sign
        if self._push_until is not None and t < self._push_until:
            w = np.zeros(6)
            w[1] = self._push_sign * self.push_force
            return w
        if self._push_until is not None and t >= self._push_until:
            self._push_until = None
        return None

    # ------------------------------------------------------------ noise
    def corrupt_sensors(self, imu: dict, qj: np.ndarray, dqj: np.ndarray):
        """Additive Gaussian noise on gyro/accel/joint readouts when noise
        injection is on (quaternion left clean — orientation noise enters
        through the gyro when the estimator integrates)."""
        if not self.noise_on:
            return imu, qj, dqj
        n = self.noise_cfg
        imu = dict(imu)
        imu["imu_gyro"] = imu["imu_gyro"] + self._rng.normal(0, n.gyro, 3)
        imu["imu_acc"] = imu["imu_acc"] + self._rng.normal(0, n.accel, 3)
        qj = qj + self._rng.normal(0, n.joint_pos, qj.shape)
        dqj = dqj + self._rng.normal(0, n.joint_vel, dqj.shape)
        return imu, qj, dqj

    # ------------------------------------------------------------ pacing
    def sleep_factor(self) -> float:
        """Extra wall-time multiplier for slow motion: a control period of
        dt should occupy dt / speed wall seconds; the caller sleeps
        (factor - 1) * dt on top of its normal pacing."""
        return 1.0 / self.speed

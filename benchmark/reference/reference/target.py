"""Target trajectories and user-command conversions
(reference/target.py counterpart).

Replaces OCS2 ``TargetTrajectories`` + the reference's
TargetTrajectoriesPublisher conversions
(bipedal_controllers/src/TargetTrajectoriesPublisher.cpp:40-100): cmd_vel and
goal-pose commands become 2-waypoint base-pose reference trajectories at the
configured com height and default joint state.

Device-side, targets are fixed-length padded tensors with linear
interpolation + clamped extrapolation (TargetTrajectories::getDesiredState)
over a tensor of times.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.rotations import rotmat_from_zyx


class TargetTable(NamedTuple):
    """Padded reference trajectory for device-side interpolation.  The
    fields may carry a leading scenario axis B (one table per scenario: the
    batched closed loop retargets each scenario from its own observation)."""

    times: torch.Tensor  # ([B,] T) padded with +inf
    states: torch.Tensor  # ([B,] T, nx) padded by repeating the last row
    inputs: torch.Tensor  # ([B,] T, nu)

    def state_at(self, t):
        """(S..., nx) for a tensor of times (S...); (B, S..., nx) for a
        batched table, the times shared by its scenarios."""
        return _interp_rows(self.times, self.states, t)

    def input_at(self, t):
        return _interp_rows(self.times, self.inputs, t)


def _interp_rows(times, rows, t):
    """rows ([B,] T, w) on their times ([B,] T), interpolated at the times t
    (S...) (shared by the B tables): ([B,] S..., w).  The indices stay on
    the device (gathers)."""
    if times.dim() == 1:
        return _interp_rows(times[None], rows[None], t)[0]
    B, T, w = rows.shape
    tb = t.reshape(1, -1).expand(B, -1).contiguous()
    idx = torch.clamp(torch.searchsorted(times.contiguous(), tb, right=True), 1, T - 1)
    t0, t1 = torch.gather(times, 1, idx - 1), torch.gather(times, 1, idx)
    denom = torch.where(t1 > t0, t1 - t0, torch.ones_like(t1))
    alpha = torch.clamp((tb - t0) / denom, 0.0, 1.0)
    alpha = torch.where(torch.isfinite(t1), alpha, torch.zeros_like(alpha))[..., None]
    pick = lambda i: torch.gather(rows, 1, i[..., None].expand(i.shape + (w,)))
    out = pick(idx - 1) * (1.0 - alpha) + pick(idx) * alpha
    return out.reshape((B,) + t.shape + (w,))


@dataclasses.dataclass
class TargetTrajectories:
    """Host-side (mutable) reference trajectory."""

    times: np.ndarray  # (T,)
    states: np.ndarray  # (T, nx)
    inputs: np.ndarray  # (T, nu)

    def freeze(self, max_len: int, device=None, dtype=torch.float64) -> TargetTable:
        """The padded table on ``device`` (the card when None)."""
        device = resolve_device(device)
        return TargetTable(*(torch.as_tensor(a, dtype=dtype, device=device) for a in self.freeze_arrays(max_len)))

    def freeze_arrays(self, max_len: int):
        """(times (T,), states (T, nx), inputs (T, nu)) padded as numpy."""
        T = len(self.times)
        if T > max_len:
            # keep the most recent max_len waypoints
            times, states, inputs = (
                self.times[-max_len:],
                self.states[-max_len:],
                self.inputs[-max_len:],
            )
            T = max_len
        else:
            times, states, inputs = self.times, self.states, self.inputs
        tt = np.full(max_len, np.inf)
        tt[:T] = times
        ss = np.repeat(states[-1:], max_len, axis=0)
        ss[:T] = states
        uu = np.repeat(inputs[-1:], max_len, axis=0)
        uu[:T] = inputs
        return tt, ss, uu


@dataclasses.dataclass(frozen=True)
class CommandConfig:
    """reference.info knobs (h1_ocs2_config/config/command/reference.info:1-4)."""

    com_height: float
    default_joint_state: np.ndarray  # (nj,)
    target_displacement_velocity: float = 0.5
    target_rotation_velocity: float = 0.3
    target_reaching_duration: float = 1.0  # TIME_TO_TARGET for cmd_vel


def _target_pose_to_trajectories(
    target_pose: np.ndarray, observation_time: float, observation_state: np.ndarray,
    target_reaching_time: float, cfg: CommandConfig, input_dim: int,
) -> TargetTrajectories:
    """targetPoseToTargetTrajectories (TargetTrajectoriesPublisher.cpp:40-58)."""
    nx = len(observation_state)
    current_pose = observation_state[6:12].copy()
    current_pose[2] = cfg.com_height
    current_pose[4] = 0.0  # pitch
    current_pose[5] = 0.0  # roll
    s0 = np.zeros(nx)
    s0[0:6] = 0.0
    s0[6:12] = current_pose
    s0[12:] = cfg.default_joint_state
    s1 = np.zeros(nx)
    s1[6:12] = target_pose
    s1[12:] = cfg.default_joint_state
    return TargetTrajectories(
        times=np.array([observation_time, target_reaching_time]),
        states=np.stack([s0, s1]),
        inputs=np.zeros((2, input_dim)),
    )


def estimate_time_to_target(pose_delta: np.ndarray, cfg: CommandConfig) -> float:
    """Displacement/rotation limited duration (TargetTrajectoriesPublisher.h:94-103)."""
    dx, dy = pose_delta[0], pose_delta[1]
    dyaw = abs(pose_delta[3])
    displacement = np.hypot(dx, dy)
    rot_time = dyaw / cfg.target_rotation_velocity
    disp_time = displacement / cfg.target_displacement_velocity
    return max(rot_time, disp_time)


def goal_to_target_trajectories(
    goal_pose: np.ndarray, observation_time: float, observation_state: np.ndarray,
    cfg: CommandConfig, input_dim: int,
) -> TargetTrajectories:
    """'/move_base_simple/goal' semantics (goalToTargetTrajectories)."""
    current_pose = observation_state[6:12]
    target = np.array(
        [goal_pose[0], goal_pose[1], cfg.com_height, goal_pose[3], 0.0, 0.0]
    )
    reach = observation_time + estimate_time_to_target(target - current_pose, cfg)
    return _target_pose_to_trajectories(
        target, observation_time, observation_state, reach, cfg, input_dim
    )


def cmd_vel_to_target_trajectories(
    cmd_vel: np.ndarray, observation_time: float, observation_state: np.ndarray,
    cfg: CommandConfig, input_dim: int,
) -> TargetTrajectories:
    """'/cmd_vel' semantics (cmdVelToTargetTrajectories): rotate the commanded
    body-frame velocity to world, extrapolate the pose over the reaching
    duration, and pin the velocity reference into the momentum slots."""
    current_pose = np.asarray(observation_state[6:12])
    R = rotmat_from_zyx(torch.as_tensor(current_pose[3:6], dtype=torch.float64)).numpy()
    v_world = R @ np.asarray(cmd_vel[:3])
    dt = cfg.target_reaching_duration
    target = np.array(
        [
            current_pose[0] + v_world[0] * dt,
            current_pose[1] + v_world[1] * dt,
            cfg.com_height,
            current_pose[3] + cmd_vel[3] * dt,
            0.0,
            0.0,
        ]
    )
    traj = _target_pose_to_trajectories(
        target, observation_time, observation_state, observation_time + dt, cfg, input_dim
    )
    traj.states[0][0:3] = v_world
    traj.states[1][0:3] = v_world
    return traj


@dataclasses.dataclass
class CmdVelFollower:
    """Closed-loop /cmd_vel target publisher with velocity-integral trim.

    Per-observation retargeting (anchor the reference at the CURRENT
    observation every ``retarget_period``) is what stabilizes the lateral
    axis on short-footed robots (round-3 result: a fixed target integrates
    base-y error until the capture correction overshoots).  Its cost is that
    position error never accumulates, so the steady braking impulse of every
    touchdown shows up as a permanent forward-velocity deficit — G1 and
    OpenLoong measured ~40-60% of command.  This follower closes that loop
    with integral action on the VELOCITY error (not position, which would
    re-introduce the lateral runaway): the commanded forward speed is
    trimmed by ki * integral(cmd - v_meas) dt, clamped to
    ``trim_frac_max * |cmd|``, where v_meas is the measured body-frame
    forward velocity from the observation's normalized-momentum slots.

    Role: the closed-loop analogue of the reference's open-loop cmd_vel
    relay (TargetTrajectoriesPublisher.cpp:77-100 has no feedback; its robot
    undertracks the same way)."""

    cmd_vel: np.ndarray  # (4,) body-frame [vx, vy, vz, yaw_rate]
    cfg: CommandConfig
    input_dim: int
    ki: float = 1.2  # 1/s integral gain on the forward-velocity error
    trim_frac_max: float = 1.0  # |trim| <= trim_frac_max * |cmd_vx|
    retarget_period: float = 0.25
    # Heading hold: per-observation retargeting re-anchors the yaw reference
    # at the MEASURED yaw every cycle, so heading performs a random walk and
    # the world-frame path curves — measured on OpenLoong as yaw drifting to
    # -0.38 rad over 6 s, which IS the reported "lateral drift" (the robot
    # walks straight along its own wandering heading; dy/dt matches
    # v*sin(yaw) exactly).  k_yaw pulls the commanded yaw rate toward the
    # integrated heading reference yaw0 + cmd_yaw_rate * t.
    k_yaw: float = 0.0  # 1/s proportional heading-hold gain
    yaw_rate_max: float = 0.5  # rad/s clamp on the correction
    # engage the heading hold only after this settling time: it is a
    # steady-state corrector, and fighting the capture-stepping transient
    # of the first strides can tip a marginal robot (measured on OpenLoong:
    # immediate engagement falls at ~3.6 s from some spawns)
    yaw_hold_delay_s: float = 2.0

    # NOTE: trimming the LATERAL axis the same way was tried and rejected —
    # on OpenLoong the lateral dynamics carry a slow (~2 s) rocking mode,
    # and a velocity-integral trim chases it into a growing oscillation that
    # fells the robot at ~4.7 s (measured 2026-08-21, ki_lat 0.8).  Forward
    # trim is safe because the sagittal axis is stride-stabilized.

    def __post_init__(self):
        self.cmd_vel = np.asarray(self.cmd_vel, dtype=float)
        self._trim = 0.0
        self._last_t = None
        self._next_retarget = None
        self._yaw_ref = None

    @property
    def trim(self) -> float:
        return self._trim

    def update(self, t_obs: float, x_obs: np.ndarray):
        """Advance the trim integrator and, at the retarget cadence, return a
        fresh TargetTrajectories anchored at the observation (None between
        retargets).  Call once per control tick with the latest observation."""
        x_obs = np.asarray(x_obs)
        if self._last_t is not None and t_obs > self._last_t:
            dt = t_obs - self._last_t
            yaw = x_obs[9]
            v_fwd = np.cos(yaw) * x_obs[0] + np.sin(yaw) * x_obs[1]
            lim = self.trim_frac_max * abs(self.cmd_vel[0])
            self._trim = float(
                np.clip(self._trim + self.ki * (self.cmd_vel[0] - v_fwd) * dt, -lim, lim)
            )
        self._last_t = t_obs
        if self._next_retarget is None:
            self._next_retarget = t_obs
        if t_obs + 1e-9 < self._next_retarget:
            return None
        self._next_retarget += self.retarget_period
        if not hasattr(self, "_t_first"):
            self._t_first = t_obs
        cmd = self.cmd_vel.copy()
        cmd[0] += self._trim
        if self.k_yaw > 0.0 and t_obs - self._t_first >= self.yaw_hold_delay_s:
            if self._yaw_ref is None:
                self._yaw_ref = float(x_obs[9])
            else:
                self._yaw_ref += self.cmd_vel[3] * self.retarget_period
            err = (self._yaw_ref - float(x_obs[9]) + np.pi) % (2 * np.pi) - np.pi
            cmd[3] += float(np.clip(self.k_yaw * err, -self.yaw_rate_max, self.yaw_rate_max))
        return cmd_vel_to_target_trajectories(
            cmd, t_obs, x_obs, self.cfg, self.input_dim
        )


def stationary_target(
    observation_time: float,
    observation_state: np.ndarray,
    cfg: CommandConfig,
    input_dim: int,
    stop_duration: float = 0.7,
) -> TargetTrajectories:
    """Come to rest near the current pose: decelerate to zero velocity over
    ``stop_duration``, stopping at the constant-deceleration point
    (current + v * d/2) instead of demanding an instant stop at the current
    xy.  A robot walking at 0.4 m/s given an instant-stop reference sees a
    step velocity discontinuity the RTI must absorb in one replan — the
    measured failure mode of the walk -> stance switch-back at high replan
    cadence.  The decelerating reference keeps every replan's step inside
    the filter's g_max band."""
    x = np.asarray(observation_state)
    pose = x[6:12]
    v_world = x[0:3]  # normalized momentum ~ com velocity
    stop_xy = pose[0:2] + v_world[0:2] * (stop_duration / 2.0)
    target = np.array([stop_xy[0], stop_xy[1], cfg.com_height, pose[3], 0.0, 0.0])
    traj = _target_pose_to_trajectories(
        target, observation_time, x, observation_time + stop_duration, cfg, input_dim
    )
    # seed the current velocity into the first waypoint's momentum slots so
    # the interpolated reference decelerates instead of stepping to zero
    traj.states[0][0:3] = v_world
    return traj

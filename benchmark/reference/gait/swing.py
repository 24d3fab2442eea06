"""Swing foot z-trajectory planner (gait/swing.py counterpart).

The reference SwingTrajectoryPlanner / CubicSpline / SplineCpg
(ocs2_bipedal_robot/src/foot_planner/*.cpp) as a host-side numpy planner that
emits fixed-size per-(contact, phase) cubic-spline coefficient tables; the
table is tensors on an explicit device, queried with tensors of contacts,
phases and times that broadcast against each other.

Per swing phase (lift-off event -> touch-down event) each contact gets a pair
of cubic splines lift-off -> apex -> touch-down with:
  apex height  = min(liftOffHeight, touchDownHeight) + scaling * swingHeight
  node velocities scaled by  scaling = min(1, (t_f - t_0) / swingTimeScale)
(SwingTrajectoryPlanner.cpp:93-118, 226-233).  Stance phases hold constant
height.  Config fields mirror swing_trajectory_config in task.info:56-63.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device

from .mode_schedule import (
    NUM_CONTACTS,
    ModeSchedule,
    extract_contact_flags,
    swing_phase_bounds,
)


@dataclasses.dataclass(frozen=True)
class SwingConfig:
    lift_off_velocity: float = 0.05
    touch_down_velocity: float = 0.0
    swing_height: float = 0.05
    touchdown_after_horizon: float = 0.2  # parsed for parity; OCS2 planner ignores it too
    swing_time_scale: float = 0.15
    # apex = min(lo, td) + swingHeight is the reference formula
    # (SwingTrajectoryPlanner.cpp:107) — but it was only ever run with
    # lo == td == 0 (terrainHeight hardcoded 0).  Stepping UP a dh riser it
    # leaves swingHeight - dh of clearance over the upper surface, and the
    # swing toe strikes the riser edge on any foothold-prediction error
    # (measured: H1 tips at a 6 cm step's edge).  True terrain use wants
    # apex above the HIGHER surface; identical on flat ground.
    apex_over_max_height: bool = False


def _cubic_coeffs(t0, p0, v0, t1, p1, v1):
    """Coefficients of p(tn) = c3 tn^3 + c2 tn^2 + c1 tn + c0, tn=(t-t0)/dt
    (CubicSpline.cpp:38-56)."""
    dt = t1 - t0
    dp = p1 - p0
    dv = v1 - v0
    c0 = p0
    c1 = v0 * dt
    c2 = -(3.0 * v0 + dv) * dt + 3.0 * dp
    c3 = (2.0 * v0 + dv) * dt - 2.0 * dp
    return np.array([c0, c1, c2, c3, t0, dt])


class SwingTable(NamedTuple):
    """Device spline table: per contact, per phase, two cubic segments.

    coeffs: (4, P+1, 2, 6) — last dim [c0, c1, c2, c3, t_start, dt];
    mid_times: (4, P+1) segment switch time.
    Query with the phase index from the matching GaitTable; contact, phase
    and t broadcast against each other (contact may be an int).
    """

    coeffs: torch.Tensor
    mid_times: torch.Tensor

    def _coeffs(self, contact, phase, t):
        """(S..., 6) the segment's coefficients and (S...) tn."""
        use_right = (t >= self.mid_times[contact, phase]).long()
        c = self.coeffs[contact, phase, use_right]
        return c, (t - c[..., 4]) / c[..., 5]

    def z_position(self, contact, phase, t):
        c, tn = self._coeffs(contact, phase, t)
        return ((c[..., 3] * tn + c[..., 2]) * tn + c[..., 1]) * tn + c[..., 0]

    def z_velocity(self, contact, phase, t):
        c, tn = self._coeffs(contact, phase, t)
        return ((3.0 * c[..., 3] * tn + 2.0 * c[..., 2]) * tn + c[..., 1]) / c[..., 5]

    def z_position_velocity(self, contact, phase, t):
        """(z_position, z_velocity) from one lookup of the coefficients."""
        c, tn = self._coeffs(contact, phase, t)
        pos = ((c[..., 3] * tn + c[..., 2]) * tn + c[..., 1]) * tn + c[..., 0]
        vel = ((3.0 * c[..., 3] * tn + 2.0 * c[..., 2]) * tn + c[..., 1]) / c[..., 5]
        return pos, vel


def swing_trajectory_scaling(start_time, final_time, swing_time_scale):
    return min(1.0, (final_time - start_time) / swing_time_scale)


def plan_swing_table(
    config: SwingConfig,
    schedule: ModeSchedule,
    max_phases: int,
    terrain_height: float = 0.0,
    lift_off_heights: np.ndarray | None = None,
    touch_down_heights: np.ndarray | None = None,
    device=None,
    dtype=torch.float64,
) -> SwingTable:
    """The spline table of a frozen mode schedule on ``device`` (the card
    when None); :func:`swing_table_arrays` gives it as numpy.

    lift_off_heights / touch_down_heights: optional (4, num_phases) terrain
    heights (flat ``terrain_height`` when omitted, matching
    SwingTrajectoryPlanner::update(modeSchedule, terrainHeight)).
    """
    device = resolve_device(device)
    coeffs, mids = swing_table_arrays(
        config, schedule, max_phases, terrain_height, lift_off_heights, touch_down_heights
    )
    return SwingTable(
        coeffs=torch.as_tensor(coeffs, dtype=dtype, device=device),
        mid_times=torch.as_tensor(mids, dtype=dtype, device=device),
    )


def swing_table_arrays(
    config: SwingConfig,
    schedule: ModeSchedule,
    max_phases: int,
    terrain_height: float = 0.0,
    lift_off_heights: np.ndarray | None = None,
    touch_down_heights: np.ndarray | None = None,
):
    """(coeffs (4, P+1, 2, 6), mid_times (4, P+1)) as numpy."""
    ev = schedule.event_times
    num_phases = len(schedule.mode_sequence)
    flags = extract_contact_flags(schedule.mode_sequence)  # (num_phases, 4)
    if lift_off_heights is None:
        lift_off_heights = np.full((NUM_CONTACTS, num_phases), terrain_height)
    if touch_down_heights is None:
        touch_down_heights = np.full((NUM_CONTACTS, num_phases), terrain_height)

    coeffs = np.zeros((NUM_CONTACTS, max_phases + 1, 2, 6))
    mids = np.zeros((NUM_CONTACTS, max_phases + 1))
    for c in range(NUM_CONTACTS):
        bounds = swing_phase_bounds(flags[:, c])
        for p in range(num_phases):
            lo_h = lift_off_heights[c, p]
            td_h = touch_down_heights[c, p]
            if flags[p, c]:
                # stance: constant height (dummy 0->1 spline like the reference)
                coeffs[c, p, 0] = _cubic_coeffs(0.0, lo_h, 0.0, 0.5, lo_h, 0.0)
                coeffs[c, p, 1] = _cubic_coeffs(0.5, lo_h, 0.0, 1.0, lo_h, 0.0)
                mids[c, p] = 0.5
                continue
            start_idx, final_idx = bounds[p]
            if start_idx < 0:
                raise ValueError(
                    f"take-off time undefined for contact {c} in leading swing phase {p}"
                )
            if final_idx >= num_phases - 1:
                raise ValueError(
                    f"touch-down time undefined for contact {c} in trailing swing phase {p}"
                )
            t0, t1 = ev[start_idx], ev[final_idx]
            scaling = swing_trajectory_scaling(t0, t1, config.swing_time_scale)
            mid_t = 0.5 * (t0 + t1)
            base_h = max(lo_h, td_h) if config.apex_over_max_height else min(lo_h, td_h)
            apex = base_h + scaling * config.swing_height
            coeffs[c, p, 0] = _cubic_coeffs(
                t0, lo_h, scaling * config.lift_off_velocity, mid_t, apex, 0.0
            )
            coeffs[c, p, 1] = _cubic_coeffs(
                mid_t, apex, 0.0, t1, td_h, scaling * config.touch_down_velocity
            )
            mids[c, p] = mid_t
        # pad remaining phases with the last real phase (constant height)
        for p in range(num_phases, max_phases + 1):
            coeffs[c, p] = coeffs[c, num_phases - 1]
            mids[c, p] = mids[c, num_phases - 1]
    return coeffs, mids

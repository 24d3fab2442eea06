"""Switched-model reference manager (reference/manager.py counterpart).

Equivalent of the reference's SwitchedModelReferenceManager + GaitReceiver
solver-sync hooks (SwitchedModelReferenceManager.cpp:39-71,
GaitReceiver.cpp:40-68): before every solve it re-tiles the gait over
[t0 - T, tf + T], replans the swing splines, and freezes everything —
gait, swing splines, target trajectory, and the (event-snapped) node time
grid — into device tables consumed by the SQP.  The planning stays numpy on
the host; :meth:`ReferenceManager.freeze` moves every table to the manager's
device in one host-to-device copy of a packed buffer.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..gait.mode_schedule import (
    GaitSchedule,
    GaitTable,
    ModeSequenceTemplate,
    mode_schedule_arrays,
)
from ..gait.swing import SwingConfig, SwingTable, swing_table_arrays
from ..utils.device import resolve_device
from .target import TargetTable, TargetTrajectories


class FrozenReferences(NamedTuple):
    gait: GaitTable
    swing: SwingTable
    target: TargetTable
    t_nodes: torch.Tensor  # (N+1,) node grid on the device


def to_device_packed(arrays, device, dtype):
    """The numpy arrays as tensors of ``dtype`` on ``device``, made by one
    host-to-device copy of one packed buffer (views into it)."""
    flat = np.concatenate([np.asarray(a, dtype=np.float64).reshape(-1) for a in arrays])
    buf = torch.from_numpy(flat).to(dtype=dtype)
    if device.type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    else:
        buf = buf.to(device)
    out, o = [], 0
    for a in arrays:
        n = int(np.prod(np.shape(a), dtype=np.int64))
        out.append(buf[o : o + n].view(np.shape(a)))
        o += n
    return out


def build_time_grid(t0: float, horizon: float, num_intervals: int, event_times) -> np.ndarray:
    """Uniform grid with nodes snapped to mode-switch times.

    OCS2 *inserts* event times into the shooting grid so constraint
    activation changes exactly at phase boundaries; with static shapes we
    instead pin distinct interior nodes to the events and re-space the
    remaining nodes uniformly between consecutive pins.  Unlike naive
    nearest-node snapping, clustered events (several switches inside one dt
    bucket) each get their own node and the segments between pins stay
    evenly conditioned — no arbitrarily displaced node, no near-zero
    interval unless two events genuinely almost coincide.

    Events within a quarter-interval of the grid boundaries are NOT pinned:
    a replan landing just before a mode switch would otherwise produce a
    near-zero first interval, and the stage equality rows are not
    dt-scaled — with B ~ dt the Riccati is forced to satisfy them with
    vanishing actuation authority, which blows up the feedback gains right
    where the policy is evaluated (measured: 50 Hz replanning walks fell
    over precisely on such replans; at the old ~7 Hz effective cadence the
    hazard was just rare)."""
    tf = t0 + horizon
    margin = 0.5 * horizon / num_intervals
    # distinct interior events, earliest num_intervals-1 if oversubscribed
    evs = sorted(
        ev for ev in np.atleast_1d(np.asarray(event_times, dtype=float))
        if np.isfinite(ev) and t0 + margin < ev < tf - margin
    )
    dedup: list[float] = []
    for ev in evs:
        if not dedup or ev - dedup[-1] > 1e-6:
            dedup.append(ev)
    dedup = dedup[: num_intervals - 1]

    # assign strictly increasing node indices near each event's uniform slot
    dt = horizon / num_intervals
    idxs: list[int] = []
    for k, ev in enumerate(dedup):
        ideal = int(round((ev - t0) / dt))
        lo = (idxs[-1] + 1) if idxs else 1
        hi = num_intervals - (len(dedup) - k)  # room for the events after
        idxs.append(int(np.clip(ideal, lo, hi)))

    # uniform spacing between consecutive pinned anchors
    anchors_i = [0] + idxs + [num_intervals]
    anchors_t = [t0] + dedup + [tf]
    grid = np.empty(num_intervals + 1)
    for (ia, ta), (ib, tb) in zip(
        zip(anchors_i, anchors_t), zip(anchors_i[1:], anchors_t[1:])
    ):
        grid[ia : ib + 1] = np.linspace(ta, tb, ib - ia + 1)
    return grid


@dataclasses.dataclass
class ReferenceManager:
    """Host-side mutable references; freeze() per solve."""

    gait_schedule: GaitSchedule
    swing_config: SwingConfig
    target: TargetTrajectories
    horizon: float
    num_intervals: int
    max_phases: int = 24
    max_targets: int = 8
    terrain_height: float = 0.0
    # terrain-aware references (sim/terrain.py): height_at(x, y) callable
    # sampled from the world, plus the body-frame xy offsets of the 4
    # contact points (for predicting where a swing foot will land).  When
    # set, freeze() (a) feeds per-(contact, phase) lift-off/touch-down
    # heights into the swing splines and (b) re-bases the target z so the
    # command's comHeight is measured ABOVE local ground — the machinery
    # the reference ships but never drives (its planner hardcodes
    # terrainHeight = 0, SwitchedModelReferenceManager.cpp:64-71).
    terrain_fn: object | None = None
    foot_xy_offsets: np.ndarray | None = None  # (4, 2) body frame
    # where freeze() puts its tables: the card when None (utils/device.py)
    device: object = None
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def set_target(self, target: TargetTrajectories) -> None:
        self.target = target

    def set_gait(self, template: ModeSequenceTemplate, start_time: float) -> None:
        """Gait command semantics (GaitReceiver::preSolverRun): splice the new
        template at the end of the current horizon."""
        self.gait_schedule.insert_mode_sequence_template(
            template, start_time, start_time + self.horizon
        )

    def _foot_xy_at(self, t: float, contact: int) -> tuple[float, float]:
        """Predicted world xy of a contact point at time t: target base xy
        plus the yaw-rotated body-frame offset (the foot-placement estimate
        the terrain query needs; exact placement is the MPC's decision)."""
        times, states = self.target.times, self.target.states
        bx = float(np.interp(t, times, states[:, 6]))
        by = float(np.interp(t, times, states[:, 7]))
        yaw = float(np.interp(t, times, states[:, 9]))
        ox, oy = self.foot_xy_offsets[contact]
        c, s = np.cos(yaw), np.sin(yaw)
        return bx + c * ox - s * oy, by + s * ox + c * oy

    def _terrain_heights(self, schedule) -> tuple[np.ndarray, np.ndarray]:
        """Per-(contact, phase) lift-off/touch-down heights from terrain_fn
        (the SwingTrajectoryPlanner::update(modeSchedule, liftOff/touchDown
        height vectors) inputs, SwingTrajectoryPlanner.cpp:66-118)."""
        from ..gait.mode_schedule import extract_contact_flags, swing_phase_bounds

        ev = schedule.event_times
        num_phases = len(schedule.mode_sequence)
        flags = extract_contact_flags(schedule.mode_sequence)
        lift = np.zeros((4, num_phases))
        touch = np.zeros((4, num_phases))
        for c in range(4):
            bounds = swing_phase_bounds(flags[:, c])
            for p in range(num_phases):
                if flags[p, c]:
                    # stance: constant height at where the foot stands
                    t_at = ev[p - 1] if p > 0 else (ev[0] - 1e-3 if ev else 0.0)
                    h = self.terrain_fn(*self._foot_xy_at(t_at, c))
                    lift[c, p] = touch[c, p] = h
                else:
                    si, fi = bounds[p]
                    # guarded like plan_swing_table: open-ended swing phases
                    # get the nearest event's height
                    t_lo = ev[si] if si >= 0 else (ev[0] if ev else 0.0)
                    t_td = ev[fi] if fi < len(ev) else (ev[-1] if ev else 0.0)
                    lift[c, p] = self.terrain_fn(*self._foot_xy_at(t_lo, c))
                    touch[c, p] = self.terrain_fn(*self._foot_xy_at(t_td, c))
        return lift, touch

    def freeze(self, t0: float) -> FrozenReferences:
        tf = t0 + self.horizon
        schedule = self.gait_schedule.get_mode_schedule(t0 - self.horizon, tf + self.horizon)
        ev, modes, contacts = mode_schedule_arrays(schedule, self.max_phases)
        terrain_active = self.terrain_fn is not None and self.foot_xy_offsets is not None
        if terrain_active:
            lift, touch = self._terrain_heights(schedule)
            coeffs, mids = swing_table_arrays(
                self.swing_config, schedule, self.max_phases,
                lift_off_heights=lift, touch_down_heights=touch,
            )
        else:
            coeffs, mids = swing_table_arrays(
                self.swing_config, schedule, self.max_phases, self.terrain_height
            )
        target = self.target
        if terrain_active:
            # re-base the command z: comHeight above LOCAL ground
            states = target.states.copy()
            for k in range(states.shape[0]):
                states[k, 8] += self.terrain_fn(states[k, 6], states[k, 7])
            target = TargetTrajectories(target.times, states, target.inputs)
        times, states, inputs = target.freeze_arrays(self.max_targets)
        t_nodes = build_time_grid(t0, self.horizon, self.num_intervals, schedule.event_times)
        (ev_d, modes_d, contacts_d, coeffs_d, mids_d, times_d, states_d, inputs_d, t_nodes_d) = to_device_packed(
            (ev, modes, contacts, coeffs, mids, times, states, inputs, t_nodes), self.device, self.dtype
        )
        return FrozenReferences(
            GaitTable(ev_d, modes_d.to(torch.int64), contacts_d),
            SwingTable(coeffs_d, mids_d),
            TargetTable(times_d, states_d, inputs_d),
            t_nodes_d,
        )

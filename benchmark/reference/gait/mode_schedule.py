"""Gait logic: modes, schedules, templates, tiling
(gait/mode_schedule.py counterpart).

The mutable schedule lives on the host (plain Python/numpy, the same code as
the JAX package's); before each solve it is frozen into a fixed-size, padded
:class:`GaitTable` of tensors on an explicit device, whose queries take a
tensor of times (``torch.searchsorted``), so one call serves every node of
the horizon.

Modes ({LF_pair, RF_pair} contact sets): FLY=0, LF=1, RF=2, STANCE=3
(MotionPhaseDefinition.h:47-76).  Contact order: [left_toe, left_heel,
right_toe, right_heel] ("left_sole_1/2, right_sole_1/2").
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device

FLY = 0
LF = 1
RF = 2
STANCE = 3

MODE_NAMES = {FLY: "FLY", LF: "LF", RF: "RF", STANCE: "STANCE"}
MODE_BY_NAME = {v: k for k, v in MODE_NAMES.items()}

# (4 modes, 4 contacts) table; row m = contact flags of mode m
MODE_CONTACTS = np.array(
    [
        [0, 0, 0, 0],  # FLY
        [1, 1, 0, 0],  # LF
        [0, 0, 1, 1],  # RF
        [1, 1, 1, 1],  # STANCE
    ],
    dtype=bool,
)

NUM_CONTACTS = 4
NUM_LEGS = 2
# leg -> contact indices (toe, heel)
LEG_CONTACTS = ((0, 1), (2, 3))


def mode_to_contact_flags(mode: int) -> np.ndarray:
    return MODE_CONTACTS[mode]


def contact_flags_to_mode(flags) -> int:
    """Inverse map (left as a stub in the reference, MotionPhaseDefinition.h:81-86)."""
    left = bool(flags[0]) or bool(flags[1])
    right = bool(flags[2]) or bool(flags[3])
    return {(False, False): FLY, (True, False): LF, (False, True): RF, (True, True): STANCE}[
        (left, right)
    ]


@dataclasses.dataclass
class ModeSchedule:
    """event_times (n) strictly increasing; mode_sequence (n+1)."""

    event_times: list[float]
    mode_sequence: list[int]

    def mode_at(self, t: float) -> int:
        # matches OCS2 lookup: first event time strictly greater than t
        idx = bisect.bisect_right(self.event_times, t)
        return self.mode_sequence[idx]

    def copy(self) -> "ModeSchedule":
        return ModeSchedule(list(self.event_times), list(self.mode_sequence))


@dataclasses.dataclass
class ModeSequenceTemplate:
    """Periodic gait template (ModeSequenceTemplate.h): switching_times has
    len(mode_sequence) + 1 entries starting at 0."""

    switching_times: list[float]
    mode_sequence: list[int]

    @property
    def duration(self) -> float:
        return self.switching_times[-1] - self.switching_times[0]


def stance_template(duration: float = 0.5) -> ModeSequenceTemplate:
    return ModeSequenceTemplate([0.0, duration], [STANCE])


class GaitSchedule:
    """Host-side mutable gait schedule (GaitSchedule.cpp semantics)."""

    def __init__(
        self,
        init_mode_schedule: ModeSchedule,
        init_template: ModeSequenceTemplate,
        phase_transition_stance_time: float,
    ):
        self._schedule = init_mode_schedule.copy()
        self._template = dataclasses.replace(init_template)
        self.phase_transition_stance_time = phase_transition_stance_time

    def insert_mode_sequence_template(
        self, template: ModeSequenceTemplate, start_time: float, final_time: float
    ) -> None:
        """Splice a new gait at start_time with a stance transition buffer
        (GaitSchedule.cpp:47-74)."""
        self._template = template
        ev, seq = self._schedule.event_times, self._schedule.mode_sequence
        index = bisect.bisect_left(ev, start_time)
        if index < len(ev):
            del ev[index:]
            del seq[index + 1 :]
        stance_time = self.phase_transition_stance_time
        if seq and seq[-1] == STANCE:
            stance_time = 0.0
        if stance_time > 0.0:
            ev.append(start_time)
            seq.append(STANCE)
        self._tile(start_time + stance_time, final_time)

    def get_mode_schedule(self, lower_bound_time: float, upper_bound_time: float) -> ModeSchedule:
        """Trim history before lower bound, tile template up to upper bound
        (GaitSchedule.cpp:79-103).  Mutates internal state, like the reference."""
        ev, seq = self._schedule.event_times, self._schedule.mode_sequence
        index = bisect.bisect_left(ev, lower_bound_time)
        if index > 0:
            # keep one event before the bound; set the leading phase to STANCE
            del ev[: index - 1]
            del seq[: index - 1]
            seq[0] = STANCE
        tiling_start = ev[-1] if ev else upper_bound_time
        # drop the trailing default stance phase before tiling
        if ev:
            del ev[-1:]
        del seq[-1:]
        self._tile(tiling_start, upper_bound_time)
        return self._schedule.copy()

    def _tile(self, start_time: float, final_time: float) -> None:
        """GaitSchedule::tileModeSequenceTemplate (GaitSchedule.cpp:108-136)."""
        ev, seq = self._schedule.event_times, self._schedule.mode_sequence
        tpl_t, tpl_m = self._template.switching_times, self._template.mode_sequence
        if not tpl_m:
            return
        if ev and start_time <= ev[-1]:
            raise ValueError("template tiling start must exceed the last event time")
        ev.append(start_time)
        while ev[-1] < final_time:
            for i, mode in enumerate(tpl_m):
                seq.append(mode)
                ev.append(ev[-1] + (tpl_t[i + 1] - tpl_t[i]))
        seq.append(STANCE)


# ---------------------------------------------------------------- leg logic
def extract_contact_flags(mode_sequence: list[int]) -> np.ndarray:
    """(num_phases, 4) bool (SwingTrajectoryPlanner::extractContactFlags)."""
    return MODE_CONTACTS[np.asarray(mode_sequence, dtype=int)]


class LegPhase(NamedTuple):
    """Normalized phase within the current contact/swing interval.

    phase in [0, 1] inside an interval (NaN-duration legs report -1), and
    duration is +inf for the half-open boundary intervals — the LegLogic.h
    LegPhase contract (LegLogic.cpp:104-187)."""

    phase: float
    duration: float


class PhaseTiming(NamedTuple):
    """One contact (or swing) interval; open ends are NaN, exactly like the
    reference's ContactTiming/SwingTiming (LegLogic.h): the first interval
    has no recorded start if the schedule begins inside it, the last no end
    if the schedule ends inside it."""

    start: float
    end: float


def leg_contact_flags(mode_sequence: list[int]) -> np.ndarray:
    """(num_phases, 2) bool per LEG (left, right) — modeNumber2StanceLeg
    collapsed over each leg's toe/heel pair (both contacts of a leg share
    the mode's stance assignment under the biped mode set)."""
    flags = extract_contact_flags(mode_sequence)
    return np.stack([flags[:, 0] | flags[:, 1], flags[:, 2] | flags[:, 3]], axis=1)


def _extract_timings(event_times, flags, want) -> list[PhaseTiming]:
    """Run-length scan of the phase flags: one PhaseTiming per maximal run
    with flag == want (LegLogic.cpp extractContactTimings/extractSwingTimings
    semantics, done as a single numpy diff pass instead of nested loops)."""
    flags = np.asarray(flags, dtype=bool)
    ev = np.asarray(event_times, dtype=float)
    n = flags.size
    if n == 0:
        return []
    # run starts: phase 0 or a flip from the previous phase
    starts = np.flatnonzero(np.concatenate([[True], flags[1:] != flags[:-1]]))
    out = []
    for si, s in enumerate(starts):
        if flags[s] != want:
            continue
        e = starts[si + 1] - 1 if si + 1 < starts.size else n - 1
        start_t = ev[s - 1] if s > 0 else np.nan
        end_t = ev[e] if e + 1 < n else np.nan
        out.append(PhaseTiming(start_t, end_t))
    return out


def extract_contact_timings_per_leg(schedule: ModeSchedule) -> list[list[PhaseTiming]]:
    """Per leg [left, right]: the contact intervals of the schedule
    (LegLogic.cpp:190-203)."""
    leg_flags = leg_contact_flags(schedule.mode_sequence)
    return [
        _extract_timings(schedule.event_times, leg_flags[:, leg], True)
        for leg in range(NUM_LEGS)
    ]


def extract_swing_timings_per_leg(schedule: ModeSchedule) -> list[list[PhaseTiming]]:
    """Per leg [left, right]: the swing intervals (LegLogic.cpp:206-219)."""
    leg_flags = leg_contact_flags(schedule.mode_sequence)
    return [
        _extract_timings(schedule.event_times, leg_flags[:, leg], False)
        for leg in range(NUM_LEGS)
    ]


def _phase_in(t: float, timings: list[PhaseTiming]) -> LegPhase:
    """Shared phase lookup (LegLogic.cpp:104-187): boundary intervals are
    half-open (phase saturates at 1 entering / 0 leaving with inf duration),
    interior lookups interpolate, and 'never in this phase type' is -1."""
    if not timings:
        return LegPhase(-1.0, float("nan"))
    first, last = timings[0], timings[-1]
    if np.isnan(first.start) and t <= first.end:
        return LegPhase(1.0, float("inf"))
    if np.isnan(last.end) and t >= last.start:
        return LegPhase(0.0, float("inf"))
    for tm in timings:
        if not np.isnan(tm.start) and not np.isnan(tm.end) and tm.start <= t <= tm.end:
            dur = tm.end - tm.start
            return LegPhase((t - tm.start) / dur, dur)
    return LegPhase(-1.0, float("nan"))


def get_contact_phase_per_leg(t: float, schedule: ModeSchedule) -> list[LegPhase]:
    """Per leg: normalized contact phase at time t (LegLogic.cpp:104-142)."""
    return [_phase_in(t, tm) for tm in extract_contact_timings_per_leg(schedule)]


def get_swing_phase_per_leg(t: float, schedule: ModeSchedule) -> list[LegPhase]:
    """Per leg: normalized swing phase at time t (LegLogic.cpp:147-187)."""
    return [_phase_in(t, tm) for tm in extract_swing_timings_per_leg(schedule)]


def get_time_of_next_lift_off(t: float, contact_timings: list[PhaseTiming]) -> float:
    """First contact end after t, NaN when the leg never lifts off again
    (LegLogic.cpp:225-233)."""
    for tm in contact_timings:
        if not np.isnan(tm.end) and tm.end > t:
            return tm.end
    return float("nan")


def get_time_of_next_touch_down(t: float, contact_timings: list[PhaseTiming]) -> float:
    """First contact start after t, NaN when the leg never touches down
    again (LegLogic.cpp:238-246)."""
    for tm in contact_timings:
        if not np.isnan(tm.start) and tm.start > t:
            return tm.start
    return float("nan")


def swing_phase_bounds(contact_flags_per_phase: np.ndarray) -> list[tuple[int, int]]:
    """Per phase: (start_event_idx, final_event_idx) of the enclosing swing
    window for one leg (SwingTrajectoryPlanner::findIndex semantics).
    contact_flags_per_phase: (num_phases,) bool for one contact."""
    flags = list(contact_flags_per_phase)
    n = len(flags)
    out: list[tuple[int, int]] = []
    for i in range(n):
        if flags[i]:
            out.append((0, 0))
            continue
        start = -1
        for ip in range(i - 1, -1, -1):
            if flags[ip]:
                start = ip
                break
        final = n - 1
        for ip in range(i + 1, n):
            if flags[ip]:
                final = ip - 1
                break
        out.append((start, final))
    return out


# ---------------------------------------------------------------- device table
class GaitTable(NamedTuple):
    """Fixed-size device view of a ModeSchedule.

    event_times padded with +inf; contact table row p = contact flags of
    phase p (phase p spans (event_times[p-1], event_times[p]]).  Every query
    takes a tensor of times t of any shape S and answers for each element.
    """

    event_times: torch.Tensor  # (P,) padded +inf
    modes: torch.Tensor  # (P+1,) int64, padded with the final mode
    contacts: torch.Tensor  # (P+1, 4) float (0/1)

    def phase_index(self, t):
        """(S...) int64 phase of each time."""
        return torch.searchsorted(self.event_times, t, right=True)

    def mode_at(self, t):
        return self.modes[self.phase_index(t)]

    def contact_flags_at(self, t):
        """(S..., 4) float mask."""
        return self.contacts[self.phase_index(t)]

    def leg_contacts(self):
        """(P+1, 2) per-LEG contact flags (toe/heel collapsed)."""
        c = self.contacts
        return torch.stack([torch.maximum(c[:, 0], c[:, 1]), torch.maximum(c[:, 2], c[:, 3])], dim=1)

    def _next_switch(self, t, touchdown: bool):
        lc = self.leg_contacts() > 0.5  # (P+1, 2)
        switch = (~lc[:-1]) & lc[1:] if touchdown else lc[:-1] & (~lc[1:])  # (P, 2)
        ev = self.event_times[:, None]
        after = switch & (ev > t[..., None, None])  # (S..., P, 2)
        return torch.where(after, ev, torch.full_like(ev, float("inf"))).amin(dim=-2)

    def next_touchdown_per_leg(self, t):
        """(S..., 2) time of each leg's next swing->contact switch strictly
        after t (getTimeOfNextTouchDown, LegLogic.cpp:238-246), as a masked
        min over the padded event table; +inf for 'never'."""
        return self._next_switch(t, True)

    def next_liftoff_per_leg(self, t):
        """(S..., 2) time of each leg's next contact->swing switch strictly
        after t (getTimeOfNextLiftOff, LegLogic.cpp:225-233); +inf for
        'never'."""
        return self._next_switch(t, False)


def mode_schedule_arrays(schedule: ModeSchedule, max_phases: int):
    """(event_times (P,), modes (P+1,), contacts (P+1, 4)) as numpy: the
    padded tables of :func:`freeze_mode_schedule`."""
    n = len(schedule.event_times)
    if n > max_phases:
        raise ValueError(f"mode schedule has {n} events > max_phases {max_phases}")
    ev = np.full(max_phases, np.inf)
    ev[:n] = schedule.event_times
    modes = np.full(max_phases + 1, schedule.mode_sequence[-1], dtype=np.int64)
    modes[: n + 1] = schedule.mode_sequence
    return ev, modes, MODE_CONTACTS[modes].astype(np.float64)


def freeze_mode_schedule(schedule: ModeSchedule, max_phases: int, device=None, dtype=torch.float64) -> GaitTable:
    """The schedule's GaitTable on ``device`` (the card when None)."""
    device = resolve_device(device)
    ev, modes, contacts = mode_schedule_arrays(schedule, max_phases)
    return GaitTable(
        event_times=torch.as_tensor(ev, dtype=dtype, device=device),
        modes=torch.as_tensor(modes, device=device),
        contacts=torch.as_tensor(contacts, dtype=dtype, device=device),
    )

"""Real-time controller runner: the native RtLoop driving the control tick
(runtime/rt_runner.py counterpart, a copy).

This is the deployment composition (bipedal_hw/src/BipedalHWLoop.cpp:31-85):
a SCHED_FIFO periodic loop does read -> controller update -> write at the
HW rate against wall-clock time, while the MPC worker replans in the
background (runtime/async_mpc.py).  Simulation tests drive the tick from
their own sim-time loops instead (sim time != wall time); this runner is
for real plants and for wall-clock soak tests of the tick pipeline.

The runner times each cycle's start, read, update and write
(``cycle_seconds``, the last 100,000 cycles).  The start is how late the
callback began after the later of its deadline and the previous cycle's
end: the loop thread's wake-up and its wait for the GIL (held by another
Python thread, such as the MPC worker's host code).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable

import numpy as np

from .controller import BipedalController, JointCommand
from .native_rt import RtLoop


class RtControllerRunner:
    """Owns the RtLoop; read/write callbacks bridge to the plant HW.

    read() -> rbd_state (numpy, cheater layout) or raw sensors via the
    kalman path; write(cmd: JointCommand) pushes to the actuators.
    """

    def __init__(
        self,
        ctrl: BipedalController,
        read: Callable[[], object],
        write: Callable[[JointCommand], None],
        frequency_hz: float = 500.0,
        priority: int = 0,
    ):
        self.ctrl = ctrl
        self._read = read
        self._write = write
        self.frequency = frequency_hz
        self.priority = priority
        self._loop: RtLoop | None = None
        self._t0 = None
        self.ticks = 0
        # (start, read, update, write) seconds of each of the last 100,000 cycles
        self.cycle_seconds: deque[tuple[float, float, float, float]] = deque(maxlen=100_000)
        self._first = self._end = None  # the first cycle's start, the last cycle's end (monotonic)

    def _tick(self) -> bool:
        c0 = time.monotonic()
        if self._first is None:
            self._first = self._end = c0
        # the loop's absolute deadlines run from its first cycle
        deadline = self._first + self.ticks / self.frequency
        late = max(0.0, c0 - max(deadline, self._end))
        t = c0 - self._t0
        rbd = self._read()
        c1 = time.monotonic()
        cmd = self.ctrl.update(t, rbd)
        c2 = time.monotonic()
        self._write(cmd)
        c3 = self._end = time.monotonic()
        self.cycle_seconds.append((late, c1 - c0, c2 - c1, c3 - c2))
        self.ticks += 1
        return not self.ctrl.safe  # True stops the loop

    def _damping_command(self) -> JointCommand:
        """Zero-torque pure-damping command (the reference's safe fallback:
        damp the joints, no position/feedforward drive)."""
        nj = self.ctrl.iface.info.nj
        zero = np.zeros(nj)
        return JointCommand(zero, zero, zero, np.full(nj, self.ctrl.cfg.joint_kd), zero)

    def start(self) -> None:
        self._t0 = time.monotonic()
        self._loop = RtLoop(self.frequency, self._tick, priority=self.priority)

    def stats(self) -> dict:
        return self._loop.stats() if self._loop is not None else {}

    @property
    def failed(self) -> bool:
        """True when the tick path crashed (exception in read/update/write)."""
        return self._loop is not None and self._loop.failed

    @property
    def exception(self):
        return self._loop.exception if self._loop is not None else None

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.stop()
            if self._loop.exception is not None:
                # the crash left whatever torque was last written on the
                # actuators — overwrite with a damping command before handing
                # the plant back (BipedalHWLoop's on-error write path)
                try:
                    self._write(self._damping_command())
                except Exception:  # noqa: BLE001 — best effort on a dead bridge
                    pass
            self._loop.close()
            self._loop = None

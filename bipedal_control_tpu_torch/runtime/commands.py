"""Live command channel: re-target gait and base motion on a RUNNING loop
(runtime/commands.py counterpart, a copy on the port's reference/target.py).

The reference mutates a running controller through two ROS entry points: the
keyboard gait publisher (GaitKeyboardPublisher.cpp:46-96 — type a gait name,
it becomes a mode_schedule message spliced in at the horizon end) and the
target publisher (/cmd_vel + /move_base_simple/goal ->
TargetTrajectoriesPublisher.cpp:40-100).  Here both collapse into a text
command protocol routed to a live :class:`BipedalController` (or bare
MpcRunner) — drivable from stdin (:class:`StdinCommandChannel`), a socket, or
programmatically from tests.

Commands:
    gait <name>              splice the named gait at the horizon end
    cmd_vel <vx> <vy> [<vz> <wz>]   stream a velocity target
    goal <x> <y> <yaw>       goal-pose target
    stop                     stationary target (hold current pose)
    list                     -> known gait names
    wbc_weight <name> <val>  live WBC task weight (baseAccel/swingLeg/
                             contactForce — the dynamic_reconfigure knobs,
                             BipedalController.cpp:407-478)
    gain <pattern> <kp> <kd> live PD gains on joints matching <pattern>
                             (substring; mirrors left/right like the
                             reference's paired motor params)
"""
from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from ..reference.target import (
    cmd_vel_to_target_trajectories,
    goal_to_target_trajectories,
    stationary_target,
)


class CommandRouter:
    """Parses text commands and applies them to a live control loop.

    ``sink`` must expose set_gait(template, start_time)/set_target(target)
    (BipedalController and AsyncMpcRunner both do; a bare MpcRunner's
    ReferenceManager works via the rm= keyword).
    ``observation`` returns the latest (t, x_obs) — commands that extrapolate
    from the current state (cmd_vel/goal) need it, exactly like the
    reference's publishers subscribe to the observation topic.
    """

    def __init__(self, sink, iface, observation: Callable[[], tuple[float, np.ndarray]]):
        self.sink = sink
        self.iface = iface
        self.observation = observation

    def handle(self, line: str) -> str:
        """Apply one command; returns a human-readable ack (or error)."""
        parts = line.strip().split()
        if not parts:
            return ""
        cmd, args = parts[0].lower(), parts[1:]
        try:
            if cmd == "list":
                return " ".join(sorted(self.iface.task.gait_library))
            if cmd == "wbc_weight":
                if not hasattr(self.sink, "set_wbc_weight"):
                    return "sink has no live WBC (bare MpcRunner?)"
                self.sink.set_wbc_weight(args[0], float(args[1]))
                return f"wbc weight {args[0]} -> {float(args[1])}"
            if cmd == "gain":
                if not hasattr(self.sink, "set_joint_gains"):
                    return "sink has no joint gains"
                hits = self.sink.set_joint_gains(args[0], float(args[1]), float(args[2]))
                return f"gains kp={args[1]} kd={args[2]} on {hits} joints"
            # every other command extrapolates from the current observation;
            # before the first controller tick there is none yet
            if self.observation() is None:
                return "no observation yet (controller not ticking)"
            if cmd == "gait":
                name = args[0]
                if name not in self.iface.task.gait_library:
                    return f"unknown gait {name!r} (try: list)"
                t, _ = self.observation()
                # splice after the current horizon tail settles, like
                # GaitSchedule::insertModeSequenceTemplate at horizon end
                self.sink.set_gait(self.iface.task.gait_library[name], start_time=t + 0.1)
                return f"gait -> {name}"
            if cmd == "cmd_vel":
                v = [float(a) for a in args]
                v += [0.0] * (4 - len(v))
                t, x = self.observation()
                self.sink.set_target(
                    cmd_vel_to_target_trajectories(
                        np.asarray(v), t, np.asarray(x),
                        self.iface.command_config, self.iface.info.input_dim,
                    )
                )
                return f"cmd_vel -> {v}"
            if cmd == "goal":
                x_, y_, yaw = (float(a) for a in args[:3])
                t, x = self.observation()
                goal = np.array([x_, y_, 0.0, yaw, 0.0, 0.0])
                self.sink.set_target(
                    goal_to_target_trajectories(
                        goal, t, np.asarray(x),
                        self.iface.command_config, self.iface.info.input_dim,
                    )
                )
                return f"goal -> ({x_}, {y_}, yaw {yaw})"
            if cmd == "stop":
                t, x = self.observation()
                self.sink.set_target(
                    stationary_target(
                        t, np.asarray(x), self.iface.command_config, self.iface.info.input_dim
                    )
                )
                return "holding current pose"
            return f"unknown command {cmd!r}"
        except (ValueError, IndexError, TypeError) as e:
            # TypeError included so a malformed line can never kill the
            # stdin reader thread (the channel must survive bad input)
            return f"bad arguments for {cmd!r}: {e}"


class StdinCommandChannel:
    """Background stdin reader feeding a CommandRouter (the keyboard
    publisher's terminal UX).  start() spawns the reader; acks print to
    stdout; EOF or close() ends it."""

    def __init__(self, router: CommandRouter):
        self.router = router
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def start(self) -> None:
        import sys

        def _reader():
            print("command> ", end="", flush=True)
            for line in sys.stdin:
                if self._stop.is_set():
                    break
                ack = self.router.handle(line)
                if ack:
                    print(ack)
                print("command> ", end="", flush=True)

        self._thread = threading.Thread(target=_reader, name="cmd_stdin", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()

"""Safety checker (runtime/safety.py counterpart, a copy; bipedal_controllers
SafetyChecker.h:23-52): stop when the base tilts beyond +-pi/3 in roll or
pitch.  Pure host math — it runs on the RT tick path."""
from __future__ import annotations

import math

TILT_LIMIT = math.pi / 3


def check_orientation(rbd_state, limit: float = TILT_LIMIT) -> bool:
    """rbdState leads with [yaw, pitch, roll]; returns True when safe."""
    pitch, roll = float(rbd_state[1]), float(rbd_state[2])
    return abs(pitch) < limit and abs(roll) < limit

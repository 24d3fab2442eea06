"""Whole-body-control task configuration (wbc/tasks.py counterpart, its
configuration part).

Decision vector  x = [vdot (6+nj); F_contact (12); tau (nj)]
(bipedal_wbc/src/WbcBase.cpp:37).  The host WBC (wbc/host_wbc.py) builds its
task rows from this configuration.  The JAX module's task functions (the
device WBC's rows, on model/dynamics.py) are not ported yet: they come with
the device WBC (ROADMAP queue 1 item 6b).
"""
from __future__ import annotations

import dataclasses

NUM_CONTACTS = 4


@dataclasses.dataclass(frozen=True)
class WbcTaskConfig:
    """task.info WBC blocks (torqueLimitsTask .. weight, task.info:289-342)."""

    torque_limit_per_leg: tuple  # (nj/2,)
    friction_coefficient: float = 0.3
    swing_kp: float = 350.0
    swing_kd: float = 37.0
    base_kp: tuple = (40.0, 40.0, 20.0, 20.0, 20.0, 20.0)
    base_kd: tuple = (4.0, 4.0, 3.0, 3.0, 3.0, 3.0)
    no_contact_motion_tolerance: float = 5.0
    weight_swing_leg: float = 100.0
    weight_base_accel: float = 1.0
    weight_contact_force: float = 0.01
    # Null-space regularization: in full stance no weighted task touches the
    # joint accelerations (the +-tolerance no-contact band leaves them free),
    # so the QP optimum is degenerate.  qpOASES's zero-initialized active-set
    # implicitly returns a small solution; the ADMM needs the preference made
    # explicit or the null space fills with tens of rad/s^2 that leak into
    # the torques through the EoM.
    accel_reg: float = 1e-2
    force_reg: float = 1e-6
    torque_reg: float = 1e-6

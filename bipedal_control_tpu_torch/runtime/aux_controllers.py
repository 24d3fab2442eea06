"""Auxiliary joint controllers + policy serialization
(runtime/aux_controllers.py counterpart).

- :class:`InitialJointPositionController`: drive the legs to the default
  joint state with joint-limit clamping and per-joint PD gains — the
  bring-up/reset controller (reference: InitialJointController.cpp:28-200,
  used by the restart scripts before switching to the main controller).
- :class:`UpperJointController`: hold the upper body at its defaults with
  fixed kp=100/kd=3 (UpperJointController.cpp:31-118).
- save/load of SqpSolution policies (.npz) — the checkpoint/resume facility
  the reference lacks entirely (SURVEY.md §5.4).  The file holds one
  scenario under the JAX package's keys and shapes, so a policy saved by
  either package loads in the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..solver.sqp import SqpSolution
from ..utils.device import resolve_device
from .controller import JointCommand


@dataclasses.dataclass
class InitialJointPositionController:
    """PD to a target posture, ramped over `duration` with limit clamping."""

    target: np.ndarray  # (nj,)
    lower: np.ndarray
    upper: np.ndarray
    kp: float = 100.0
    kd: float = 3.0
    duration: float = 2.0

    _q_start: np.ndarray | None = None
    _t_start: float = 0.0

    def starting(self, t: float, joint_pos: np.ndarray) -> None:
        self._q_start = np.asarray(joint_pos).copy()
        self._t_start = t

    def update(self, t: float, joint_pos, joint_vel) -> JointCommand:
        if self._q_start is None:
            self.starting(t, joint_pos)
        alpha = np.clip((t - self._t_start) / self.duration, 0.0, 1.0)
        target = np.clip(self.target, self.lower, self.upper)
        pos_des = (1 - alpha) * self._q_start + alpha * target
        nj = len(target)
        return JointCommand(
            pos_des=pos_des,
            vel_des=np.zeros(nj),
            kp=np.full(nj, self.kp),
            kd=np.full(nj, self.kd),
            tau_ff=np.zeros(nj),
        )


@dataclasses.dataclass
class UpperJointController:
    """Hold upper-body joints at defaults (fixed gains, no ramp)."""

    target: np.ndarray
    kp: float = 100.0
    kd: float = 3.0

    def update(self, t: float, joint_pos, joint_vel) -> JointCommand:
        nj = len(self.target)
        return JointCommand(
            pos_des=np.asarray(self.target),
            vel_des=np.zeros(nj),
            kp=np.full(nj, self.kp),
            kd=np.full(nj, self.kd),
            tau_ff=np.zeros(nj),
        )


# ---------------------------------------------------------------- checkpoint
# the primal policy's fields (the reference's file keys; not the ipm's cone iterates)
POLICY_FIELDS = SqpSolution._fields[:8]


def save_policy(path: str, sol: SqpSolution) -> None:
    """Serialize scenario 0 of a batched solution (warm start / resume /
    offline analysis)."""
    np.savez(path, **{name: getattr(sol, name)[0].detach().cpu().numpy() for name in POLICY_FIELDS})


def load_policy(path: str, device=None, dtype=torch.float64) -> SqpSolution:
    """A saved policy as a batched solution of one scenario on ``device``
    (the card when None; utils/device.py)."""
    device = resolve_device(device)
    with np.load(path) as z:
        return SqpSolution(*(torch.as_tensor(z[name], dtype=dtype, device=device)[None]
                             for name in POLICY_FIELDS))

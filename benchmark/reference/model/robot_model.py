"""Robot model as tensors (model/robot_model.py counterpart).

Generalized coordinates: q = [p_base(3, world), theta(3, euler-zyx), q_j(nj)],
v = dq/dt (Euler rates).  nq == nv == 6 + nj.

Topology is static Python/numpy metadata; the numeric parameters are tensors
that move together with :meth:`RobotModel.to`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from .urdf import RobotDescription

LEAF_FIELDS = (
    "joint_offset_R",
    "joint_offset_p",
    "joint_axis",
    "joint_limit_lower",
    "joint_limit_upper",
    "joint_limit_effort",
    "joint_limit_velocity",
    "body_mass",
    "body_com",
    "body_inertia",
    "frame_R",
    "frame_p",
)


@dataclasses.dataclass(frozen=True)
class RobotModel:
    # --- static topology ---
    name: str
    joint_names: tuple[str, ...]
    frame_names: tuple[str, ...]
    joint_parent_body: tuple[int, ...]  # (nj,)
    joint_type: tuple[int, ...]  # (nj,)
    frame_body: tuple[int, ...]  # (nf,)
    ancestor_joints: bytes  # (nb, nj) bool mask as bytes: joint j moves body b

    # --- tensors ---
    joint_offset_R: torch.Tensor  # (nj,3,3)
    joint_offset_p: torch.Tensor  # (nj,3)
    joint_axis: torch.Tensor  # (nj,3)
    joint_limit_lower: torch.Tensor
    joint_limit_upper: torch.Tensor
    joint_limit_effort: torch.Tensor
    joint_limit_velocity: torch.Tensor
    body_mass: torch.Tensor  # (nb,)
    body_com: torch.Tensor  # (nb,3)
    body_inertia: torch.Tensor  # (nb,3,3)
    frame_R: torch.Tensor  # (nf,3,3)
    frame_p: torch.Tensor  # (nf,3)

    @property
    def nj(self) -> int:
        return len(self.joint_names)

    @property
    def nb(self) -> int:
        return self.nj + 1

    @property
    def nq(self) -> int:
        return 6 + self.nj

    @property
    def nv(self) -> int:
        return 6 + self.nj

    @property
    def total_mass(self):
        return self.body_mass.sum()

    @property
    def dtype(self) -> torch.dtype:
        return self.body_mass.dtype

    def frame_index(self, name: str) -> int:
        return self.frame_names.index(name)

    def ancestor_mask(self) -> np.ndarray:
        """(nb, nj) static bool: joint j moves body b."""
        return np.frombuffer(self.ancestor_joints, dtype=np.bool_).reshape(self.nb, self.nj)

    def to(self, device=None, dtype=None) -> "RobotModel":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device=device, dtype=dtype) for f in LEAF_FIELDS}
        )


def ancestor_mask_from_parents(joint_parent_body) -> np.ndarray:
    """(nb, nj) bool: joint j (body j+1) moves body b iff body j+1 lies on
    the chain from the root to b."""
    nj = len(joint_parent_body)
    anc = np.zeros((nj + 1, nj), dtype=np.bool_)
    for b in range(1, nj + 1):
        cur = b
        while cur != 0:
            anc[b, cur - 1] = True
            cur = int(joint_parent_body[cur - 1])
    return anc


def from_description(
    desc: RobotDescription, dtype=torch.float64, device=None
) -> RobotModel:
    """The model's tensors on ``device``: the card when None
    (utils/device.py); pass ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    arr = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)
    return RobotModel(
        name=desc.name,
        joint_names=tuple(desc.joint_names),
        frame_names=tuple(desc.frame_names),
        joint_parent_body=tuple(int(i) for i in desc.joint_parent_body),
        joint_type=tuple(int(t) for t in desc.joint_type),
        frame_body=tuple(int(b) for b in desc.frame_body),
        ancestor_joints=ancestor_mask_from_parents(desc.joint_parent_body).tobytes(),
        **{f: arr(getattr(desc, f)) for f in LEAF_FIELDS},
    )

"""Robot constants as numpy for the hand-written model kernels
(the numpy table extraction of ops/pallas_linearize.py: ``StaticModel``,
``make_static_model`` and ``tables_np``).

The JAX package's lane circuits in that module are the specification of the
CUDA device functions in ``csrc/centroidal_circuit.cuh``; they are not
ported as Python.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..model.robot_model import RobotModel


@dataclasses.dataclass
class StaticModel:
    """All robot constants as numpy/python."""

    nj: int
    nb: int
    nv: int
    parent: list[int]
    jtype: list[int]
    axis: np.ndarray  # (nj, 3)
    off_R: np.ndarray  # (nj, 3, 3)
    off_p: np.ndarray  # (nj, 3)
    mass: np.ndarray  # (nb,)
    total_mass: float
    com: np.ndarray  # (nb, 3)
    inertia: np.ndarray  # (nb, 3, 3)
    anc: np.ndarray  # (nb, nj) bool: joint j moves body b
    contact_body: list[int]
    contact_p: np.ndarray  # (nc, 3)


def make_static_model(model: RobotModel, contact_frame_ids) -> StaticModel:
    np64 = lambda t: t.detach().cpu().numpy().astype(np.float64)
    nb = model.nb
    parent = [int(model.joint_parent_body[j]) for j in range(model.nj)]
    mass = np64(model.body_mass)
    frame_p = np64(model.frame_p)
    return StaticModel(
        nj=model.nj,
        nb=nb,
        nv=model.nv,
        parent=parent,
        jtype=[int(t) for t in model.joint_type],
        axis=np64(model.joint_axis),
        off_R=np64(model.joint_offset_R),
        off_p=np64(model.joint_offset_p),
        mass=mass,
        total_mass=float(np.sum(mass)),
        com=np64(model.body_com),
        inertia=np64(model.body_inertia),
        anc=np.asarray(model.ancestor_mask(), dtype=bool),
        contact_body=[int(model.frame_body[f]) for f in contact_frame_ids],
        contact_p=np.stack([frame_p[f] for f in contact_frame_ids]),
    )


def tables_np(sm: StaticModel) -> np.ndarray:
    """(1 + nb, nv) table stack: subtree mass per coordinate, then per body
    the "coordinate l moves body b" mask.  These are the first two groups of
    the reference's stack; the merit circuit derives the rotation mask, the
    Euler dw masks and the translation one-hots from the coordinate index."""
    nv, nb, nj = sm.nv, sm.nb, sm.nj
    move = np.zeros((nb, nv))
    move[:, 0:6] = 1.0
    move[:, 6:] = sm.anc.astype(float)
    msub = np.zeros(nv)
    msub[:6] = sm.total_mass
    for j in range(nj):
        msub[6 + j] = float(np.sum(sm.mass * sm.anc[:, j]))
    return np.concatenate([msub[None], move], axis=0)

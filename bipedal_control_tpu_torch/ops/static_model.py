"""Robot constants as numpy for the hand-written model kernels
(the numpy table extraction of ops/pallas_linearize.py: ``StaticModel``,
``make_static_model`` and ``tables_np``), and the compile-time defines and
parameter buffer that the linearize (K1) and merit (K4) kernels share.

The JAX package's lane circuits in that module are the specification of the
CUDA device functions in ``csrc/centroidal_circuit.cuh``; they are not
ported as Python.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..model.robot_model import RobotModel
from ..ocp.problem import NUM_CONTACTS


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
    the reference's stack; the circuits derive its other groups from the
    coordinate index l: the rotation mask is "moves and l >= 3", the Euler dw
    mask of Euler coordinate i is 3 <= l < 3 + i, and the translation
    one-hot of axis c is l == c."""
    nv, nb, nj = sm.nv, sm.nb, sm.nj
    move = np.zeros((nb, nv))
    move[:, 0:6] = 1.0
    move[:, 6:] = sm.anc.astype(float)
    msub = np.zeros(nv)
    msub[:6] = sm.total_mass
    for j in range(nj):
        msub[6 + j] = float(np.sum(sm.mass * sm.anc[:, j]))
    return np.concatenate([msub[None], move], axis=0)


def group_width(nv: int) -> int:
    """Lanes per instance of the circuit kernels: the next power of two
    >= nv (a ``__shfl_sync`` width), at least 16 (a lane per equality row),
    at most a warp."""
    if nv > 32:
        raise NotImplementedError(f"the circuit kernels take at most 32 coordinates, got {nv}")
    return max(16, 1 << (nv - 1).bit_length())


def joint_levels(parent: list[int]) -> list[int]:
    """Depth of each joint in the tree: 0 for a joint on the base (body 0),
    its parent joint's level + 1 otherwise (joint j moves body j + 1, so the
    joint whose body is ``parent[j]`` is joint ``parent[j] - 1``)."""
    levels: list[int] = []
    for j, par in enumerate(parent):
        if not 0 <= par <= j:
            raise ValueError(f"joint {j}: parent body {par} is not an earlier body")
        levels.append(0 if par == 0 else levels[par - 1] + 1)
    return levels


def level_schedule(parent: list[int]) -> tuple[list[int], list[int]]:
    """(joints in level order, offsets of each level in it): FK composes
    the world frames one tree level at a time, every joint of a level at
    once."""
    levels = joint_levels(parent)
    order = sorted(range(len(parent)), key=lambda j: (levels[j], j))
    start = [0]
    for d in range(max(levels, default=-1) + 1):
        start.append(start[-1] + levels.count(d))
    return order, start


def kernel_defines(sm: StaticModel) -> dict[str, str]:
    """Compile-time robot topology of the circuit kernels: the tree, joint
    types, contact bodies, FK's level schedule and the group width."""
    if len(sm.contact_body) != NUM_CONTACTS:
        raise NotImplementedError(f"the circuit kernels take {NUM_CONTACTS} contacts, got {len(sm.contact_body)}")
    join = lambda xs: ",".join(str(int(v)) for v in xs)
    order, start = level_schedule(sm.parent)
    return {
        "NJ": str(sm.nj),
        "PARENT_LIST": join(sm.parent),
        "JTYPE_LIST": join(sm.jtype),
        "CONTACT_BODY_LIST": join(sm.contact_body),
        "NLEVELS": str(len(start) - 1),
        "LEVEL_ORDER": join(order),
        "LEVEL_START": join(start),
        "GROUP": str(group_width(sm.nv)),
    }


def kernel_params(sm: StaticModel, robot_mass: float) -> np.ndarray:
    """The parameter buffer in the layout of csrc/centroidal_circuit.cuh."""
    parts = [
        sm.off_R.reshape(-1), sm.off_p.reshape(-1), sm.axis.reshape(-1), sm.mass.reshape(-1),
        sm.com.reshape(-1), sm.inertia.reshape(-1), sm.contact_p.reshape(-1),
        tables_np(sm).reshape(-1),  # msub (nv) | move (nb, nv)
        np.array([sm.total_mass, float(robot_mass)]),
    ]
    return np.concatenate(parts).astype(np.float64)


def circuit_static(model: RobotModel, info):
    """(kernel_defines, kernel_params as a tensor of the model's dtype and
    device) for the circuit kernels."""
    sm = make_static_model(model, info.contact_frame_ids)
    params = torch.as_tensor(kernel_params(sm, info.robot_mass), dtype=model.dtype, device=model.body_mass.device)
    return kernel_defines(sm), params

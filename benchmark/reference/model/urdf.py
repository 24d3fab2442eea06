"""URDF -> reduced rigid-body model description (host-side, numpy).

Replaces the reference's Pinocchio model factory
(ocs2_bipedal_robot/src/BipedalRobotInterface.cpp:117 createPinocchioInterface):
parse the URDF tree, keep the requested actuated joints as moving joints,
weld every other joint at a configurable lock position (default 0, matching
the reference's reduced model), and fold welded-subtree inertias into their
nearest moving ancestor body.

Output is a :class:`RobotDescription` of plain numpy arrays that
:mod:`bipedal_control_tpu_torch.model.robot_model` lifts into tensors.
This module is numpy-only and identical in both packages (the port keeps its
own copy so that it never imports the JAX package).

Conventions:
- body i (i >= 1) is the child link of moving joint i; its frame is the URDF
  child-link frame (joint frame): ``T_child = T_parent @ T_offset @ Motion(axis, q_i)``.
- body 0 is the root link, positioned by the floating base
  ``[xyz, euler-zyx]`` (see utils.rotations for the velocity convention).
- every URDF link (welded or not) is retained as a named *frame* attached to
  its nearest moving ancestor body — contact frames such as
  ``left_sole_1_link`` stay addressable.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np

JOINT_REVOLUTE = 0
JOINT_PRISMATIC = 1


def _rpy_to_rotmat_np(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _axis_angle_rotmat(axis, angle):
    axis = np.asarray(axis, dtype=float)
    n = np.linalg.norm(axis)
    if n == 0.0:
        return np.eye(3)
    a = axis / n
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


@dataclasses.dataclass
class _UrdfJoint:
    name: str
    jtype: str
    parent: str
    child: str
    origin_R: np.ndarray
    origin_p: np.ndarray
    axis: np.ndarray
    limit_lower: float
    limit_upper: float
    limit_effort: float
    limit_velocity: float


@dataclasses.dataclass
class _UrdfLink:
    name: str
    mass: float
    com: np.ndarray
    inertia: np.ndarray  # 3x3 about com, in link frame


@dataclasses.dataclass
class RobotDescription:
    """Reduced model arrays; see module docstring for conventions."""

    name: str
    joint_names: list[str]  # moving joints, order = body order 1..n
    # per moving joint i (index 0 <-> body 1):
    joint_parent_body: np.ndarray  # (nj,) int, parent body index
    joint_type: np.ndarray  # (nj,) int (JOINT_REVOLUTE/JOINT_PRISMATIC)
    joint_offset_R: np.ndarray  # (nj,3,3) parent-body -> joint frame rotation
    joint_offset_p: np.ndarray  # (nj,3)
    joint_axis: np.ndarray  # (nj,3) in joint(child) frame
    joint_limit_lower: np.ndarray  # (nj,)
    joint_limit_upper: np.ndarray  # (nj,)
    joint_limit_effort: np.ndarray  # (nj,)
    joint_limit_velocity: np.ndarray  # (nj,)
    # per body b in 0..nj (0 = root):
    body_mass: np.ndarray  # (nb,)
    body_com: np.ndarray  # (nb,3) in body frame
    body_inertia: np.ndarray  # (nb,3,3) about com, body frame
    # named frames:
    frame_names: list[str]
    frame_body: np.ndarray  # (nf,) int
    frame_R: np.ndarray  # (nf,3,3) body -> frame
    frame_p: np.ndarray  # (nf,3)

    @property
    def num_joints(self) -> int:
        return len(self.joint_names)

    @property
    def num_bodies(self) -> int:
        return self.num_joints + 1

    def frame_index(self, name: str) -> int:
        return self.frame_names.index(name)

    @property
    def total_mass(self) -> float:
        return float(np.sum(self.body_mass))


def _parse_urdf_xml(urdf_text: str):
    root = ET.fromstring(urdf_text)
    robot_name = root.get("name", "robot")
    links: dict[str, _UrdfLink] = {}
    for link_el in root.findall("link"):
        name = link_el.get("name")
        inertial = link_el.find("inertial")
        if inertial is None:
            links[name] = _UrdfLink(name, 0.0, np.zeros(3), np.zeros((3, 3)))
            continue
        origin = inertial.find("origin")
        xyz = np.zeros(3)
        rpy = np.zeros(3)
        if origin is not None:
            if origin.get("xyz"):
                xyz = np.array([float(v) for v in origin.get("xyz").split()])
            if origin.get("rpy"):
                rpy = np.array([float(v) for v in origin.get("rpy").split()])
        mass = float(inertial.find("mass").get("value"))
        in_el = inertial.find("inertia")
        I = np.array(
            [
                [float(in_el.get("ixx")), float(in_el.get("ixy", 0)), float(in_el.get("ixz", 0))],
                [float(in_el.get("ixy", 0)), float(in_el.get("iyy")), float(in_el.get("iyz", 0))],
                [float(in_el.get("ixz", 0)), float(in_el.get("iyz", 0)), float(in_el.get("izz"))],
            ]
        )
        # inertia tensor is given about the com in the inertial-origin frame;
        # rotate it into the link frame.
        R_li = _rpy_to_rotmat_np(rpy)
        links[name] = _UrdfLink(name, mass, xyz, R_li @ I @ R_li.T)

    joints: list[_UrdfJoint] = []
    for j_el in root.findall("joint"):
        jtype = j_el.get("type")
        origin = j_el.find("origin")
        xyz = np.zeros(3)
        rpy = np.zeros(3)
        if origin is not None:
            if origin.get("xyz"):
                xyz = np.array([float(v) for v in origin.get("xyz").split()])
            if origin.get("rpy"):
                rpy = np.array([float(v) for v in origin.get("rpy").split()])
        axis = np.array([1.0, 0.0, 0.0])
        axis_el = j_el.find("axis")
        if axis_el is not None and axis_el.get("xyz"):
            axis = np.array([float(v) for v in axis_el.get("xyz").split()])
        limit_el = j_el.find("limit")
        lo, hi, eff, vel = -np.inf, np.inf, np.inf, np.inf
        if limit_el is not None:
            lo = float(limit_el.get("lower", -np.inf))
            hi = float(limit_el.get("upper", np.inf))
            eff = float(limit_el.get("effort", np.inf))
            vel = float(limit_el.get("velocity", np.inf))
        joints.append(
            _UrdfJoint(
                name=j_el.get("name"),
                jtype=jtype,
                parent=j_el.find("parent").get("link"),
                child=j_el.find("child").get("link"),
                origin_R=_rpy_to_rotmat_np(rpy),
                origin_p=xyz,
                axis=axis,
                limit_lower=lo,
                limit_upper=hi,
                limit_effort=eff,
                limit_velocity=vel,
            )
        )
    return robot_name, links, joints


def build_reduced_model(
    urdf_text: str,
    actuated_joint_names: list[str],
    locked_joint_positions: dict[str, float] | None = None,
    extra_frames: dict[str, tuple[str, tuple[float, float, float]]] | None = None,
) -> RobotDescription:
    """Build the reduced floating-base model (see module docstring).

    extra_frames: name -> (parent link, xyz offset) massless frames to attach
    (e.g. toe/heel contact points for robots whose URDF lacks sole links,
    like the Unitree G1).
    """
    locked_joint_positions = locked_joint_positions or {}
    robot_name, links, joints = _parse_urdf_xml(urdf_text)

    children_of: dict[str, list[_UrdfJoint]] = {}
    child_links = set()
    for j in joints:
        children_of.setdefault(j.parent, []).append(j)
        child_links.add(j.child)
    roots = [name for name in links if name not in child_links]
    if len(roots) != 1:
        # 'world'-style massless roots connected by floating joints would land
        # here; pick the first root that has outgoing joints.
        roots = [r for r in roots if r in children_of]
    root_link = roots[0]

    for jn in actuated_joint_names:
        if not any(j.name == jn for j in joints):
            raise ValueError(f"actuated joint '{jn}' not found in URDF")

    actuated = set(actuated_joint_names)

    # Traverse; build bodies in encounter order first.
    joint_parent_body: list[int] = []
    joint_rows: list[_UrdfJoint] = []
    body_links: list[str] = [root_link]  # body index -> defining link name
    frames: list[tuple[str, int, np.ndarray, np.ndarray]] = []

    def visit(link_name: str, body_idx: int, R_acc: np.ndarray, p_acc: np.ndarray):
        """Record `link_name` as a frame on body `body_idx` at (R_acc, p_acc),
        then recurse through its child joints."""
        frames.append((link_name, body_idx, R_acc.copy(), p_acc.copy()))
        for j in children_of.get(link_name, []):
            R_j = R_acc @ j.origin_R
            p_j = p_acc + R_acc @ j.origin_p
            if j.name in actuated:
                if j.jtype not in ("revolute", "continuous", "prismatic"):
                    raise ValueError(f"actuated joint {j.name} has type {j.jtype}")
                new_body = len(body_links)
                body_links.append(j.child)
                jj = dataclasses.replace(j, origin_R=R_j, origin_p=p_j)
                joint_rows.append(jj)
                joint_parent_body.append(body_idx)
                visit(j.child, new_body, np.eye(3), np.zeros(3))
            else:
                # weld (fixed, or locked non-fixed at its lock position)
                if j.jtype in ("revolute", "continuous"):
                    R_j = R_j @ _axis_angle_rotmat(j.axis, locked_joint_positions.get(j.name, 0.0))
                elif j.jtype == "prismatic":
                    p_j = p_j + R_j @ (j.axis * locked_joint_positions.get(j.name, 0.0))
                elif j.jtype not in ("fixed", "floating"):
                    raise ValueError(f"unsupported joint type {j.jtype}")
                visit(j.child, body_idx, R_j, p_j)

    visit(root_link, 0, np.eye(3), np.zeros(3))

    for fname, (parent_link, xyz) in (extra_frames or {}).items():
        hit = [(n, b, R, p) for (n, b, R, p) in frames if n == parent_link]
        if not hit:
            raise ValueError(f"extra frame parent link '{parent_link}' not found")
        _, b, R, p = hit[0]
        frames.append((fname, b, R.copy(), p + R @ np.asarray(xyz, dtype=float)))

    # Reorder moving joints to the requested order (must stay topological).
    order = [next(i for i, j in enumerate(joint_rows) if j.name == name) for name in actuated_joint_names]
    old_to_new_body = {0: 0}
    for new_i, old_i in enumerate(order):
        old_to_new_body[old_i + 1] = new_i + 1
    new_parent = []
    for new_i, old_i in enumerate(order):
        p_old = joint_parent_body[old_i]
        p_new = old_to_new_body[p_old]
        if p_new > new_i:
            raise ValueError(
                "actuated joint order is not topological: "
                f"{actuated_joint_names[new_i]} listed before its parent joint"
            )
        new_parent.append(p_new)
    joint_rows = [joint_rows[i] for i in order]
    joint_parent_body_arr = np.array(new_parent, dtype=np.int32)
    frames = [(n, old_to_new_body[b], R, p) for (n, b, R, p) in frames]

    nb = len(body_links)
    body_mass = np.zeros(nb)
    body_com_weighted = np.zeros((nb, 3))
    # accumulate inertia about each body origin, then shift to combined com
    body_inertia_origin = np.zeros((nb, 3, 3))
    for name, b, R, p in frames:
        link = links.get(name)  # extra (massless) frames have no link entry
        if link is None or link.mass == 0.0:
            continue
        c_w = R @ link.com + p  # com in body frame
        I_b = R @ link.inertia @ R.T  # about link com, body-frame axes
        body_mass[b] += link.mass
        body_com_weighted[b] += link.mass * c_w
        d = c_w
        # parallel axis: about body origin
        body_inertia_origin[b] += I_b + link.mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    body_com = np.where(body_mass[:, None] > 0, body_com_weighted / np.maximum(body_mass[:, None], 1e-12), 0.0)
    body_inertia = np.zeros((nb, 3, 3))
    for b in range(nb):
        d = body_com[b]
        body_inertia[b] = body_inertia_origin[b] - body_mass[b] * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    type_code = {"revolute": JOINT_REVOLUTE, "continuous": JOINT_REVOLUTE, "prismatic": JOINT_PRISMATIC}
    return RobotDescription(
        name=robot_name,
        joint_names=[j.name for j in joint_rows],
        joint_parent_body=joint_parent_body_arr,
        joint_type=np.array([type_code[j.jtype] for j in joint_rows], dtype=np.int32),
        joint_offset_R=np.stack([j.origin_R for j in joint_rows]) if joint_rows else np.zeros((0, 3, 3)),
        joint_offset_p=np.stack([j.origin_p for j in joint_rows]) if joint_rows else np.zeros((0, 3)),
        joint_axis=np.stack([j.axis / np.linalg.norm(j.axis) for j in joint_rows]) if joint_rows else np.zeros((0, 3)),
        joint_limit_lower=np.array([j.limit_lower for j in joint_rows]),
        joint_limit_upper=np.array([j.limit_upper for j in joint_rows]),
        joint_limit_effort=np.array([j.limit_effort for j in joint_rows]),
        joint_limit_velocity=np.array([j.limit_velocity for j in joint_rows]),
        body_mass=body_mass,
        body_com=body_com,
        body_inertia=body_inertia,
        frame_names=[f[0] for f in frames],
        frame_body=np.array([f[1] for f in frames], dtype=np.int32),
        frame_R=np.stack([f[2] for f in frames]),
        frame_p=np.stack([f[3] for f in frames]),
    )


def load_urdf(
    path: str, actuated_joint_names: list[str], locked_joint_positions=None, extra_frames=None
) -> RobotDescription:
    with open(path) as f:
        return build_reduced_model(
            f.read(), actuated_joint_names, locked_joint_positions, extra_frames
        )

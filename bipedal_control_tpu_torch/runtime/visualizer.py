"""Trajectory / marker visualizer — BipedalRobotVisualizer equivalent
(runtime/visualizer.py counterpart).

The reference publishes rviz TF + markers per control tick, throttled by
maxUpdateFrequency (ocs2_bipedal_robot_ros/src/visualization/
BipedalRobotVisualizer.cpp:65-411): foot positions, contact forces, center
of pressure, support polygon, and the desired + optimized base trajectories.

Without a ROS graph, the port records the same marker set (throttled
`update`, like the reference's minPublishTimeDifference_) and
renders/exports it after the run.  Each frame's kinematics run on the
model's device and reach the host in one copy; the frames are numpy:

- :meth:`Visualizer.save_figure` — multi-panel matplotlib figure (base
  trajectory desired-vs-actual, foot heights vs swing references, contact
  force profiles, CoP + support polygon footprint);
- :meth:`Visualizer.export_json` — raw marker frames (the "topic" analog)
  for external tooling.

Driven by `cli plan --viz out.png` and usable around any controller loop.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..model.centroidal import (
    CentroidalModelInfo,
    contact_positions,
    get_contact_forces,
    get_generalized_coordinates,
)
from ..model.kinematics import forward_kinematics
from ..model.robot_model import RobotModel
from ..utils.rotations import zyx_from_rotmat


@dataclasses.dataclass
class MarkerFrame:
    t: float
    base_pose: np.ndarray  # (6,) xyz + zyx
    foot_positions: np.ndarray  # (nc, 3)
    contact_forces: np.ndarray  # (nc, 3)
    contact_flags: np.ndarray  # (nc,)
    cop: np.ndarray  # (3,) nan when airborne
    desired_base: np.ndarray | None = None  # (6,)
    # full TF tree (record_tf=True): world placement of every body frame,
    # the robot_state_publisher/TF analogue of the reference visualizer
    body_names: list | None = None
    body_positions: np.ndarray | None = None  # (nb, 3)
    body_orientations_zyx: np.ndarray | None = None  # (nb, 3)


def center_of_pressure(foot_positions, forces):
    """CoP of the normal-force distribution (reference cpp:303-317 semantics)."""
    fz = np.maximum(np.asarray(forces)[:, 2], 0.0)
    total = fz.sum()
    if total <= 1e-9:
        return np.full(3, np.nan)
    return (np.asarray(foot_positions) * fz[:, None]).sum(axis=0) / total


class Visualizer:
    """Throttled marker recorder + offline renderer."""

    def __init__(
        self,
        model: RobotModel,
        info: CentroidalModelInfo,
        max_update_frequency: float = 100.0,
        record_tf: bool = False,
    ):
        self.model = model
        self.info = info
        self.min_dt = 1.0 / max_update_frequency
        self._last_t = -np.inf
        self.record_tf = record_tf
        self.frames: list[MarkerFrame] = []

    def _markers(self, x, u):
        """(base pose (6,), feet (nc, 3), forces (nc, 3), body positions
        (nb, 3) and zyx (nb, 3) or None) of one state and input, computed on
        the model's device; the state and input go there in one copy and
        the markers come back in one."""
        model, info = self.model, self.info
        nx, nc, nb = info.state_dim, info.num_contacts, model.nb
        xu_host = np.concatenate([_host(x), _host(u)])
        xu = torch.as_tensor(xu_host, dtype=model.dtype, device=model.body_mass.device)
        x, u = xu[:nx], xu[nx:]
        q = get_generalized_coordinates(x)
        parts = [contact_positions(model, info, q).reshape(-1), get_contact_forces(u, info).reshape(-1)]
        if self.record_tf:
            # the whole tree's placements, in the same copy
            kin = forward_kinematics(model, q)
            parts += [kin.p.reshape(-1), zyx_from_rotmat(kin.R).reshape(-1)]
        flat = torch.cat(parts).to(device="cpu", dtype=torch.float64).numpy()
        feet, forces = flat[: 3 * nc].reshape(nc, 3), flat[3 * nc : 6 * nc].reshape(nc, 3)
        tf_pos = tf_zyx = None
        if self.record_tf:
            tf_pos = flat[6 * nc : 6 * nc + 3 * nb].reshape(nb, 3)
            tf_zyx = flat[6 * nc + 3 * nb :].reshape(nb, 3)
        return xu_host[6:12].copy(), feet, forces, tf_pos, tf_zyx

    def update(self, t, x, u, contact_flags=None, desired_state=None):
        """Record one frame (throttled). x: centroidal state, u: input
        (numpy or tensors on any device)."""
        t = float(t)
        if t - self._last_t < self.min_dt:
            return
        self._last_t = t
        base_pose, feet, forces, tf_pos, tf_zyx = self._markers(x, u)
        flags = (
            np.asarray(contact_flags)
            if contact_flags is not None
            else (forces[:, 2] > 1.0).astype(float)
        )
        tf_names = None
        if self.record_tf:
            tf_names = ["base"] + [f"{j}_child" for j in self.model.joint_names]
        self.frames.append(
            MarkerFrame(
                t=t,
                base_pose=base_pose,
                foot_positions=feet,
                contact_forces=forces,
                contact_flags=flags,
                cop=center_of_pressure(feet, forces),
                desired_base=None if desired_state is None else _host(desired_state)[6:12].copy(),
                body_names=tf_names,
                body_positions=tf_pos,
                body_orientations_zyx=tf_zyx,
            )
        )

    # ------------------------------------------------------------- exports
    def export_json(self, path: str) -> None:
        def enc(f: MarkerFrame):
            d = dataclasses.asdict(f)
            return {
                k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in d.items()
            }

        with open(path, "w") as fh:
            json.dump({"frames": [enc(f) for f in self.frames]}, fh)

    def save_figure(self, path: str, swing_refs=None) -> None:
        """Render the recorded markers to a multi-panel figure.

        swing_refs: optional (times (T,), z_ref (T, nc)) overlay of the swing
        planner's z-references (the zero-velocity/normal-velocity targets).
        """
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if not self.frames:
            raise ValueError("no frames recorded")
        ts = np.array([f.t for f in self.frames])
        base = np.stack([f.base_pose for f in self.frames])
        feet = np.stack([f.foot_positions for f in self.frames])  # (T, nc, 3)
        forces = np.stack([f.contact_forces for f in self.frames])
        cops = np.stack([f.cop for f in self.frames])
        des = (
            np.stack([f.desired_base for f in self.frames])
            if self.frames[0].desired_base is not None
            else None
        )

        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        ax = axes[0, 0]
        ax.plot(base[:, 0], base[:, 1], label="base xy")
        if des is not None:
            ax.plot(des[:, 0], des[:, 1], "--", label="desired xy")
        ax.plot(cops[:, 0], cops[:, 1], ":", alpha=0.7, label="CoP")
        # support polygon footprint at the last frame (stance feet hull)
        last = self.frames[-1]
        stance = last.foot_positions[last.contact_flags > 0.5]
        if len(stance) >= 3:
            hull = _convex_hull_2d(stance[:, :2])
            poly = np.vstack([hull, hull[:1]])
            ax.plot(poly[:, 0], poly[:, 1], "k-", lw=0.8, label="support polygon")
        elif len(stance) > 0:
            ax.plot(stance[:, 0], stance[:, 1], "k.", label="stance feet")
        ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.legend(fontsize=7)
        ax.set_title("base path / CoP / support polygon")

        ax = axes[0, 1]
        ax.plot(ts, base[:, 2], label="base z")
        if des is not None:
            ax.plot(ts, des[:, 2], "--", label="desired z")
        ax.set_xlabel("t [s]"); ax.set_ylabel("z [m]"); ax.legend(fontsize=7)
        ax.set_title("base height")

        ax = axes[1, 0]
        names = ["LT", "LH", "RT", "RH"]
        for c in range(feet.shape[1]):
            ax.plot(ts, feet[:, c, 2], label=f"foot {names[c % 4]}")
        if swing_refs is not None:
            rt, rz = swing_refs
            for c in range(rz.shape[1]):
                ax.plot(rt, rz[:, c], "--", alpha=0.5)
        ax.set_xlabel("t [s]"); ax.set_ylabel("z [m]"); ax.legend(fontsize=7, ncol=2)
        ax.set_title("foot heights (vs swing refs)")

        ax = axes[1, 1]
        for c in range(forces.shape[1]):
            ax.plot(ts, forces[:, c, 2], label=f"Fz {names[c % 4]}")
        ax.set_xlabel("t [s]"); ax.set_ylabel("Fz [N]"); ax.legend(fontsize=7, ncol=2)
        ax.set_title("contact normal forces")

        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)


def _convex_hull_2d(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain (tiny point sets; no scipy dependency)."""
    pts = np.unique(np.asarray(pts), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross_z(a, b):
        return a[0] * b[1] - a[1] * b[0]

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2 and cross_z(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def _host(a) -> np.ndarray:
    """A float64 numpy copy of an array or tensor (on any device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device="cpu", dtype=torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)

"""Host MuJoCo simulation backend — the bipedal_mujoco equivalent
(sim/mujoco_backend.py counterpart, a copy: numpy and MuJoCo on the host,
on the port's JointCommand and cheater estimator).

Runs the robot's MJCF scene (e.g. the reference's
h1_description/mjcf/scene.xml) as the physics ground truth, applying hybrid
joint commands exactly like BipedalMujocoHW::write
(bipedal_mujoco/src/hw/BipedalMujocoHW.cpp:206-218):

    ctrl = tau_ff + kp (posDes - q) + kd (velDes - dq)

re-evaluated every physics substep, with an optional actuation delay buffer
replicating the Gazebo backend's 9 ms command latency
(bipedal_gazebo/src/BipedalHWSim.cpp:160-178).  Ground truth (base pose/twist)
feeds the cheater estimator; IMU/joint sensor readouts are also exposed for
the Kalman estimator path.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from ..runtime.controller import JointCommand


@dataclasses.dataclass
class MujocoSimConfig:
    physics_substeps_per_control: int = 1
    command_delay_s: float = 0.0  # 0.009 replicates the Gazebo delay buffer
    # Gazebo read-path fidelity (BipedalHWSim::readSim, BipedalHWSim.cpp:88-158):
    # - joint velocities are FINITE-DIFFERENCED from positions between reads
    #   (with shortest-angular-distance accumulation for revolute joints),
    #   not read from the simulator's velocity state;
    # - the IMU is SYNTHESIZED from the base link state (orientation, local
    #   angular rate, local linear acceleration minus rotated gravity)
    #   instead of MJCF sensor elements;
    # - a command is consumed ONCE: stepping again without a fresh
    #   apply_command() zeroes the actuation ("set cmd to zero to avoid
    #   crazy soft limit oscillation when no controller loaded").
    gazebo_semantics: bool = False


def _load_mj_model(mujoco, mjcf_path: str):
    """Load an MJCF scene; fall back to a virtual-asset load when relative
    meshdir resolution fails (MuJoCo does not apply an included file's
    meshdir to the including scene — bites the reference's OpenLoong
    scene.xml, whose AzureLoong.xml declares meshdir="../meshes/")."""
    import os

    try:
        return mujoco.MjModel.from_xml_path(mjcf_path)
    except ValueError:
        base = os.path.dirname(os.path.abspath(mjcf_path))
        assets: dict[str, bytes] = {}
        for d, prefix in [
            (base, ""),
            (os.path.join(base, "asset"), "asset/"),
            (os.path.join(base, "..", "meshes"), "../meshes/"),
            (os.path.join(base, "meshes"), "meshes/"),
        ]:
            if not os.path.isdir(d):
                continue
            for f in os.listdir(d):
                p = os.path.join(d, f)
                # register under the exact key the XML resolves to (meshdir
                # prefix + name); MuJoCo flags stripped-basename collisions,
                # so one key per file
                if os.path.isfile(p):
                    with open(p, "rb") as fh:
                        assets[prefix + f] = fh.read()
        # the reference ships broken asset sets (OpenLoong references
        # base_link.STL which exists nowhere in the tree) — substitute a
        # placeholder box mesh for missing references so the scene loads
        # (bodies carry explicit <inertial> elements, so collision/visual
        # placeholder geometry does not change the dynamics parameters)
        import re

        with open(mjcf_path) as fh:
            xml = fh.read()
        referenced = set(re.findall(r'file="([^"]+)"', xml))
        for a in list(assets):
            if a.endswith(".xml"):
                referenced |= {
                    m.decode() for m in re.findall(rb'file="([^"]+)"', assets[a])
                }
        have = {k.split("/")[-1].lower() for k in assets}
        for ref in referenced:
            base_name = ref.split("/")[-1]
            if base_name.lower() not in have and base_name.lower().endswith(".stl"):
                assets[ref] = _placeholder_box_stl()
        return mujoco.MjModel.from_xml_string(xml, assets)


def _placeholder_box_stl(half: float = 0.12) -> bytes:
    """Binary STL of an axis-aligned box (stand-in for missing meshes)."""
    import struct

    h = half
    corners = [
        (sx * h, sy * h, sz * h)
        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
    ]
    # 12 triangles over the 6 faces (indices into corners)
    faces = [
        (0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),  # x faces
        (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),  # y faces
        (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3),  # z faces
    ]
    out = bytearray(b"\x00" * 80)
    out += struct.pack("<I", len(faces))
    for f in faces:
        out += struct.pack("<3f", 0.0, 0.0, 0.0)  # normal (recomputed by mj)
        for idx in f:
            out += struct.pack("<3f", *corners[idx])
        out += struct.pack("<H", 0)
    return bytes(out)


class MujocoSimBackend:
    def __init__(self, mjcf_path: str, joint_names: list[str], cfg: MujocoSimConfig | None = None):
        import mujoco

        self._mj = mujoco
        self.model = _load_mj_model(mujoco, mjcf_path)
        self.data = mujoco.MjData(self.model)
        self.cfg = cfg or MujocoSimConfig()
        self.joint_names = joint_names
        # actuator/joint address maps for our joint ordering
        self._act_ids, self._qadr, self._dadr = [], [], []
        # actuators resolve through their transmission joint, not by name
        # (H1 names actuators after joints; OpenLoong uses M_* names)
        act_by_joint = {
            int(self.model.actuator_trnid[a, 0]): a for a in range(self.model.nu)
        }
        for name in joint_names:
            jid = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_JOINT, name)
            if jid < 0:
                raise ValueError(f"joint {name} not in model")
            self._qadr.append(self.model.jnt_qposadr[jid])
            self._dadr.append(self.model.jnt_dofadr[jid])
            if jid not in act_by_joint:
                raise ValueError(f"no actuator drives joint {name}")
            self._act_ids.append(act_by_joint[jid])
        self._qadr = np.asarray(self._qadr)
        self._dadr = np.asarray(self._dadr)
        # extra actuators (upper body etc.) not driven by the main controller
        self._other_act = [
            a for a in range(self.model.nu) if a not in self._act_ids
        ]
        self._other_act_joint = []
        for a in self._other_act:
            jid = self.model.actuator_trnid[a, 0]
            self._other_act_joint.append(
                (a, self.model.jnt_qposadr[jid], self.model.jnt_dofadr[jid])
            )
        self._cmd: JointCommand | None = None
        self._upper_targets: dict[int, float] = {}
        delay_steps = int(round(self.cfg.command_delay_s / self.model.opt.timestep))
        self._delay_queue = collections.deque(maxlen=max(1, delay_steps + 1))

    # ------------------------------------------------------------------
    @property
    def time(self) -> float:
        return float(self.data.time)

    @property
    def timestep(self) -> float:
        return float(self.model.opt.timestep)

    def reset(self, base_pos, base_quat_wxyz, joint_pos, upper_joint_targets=None):
        self._mj.mj_resetData(self.model, self.data)
        self.data.qpos[0:3] = base_pos
        self.data.qpos[3:7] = base_quat_wxyz
        for adr, q in zip(self._qadr, joint_pos):
            self.data.qpos[adr] = q
        if upper_joint_targets:
            for name, q in upper_joint_targets.items():
                jid = self._mj.mj_name2id(self.model, self._mj.mjtObj.mjOBJ_JOINT, name)
                if jid >= 0:
                    self.data.qpos[self.model.jnt_qposadr[jid]] = q
                    self._upper_targets[jid] = q
        self._mj.mj_forward(self.model, self.data)
        self._cmd = None
        self._delay_queue.clear()
        self._cmd_fresh = False
        self._fd_prev = None  # gazebo-semantics finite-difference state

    def apply_command(self, cmd: JointCommand) -> None:
        self._delay_queue.append(cmd)
        self._cmd_fresh = True

    def _active_command(self) -> JointCommand | None:
        if not self._delay_queue:
            return self._cmd
        if len(self._delay_queue) == self._delay_queue.maxlen or self.cfg.command_delay_s == 0.0:
            self._cmd = self._delay_queue.popleft() if self.cfg.command_delay_s > 0 else self._delay_queue[-1]
            if self.cfg.command_delay_s == 0.0:
                self._delay_queue.clear()
        return self._cmd

    def step(self, n_substeps: int = 1) -> None:
        # one step() call = one read/write cycle: under gazebo semantics a
        # command not refreshed since the previous cycle actuates NOTHING
        # (readSim zeroes the buffers; only a live controller re-fills them)
        stale = self.cfg.gazebo_semantics and not getattr(self, "_cmd_fresh", False)
        self._cmd_fresh = False
        for _ in range(n_substeps):
            cmd = None if stale else self._active_command()
            if cmd is not None:
                q = self.data.qpos[self._qadr]
                dq = self.data.qvel[self._dadr]
                tau = cmd.tau_ff + cmd.kp * (cmd.pos_des - q) + cmd.kd * (cmd.vel_des - dq)
                for aid, t in zip(self._act_ids, tau):
                    lo, hi = self.model.actuator_ctrlrange[aid]
                    self.data.ctrl[aid] = np.clip(t, lo, hi)
            elif stale:
                # ctrl persists in MuJoCo; the readSim zeroing must clear it
                for aid in self._act_ids:
                    self.data.ctrl[aid] = 0.0
            # hold the upper body at its targets (UpperJointController
            # semantics, kp=100 kd=3, UpperJointController.cpp:31-118)
            for aid, qadr, dadr in self._other_act_joint:
                jid = self.model.actuator_trnid[aid, 0]
                q_t = self._upper_targets.get(jid, 0.0)
                lo, hi = self.model.actuator_ctrlrange[aid]
                self.data.ctrl[aid] = np.clip(
                    100.0 * (q_t - self.data.qpos[qadr]) - 3.0 * self.data.qvel[dadr], lo, hi
                )
            self._mj.mj_step(self.model, self.data)

    # ------------------------------------------------------------------
    def ground_truth(self):
        """(pos, quat_wxyz, v_world, omega_world) of the floating base
        (the /ground_truth/state odom of BipedalMujocoHW.cpp:159-203)."""
        pos = self.data.qpos[0:3].copy()
        quat = self.data.qpos[3:7].copy()
        v_world = self.data.qvel[0:3].copy()
        # mujoco free-joint angular velocity is body-local
        R = np.zeros(9)
        self._mj.mju_quat2Mat(R, quat)
        omega_world = R.reshape(3, 3) @ self.data.qvel[3:6]
        return pos, quat, v_world, omega_world

    def joint_states(self):
        """(q_j, dq_j).  Under gazebo_semantics, velocities are FINITE
        DIFFERENCES of the position readout between successive calls (the
        reference hardware sim never reads simulator velocities —
        BipedalHWSim.cpp:90-96), with zero velocity on the first read."""
        q = self.data.qpos[self._qadr].copy()
        if not self.cfg.gazebo_semantics:
            return q, self.data.qvel[self._dadr].copy()
        t = self.time
        prev = getattr(self, "_fd_prev", None)
        if prev is None or t <= prev[0]:
            dq = np.zeros_like(q)
        else:
            dq = (q - prev[1]) / (t - prev[0])
        self._fd_prev = (t, q.copy())
        return q, dq

    def rbd_state(self, last_yaw=None) -> np.ndarray:
        """Cheater-estimator rbdState straight from ground truth."""
        from ..estim.cheater import rbd_state_from_ground_truth

        pos, quat, v, w = self.ground_truth()
        qj, dqj = self.joint_states()
        return np.asarray(
            rbd_state_from_ground_truth(pos, quat, v, w, qj, dqj, last_yaw=last_yaw)
        )

    def contact_flags_by_side(self, left_body: str, right_body: str) -> np.ndarray:
        """(4,) measured contact flags in the framework's contact order
        [left_toe, left_heel, right_toe, right_heel]: each side's pair reads
        1.0 when any active MuJoCo contact touches a geom on that side's
        foot body (or its subtree).

        The reference plumbs a ContactSensorInterface but never wires it
        (BipedalHW.cpp contact interface TODO-disabled; the controller
        hardcodes STANCE flags, BipedalController.cpp:372-377).  This is the
        working readout — feed it to
        BipedalController.update_from_sensors(contact_flags_meas=...)."""
        m, d = self.model, self.data
        sides = np.zeros(2)
        ids = [
            self._mj.mj_name2id(m, self._mj.mjtObj.mjOBJ_BODY, n)
            for n in (left_body, right_body)
        ]
        for i in range(d.ncon):
            con = d.contact[i]
            for g in (con.geom1, con.geom2):
                b = int(m.geom_bodyid[g])
                # ascend the tree from the geom's body to a named foot body
                while b > 0:
                    if b in ids:
                        sides[ids.index(b)] = 1.0
                        break
                    b = int(m.body_parentid[b])
        return np.array([sides[0], sides[0], sides[1], sides[1]])

    # the reference's two MJCF sensor naming schemes:
    # H1 (h1.xml:290-292) and OpenLoong (AzureLoong.xml:416-419)
    _IMU_ALIASES = {
        "imu_quat": ("imu_quat", "baselink-quat"),
        "imu_gyro": ("imu_gyro", "baselink-gyro"),
        "imu_acc": ("imu_acc", "baselink-baseAcc"),
    }

    def imu(self):
        """(quat_wxyz, gyro_local, accel_local) from the MJCF IMU sensors when
        present, else synthesized from ground truth.  Under gazebo_semantics
        the synthesized path is ALWAYS used — the reference's hardware sim
        builds its IMU from the base link state, not sensor plugins
        (BipedalHWSim.cpp:106-124): orientation from the link pose, angular
        rate in the link frame, and specific force R^T (a_world - g)."""
        if self.cfg.gazebo_semantics:
            return self._imu_from_link_state()
        m, d = self.model, self.data
        out = {}
        for key, names in self._IMU_ALIASES.items():
            for name in names:
                sid = self._mj.mj_name2id(m, self._mj.mjtObj.mjOBJ_SENSOR, name)
                if sid >= 0:
                    adr, dim = m.sensor_adr[sid], m.sensor_dim[sid]
                    out[key] = d.sensordata[adr : adr + dim].copy()
                    break
        if len(out) < 3:
            out = {**self._imu_from_link_state(), **out}
        return out

    def _imu_from_link_state(self):
        """Synthesize the IMU triple from the floating base's state: the
        accelerometer's specific force uses the base linear acceleration
        from the dynamics (mjData.qacc after the step) minus gravity,
        rotated into the base frame."""
        pos, quat, v_world, omega_world = self.ground_truth()
        R = np.zeros(9)
        self._mj.mju_quat2Mat(R, quat)
        R = R.reshape(3, 3)
        gyro_local = R.T @ omega_world
        a_world = self.data.qacc[0:3].copy()
        accel_local = R.T @ (a_world - np.array([0.0, 0.0, -9.81]))
        return {
            "imu_quat": quat.copy(),
            "imu_gyro": gyro_local,
            "imu_acc": accel_local,
        }

"""PyTorch port vs JAX reference: the MuJoCo simulators (sim/urdf_mjcf.py,
sim/mujoco_backend.py, sim/terrain.py, sim/interactive.py), the visualizer
(runtime/visualizer.py) and the controller closed in MuJoCo, float64 on the
CPU.

The plant is tests/data/g1_shaped_biped_feet.urdf (the synthetic G1-shaped
biped with four sole spheres at g1_task.info's sole frames) made into a
scene by each package's generator, with motors on all 23 revolute joints so
that the backend holds the upper body, and an armature of 0.01 kg m^2 on
them: without it the explicit PD's kd of 5 on the ankle roll's 2e-4 kg m^2
rings the joint to ~100 rad/s within 4 ms at the 1 ms step, in both
packages.  The controllers' model is built from g1_shaped_biped.urdf, as
everywhere else.  One MuJoCo runs both packages' plants, so the backends
agree to the last bit; the closed loops meet the controller's batched-parity
bar (1e-5 relative to max(1, max|ref|)).  Inputs are drawn from seeded numpy
generators.  The reference's runner is built once per module, so its
replans compile once.
"""
import dataclasses
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from bipedal_control_tpu.interface import make_interface as j_make_interface  # noqa: E402
from bipedal_control_tpu.reference.target import cmd_vel_to_target_trajectories as j_cmd_vel  # noqa: E402
from bipedal_control_tpu.runtime.controller import BipedalController as JBipedalController  # noqa: E402
from bipedal_control_tpu.runtime.controller import ControllerConfig as JControllerConfig  # noqa: E402
from bipedal_control_tpu.runtime.controller import JointCommand as JJointCommand  # noqa: E402
from bipedal_control_tpu.runtime.mpc_runner import MpcRunner as JMpcRunner  # noqa: E402
from bipedal_control_tpu.runtime.visualizer import Visualizer as JVisualizer  # noqa: E402
from bipedal_control_tpu.sim import interactive as j_interactive  # noqa: E402
from bipedal_control_tpu.sim.mujoco_backend import MujocoSimBackend as JMujocoSimBackend  # noqa: E402
from bipedal_control_tpu.sim.mujoco_backend import MujocoSimConfig as JMujocoSimConfig  # noqa: E402
from bipedal_control_tpu.sim.terrain import terrain_from_mujoco as j_terrain_from_mujoco  # noqa: E402
from bipedal_control_tpu.sim.urdf_mjcf import build_mjcf_scene_from_urdf as j_build_scene  # noqa: E402
from bipedal_control_tpu_torch.interface import make_interface, production_settings  # noqa: E402
from bipedal_control_tpu_torch.ops.linearize_kernel import make_node_linearizer  # noqa: E402
from bipedal_control_tpu_torch.ops.merit_kernel import make_merit_sums  # noqa: E402
from bipedal_control_tpu_torch.reference.target import cmd_vel_to_target_trajectories  # noqa: E402
from bipedal_control_tpu_torch.runtime.controller import BipedalController, ControllerConfig, JointCommand  # noqa: E402
from bipedal_control_tpu_torch.runtime.visualizer import Visualizer  # noqa: E402
from bipedal_control_tpu_torch.sim import interactive  # noqa: E402
from bipedal_control_tpu_torch.sim.mujoco_backend import MujocoSimBackend, MujocoSimConfig  # noqa: E402
from bipedal_control_tpu_torch.sim.terrain import terrain_from_mujoco  # noqa: E402
from bipedal_control_tpu_torch.sim.urdf_mjcf import build_mjcf_scene_from_urdf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
FEET_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped_feet.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))
SCENE_ARMATURE = 0.01  # kg m^2 on every motor joint of the test scene
FEET_BODIES = ("left_ankle_roll_link", "right_ankle_roll_link")
CONTROL_HZ = 500.0


def scene_joints() -> list[str]:
    """The test URDF's 23 revolute joints: 12 legs, 11 upper body."""
    with open(FEET_URDF) as fh:
        return re.findall(r'<joint name="([^"]+)" type="revolute"', fh.read())


def make_test_scene(build, home) -> str:
    """``build`` (either package's generator) on the test URDF, into the
    default cache under ``home``: the scene's path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(home))
        return build(FEET_URDF, scene_joints(), armature=SCENE_ARMATURE)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{package: (path, XML text)} of the generated scene, each package's
    in a cache of its own."""
    out = {}
    for pkg, build in (("jax", j_build_scene), ("port", build_mjcf_scene_from_urdf)):
        home = tmp_path_factory.mktemp(f"home_{pkg}")
        path = make_test_scene(build, home)
        assert path == os.path.join(str(home), ".cache", "bctpu_scenes", "g1_shaped_biped_feet_scene.xml")
        with open(path) as fh:
            out[pkg] = (path, fh.read().replace(str(home), "<HOME>"))
    return out


@pytest.fixture(scope="module")
def ifaces():
    """(JAX interface, port interface) of G1 on g1_shaped_biped.urdf; the
    port's with the command line's production backends."""
    t = make_interface(G1_URDF, *G1_FILES, device="cpu")
    t.settings = production_settings(t.settings, t.info)
    return j_make_interface(G1_URDF, *G1_FILES), t


@pytest.fixture(scope="module")
def j_runner(ifaces):
    """The reference's MPC runner, shared by the module's JAX controllers."""
    return JMpcRunner(ifaces[0])


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def _upper(task) -> dict:
    return dict(zip(task.upper_joint_names, task.default_upper_joint_state))


def _reset(sim, task, x0) -> None:
    sim.reset(base_pos=x0[6:9], base_quat_wxyz=np.array([1.0, 0, 0, 0]), joint_pos=x0[12:],
              upper_joint_targets=_upper(task))


# ------------------------------------------------------------------ the scene
def test_generated_scene_matches_reference(scenes):
    """The XML text is equal once each cache's home is normalised, and the
    compiled models' body, joint, geom, actuator and sensor arrays are equal;
    the scene has the four sole spheres, 23 motors and the IMU sensors."""
    assert scenes["port"][1] == scenes["jax"][1]
    models = {pkg: mujoco.MjModel.from_xml_path(path) for pkg, (path, _) in scenes.items()}
    compared = 0
    for name in dir(models["jax"]):
        if name.split("_")[0] in ("body", "jnt", "dof", "geom", "actuator", "sensor"):
            want = getattr(models["jax"], name)
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(getattr(models["port"], name), want, err_msg=name)
                compared += 1
    assert compared > 60
    m = models["port"]
    assert (m.nq, m.nu, m.nbody, m.ngeom, m.nsensor) == (30, 23, 29, 5, 3)
    spheres = [g for g in range(m.ngeom) if m.geom_type[g] == mujoco.mjtGeom.mjGEOM_SPHERE]
    assert len(spheres) == 4
    np.testing.assert_allclose(m.dof_armature[6:], SCENE_ARMATURE)


# ------------------------------------------------------------------ the backend
def _commands(rng, q0, steps: int):
    """Random hybrid joint commands around the standing pose."""
    nj = q0.size
    for _ in range(steps):
        yield (q0 + rng.normal(scale=0.05, size=nj), rng.normal(scale=0.2, size=nj),
               rng.uniform(60.0, 100.0, nj), rng.uniform(3.0, 6.0, nj), rng.normal(scale=5.0, size=nj))


def _readout(sim, last_yaw):
    """Everything the backend reports, in a fixed call order (the
    finite-differenced joint velocities are stateful)."""
    d = sim.data
    out = {"qpos": d.qpos.copy(), "qvel": d.qvel.copy(), "ctrl": d.ctrl.copy()}
    out.update({f"imu.{k}": v for k, v in sim.imu().items()})
    out["q_j"], out["dq_j"] = sim.joint_states()
    out["rbd"] = sim.rbd_state(last_yaw=last_yaw)
    out["contact"] = sim.contact_flags_by_side(*FEET_BODIES)
    out["ground_truth"] = np.concatenate(sim.ground_truth())
    return out


@pytest.mark.parametrize("delay", [0.0, 0.009])
@pytest.mark.parametrize("gazebo", [False, True])
def test_backend_matches_reference(scenes, ifaces, delay, gazebo):
    """~500 substeps (250 control steps of 2) under the same random
    commands, every readout at 1e-12; under gazebo semantics every fifth
    step sends no command, so the stale command zeroes ctrl."""
    task = ifaces[1].task
    x0 = np.asarray(ifaces[1].initial_state)
    path = scenes["port"][0]
    j_sim = JMujocoSimBackend(path, list(task.joint_names), JMujocoSimConfig(command_delay_s=delay,
                                                                              gazebo_semantics=gazebo))
    t_sim = MujocoSimBackend(path, list(task.joint_names), MujocoSimConfig(command_delay_s=delay,
                                                                           gazebo_semantics=gazebo))
    for sim in (j_sim, t_sim):
        _reset(sim, task, x0)
    contacts, stale = set(), 0
    for k, fields in enumerate(_commands(np.random.default_rng(11), x0[12:], 250)):
        if gazebo and k % 5 == 4:
            stale += 1
        else:
            j_sim.apply_command(JJointCommand(*fields))
            t_sim.apply_command(JointCommand(*fields))
        j_sim.step(2)
        t_sim.step(2)
        want, got = _readout(j_sim, 0.0), _readout(t_sim, 0.0)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-12, err_msg=f"step {k} {name}")
        contacts.add(tuple(got["contact"]))
    assert t_sim.time == pytest.approx(0.5)
    assert (1.0, 1.0, 1.0, 1.0) in contacts and stale == (50 if gazebo else 0)


# ------------------------------------------------------------------ the terrain
@pytest.fixture(scope="module")
def step_scene(scenes):
    """The test scene with an authored 5 cm step over x in [0.3, 0.7]."""
    xml = scenes["port"][1].replace(
        "<worldbody>", '<worldbody>\n    <geom name="step" type="box" pos="0.5 0 0.025" size="0.2 0.6 0.025"/>', 1)
    return mujoco.MjModel.from_xml_string(xml)


def test_terrain_map_matches_reference(step_scene):
    """The raycast map of the step scene is equal in both packages, the step
    is in it, and its bilinear height agrees at random points."""
    kw = dict(x_range=(-0.2, 1.0), y_range=(-0.3, 0.3), resolution=0.05)
    want, got = j_terrain_from_mujoco(step_scene, **kw), terrain_from_mujoco(step_scene, **kw)
    np.testing.assert_array_equal(got.z, want.z)
    assert (got.x0, got.y0, got.res) == (want.x0, want.y0, want.res)
    assert got.z.max() == pytest.approx(0.05) and got.z.min() == pytest.approx(0.0, abs=1e-12)
    for x, y in np.random.default_rng(3).uniform((-0.3, -0.4), (1.1, 0.4), (50, 2)):
        assert got.height_at(x, y) == want(x, y)


def test_terrain_feeds_references_like_reference(step_scene, ifaces):
    """ReferenceManager.freeze with the map as terrain_fn, trotting onto the
    step at 0.5 m/s: the swing splines (lift-off and touch-down heights)
    and the re-based target z at 1e-12."""
    j_iface, t_iface = ifaces
    kw = dict(x_range=(-0.5, 1.5), y_range=(-0.5, 0.5), resolution=0.05)
    j_map, t_map = j_terrain_from_mujoco(step_scene, **kw), terrain_from_mujoco(step_scene, **kw)
    x0 = np.asarray(t_iface.initial_state)
    rms = []
    for iface, tmap, cmd_vel in ((j_iface, j_map, j_cmd_vel), (t_iface, t_map, cmd_vel_to_target_trajectories)):
        rm = iface.make_reference_manager()
        rm.terrain_fn = tmap.height_at
        rm.set_gait(iface.task.gait_library["trot"], 0.1)
        rm.set_target(cmd_vel(np.array([0.5, 0.0, 0.0, 0.0]), 0.0, x0, iface.command_config, iface.info.input_dim))
        rms.append(rm)
    stepped = False
    for t in (0.0, 0.35, 0.7):
        want, got = rms[0].freeze(t), rms[1].freeze(t)
        pairs = (("swing coeffs", got.swing[0], want.swing[0]), ("swing mids", got.swing[1], want.swing[1]),
                 ("target states", got.target[1], want.target[1]), ("t_nodes", got.t_nodes, want.t_nodes))
        for name, a, b in pairs:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12, err_msg=f"t={t} {name}")
        stepped |= bool(np.asarray(want.target[1])[:, 8].max() > 0.665 + 0.04)
    assert stepped  # the target z rode the step


# ------------------------------------------------------------------ interaction
def _interaction_script(pkg):
    """tests/test_interactive.py's three cases on one package, every state
    and output after each key or query, in order."""
    log = []
    s = pkg.SimInteraction()
    for key in [32, 32] + [ord("-")] * 12 + [ord("=")] * 10:
        s.key_callback(key)
        log.append((s.paused, s.speed, s.sleep_factor(), s.noise_on))
    s = pkg.SimInteraction(push_force=100.0, push_duration=0.1)
    for key, t in ((None, 0.0), (ord("p"), 0.0), (None, 0.05), (None, 0.2), (ord("p"), 0.3), (None, 0.45)):
        if key is not None:
            s.key_callback(key)
        w = s.push_wrench(t)
        log.append(None if w is None else w.tolist())
    s = pkg.SimInteraction(noise=pkg.NoiseConfig(gyro=0.1, accel=0.5, joint_pos=0.01, joint_vel=0.1))
    imu = {"imu_quat": np.array([1.0, 0, 0, 0]), "imu_gyro": np.zeros(3), "imu_acc": np.zeros(3)}
    for key in (None, ord("n"), None, ord("N"), None):
        if key is not None:
            s.key_callback(key)
        i, q, d = s.corrupt_sensors(imu, np.zeros(5), np.zeros(5))
        log.append(({k: v.tolist() for k, v in i.items()}, q.tolist(), d.tolist(), s.noise_on))
    return log


def test_sim_interaction_matches_reference():
    """Key by key, the same states, wrenches and noise draws."""
    assert _interaction_script(interactive) == _interaction_script(j_interactive)


# ------------------------------------------------------------------ backends
@pytest.mark.parametrize("change, want", [
    ({}, ("pallas", "pallas")),
    ({"integrator": "euler"}, ("pallas", "pallas")),
    ({"exact_rk2_sensitivity": True}, ("structured", "pallas")),
    ({"integrator": "rk4"}, ("structured", "xla")),
    ("srbd", ("structured", "xla")),
])
def test_production_settings_follow_the_kernels(ifaces, change, want):
    """The command line's backends: K2+K3 always, K1 and K4 exactly where
    their wrappers take the configuration, the configuration's own backend
    where they refuse it."""
    t = ifaces[1]
    info, settings = t.info, dataclasses.replace(t.settings, linearize="structured", riccati="sequential",
                                                 merit="xla")
    if change == "srbd":
        info = dataclasses.replace(info, model_type=1)
    else:
        settings = dataclasses.replace(settings, **change)
    got = production_settings(settings, info)
    assert (got.linearize, got.merit, got.riccati) == (*want, "pallas")
    makers = {"linearize": lambda: make_node_linearizer(t.model, info, settings, t.Q, t.R, static=t.circuit),
              "merit": lambda: make_merit_sums(t.model, info, settings, static=t.circuit)}
    for name, make in makers.items():
        if getattr(got, name) == "pallas":
            make()
        else:
            with pytest.raises(NotImplementedError):
                make()


# ------------------------------------------------------------------ visualizer
@pytest.mark.parametrize("record_tf", [False, True])
def test_visualizer_matches_reference(ifaces, tmp_path, record_tf):
    """Frames at 200 Hz throttled to 50 Hz on random states and inputs near
    the stand: every frame's markers at 1e-9, the JSON exports at 1e-9, and
    save_figure writes a PNG."""
    j_iface, t_iface = ifaces
    rng = np.random.default_rng(7)
    x0 = np.asarray(t_iface.initial_state)
    nu = t_iface.info.input_dim
    j_viz = JVisualizer(j_iface.model, j_iface.info, max_update_frequency=50.0, record_tf=record_tf)
    t_viz = Visualizer(t_iface.model, t_iface.info, max_update_frequency=50.0, record_tf=record_tf)
    for k in range(40):
        x = x0 + rng.normal(scale=0.05, size=x0.shape)
        u = rng.normal(scale=5.0, size=nu)
        u[2:12:3] += rng.uniform(-20.0, 120.0, 4)  # normal forces, some below the 1 N contact threshold
        desired = x if k % 2 else None
        j_viz.update(k * 0.005, x, u, desired_state=desired)
        t_viz.update(k * 0.005, torch.as_tensor(x), torch.as_tensor(u), desired_state=desired)
    assert len(t_viz.frames) == len(j_viz.frames) >= 8
    for a, b in zip(t_viz.frames, j_viz.frames):
        for f in dataclasses.fields(b):
            want, got = getattr(b, f.name), getattr(a, f.name)
            if isinstance(want, np.ndarray):
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-9, err_msg=f.name)
            else:
                assert got == want, f.name
    paths = {name: str(tmp_path / f"{name}.json") for name in ("jax", "port")}
    j_viz.export_json(paths["jax"])
    t_viz.export_json(paths["port"])
    want, got = (json.load(open(paths[n]))["frames"] for n in ("jax", "port"))
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], list) and b[k] and not isinstance(b[k][0], str):
                np.testing.assert_allclose(np.asarray(a[k], dtype=float), np.asarray(b[k], dtype=float),
                                           rtol=0, atol=1e-9, err_msg=k)
            else:
                assert a[k] == b[k], k
    png = tmp_path / "viz.png"
    t_viz.save_figure(str(png))
    assert png.stat().st_size > 10_000


# ------------------------------------------------------------------ the closed loop
def _closed_loop(ctrl, sim, iface, ticks: int, kalman: bool, jax_in: bool):
    """``ticks`` control ticks at 500 Hz of one package's controller on its
    own plant (two 1 ms substeps per tick), in stance: per tick (tau_ff,
    pos_des, base position, quaternion, linear and angular velocity,
    safe)."""
    x0 = np.asarray(iface.initial_state)
    _reset(sim, iface.task, x0)
    as_in = jnp.asarray if jax_in else np.asarray
    if kalman:
        imu = sim.imu()
        qj, dqj = sim.joint_states()
        ctrl.starting_from_sensors(sim.time, imu["imu_quat"], imu["imu_gyro"], imu["imu_acc"], qj, dqj,
                                   base_pos_guess=sim.ground_truth()[0])
    else:
        ctrl.starting(sim.time, as_in(sim.rbd_state()))
    log = []
    for _ in range(ticks):
        if kalman:
            imu = sim.imu()
            qj, dqj = sim.joint_states()
            cmd = ctrl.update_from_sensors(sim.time, imu["imu_quat"], imu["imu_gyro"], imu["imu_acc"], qj, dqj)
        else:
            cmd = ctrl.update(sim.time, sim.rbd_state(last_yaw=ctrl.last_yaw))
        sim.apply_command(cmd)
        sim.step(2)
        log.append((np.asarray(cmd.tau_ff), np.asarray(cmd.pos_des), np.concatenate(sim.ground_truth()), ctrl.safe))
    return log


@pytest.mark.parametrize("estimator", ["cheater", "kalman"])
def test_controller_in_mujoco_matches_reference(scenes, ifaces, j_runner, estimator):
    """Each package's BipedalController (synchronous, host WBC) on its own
    MuJoCo plant of the test scene for 0.1 s at 500 Hz (5 replans), in
    stance, as the command line's sim starts: tau_ff, pos_des and the base
    state at 1e-5 relative to max(1, max|ref|) on every tick, safe equal;
    the robot stays up.

    Stance is where the closed loop is conditioned.  With a trot spliced in
    at 0.02 s the reference is not reproducible at this bar even against
    itself: the base z of its initial state moved by one ulp moves its own
    tau_ff by 8.9e-2, pos_des by 1.2e-2 and the base state by 5.3e-2 within
    the 50 ticks, and the port lands 4.0e-2, 2.9e-3 and 3.7e-2 from it.  In
    stance the same one-ulp spread is 5.3e-8, 4.2e-9 and 6.1e-9, and the
    port is 8.2e-8, 1.0e-8 and 1.4e-8 from the reference (cheater
    estimator, float64 on a CPU)."""
    j_iface, t_iface = ifaces
    path = scenes["port"][0]
    joints = list(t_iface.task.joint_names)
    j_ctrl = JBipedalController(j_iface, JControllerConfig(estimator=estimator))
    j_runner.reset()
    j_runner.timer.samples.clear()
    j_runner.rm = j_iface.make_reference_manager()
    j_ctrl.mpc = j_runner
    t_ctrl = BipedalController(t_iface, ControllerConfig(estimator=estimator))
    kalman = estimator == "kalman"
    want = _closed_loop(j_ctrl, JMujocoSimBackend(path, joints), j_iface, 50, kalman, jax_in=True)
    got = _closed_loop(t_ctrl, MujocoSimBackend(path, joints), t_iface, 50, kalman, jax_in=False)
    worst = {"tau_ff": 0.0, "pos_des": 0.0, "base": 0.0}
    for k, (a, b) in enumerate(zip(got, want)):
        for i, name in enumerate(worst):
            err = _rel(a[i], b[i])
            worst[name] = max(worst[name], err)
            assert err <= 1e-5, f"tick {k} {name}: {err:.3e}"
        assert a[3] == b[3], f"tick {k} safe"
    print(f"{estimator}: largest relative errors over 50 ticks {worst}")
    assert t_ctrl.mpc.timer.count == j_runner.timer.count == 5
    assert got[-1][3] and abs(got[-1][2][2] - 0.665) < 0.03

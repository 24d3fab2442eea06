"""PyTorch port vs JAX reference: the contact Kalman filter
(estim/kalman.py) and its estimator (estim/estimator.py) on G1's
configuration and the synthetic G1-shaped URDF
(tests/data/g1_shaped_biped.urdf), float64 on the CPU, sensors drawn from a
numpy seed: 200 filter steps with contact-flag changes (and, for the
estimator, chattering flags under a 2-tick debounce), state and rbdState to
1e-9; the debouncer exactly; and the controller's sensor entry points with
the Kalman estimator and the device WBC.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.estim.estimator import KalmanStateEstimator as JKalmanStateEstimator
from bipedal_control_tpu.estim.kalman import KalmanConfig as JKalmanConfig
from bipedal_control_tpu.estim.kalman import kalman_init as j_kalman_init
from bipedal_control_tpu.estim.kalman import kalman_update as j_kalman_update
from bipedal_control_tpu.interface import make_interface as j_make_interface
from bipedal_control_tpu.model.centroidal import contact_positions as j_contact_positions
from bipedal_control_tpu_torch.convert import kalman_state_from_numpy
from bipedal_control_tpu_torch.estim.estimator import KalmanStateEstimator
from bipedal_control_tpu_torch.estim.kalman import KalmanConfig, kalman_update
from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.runtime.controller import BipedalController, ControllerConfig
from bipedal_control_tpu_torch.utils.rotations import quat_wxyz_to_rotmat, zyx_from_quat_wxyz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))
TICKS = 200


def _close(name, got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))
    assert err <= tol, f"{name}: rel err {err:.3e} (bar {tol:g})"


@pytest.fixture(scope="module")
def g1():
    return j_make_interface(G1_URDF, *G1_FILES), make_interface(G1_URDF, *G1_FILES, device="cpu")


def _quat_from_zyx(e):
    """Unit quaternion (w, x, y, z) of R = Rz(e0) Ry(e1) Rx(e2)."""
    cz, sz = np.cos(e[0] / 2), np.sin(e[0] / 2)
    cy, sy = np.cos(e[1] / 2), np.sin(e[1] / 2)
    cx, sx = np.cos(e[2] / 2), np.sin(e[2] / 2)
    return np.array([cz * cy * cx + sz * sy * sx, cz * cy * sx - sz * sy * cx,
                     cz * sy * cx + sz * cy * sx, sz * cy * cx - cz * sy * sx])


def _sensors(x0, nj, seed, chatter: bool):
    """TICKS ticks of (quat, gyro, accel, joint_pos, joint_vel, flags): a
    slow yaw drift across +-pi (the estimator's yaw unwrap), noisy IMU,
    joints near the stand, and flags cycling stance -> left -> right support
    every 30 ticks, with random single-tick flips when ``chatter``."""
    rng = np.random.default_rng(seed)
    modes = (np.ones(4), np.array([1.0, 1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0, 1.0]))
    out = []
    for k in range(TICKS):
        e = np.array([3.0 + 0.002 * k, 0.02 * np.sin(k / 20), -0.01])
        flags = modes[(k // 30) % 3].copy()
        if chatter and rng.random() < 0.2:
            i = rng.integers(4)
            flags[i] = 1.0 - flags[i]
        out.append((_quat_from_zyx(e), rng.normal(scale=0.05, size=3),
                    np.array([0.0, 0.0, 9.81]) + rng.normal(scale=0.2, size=3),
                    x0[12:] + rng.normal(scale=0.02, size=nj), rng.normal(scale=0.2, size=nj), flags))
    return out


def test_kalman_update_matches_reference(g1):
    """kalman_update from the same initial state (carried across by
    convert.kalman_state_from_numpy), 200 steps: z and P to 1e-9."""
    j, t = g1
    x0 = np.asarray(t.initial_state)
    feet = np.asarray(j_contact_positions(j.model, j.info, jnp.asarray(x0[6:])))
    j_state = j_kalman_init(jnp.asarray(x0[6:9]), jnp.zeros(3), jnp.asarray(feet))
    state = kalman_state_from_numpy({"z": np.asarray(j_state.z), "P": np.asarray(j_state.P)}, device="cpu")
    j_cfg, cfg = JKalmanConfig(terrain_height=0.01), KalmanConfig(terrain_height=0.01)

    def j_step(s, quat, gyro, accel, jp, jv, flags):
        from bipedal_control_tpu.utils.rotations import quat_wxyz_to_rotmat as jq, zyx_from_quat_wxyz as je

        R = jq(quat)
        return j_kalman_update(j.model, j.info, j_cfg, s, R, accel, je(quat), R @ gyro, jp, jv, flags)

    j_step = jax.jit(j_step)
    for k, sensors in enumerate(_sensors(x0, t.info.nj, 5, chatter=True)):
        j_state = j_step(j_state, *(jnp.asarray(a) for a in sensors))
        quat, gyro, accel, jp, jv, flags = (torch.as_tensor(a) for a in sensors)
        R = quat_wxyz_to_rotmat(quat)
        state = kalman_update(t.model, t.info, cfg, state, R, accel, zyx_from_quat_wxyz(quat), R @ gyro, jp, jv,
                              flags)
        if k % 50 == 49 or k == TICKS - 1:
            _close(f"z at step {k}", state.z, j_state.z, 1e-9)
            _close(f"P at step {k}", state.P, j_state.P, 1e-9)


def test_estimator_matches_reference(g1):
    """KalmanStateEstimator (2-tick debounce, chattering flags, yaw crossing
    +-pi) against the reference's over 200 ticks: every rbdState, the final
    z and P, and base_position to 1e-9; the accepted flags equal."""
    j, t = g1
    x0, nj = np.asarray(t.initial_state), t.info.nj
    ours, ref = KalmanStateEstimator(t.model, t.info, debounce_ticks=2), JKalmanStateEstimator(
        j.model, j.info, debounce_ticks=2)
    sensors = _sensors(x0, nj, 6, chatter=True)
    for est in (ours, ref):
        est.reset(sensors[0][0], x0[12:], x0[6:9])
    assert ours.last_yaw == pytest.approx(ref.last_yaw, abs=1e-12)
    for k, s in enumerate(sensors):
        _close(f"rbd at tick {k}", ours.update(*s), ref.update(*s), 1e-9)
        np.testing.assert_array_equal(ours._flag_state, ref._flag_state)
    assert abs(ours.last_yaw) > np.pi  # the yaw was unwrapped past pi, as the reference does
    _close("z", ours.state.z, ref.state.z, 1e-9)
    _close("P", ours.state.P, ref.state.P, 1e-9)
    _close("base_position", ours.base_position, ref.base_position, 1e-9)


def test_debounce_matches_reference():
    """The contact-flag hysteresis, flag for flag, at 0 (passthrough) and 3
    ticks."""
    rng = np.random.default_rng(7)
    seq = (rng.random((60, 4)) < 0.7).astype(float)
    for ticks in (0, 3):
        ours = KalmanStateEstimator.__new__(KalmanStateEstimator)
        ref = JKalmanStateEstimator.__new__(JKalmanStateEstimator)
        for est in (ours, ref):
            est.debounce_ticks, est._flag_state, est._flag_count = ticks, None, np.zeros(4, dtype=int)
        for flags in seq:
            np.testing.assert_array_equal(ours._debounce(flags), ref._debounce(flags))


def test_controller_from_sensors(g1):
    """BipedalController(wbc_backend="device", estimator="kalman") on the
    CPU: starting_from_sensors, then ticks of update_from_sensors.  Each
    tick's rbdState is the reference estimator's on the same sensors and the
    planned flags the controller fed it (1e-9), and its commands are finite."""
    j, t = g1
    x0, nj = np.asarray(t.initial_state), t.info.nj
    ctrl = BipedalController(t, ControllerConfig(wbc_backend="device", estimator="kalman"))
    assert ctrl.backends["qp"] == "cpu" and ctrl.backends["estimator"] == "cpu"
    ctrl.set_gait(t.task.gait_library["trot"], 0.0)
    ref = JKalmanStateEstimator(j.model, j.info)
    fed = []
    inner = ctrl.estimator.update

    def record(*args):
        fed.append(args)
        return inner(*args)

    ctrl.estimator.update = record
    sensors = _sensors(x0, nj, 8, chatter=False)
    quat, gyro, accel, jp, jv, _ = sensors[0]
    ctrl.starting_from_sensors(0.0, quat, gyro, accel, jp, jv, x0[6:9])
    ref.reset(quat, jp, x0[6:9])
    ref_rbd = [ref.update(*fed[0])]
    for k, (quat, gyro, accel, jp, jv, _) in enumerate(sensors[1:4]):
        cmd = ctrl.update_from_sensors(0.3 + 0.0025 * k, quat, gyro, accel, jp, jv)
        assert ctrl.safe and all(np.all(np.isfinite(c)) for c in cmd)
        ref_rbd.append(ref.update(*fed[-1]))
    assert len(fed) == 4 and not np.all(fed[-1][5] == 1.0)  # planned single support from the trot
    _close("rbd", ctrl.last_observation[1][6:9], ref_rbd[-1][3:6], 1e-9)
    with pytest.raises(RuntimeError, match="estimator='kalman'"):
        BipedalController(t, ControllerConfig()).update_from_sensors(0.0, *sensors[0][:5])

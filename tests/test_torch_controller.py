"""PyTorch port vs JAX reference: the controller's runtime pieces on G1's
configuration (configs/g1/* with overrides.info) and the synthetic G1-shaped
URDF (tests/data/g1_shaped_biped.urdf), float64 on the CPU.

The policy snapshot's layout, its numpy evaluator and the planned contact
flags are held against the reference's on the same arrays, exactly (the
port gathers the snapshot from tensors, the reference from arrays); the
command router on G1 (the counterpart of tests/test_commands.py's H1
parsing test); the auxiliary joint controllers; policy files written by
one package and read by the other; the async worker on the card's path
(here its CPU twin), its crash and the controller's stop; the safety check;
and the backends' names (the device WBC and the Kalman estimator construct,
unknown names raise).  Only the reference's
numpy functions are called: no JAX program is compiled here.
"""
import dataclasses
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bipedal_control_tpu.gait.mode_schedule import GaitTable as JGaitTable
from bipedal_control_tpu.runtime import async_mpc as j_async
from bipedal_control_tpu.runtime import aux_controllers as j_aux
from bipedal_control_tpu.runtime.safety import check_orientation as j_check_orientation
from bipedal_control_tpu.solver.sqp import SqpSolution as JSqpSolution
from bipedal_control_tpu_torch.gait.mode_schedule import GaitTable
from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.runtime import async_mpc
from bipedal_control_tpu_torch.runtime import aux_controllers as aux
from bipedal_control_tpu_torch.runtime.commands import CommandRouter
from bipedal_control_tpu_torch.runtime.controller import BipedalController, ControllerConfig
from bipedal_control_tpu_torch.runtime.mpc_runner import MpcRunner
from bipedal_control_tpu_torch.runtime.mrt import evaluate_policy
from bipedal_control_tpu_torch.runtime.safety import TILT_LIMIT, check_orientation
from bipedal_control_tpu_torch.solver.sqp import SqpSolution

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))


@pytest.fixture(scope="module")
def iface():
    """The port's G1 interface with bench.py's settings (one SQP iteration,
    the single candidate alpha = 1, the production backends)."""
    t = make_interface(G1_URDF, *G1_FILES, device="cpu")
    t.settings = dataclasses.replace(t.settings, sqp_iterations=1, linesearch_alphas=(1.0,), linearize="pallas",
                                     riccati="pallas", merit="pallas")
    return t


def _standing_rbd(iface):
    x0 = np.asarray(iface.initial_state)
    return np.concatenate([x0[9:12], x0[6:9], x0[12:], np.zeros(6 + iface.info.nj)])


def _random_policy(rng, N=8, nx=5, nu=3, P=6):
    """Random solution fields and gait table: (numpy fields, port batched
    solution, port gait table, reference solution, reference gait table)."""
    f = dict(t_nodes=np.sort(rng.uniform(0, 1, N + 1)), x_traj=rng.normal(size=(N + 1, nx)),
             u_traj=rng.normal(size=(N, nu)), K=rng.normal(size=(N, nu, nx)), cost=np.float64(1.25),
             defect_norm=np.float64(0.25), eq_norm=np.float64(0.5), step_size=np.float64(1.0))
    ev = np.concatenate([np.sort(rng.uniform(0, 1, 3)), np.full(P - 3, np.inf)])
    contacts = rng.integers(0, 2, size=(P + 1, 4)).astype(float)
    modes = np.zeros(P + 1, dtype=np.int64)
    sol = SqpSolution(**{k: torch.as_tensor(v)[None] for k, v in f.items()})
    gait = GaitTable(torch.as_tensor(ev), torch.as_tensor(modes), torch.as_tensor(contacts))
    j_sol = JSqpSolution(**{k: jnp.asarray(v) for k, v in f.items()})
    j_gait = JGaitTable(jnp.asarray(ev), jnp.asarray(modes), jnp.asarray(contacts))
    return f, sol, gait, j_sol, j_gait


def test_policy_layout_and_evaluator_match_reference():
    """_PolicyLayout.pack/unpack, evaluate_policy_np and contact_flags_at_np
    against the reference's on the same arrays, exactly: a snapshot of one
    package is a snapshot of the other."""
    rng = np.random.default_rng(0)
    f, sol, gait, j_sol, j_gait = _random_policy(rng)
    layout, j_layout = async_mpc._PolicyLayout(9, 5, 3, 6), j_async._PolicyLayout(9, 5, 3, 6)
    assert layout.sizes == j_layout.sizes and layout.total == j_layout.total
    flat = layout.pack(0.125, sol, gait, 7.5)
    np.testing.assert_array_equal(flat, j_layout.pack(0.125, j_sol, j_gait, 7.5))
    snap, j_snap = layout.unpack(3, flat), j_layout.unpack(3, flat)
    for name in j_async.PolicySnapshot._fields:
        np.testing.assert_array_equal(getattr(snap, name), getattr(j_snap, name), err_msg=name)
    np.testing.assert_array_equal(snap.K, f["K"])
    for t in np.concatenate([rng.uniform(-0.1, 1.1, size=6), f["t_nodes"][[0, 3, -1]]]):
        x = rng.normal(size=5)
        for fb in (True, False):
            got = async_mpc.evaluate_policy_np(snap, t, x, use_feedback=fb)
            want = j_async.evaluate_policy_np(j_snap, t, x, use_feedback=fb)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(async_mpc.contact_flags_at_np(snap, t), j_async.contact_flags_at_np(j_snap, t))


def test_policy_files_load_across_packages(tmp_path):
    """save_policy/load_policy write and read the reference's keys: a file
    saved by either package loads in the other (the port saves scenario 0
    and loads a batch of one)."""
    f, sol, _, j_sol, _ = _random_policy(np.random.default_rng(1))
    aux.save_policy(str(tmp_path / "port.npz"), sol)
    j_aux.save_policy(str(tmp_path / "jax.npz"), j_sol)
    from_port = j_aux.load_policy(str(tmp_path / "port.npz"))
    from_jax = aux.load_policy(str(tmp_path / "jax.npz"), device="cpu")
    for name, want in f.items():
        np.testing.assert_array_equal(np.asarray(getattr(from_port, name)), want, err_msg=name)
        assert getattr(from_jax, name).shape == (1,) + np.shape(want)
        np.testing.assert_array_equal(getattr(from_jax, name)[0].numpy(), want, err_msg=name)


def test_command_router_parsing(iface):
    """tests/test_commands.py's router checks on G1: list, errors, a gait
    splice, cmd_vel, goal and stop land in a bare MpcRunner's references."""
    mpc = MpcRunner(iface)
    x0 = np.asarray(iface.initial_state)
    router = CommandRouter(mpc, iface, observation=lambda: (0.0, x0))
    assert "trot" in router.handle("list")
    assert "unknown gait" in router.handle("gait no_such_gait")
    assert "unknown command" in router.handle("frobnicate")
    assert "bad arguments" in router.handle("cmd_vel not_a_number")
    assert "no live WBC" in router.handle("wbc_weight baseAccel 2")
    assert router.handle("") == ""
    n_events_before = len(mpc.rm.gait_schedule.get_mode_schedule(0.0, 3.0).event_times)
    assert router.handle("gait trot") == "gait -> trot"
    assert len(mpc.rm.gait_schedule.get_mode_schedule(0.0, 3.0).event_times) > n_events_before
    assert "cmd_vel" in router.handle("cmd_vel 0.4 0")
    assert mpc.rm.target.states[0][0] == pytest.approx(0.4, abs=1e-9)
    assert "goal" in router.handle("goal 1.0 0.0 0.0")
    assert "holding" in router.handle("stop")
    assert CommandRouter(mpc, iface, observation=lambda: None).handle("stop").startswith("no observation")


def test_aux_controllers_match_reference():
    """InitialJointPositionController's ramp and clamp and
    UpperJointController's hold against the reference's."""
    rng = np.random.default_rng(2)
    target, q0 = rng.normal(size=6), rng.normal(size=6)
    lower, upper = -0.5 * np.ones(6), 0.5 * np.ones(6)
    ours = aux.InitialJointPositionController(target=target, lower=lower, upper=upper, duration=1.0)
    ref = j_aux.InitialJointPositionController(target=target, lower=lower, upper=upper, duration=1.0)
    ours.starting(0.2, q0)
    ref.starting(0.2, q0)
    for t in (0.2, 0.7, 1.3, 5.0):
        for a, b in zip(ours.update(t, q0, np.zeros(6)), ref.update(t, q0, np.zeros(6))):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(aux.UpperJointController(target=target).update(0.0, q0, q0),
                    j_aux.UpperJointController(target=target).update(0.0, q0, q0)):
        np.testing.assert_array_equal(a, b)


class _HostReads(TorchDispatchMode):
    """Counts the reads of a tensor's value to the host (``.item()``, and
    indexing with a 0-dim tensor): each one synchronises the card."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


def test_sync_tick_reads_no_value_back(iface):
    """A synchronous tick without a replan, and the policy evaluation of
    runtime/mrt.py, read no tensor value to the host: on the card their
    only synchronisation is the tick's one copy of (x_star, u_fb, flags)."""
    ctrl = BipedalController(iface, ControllerConfig())
    ctrl.set_gait(iface.task.gait_library["trot"], 0.1)
    rbd = _standing_rbd(iface)
    ctrl.starting(0.0, rbd)
    ctrl.update(0.0, rbd)
    sol = SqpSolution(*(None if f is None else f[0] for f in ctrl.mpc.last_solution))
    x = torch.as_tensor(np.asarray(iface.initial_state))
    with _HostReads() as reads:
        cmd = ctrl.update(0.0025, rbd)
        evaluate_policy(sol, 0.01, x)
    assert reads.count == 0 and ctrl.mpc.timer.count == 1
    assert np.all(np.isfinite(cmd.tau_ff)) and ctrl.last_policy[0].dtype == np.float64
    # tau_ff is the QP's torque, unsaturated as in the JAX controller; a
    # tick whose torque leaves the limits is counted with its excess
    assert ctrl.report()["torque_excess"] == {"ticks": 0, "max_excess_nm": 0.0}
    ctrl.wbc_cfg = dataclasses.replace(ctrl.wbc_cfg, torque_limit_per_leg=(0.5,) * 6)
    cmd = ctrl.update(0.005, rbd)
    top = float(np.max(np.abs(cmd.tau_ff)))
    assert top > 0.5 and np.array_equal(cmd.tau_ff, ctrl.last_wbc_decision[-iface.info.nj:])
    assert ctrl.report()["torque_excess"] == {"ticks": 1, "max_excess_nm": top - 0.5}
    assert 0.0 <= ctrl.wbc_primal_residual < np.inf


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_async_controller_and_worker_crash(iface):
    """The asynchronous controller on the CPU: the worker replans in the
    background and the tick evaluates its snapshots (the newest equals the
    runner's solution, scenario 0).  Then a crash in the worker marks it
    failed and stops the tick: the controller turns unsafe and commands
    zero torque (tests/test_async_mpc.py:220's semantics)."""
    ctrl = BipedalController(iface, ControllerConfig(mpc_async=True))
    ctrl.set_gait(iface.task.gait_library["trot"], 0.1)
    rbd = _standing_rbd(iface)
    try:
        ctrl.starting(0.0, rbd)
        snap = ctrl.async_mpc.poll_policy()
        sol = ctrl.mpc.last_solution
        np.testing.assert_array_equal(snap.K, sol.K[0].numpy())
        np.testing.assert_array_equal(snap.gait_contacts, ctrl.mpc.last_frozen.gait.contacts.numpy())
        deadline, k = time.monotonic() + 20.0, 0
        while ctrl.async_mpc.solve_count < 4 and time.monotonic() < deadline:
            cmd = ctrl.update(k * 0.0025, rbd)
            assert ctrl.safe and all(np.all(np.isfinite(c)) for c in cmd)
            k += 1
            time.sleep(0.002)
        assert ctrl.async_mpc.solve_count >= 4 and not ctrl.async_mpc.failed
        report = ctrl.report()
        assert report["tick"]["count"] == k and report["policy_staleness_s"]["max"] >= 0.0

        def boom(t):
            raise RuntimeError("boom")

        ctrl.mpc.rm.freeze = boom
        t_crash = k * 0.0025 + 0.05  # one MPC period ahead: the worker replans and dies
        for _ in range(200):
            ctrl.update(t_crash, rbd)
            if ctrl.async_mpc.failed:
                break
            time.sleep(0.01)
        assert ctrl.async_mpc.failed and not ctrl.async_mpc.running
        cmd = ctrl.update(t_crash + 0.0025, rbd)
        assert not ctrl.safe and not np.any(cmd.tau_ff) and not np.any(cmd.kp)
    finally:
        ctrl.stop()


def test_deliberate_stop_is_not_a_failure(iface):
    """Stopping the worker before any observation is no failure."""
    runner = MpcRunner(iface)
    amr = async_mpc.AsyncMpcRunner(runner, mpc_frequency=50.0)
    try:
        amr.start()
        time.sleep(0.02)
        assert amr.running
        amr.stop()
        assert not amr.failed and not amr.running and amr.solve_count == 0
    finally:
        amr.close()


def test_check_orientation_matches_reference():
    rng = np.random.default_rng(3)
    for pitch, roll in [(0.0, 0.0), (TILT_LIMIT - 1e-6, 0.0), (0.0, -TILT_LIMIT), (1.2, 0.1)] + [
            tuple(rng.uniform(-1.5, 1.5, size=2)) for _ in range(4)]:
        rbd = np.array([0.3, pitch, roll, 0.0, 0.0, 0.665])
        assert check_orientation(rbd) == j_check_orientation(rbd)
    assert check_orientation(np.zeros(6)) and not check_orientation(np.array([0.0, 1.1, 0.0]))


@pytest.mark.parametrize("field,value", [("wbc_backend", "device"), ("estimator", "kalman")])
def test_unported_backends_raise(iface, field, value):
    """The backends that were once unported construct (the device WBC and the
    Kalman estimator, on the interface's device), and an unknown name of
    either raises ValueError."""
    ctrl = BipedalController(iface, ControllerConfig(**{field: value}))
    assert (ctrl.device_wbc is not None) if field == "wbc_backend" else (ctrl.estimator is not None)
    with pytest.raises(ValueError, match="unknown"):
        BipedalController(iface, ControllerConfig(**{field: "nope"}))

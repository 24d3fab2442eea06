"""PyTorch port vs JAX reference: the robot interface, the MPC runner and the
dummy loop on G1's configuration (configs/g1/* with overrides.info) and the
synthetic G1-shaped URDF (tests/data/g1_shaped_biped.urdf), float64 on the
CPU.

The port runs its production settings (linearize, riccati, merit "pallas":
their plain versions on CPU tensors), the reference its plain backends
(structured, sequential, xla), both with one SQP iteration and the single
line-search candidate alpha = 1, at g1_task.info's full horizon (1.0 s, 67
nodes; a horizon cut to 0.3 or 0.6 s makes the trot's replans diverge on
this robot, so the horizon is not cut).  The reference runner is built once
per module, so its cold and warm replans compile once each.  Bars are
those of the reference's batched-parity test: x/u 1e-5 relative to
max(1, max|ref|), K 1e-3, and the accepted step exactly.

The module's runners also drive the two packages' BipedalController (the
reference's with its runner replaced by the module's, after a fresh
reference manager: test code only) for 20 synchronous ticks, held at
pos_des, vel_des and tau_ff 1e-5 relative with contact flags and safety
equal, and the observability records on one solution at 1e-10.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.interface import make_interface as j_make_interface
from bipedal_control_tpu.ocp.problem import NodeRefs as JNodeRefs
from bipedal_control_tpu.runtime import observability as j_obs
from bipedal_control_tpu.runtime.controller import BipedalController as JBipedalController
from bipedal_control_tpu.runtime.controller import ControllerConfig as JControllerConfig
from bipedal_control_tpu.runtime.mpc_runner import MpcRunner as JMpcRunner
from bipedal_control_tpu.runtime.mrt import evaluate_policy as j_evaluate_policy
from bipedal_control_tpu.sim.dummy_loop import run_dummy_loop as j_run_dummy_loop
from bipedal_control_tpu.solver.sqp import SqpSolution as JSqpSolution
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.ocp.problem import NodeRefs
from bipedal_control_tpu_torch.runtime import observability
from bipedal_control_tpu_torch.runtime.controller import BipedalController, ControllerConfig
from bipedal_control_tpu_torch.runtime.mpc_runner import MpcRunner
from bipedal_control_tpu_torch.runtime.mrt import evaluate_policy
from bipedal_control_tpu_torch.sim.dummy_loop import run_dummy_loop
from bipedal_control_tpu_torch.solver.sqp import SqpSolution, build_refs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))


def _production(iface, **backends):
    """The interface with bench.py's settings: one SQP iteration, the single
    candidate alpha = 1, and the given backends."""
    iface.settings = dataclasses.replace(iface.settings, sqp_iterations=1, linesearch_alphas=(1.0,), **backends)
    return iface


@pytest.fixture(scope="module")
def ifaces():
    """(JAX interface, port interface) on the same files, uncut."""
    return j_make_interface(G1_URDF, *G1_FILES), make_interface(G1_URDF, *G1_FILES, device="cpu")


@pytest.fixture(scope="module")
def runners():
    """(JAX runner, port runner): the reference's plain backends against the
    port's production settings."""
    j_iface = _production(j_make_interface(G1_URDF, *G1_FILES), linearize="structured", riccati="sequential",
                          merit="xla")
    t_iface = _production(make_interface(G1_URDF, *G1_FILES, device="cpu"), linearize="pallas", riccati="pallas",
                          merit="pallas")
    return JMpcRunner(j_iface), MpcRunner(t_iface)


def _fresh_trot(runners):
    """Fresh reference managers and timers in both runners, trot from 0.1 s."""
    for mpc in runners:
        mpc.timer.samples.clear()
        mpc.rm = mpc.iface.make_reference_manager()
        mpc.rm.set_gait(mpc.iface.task.gait_library["trot"], 0.1)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def _assert_solution(got, ref):
    for name, bar in (("x_traj", 1e-5), ("u_traj", 1e-5), ("K", 1e-3)):
        err = _rel(getattr(got, name)[0].numpy(), getattr(ref, name))
        assert err < bar, f"{name}: rel err {err:.3e}"
    np.testing.assert_array_equal(got.step_size.numpy(), np.atleast_1d(np.asarray(ref.step_size)))
    np.testing.assert_allclose(got.t_nodes[0].numpy(), np.asarray(ref.t_nodes), rtol=0, atol=1e-12)


def test_interface_matches_reference(ifaces):
    """make_interface on both packages, compared through
    convert.interface_to_numpy at 1e-12."""
    j, t = ifaces
    got = convert.interface_to_numpy(t)
    for f in dataclasses.fields(j.model):
        want = getattr(j.model, f.name)
        if f.name == "ancestor_joints":
            assert got["model"][f.name] == want
        elif isinstance(want, (str, tuple)):
            assert got["model"][f.name] == want, f.name
        else:
            np.testing.assert_allclose(got["model"][f.name], np.asarray(want), rtol=0, atol=1e-12, err_msg=f.name)
    for k, v in dataclasses.asdict(j.info).items():
        np.testing.assert_array_equal(np.asarray(got["info"][k]), np.asarray(v), err_msg=k)
    assert got["settings"] == dataclasses.asdict(j.settings)
    np.testing.assert_allclose(got["Q"], np.asarray(j.Q), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["R"], np.asarray(j.R), rtol=0, atol=1e-12)
    assert t.circuit is not None and t.circuit[1].dtype == torch.float64
    # the round trip builds the same interface (and its circuit tables)
    back = convert.interface_from_numpy(got, device="cpu")
    np.testing.assert_array_equal(back.R.numpy(), got["R"])
    assert back.circuit[0] == t.circuit[0] and torch.equal(back.circuit[1], t.circuit[1])
    # the reference managers' sizing and nominal foot offsets
    jr, tr = j.make_reference_manager(), t.make_reference_manager()
    assert (tr.max_phases, tr.max_targets, tr.num_intervals) == (jr.max_phases, jr.max_targets, jr.num_intervals)
    np.testing.assert_allclose(tr.foot_xy_offsets, jr.foot_xy_offsets, rtol=0, atol=1e-12)


def test_replans_match_reference(runners):
    """One cold and two warm replans of the port's MpcRunner against the
    reference's, on the same measured states."""
    j_mpc, t_mpc = runners
    _fresh_trot(runners)
    j_mpc.reset()
    t_mpc.reset()
    rng = np.random.default_rng(0)
    x0 = np.asarray(j_mpc.iface.initial_state)
    for k, t in enumerate((0.0, 0.02, 0.04)):
        x = x0 + rng.normal(scale=0.005, size=x0.shape)
        ref = j_mpc.advance(t, jnp.asarray(x))
        got = t_mpc.advance(t, torch.as_tensor(x))
        _assert_solution(got, ref)
        assert t_mpc.timer.count == k + 1
    # the feedback policy at random times inside the first interval pair
    sol = SqpSolution(*(None if f is None else f[0] for f in t_mpc.last_solution))
    for tq in rng.uniform(0.04, 0.07, size=3):
        xq = x0 + rng.normal(scale=0.005, size=x0.shape)
        pol = evaluate_policy(sol, float(tq), torch.as_tensor(xq))
        ref = j_evaluate_policy(j_mpc.last_solution, tq, jnp.asarray(xq))
        for a, b in zip(pol, ref):
            assert _rel(a.numpy(), b) < 1e-5


def test_dummy_loop_matches_reference(runners):
    """0.1 s of run_dummy_loop (400 Hz MRT, 50 Hz MPC: 5 replans) against
    the reference's on the same start state."""
    j_mpc, t_mpc = runners
    _fresh_trot(runners)
    x0 = np.asarray(j_mpc.iface.initial_state)
    ref = j_run_dummy_loop(j_mpc.iface, j_mpc, jnp.asarray(x0), duration=0.1)
    got = run_dummy_loop(t_mpc.iface, t_mpc, x0, duration=0.1)
    np.testing.assert_allclose(got.times, ref.times, rtol=0, atol=1e-12)
    assert _rel(got.states, ref.states) < 1e-5
    assert _rel(got.inputs, ref.inputs) < 1e-5
    assert got.mpc_stats["count"] == ref.mpc_stats["count"] == 5
    assert np.all(np.isfinite(got.states))


def test_controller_matches_reference(runners):
    """20 synchronous ticks at 400 Hz (0.05 s, 3 replans, trot from 0.1 s) of
    the port's BipedalController against the reference's, host WBC and
    cheater estimator, from the same seeded, slightly perturbed standing
    rbd state."""
    j_mpc, t_mpc = runners
    _fresh_trot(runners)
    j_ctrl = JBipedalController(j_mpc.iface, JControllerConfig())
    j_ctrl.mpc = j_mpc
    t_ctrl = BipedalController(t_mpc.iface, ControllerConfig())
    t_ctrl.mpc = t_mpc
    assert t_ctrl.backends["host_model"] == t_ctrl.backends["qp"] == "native"
    x0 = np.asarray(j_mpc.iface.initial_state)
    nj = j_mpc.iface.info.nj
    rng = np.random.default_rng(5)
    rbd0 = np.concatenate([x0[9:12], x0[6:9], x0[12:], np.zeros(6 + nj)])
    rbd0 += rng.normal(scale=0.002, size=rbd0.shape)
    j_ctrl.starting(0.0, rbd0)
    t_ctrl.starting(0.0, rbd0)
    for k in range(20):
        t = k * 0.0025
        rbd = rbd0 + rng.normal(scale=0.001, size=rbd0.shape)
        want, got = j_ctrl.update(t, rbd), t_ctrl.update(t, rbd)
        for name in ("pos_des", "vel_des", "tau_ff"):
            assert _rel(getattr(got, name), getattr(want, name)) < 1e-5, f"tick {k} {name}"
        np.testing.assert_array_equal(got.kp, want.kp)
        np.testing.assert_array_equal(got.kd, want.kd)
        flags = t_mpc.last_frozen.gait.contact_flags_at(torch.tensor(t, dtype=torch.float64)).numpy()
        np.testing.assert_array_equal(flags, np.asarray(j_mpc.last_frozen.gait.contact_flags_at(jnp.asarray(t))))
        assert got.tau_ff.shape == (nj,) and t_ctrl.safe == j_ctrl.safe
    assert t_mpc.timer.count == j_mpc.timer.count == 3


def test_observability_matches_reference(runners):
    """observe_constraints, tracking_error and solve_report on one solution
    and one set of references (the same arrays in both packages), at 1e-10."""
    j_mpc, t_mpc = runners
    _fresh_trot(runners)
    t_mpc.reset()
    x0 = np.asarray(t_mpc.iface.initial_state)
    sol = SqpSolution(*(None if f is None else f[0] for f in t_mpc.advance(0.0, torch.as_tensor(x0))))
    fr = t_mpc.last_frozen
    refs = NodeRefs(*(f[0] for f in build_refs(t_mpc.iface.info, fr.gait, fr.swing, fr.target, fr.t_nodes)))
    j_sol = JSqpSolution(*(None if f is None else jnp.asarray(f.numpy()) for f in sol))
    j_refs = JNodeRefs(*(jnp.asarray(f.numpy()) for f in refs))
    j_iface, t_iface = j_mpc.iface, t_mpc.iface
    got = observability.observe_constraints(t_iface.model, t_iface.info, t_iface.settings, sol, refs)
    want = j_obs.observe_constraints(j_iface.model, j_iface.info, j_iface.settings, j_sol, j_refs)
    for name in want._fields:
        np.testing.assert_array_equal(np.isnan(getattr(got, name)), np.isnan(getattr(want, name)), err_msg=name)
        assert _rel(np.nan_to_num(getattr(got, name)), np.nan_to_num(getattr(want, name))) < 1e-10, name
    rng = np.random.default_rng(6)
    rbd = np.concatenate([x0[9:12], x0[6:9], x0[12:], np.zeros(18)]) + rng.normal(scale=0.05, size=36)
    got = observability.tracking_error(t_iface.model, t_iface.info, sol.x_traj[3].numpy(), rbd)
    want = j_obs.tracking_error(j_iface.model, j_iface.info, np.asarray(j_sol.x_traj[3]), rbd)
    for name in want._fields:
        assert _rel(getattr(got, name), getattr(want, name)) < 1e-10, name
    got, want = observability.solve_report(sol), j_obs.solve_report(j_sol)
    assert got.keys() == want.keys() and got["horizon_nodes"] == want["horizon_nodes"] == 68
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-10 * max(1.0, abs(want[k])), k


def test_runner_refuses_what_the_port_lacks(ifaces):
    """The port has both of the reference's replan backends: "ilqr" builds
    (its replans are held by tests/test_torch_ddp.py) and an unknown solver
    raises ValueError, as the reference's does."""
    _, t = ifaces
    mpc = MpcRunner(t, solver="ilqr", ddp_iterations=3, ddp_penalty=50.0)
    assert (mpc.ddp.iterations, mpc.ddp.constraint_penalty) == (3, 50.0)
    with pytest.raises(ValueError, match="unknown solver"):
        MpcRunner(t, solver="slq")


def test_entry_points_run_on_the_card_by_default():
    """Without CUDA the interface factory raises instead of computing on the
    CPU; the CPU is taken only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_interface(G1_URDF, *G1_FILES)

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
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.interface import make_interface as j_make_interface
from bipedal_control_tpu.runtime.mpc_runner import MpcRunner as JMpcRunner
from bipedal_control_tpu.runtime.mrt import evaluate_policy as j_evaluate_policy
from bipedal_control_tpu.sim.dummy_loop import run_dummy_loop as j_run_dummy_loop
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.runtime.mpc_runner import MpcRunner
from bipedal_control_tpu_torch.runtime.mrt import evaluate_policy
from bipedal_control_tpu_torch.sim.dummy_loop import run_dummy_loop
from bipedal_control_tpu_torch.solver.sqp import SqpSolution

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
    sol = SqpSolution(*(f[0] for f in t_mpc.last_solution))
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


def test_runner_refuses_what_the_port_lacks(ifaces):
    _, t = ifaces
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        MpcRunner(t, solver="ilqr")
    with pytest.raises(ValueError, match="unknown solver"):
        MpcRunner(t, solver="slq")


def test_entry_points_run_on_the_card_by_default():
    """Without CUDA the interface factory raises instead of computing on the
    CPU; the CPU is taken only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_interface(G1_URDF, *G1_FILES)

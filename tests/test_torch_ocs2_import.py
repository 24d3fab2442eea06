"""PyTorch port vs JAX reference: the OCS2 trajectory import and comparison
harness (bipedal_control_tpu_torch/reference/ocs2_import.py against
bipedal_control_tpu/reference/ocs2_import.py), float64 on the CPU.

The four asset-free cases of tests/test_ocs2_import.py run through both
packages' functions on the same inputs and must agree exactly (the port's
numpy part is a copy).  compare_solve_to_recording runs on the registry's
G1 patched to the committed G1-shaped URDF in both packages (as
tests/test_torch_cli.py patches it), with a 1.0 s horizon at dt 0.125
(N = 8; shorter G1 horizons diverge), a stance gait and the task's
backends, against a recording of the stand; the two reports agree to 1e-8.
"""
import dataclasses

import jax
import numpy as np
import pytest

from bipedal_control_tpu import robots as j_robots
from bipedal_control_tpu.interface import make_interface_for as j_make_interface_for
from bipedal_control_tpu.reference import ocs2_import as j_ocs2
from bipedal_control_tpu.solver import sqp as j_sqp
from bipedal_control_tpu_torch import robots
from bipedal_control_tpu_torch.interface import make_interface_for
from bipedal_control_tpu_torch.reference import ocs2_import as ocs2

from test_torch_sim import G1_URDF

PACKAGES = (j_ocs2, ocs2)


def _fake(T=9, nx=34, nu=31):
    rng = np.random.default_rng(0)
    return np.linspace(0.0, 1.0, T), rng.normal(size=(T, nx)), rng.normal(size=(T, nu))


def _same_recording(a, b):
    for name in ("times", "states", "inputs"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def _same_report(a, b):
    for name in ("times", "state_err", "input_err"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert a.state_err_by_block == b.state_err_by_block
    assert a.input_err_by_block == b.input_err_by_block
    assert a.summary() == b.summary()


def test_npz_roundtrip_matches_reference(tmp_path):
    """Each package loads what either saved, identically."""
    t, x, u = _fake()
    for i, writer in enumerate(PACKAGES):
        p = str(tmp_path / f"traj{i}.npz")
        writer.save_recorded_trajectory(p, t, x, u)
        want, got = (pkg.load_recorded_trajectory(p) for pkg in PACKAGES)
        _same_recording(got, want)
        np.testing.assert_array_equal(got.states, x)


def test_csv_roundtrip_matches_reference(tmp_path):
    t, x, u = _fake(T=5, nx=4, nu=3)
    p = str(tmp_path / "traj.csv")
    header = "t," + ",".join(f"x{i}" for i in range(4)) + "," + ",".join(f"u{i}" for i in range(3))
    np.savetxt(p, np.concatenate([t[:, None], x, u], axis=1), delimiter=",", header=header, comments="")
    want, got = (pkg.load_recorded_trajectory(p) for pkg in PACKAGES)
    _same_recording(got, want)
    np.testing.assert_array_equal(got.inputs, u)


def test_validation_errors_match_reference(tmp_path):
    t, x, u = _fake()
    p = str(tmp_path / "bad.npz")
    np.savez(p, times=t, states=x)
    cases = [lambda pkg: pkg.RecordedTrajectory(t[:-1], x, u),
             lambda pkg: pkg.RecordedTrajectory(np.zeros_like(t), x, u),
             lambda pkg: pkg.load_recorded_trajectory(p),
             lambda pkg: pkg.load_recorded_trajectory(str(tmp_path / "traj.txt"))]
    for case in cases:
        messages = []
        for pkg in PACKAGES:
            with pytest.raises(ValueError) as err:
                case(pkg)
            messages.append(str(err.value))
        assert messages[0] == messages[1]


def test_compare_trajectories_matches_reference():
    t, x, u = _fake(T=21, nx=34, nu=31)
    tn = np.linspace(0.1, 0.9, 15)
    for shift in (0.0, 0.5):
        reports = []
        for pkg in PACKAGES:
            rec = pkg.RecordedTrajectory(t, x, u)
            xs = np.stack([rec.state_at(tt) for tt in tn])
            xs[:, 2] += shift
            us = np.stack([rec.input_at(tt) for tt in tn[:-1]])
            reports.append(pkg.compare_trajectories(tn, xs, us, rec, nj=22))
        _same_report(reports[1], reports[0])
        assert (reports[1].state_err_by_block["momentum"] > 0.49) == (shift > 0)


@pytest.fixture
def g1_registry():
    """REGISTRY["g1"] of both packages on the committed G1-shaped URDF."""
    with pytest.MonkeyPatch.context() as mp:
        for reg in (j_robots.REGISTRY, robots.REGISTRY):
            mp.setitem(reg, "g1", dataclasses.replace(reg["g1"], urdf=G1_URDF))
        yield


def test_compare_solve_to_recording_matches_reference(g1_registry):
    """One solve of each package from a recording's first state, 1.0 s at
    dt 0.125 in stance, compared with the same recording (G1 held at its
    stand with inputs from a seed): the reports agree to 1e-8.  From the
    stand the solve is conditioned; from a stand perturbed by 1 cm noise on
    every state the reference's own jitted and eager solves differ by ~3e-5
    at the last node, beyond any bar between the packages."""
    j_iface = j_make_interface_for("g1")
    j_iface = dataclasses.replace(j_iface, settings=dataclasses.replace(j_iface.settings, dt=0.125))
    iface = make_interface_for("g1", device="cpu")
    iface.settings = dataclasses.replace(iface.settings, dt=0.125)
    assert iface.settings.num_intervals == j_iface.settings.num_intervals == 8
    assert iface.settings.horizon == 1.0
    rng = np.random.default_rng(7)
    times = np.linspace(0.0, 1.0, 11)
    states = np.tile(np.asarray(j_iface.initial_state), (11, 1))
    inputs = rng.normal(scale=1.0, size=(11, iface.info.input_dim))
    # the reference's solve compiled once (jax.jit), not run op by op (~55 s on a CPU)
    sqp_solve = j_sqp.sqp_solve
    solve = jax.jit(lambda *a: sqp_solve(j_iface.model, j_iface.info, j_iface.settings, j_iface.Q, j_iface.R, *a))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_sqp, "sqp_solve", lambda model, info, settings, Q, R, *a: solve(*a))
        want = j_ocs2.compare_solve_to_recording(j_iface, j_ocs2.RecordedTrajectory(times, states, inputs),
                                                 gait="stance")
    got = ocs2.compare_solve_to_recording(iface, ocs2.RecordedTrajectory(times, states, inputs), gait="stance")
    np.testing.assert_array_equal(got.times, want.times)
    assert len(got.times) == 9
    for name in ("state_err", "input_err"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0.0, atol=1e-8, err_msg=name)
    for blocks in ("state_err_by_block", "input_err_by_block"):
        g, w = getattr(got, blocks), getattr(want, blocks)
        assert list(g) == list(w)
        np.testing.assert_allclose([g[k] for k in g], [w[k] for k in w], rtol=0.0, atol=1e-8, err_msg=blocks)

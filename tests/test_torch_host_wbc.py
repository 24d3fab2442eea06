"""PyTorch port vs JAX reference: the controller's host stack on G1's
configuration (configs/g1/* with overrides.info) and the synthetic G1-shaped
URDF (tests/data/g1_shaped_biped.urdf), float64 on the CPU.

The host model, the host dynamics and the host WBC are numpy (and the C++ of
native/) in both packages, so the port's copies are held to 1e-12 against
the reference's on the same numpy inputs (drawn from a seed), and the WBC's
decision, whose ADMM runs 120 cold and 40 warm iterations, to 1e-10.  The
native backends are held against their numpy twins at the bars of
tests/test_host_wbc.py.  The rbd conversions of model/centroidal.py, which
the port computes in torch, are held against JAX's at 1e-12.  Nothing here
compiles a JAX program but those eager conversions.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.interface import make_interface as j_make_interface
from bipedal_control_tpu.model import centroidal as jc
from bipedal_control_tpu.model import host_dynamics as jhd
from bipedal_control_tpu.model import host_model as jhm
from bipedal_control_tpu.runtime.controller import wbc_config_from_task as j_wbc_config_from_task
from bipedal_control_tpu.wbc import host_wbc as jhw
from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.model import centroidal as tc
from bipedal_control_tpu_torch.model import host_dynamics as thd
from bipedal_control_tpu_torch.model import host_model as thm
from bipedal_control_tpu_torch.model.native_model import NativeHostModel
from bipedal_control_tpu_torch.runtime.controller import BipedalController, wbc_config_from_task
from bipedal_control_tpu_torch.runtime.native_rt import PolicySlot
from bipedal_control_tpu_torch.utils import native_build
from bipedal_control_tpu_torch.wbc import host_wbc as thw
from bipedal_control_tpu_torch.wbc.native_qp import NativeWbc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))
Z_STAND = 0.665  # G1's comHeight


def _close(name, got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    err = float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))
    assert err < tol, f"{name}: rel err {err:.3e} (bar {tol:g})"


@pytest.fixture(scope="module")
def g1():
    """(JAX interface, port interface, JAX host model, port host model)."""
    j = j_make_interface(G1_URDF, *G1_FILES)
    t = make_interface(G1_URDF, *G1_FILES, device="cpu")
    return j, t, jhm.make_host_model(j.model, j.info), thm.make_host_model(t.model, t.info)


def _random_qv(rng, nj):
    q = rng.normal(scale=0.3, size=6 + nj)
    q[2] += Z_STAND
    return q, rng.normal(scale=0.5, size=6 + nj)


def _random_xu(rng, x0, nu):
    nj = x0.shape[0] - 12
    x = x0.copy()
    x[:6] += rng.normal(scale=0.2, size=6)
    x[6:9] += rng.normal(scale=0.05, size=3)
    x[9:12] += rng.normal(scale=0.1, size=3)
    x[12:] += rng.normal(scale=0.1, size=nj)
    u = rng.normal(scale=20.0, size=nu)
    u[12:] = rng.normal(scale=0.5, size=nj)
    return x, u


def _random_rbd(rng, nj):
    rbd = rng.normal(scale=0.3, size=2 * (6 + nj))
    rbd[3:6] += np.array([0.0, 0.0, Z_STAND])
    return rbd


def test_host_model_matches_reference(g1):
    """make_host_model from the port's RobotModel tensors equals the
    reference's from its own model, field for field and exactly."""
    _, _, want, got = g1
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def test_host_dynamics_match_reference(g1):
    """Observation, mass matrix and NLE, frame Jacobians and their
    derivatives, the CMM and its derivative, the desired-side conversions
    and the WBC kinematics at 1e-12, on random states."""
    j, t, jh, th = g1
    rng = np.random.default_rng(7)
    nj, x0 = t.info.nj, np.asarray(t.initial_state)
    fids = tuple(th.contact_frame_ids) + (th.base_frame_id,)
    for _ in range(2):
        q, v = _random_qv(rng, nj)
        x, u = _random_xu(rng, x0, t.info.input_dim)
        rbd = _random_rbd(rng, nj)
        _close("observation", thm.centroidal_state_from_rbd_np(th, rbd), jhm.centroidal_state_from_rbd_np(jh, rbd),
               1e-12)
        for a, b in zip(thd.mass_and_nle_np(th, q, v), jhd.mass_and_nle_np(jh, q, v)):
            _close("mass/nle", a, b, 1e-12)
        got = thd.frame_jacobians_np(th, thd.host_kinematics_np(th, q, v), fids)
        want = jhd.frame_jacobians_np(jh, jhd.host_kinematics_np(jh, q, v), fids)
        for name, a, b in zip(("J", "dJ", "p", "v"), got, want):
            _close(name, a, b, 1e-12)
        for a, b in zip(thd.centroidal_momentum_matrix_and_dot_np(th, q, v),
                        jhd.centroidal_momentum_matrix_and_dot_np(jh, q, v)):
            _close("cmm/dot", a, b, 1e-12)
        for a, b in zip(thd.base_kinematics_from_centroidal_np(th, x, u),
                        jhd.base_kinematics_from_centroidal_np(jh, x, u)):
            _close("base kinematics", a, b, 1e-12)
        got = thw.compute_wbc_kinematics_np(th, x, u, rbd)
        want = jhw.compute_wbc_kinematics_np(jh, x, u, rbd)
        for name in want._fields:
            _close(name, getattr(got, name), getattr(want, name), 1e-12)


def test_rbd_conversions_match_reference(g1):
    """model/centroidal.py's rbd conversions (torch, over a leading batch)
    against JAX's, one state at a time, at 1e-12."""
    j, t, _, _ = g1
    rng = np.random.default_rng(9)
    nj = t.info.nj
    rbds = np.stack([_random_rbd(rng, nj) for _ in range(3)])
    xus = [_random_xu(rng, np.asarray(t.initial_state), t.info.input_dim) for _ in range(3)]
    xs, us = np.stack([a for a, _ in xus]), np.stack([b for _, b in xus])
    obs = tc.centroidal_state_from_rbd(t.model, t.info, torch.as_tensor(rbds)).numpy()
    back = tc.rbd_state_from_centroidal(t.model, t.info, torch.as_tensor(xs), torch.as_tensor(us)).numpy()
    for k in range(3):
        _close("centroidal_state_from_rbd", obs[k], jc.centroidal_state_from_rbd(j.model, j.info, jnp.asarray(rbds[k])),
               1e-12)
        _close("rbd_state_from_centroidal", back[k],
               jc.rbd_state_from_centroidal(j.model, j.info, jnp.asarray(xs[k]), jnp.asarray(us[k])), 1e-12)
    # the round trip, with the joint velocities as the input's, returns the rbd state
    u_back = np.concatenate([np.zeros((3, 12)), rbds[:, 12 + nj:]], axis=1)
    again = tc.rbd_state_from_centroidal(t.model, t.info, torch.as_tensor(obs), torch.as_tensor(u_back))
    _close("round trip", again.numpy(), rbds, 1e-12)


def test_host_wbc_matches_reference(g1):
    """HostWbc.update over 5 ticks (one cold, four warm, a contact switch on
    the fourth) on the native backends of both packages, at 1e-10."""
    j, t, jh, th = g1
    ours = thw.HostWbc(None, None, wbc_config_from_task(t.task), hm=th)
    ref = jhw.HostWbc(None, None, j_wbc_config_from_task(j.task), hm=jh)
    assert ours.backend == "native" and ref.native_model is not None
    rng = np.random.default_rng(8)
    x, u = _random_xu(rng, np.asarray(t.initial_state), t.info.input_dim)
    rbd = _random_rbd(rng, t.info.nj)
    for k in range(5):
        flags = np.ones(4) if k < 3 else np.array([0.0, 0.0, 1.0, 1.0])
        xk, rbdk = x + 1e-3 * k, rbd + 1e-3 * k
        a, b = ours.update(xk, u, rbdk, flags), ref.update(xk, u, rbdk, flags)
        _close(f"decision tick {k}", a.decision, b.decision, 1e-10)
        _close(f"torque tick {k}", a.torque, b.torque, 1e-10)


def test_native_backends_match_numpy_twins(g1):
    """The C++ host model against model/host_dynamics.py (observation 1e-12,
    WBC kinematics 1e-9: tests/test_host_wbc.py's bars), and the WBC on the
    native backends against the WBC on the numpy twins (the host-vs-device
    WBC bar of tests/test_host_wbc.py: atol 1e-7, rtol 1e-6)."""
    _, t, _, th = g1
    nm = NativeHostModel(th)
    rng = np.random.default_rng(11)
    cfg = wbc_config_from_task(t.task)
    native, numpy_twin = thw.HostWbc(None, None, cfg, hm=th), thw.HostWbc(None, None, cfg, hm=th, native=False)
    assert (native.backend, numpy_twin.backend) == ("native", "numpy") and numpy_twin.native_model is None
    for k in range(3):
        x, u = _random_xu(rng, np.asarray(t.initial_state), t.info.input_dim)
        rbd = _random_rbd(rng, t.info.nj)
        np.testing.assert_allclose(nm.observation(rbd), thm.centroidal_state_from_rbd_np(th, rbd), atol=1e-12,
                                   rtol=1e-12)
        want = thw.compute_wbc_kinematics_np(th, x, u, rbd)
        got = nm.wbc_kinematics(x, u, rbd)
        for name in want._fields:
            np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=1e-9, rtol=1e-9, err_msg=name)
        flags = np.ones(4) if k != 1 else np.array([1.0, 1.0, 0.0, 0.0])
        a, b = native.update(x, u, rbd, flags, warm=False), numpy_twin.update(x, u, rbd, flags, warm=False)
        np.testing.assert_allclose(a.decision, b.decision, atol=1e-7, rtol=1e-6)
    nm.close()


@pytest.mark.parametrize("flags", [(1, 1, 1, 1), (0, 0, 1, 1), (1, 1, 0, 0), (0, 0, 0, 0)])
def test_native_wbc_matches_numpy_assembly_and_admm(g1, flags):
    """The port's native/host_wbc.cc (HostWbc's native QP, one call per tick)
    against HostWbc._assemble and solve_qp_np's numpy loop on the same
    native kinematics: the task rows at 1e-12; the decision after 120 cold
    and then 40 warm iterations at 1e-9 relative to max(1, max|ref|)
    (measured <= 2.1e-11: its Cholesky inverse and sums over A's nonzeros
    round differently, and one ulp on H, g and A moves the numpy decision
    by ~1e-11), the residuals at 1e-6."""
    _, t, _, th = g1
    wbc = thw.HostWbc(None, None, wbc_config_from_task(t.task), hm=th)
    rng = np.random.default_rng(5)
    x, u = _random_xu(rng, np.asarray(t.initial_state), t.info.input_dim)
    rbd = _random_rbd(rng, t.info.nj)
    flags = np.asarray(flags, dtype=np.float64)
    kin = wbc.native_model.wbc_kinematics(x, u, rbd)
    want = wbc._assemble(kin, flags)
    for name, got_a, want_a in zip(("H", "g", "A", "l", "u"), wbc.native_wbc.assemble(kin, u, flags), want):
        _close(name, got_a, want_a, 1e-12)
    warm = None
    for iters in (120, 40):
        ref, primal, dual = thw.solve_qp_np(*want, iters=iters, warm=warm)
        (x_got, z_got, y_got), p_got, d_got = wbc.native_wbc.solve(kin, u, flags, iters, warm=warm)
        _close(f"x ({iters} iterations)", x_got, ref.x, 1e-9)
        _close(f"z ({iters} iterations)", z_got, ref.z, 1e-9)
        _close(f"y ({iters} iterations)", y_got, ref.y, 1e-9)
        _close(f"primal residual ({iters} iterations)", p_got, primal, 1e-6)
        _close(f"dual residual ({iters} iterations)", d_got, dual, 1e-6)
        warm = ref


def test_policy_slot_round_trip():
    """The seqlock slot: nothing published reads sequence 0; each write
    publishes one whole snapshot under a new sequence number."""
    slot = PolicySlot(37)
    try:
        seq0, _ = slot.read()
        assert seq0 == 0
        seqs = []
        for v in (1.5, -2.0):
            blob = np.arange(37, dtype=np.float64) * v
            slot.write(blob)
            seq, got = slot.read()
            np.testing.assert_array_equal(got, blob)
            seqs.append(seq)
        assert 0 < seqs[0] < seqs[1]
    finally:
        slot.close()


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_native_build_raises(g1, monkeypatch, tmp_path, compiler):
    """A native library that cannot be built raises where it is asked for;
    nothing falls back to the numpy twin, which runs only with native=False."""
    _, t, _, th = g1
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "host_native")
    monkeypatch.setattr(native_build, "CXX", str(tmp_path / "no-such-g++") if compiler == "missing" else "false")
    with pytest.raises(RuntimeError, match="host_model.cc"):
        NativeHostModel(th)
    with pytest.raises(RuntimeError, match="host_model.cc"):
        BipedalController(t)
    with pytest.raises(RuntimeError, match="rt_runtime.cc"):
        PolicySlot(4)
    with pytest.raises(RuntimeError, match="host_wbc.cc"):
        NativeWbc(t.info.nj, wbc_config_from_task(t.task), np.ones(42), 0.1, 1e-6, 1.6, 1e3)
    wbc = thw.HostWbc(None, None, wbc_config_from_task(t.task), hm=th, native=False)
    x, u = _random_xu(np.random.default_rng(1), np.asarray(t.initial_state), t.info.input_dim)
    rbd = _random_rbd(np.random.default_rng(2), t.info.nj)
    assert np.all(np.isfinite(wbc.update(x, u, rbd, np.ones(4)).decision))
    assert not (tmp_path / "host_native").exists() or not any((tmp_path / "host_native").rglob("*.so"))

"""PyTorch port vs JAX reference: the model layer under the device WBC and
the Kalman filter, on G1's configuration and the synthetic G1-shaped URDF
(tests/data/g1_shaped_biped.urdf), float64 on the CPU, inputs drawn from
numpy seeds: the rotation functions, frame Jacobians and their time
derivatives (torch.func.jvp), the com, the centroidal additions at 1e-10;
mass matrix, nonlinear effects (torch.func.grad and jvp) and the rest of
model/dynamics.py at 1e-9 (the bars of tests/test_host_wbc.py:63-64).
"""
import os

import numpy as np
import pytest
import torch

from bipedal_control_tpu.interface import make_interface as j_make_interface
from bipedal_control_tpu.model import centroidal as jc
from bipedal_control_tpu.model import dynamics as jd
from bipedal_control_tpu.model import host_dynamics as jhd
from bipedal_control_tpu.model import host_model as jhm
from bipedal_control_tpu.model import kinematics as jk
from bipedal_control_tpu.utils import rotations as jr
from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.model import centroidal as tc
from bipedal_control_tpu_torch.model import dynamics as td
from bipedal_control_tpu_torch.model import kinematics as tk
from bipedal_control_tpu_torch.utils import rotations as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))


def _close(name, got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))
    assert err <= tol, f"{name}: rel err {err:.3e} (bar {tol:g})"


@pytest.fixture(scope="module")
def g1():
    """(JAX interface, port interface on the CPU, the JAX package's host model)."""
    j = j_make_interface(G1_URDF, *G1_FILES)
    return j, make_interface(G1_URDF, *G1_FILES, device="cpu"), jhm.make_host_model(j.model, j.info)


def _random_qv(rng, nj):
    q = rng.normal(scale=0.3, size=6 + nj)
    q[2] += 0.665
    return q, rng.normal(scale=0.5, size=6 + nj)


def _random_wbc_inputs(rng, t):
    """(x, u, rbd) near G1's stand."""
    x0, nj = np.asarray(t.initial_state), t.info.nj
    x = x0 + np.concatenate([rng.normal(scale=0.05, size=6), rng.normal(scale=0.01, size=6),
                             rng.normal(scale=0.05, size=nj)])
    u = np.concatenate([np.tile([0.0, 0.0, t.info.robot_mass * 9.81 / 4], 4) + rng.normal(scale=5.0, size=12),
                        rng.normal(scale=0.3, size=nj)])
    return x, u, None


def test_rotations_match_reference():
    rng = np.random.default_rng(1)
    for _ in range(3):
        th = rng.uniform(-1.0, 1.0, size=3)
        th[1] *= 0.5
        T = torch.as_tensor(th)
        for name in ("rot_x", "rot_y", "rot_z"):
            _close(name, getattr(tr, name)(T[0]), getattr(jr, name)(th[0]), 1e-10)
        R = np.asarray(jr.rotmat_from_zyx(th))
        _close("zyx_from_rotmat", tr.zyx_from_rotmat(torch.as_tensor(R)), jr.zyx_from_rotmat(R), 1e-10)
        _close("euler_rate_map_zyx_inv", tr.euler_rate_map_zyx_inv(T), jr.euler_rate_map_zyx_inv(th), 1e-10)
        S = rng.normal(size=(3, 3))
        _close("unskew", tr.unskew(torch.as_tensor(S)), jr.unskew(S), 1e-10)
        R2 = np.asarray(jr.rotmat_from_zyx(th + rng.normal(scale=0.3, size=3)))
        for Ra, Rb in ((R, R2), (R, R)):  # a finite rotation and the identity's Taylor branch
            _close("rotation_error_in_world", tr.rotation_error_in_world(torch.as_tensor(Ra), torch.as_tensor(Rb)),
                   jr.rotation_error_in_world(Ra, Rb), 1e-10)
        _close("rotation_matrix_to_rotation_vector", tr.rotation_matrix_to_rotation_vector(torch.as_tensor(R)),
               jr.rotation_matrix_to_rotation_vector(R), 1e-10)
        a = rng.uniform(-12.0, 12.0, size=5)
        _close("wrap_to_pi", tr.wrap_to_pi(torch.as_tensor(a)), jr.wrap_to_pi(a), 1e-10)
        _close("unwrap_near", tr.unwrap_near(torch.as_tensor(a), torch.as_tensor(a[::-1].copy())),
               jr.unwrap_near(a, a[::-1]), 1e-10)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        _close("quat_wxyz_to_rotmat", tr.quat_wxyz_to_rotmat(torch.as_tensor(q)), jr.quat_wxyz_to_rotmat(q), 1e-10)
        _close("zyx_from_quat_wxyz", tr.zyx_from_quat_wxyz(torch.as_tensor(q)), jr.zyx_from_quat_wxyz(q), 1e-10)
        _close("rpy_to_rotmat", tr.rpy_to_rotmat(T), jr.rpy_to_rotmat(th), 1e-10)


def test_kinematics_and_centroidal_match_reference(g1):
    """frame_jacobian, frame_jacobian_dot and the stacked frame Jacobians,
    point_jacobian, frame_velocity, com_position, and model/centroidal.py's
    additions, at 1e-10.  One frame's Jacobian and its derivative are held
    against JAX's (jax.jvp) directly; every frame's, the CMM's derivative and the
    base kinematics against the JAX package's host twins of the same
    functions (model/host_dynamics.py, held to its jvp-based ones by
    tests/test_host_wbc.py), which cost no JAX compile."""
    j, t, jh = g1
    rng = np.random.default_rng(2)
    nj, fids = t.info.nj, tuple(t.info.contact_frame_ids) + (0,)
    q, v = _random_qv(rng, nj)
    Q, V = torch.as_tensor(q), torch.as_tensor(v)
    kin_t, kin_j = tk.forward_kinematics(t.model, Q), jk.forward_kinematics(j.model, q)
    J_all, dJ_all = tk.frame_jacobians_and_dot(t.model, Q, V, fids)
    J_ref, dJ_ref, _, v_ref = jhd.frame_jacobians_np(jh, jhd.host_kinematics_np(jh, q, v), fids)
    fid = fids[0]
    _close("frame_jacobian (jax)", tk.frame_jacobian(t.model, Q, fid), jk.frame_jacobian(j.model, q, fid), 1e-10)
    _close("frame_jacobian_dot (jax.jvp)", tk.frame_jacobian_dot(t.model, Q, V, fid),
           jk.frame_jacobian_dot(j.model, q, v, fid), 1e-10)
    for i, fid in enumerate(fids):
        _close("frame_jacobian", tk.frame_jacobian(t.model, Q, fid), J_ref[i], 1e-10)
        _close("frame_jacobians", J_all[i], J_ref[i], 1e-10)
        _close("frame_jacobian_dot", tk.frame_jacobian_dot(t.model, Q, V, fid), dJ_ref[i], 1e-10)
        _close("frame_jacobians_and_dot", dJ_all[i], dJ_ref[i], 1e-10)
        _close("frame_velocity", tk.frame_velocity(t.model, Q, V, fid)[:3], v_ref[i], 1e-10)
    b, p = 5, rng.normal(size=3)
    _close("point_jacobian", tk.point_jacobian(t.model, kin_t, b, torch.as_tensor(p)),
           jk.point_jacobian(j.model, kin_j, b, p), 1e-10)
    _close("com_position", tk.com_position(t.model, kin_t), jk.com_position(j.model, kin_j), 1e-10)
    x, u, _ = _random_wbc_inputs(rng, t)
    X, U = torch.as_tensor(x), torch.as_tensor(u)
    acc = rng.normal(size=nj)
    for name, a, b_ in zip(("base pose", "base velocity", "base acceleration"),
                           tc.base_kinematics_from_centroidal(t.model, t.info, X, U, torch.as_tensor(acc)),
                           jhd.base_kinematics_from_centroidal_np(jh, x, u, acc)):
        _close(name, a, b_, 1e-10)
    _close("contact_positions", tc.contact_positions(t.model, t.info, Q), jc.contact_positions(j.model, j.info, q),
           1e-10)
    _close("contact_rotations", tc.contact_rotations(t.model, t.info, Q), jc.contact_rotations(j.model, j.info, q),
           1e-10)
    _close("centroidal_momentum_matrix_dot", tc.centroidal_momentum_matrix_dot(t.model, Q, V),
           jhd.centroidal_momentum_matrix_and_dot_np(jh, q, v)[1], 1e-10)
    _close("assemble_state", tc.assemble_state(X[:6], X[6:12], X[12:]), jc.assemble_state(x[:6], x[6:12], x[12:]),
           0.0)
    _close("assemble_input", tc.assemble_input(U[:12], U[12:]), jc.assemble_input(u[:12], u[12:]), 0.0)
    _close("get_base_pose", tc.get_base_pose(X), jc.get_base_pose(x), 0.0)
    _close("get_joint_positions", tc.get_joint_positions(X, t.info), jc.get_joint_positions(x, j.info), 0.0)
    _close("get_contact_force", tc.get_contact_force(U, 2), jc.get_contact_force(u, 2), 0.0)


def test_dynamics_match_reference(g1):
    """model/dynamics.py (torch.func autodiff) at 1e-9 (the bars of
    tests/test_host_wbc.py:63-64) on a batch of two states: the mass matrix
    against JAX's, the nonlinear effects and gravity against the JAX
    package's host twin (model/host_dynamics.py::mass_and_nle_np, held to
    JAX's jvp/grad version at these bars by tests/test_host_wbc.py)."""
    j, t, jh = g1
    rng = np.random.default_rng(3)
    qv = [_random_qv(rng, t.info.nj) for _ in range(2)]
    Q, V = (torch.as_tensor(np.stack(a)) for a in zip(*qv))
    vdot = rng.normal(size=(2, 6 + t.info.nj))
    M = td.mass_matrix(t.model, Q)
    nle = td.nonlinear_effects(t.model, Q, V)
    g = td.gravity_vector(t.model, Q)
    tau = td.inverse_dynamics(t.model, Q, V, torch.as_tensor(vdot))
    for k, (q, v) in enumerate(qv):
        M_ref, nle_ref = jhd.mass_and_nle_np(jh, q, v)
        _close("mass_matrix", M[k], jd.mass_matrix(j.model, q), 1e-9)
        _close("nonlinear_effects", nle[k], nle_ref, 1e-9)
        _close("gravity_vector", g[k], jhd.mass_and_nle_np(jh, q, np.zeros_like(v))[1], 1e-9)
        _close("potential_energy", td.potential_energy(t.model, Q)[k], jd.potential_energy(j.model, q), 1e-9)
        _close("kinetic_energy", td.kinetic_energy(t.model, Q, V)[k], 0.5 * v @ M_ref @ v, 1e-9)
        _close("inverse_dynamics", tau[k], M_ref @ vdot[k] + nle_ref, 1e-9)
    _close("forward_dynamics", td.forward_dynamics(t.model, Q, V, tau), vdot, 1e-9)

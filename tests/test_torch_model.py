"""PyTorch port vs JAX reference: model core (FK, CMM, flow map, directional
CMM derivative, URDF reduction) on the synthetic 4-joint biped, float64.

Both packages compute on identical parameters (carried across with
bipedal_control_tpu_torch.convert); inputs are drawn with numpy from a seed.
Tolerance 1e-9 relative to max(1, |ref|): the two are the same formulas in
a different summation order, so they agree to a few ulps (~1e-15).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.model import centroidal as jc
from bipedal_control_tpu.model import kinematics as jk
from bipedal_control_tpu.model import second_order as jso
from bipedal_control_tpu.model.urdf import build_reduced_model as j_build_reduced_model
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.model import centroidal as tc
from bipedal_control_tpu_torch.model import kinematics as tk
from bipedal_control_tpu_torch.model import second_order as tso
from bipedal_control_tpu_torch.model.urdf import build_reduced_model as t_build_reduced_model

from test_pallas_linearize_kernel import tiny_biped

TOL = 1e-9


def _check(name, got, ref, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(ref))))
    err = float(np.max(np.abs(got - ref))) / scale
    assert err < tol, f"{name}: rel err {err:.3e}"


@pytest.fixture(scope="module")
def models():
    model, info = tiny_biped()
    tm = convert.model_from_numpy(
        {f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)}, device="cpu"
    )
    ti = convert.info_from_numpy(dataclasses.asdict(info))
    return model, info, tm, ti


def _qv(info, seed, n=5):
    rng = np.random.default_rng(seed)
    nv = info.generalized_dim
    q = rng.normal(scale=0.5, size=(n, nv))
    q[:, 2] += 0.6
    v = rng.normal(size=(n, nv))
    return q, v


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_kinematics_and_cmm(models, seed):
    model, info, tm, ti = models
    q, _ = _qv(info, seed)
    kj = jax.vmap(lambda qq: jk.forward_kinematics(model, qq))(jnp.asarray(q))
    kt = tk.forward_kinematics(tm, torch.as_tensor(q))
    _check("R", kt.R, kj.R)
    _check("p", kt.p, kj.p)
    _check("E", kt.E, kj.E)
    A_j = jax.vmap(lambda qq: jc.centroidal_momentum_matrix(model, qq))(jnp.asarray(q))
    _check("A", tc.centroidal_momentum_matrix(tm, torch.as_tensor(q)), A_j)


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_map(models, seed):
    model, info, tm, ti = models
    rng = np.random.default_rng(seed + 10)
    x = rng.normal(scale=0.4, size=(6, info.state_dim))
    x[:, 8] += 0.6
    u = rng.normal(size=(6, info.input_dim))
    u[:, 2:12:3] += 30.0
    ref = jax.vmap(lambda xx, uu: jc.centroidal_flow_map(model, info, xx, uu))(jnp.asarray(x), jnp.asarray(u))
    _check("flow", tc.centroidal_flow_map(tm, ti, torch.as_tensor(x), torch.as_tensor(u)), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_velocity_fields_and_cmm_v_derivative(models, seed):
    model, info, tm, ti = models
    q, v = _qv(info, seed + 20)

    def jax_side(qq, vv):
        kin = jk.forward_kinematics(model, qq)
        fd = jso.velocity_fields(model, kin)
        return fd, jso.cmm_v_derivative(model, kin, fd, vv)

    fd_j, dAv_j = jax.vmap(jax_side)(jnp.asarray(q), jnp.asarray(v))
    kin_t = tk.forward_kinematics(tm, torch.as_tensor(q))
    fd_t = tso.velocity_fields(tm, kin_t)
    for f in ("w", "v0", "dw", "dv0"):
        _check(f, getattr(fd_t, f), getattr(fd_j, f))
    dAv_t = tso.cmm_v_derivative(tm, kin_t, fd_t, torch.as_tensor(v))
    _check("dA_v", dAv_t, dAv_j)
    # and against forward-mode AD of q -> A(q) v inside the port
    jac = torch.func.jacfwd(lambda qq: tc.centroidal_momentum_matrix(tm, qq) @ torch.as_tensor(v[0]))(
        torch.as_tensor(q[0])
    )
    _check("dA_v vs jacfwd", dAv_t[0], jac)


_URDF = """<robot name="mini">
  <link name="base"><inertial><origin xyz="0 0 0.1"/><mass value="5"/>
    <inertia ixx="0.1" iyy="0.2" izz="0.15" ixy="0.01" ixz="0" iyz="0"/></inertial></link>
  <link name="thigh"><inertial><origin xyz="0 0 -0.1" rpy="0.1 0 0"/><mass value="1"/>
    <inertia ixx="0.01" iyy="0.01" izz="0.002"/></inertial></link>
  <link name="shank"><inertial><origin xyz="0 0 -0.12"/><mass value="0.5"/>
    <inertia ixx="0.004" iyy="0.004" izz="0.001"/></inertial></link>
  <link name="foot"><inertial><origin xyz="0.02 0 -0.02"/><mass value="0.2"/>
    <inertia ixx="0.001" iyy="0.001" izz="0.001"/></inertial></link>
  <link name="sole"/>
  <joint name="hip" type="revolute"><parent link="base"/><child link="thigh"/>
    <origin xyz="0 0.1 -0.05" rpy="0 0.05 0"/><axis xyz="0 1 0"/>
    <limit lower="-1" upper="1" effort="50" velocity="10"/></joint>
  <joint name="knee" type="revolute"><parent link="thigh"/><child link="shank"/>
    <origin xyz="0 0 -0.3"/><axis xyz="0 1 0"/></joint>
  <joint name="ankle" type="revolute"><parent link="shank"/><child link="foot"/>
    <origin xyz="0 0 -0.3"/><axis xyz="0 1 0"/></joint>
  <joint name="sole_fixed" type="fixed"><parent link="foot"/><child link="sole"/>
    <origin xyz="0.05 0 -0.04"/></joint>
</robot>"""


def test_urdf_reduction_matches_reference():
    """The port's numpy URDF parser reduces like the reference's (the ankle
    is welded at a lock position and folded into the shank)."""
    args = (_URDF, ["hip", "knee"], {"ankle": 0.2}, {"toe": ("sole", (0.01, 0.0, 0.0))})
    ref = j_build_reduced_model(*args)
    got = t_build_reduced_model(*args)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-15, err_msg=f.name)
        else:
            assert a == b, f.name

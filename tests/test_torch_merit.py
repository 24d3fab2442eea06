"""PyTorch port vs JAX reference: the plain merit sums (the plain version of
the K4 CUDA kernel, ops/merit_kernel.py) against the reference's node_eval
sums on the synthetic biped, float64, rtol 1e-10 as the reference's own
kernel test (tests/test_pallas_merit.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.ocp.linearize import node_eval as j_node_eval
from bipedal_control_tpu.ocp.problem import NodeRefs as JNodeRefs
from bipedal_control_tpu.ocp.problem import OcpSettings as JOcpSettings
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.ops.merit_kernel import make_merit_sums

from test_pallas_linearize_kernel import _FLAGS, tiny_biped


def _instances(info, m, seed):
    rng = np.random.default_rng(seed)
    nx, nu = info.state_dim, info.input_dim
    x = rng.normal(scale=0.4, size=(m, nx))
    x[:, 8] += 0.6
    u = rng.normal(size=(m, nu))
    u[:, 2:12:3] += 30.0
    xn = x + rng.normal(scale=0.05, size=(m, nx))
    flags = _FLAGS[np.arange(m) % 4]
    vref = rng.normal(scale=0.3, size=(m, 4))
    pref = rng.normal(scale=0.05, size=(m, 4))
    dt = rng.choice([0.015, 0.02, 0.035], size=m)
    return x, u, xn, flags, vref, pref, dt


@pytest.mark.parametrize("integrator", ["rk2", "euler"])
def test_merit_sums_match_reference_node_eval(integrator):
    model, info = tiny_biped()
    tm = convert.model_from_numpy(
        {f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)}, device="cpu"
    )
    ti = convert.info_from_numpy(dataclasses.asdict(info))
    settings = JOcpSettings(position_error_gain=0.35, integrator=integrator)
    m = 12
    x, u, xn, flags, vref, pref, dt = _instances(info, m, 4)
    nx, nu = info.state_dim, info.input_dim
    refs = JNodeRefs(
        t=jnp.zeros(m), dt=jnp.asarray(dt), contact_flags=jnp.asarray(flags), swing_vref=jnp.asarray(vref),
        swing_pref=jnp.asarray(pref), x_nom=jnp.zeros((m, nx)), u_nom=jnp.zeros((m, nu)),
    )
    Q, R = jnp.eye(nx), jnp.eye(nu)
    _, d, e = jax.jit(jax.vmap(lambda a, b, c, r: j_node_eval(model, info, settings, Q, R, a, b, c, r)))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(xn), refs
    )
    d, e = np.asarray(d), np.asarray(e)
    want = np.stack([np.abs(d).sum(1), (d**2).sum(1), np.abs(e).sum(1), (e**2).sum(1)], axis=1)

    merit = make_merit_sums(tm, ti, convert.settings_from_numpy(dataclasses.asdict(settings)))
    T = lambda a: torch.as_tensor(a)
    got = merit(T(x), T(u), T(xn), T(flags), T(vref), T(pref), T(dt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    # leading dims are carried through: (2, m/2) instances give the same sums
    got2 = merit(*(T(a.reshape((2, m // 2) + a.shape[1:])) for a in (x, u, xn, flags, vref, pref, dt)))
    np.testing.assert_array_equal(got2.reshape(m, 4).numpy(), got)


def test_merit_kernel_rejects_what_it_does_not_implement():
    model, info = tiny_biped()
    tm = convert.model_from_numpy(
        {f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)}, device="cpu"
    )
    ti = convert.info_from_numpy(dataclasses.asdict(info))
    from bipedal_control_tpu_torch.ocp.problem import OcpSettings

    with pytest.raises(NotImplementedError):
        make_merit_sums(tm, ti, OcpSettings(integrator="rk4"))
    with pytest.raises(NotImplementedError):
        make_merit_sums(tm, dataclasses.replace(ti, model_type=1), OcpSettings())

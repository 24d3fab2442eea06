"""PyTorch port vs JAX reference: the linearize kernel's linearizer
(ops/linearize_kernel.py::make_node_linearizer, the entry of K1) on CPU
tensors, where it runs its plain version, against the reference's vmapped
structured linearization (the XLA path, with the same FK-free cost
quadratics as the reference's make_node_linearizer) on the synthetic biped,
the four contact modes of _FLAGS, float64, 1e-9 relative to max(1, |ref|)
as the reference's kernel test.  The kernel itself is held against the
same plain version on the card (tests/test_torch_kernels.py, chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.ocp.linearize import linearize_node_structured as j_linearize
from bipedal_control_tpu.ocp.problem import OcpSettings as JOcpSettings
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.ocp.problem import OcpSettings
from bipedal_control_tpu_torch.ops.linearize_kernel import make_node_linearizer

from test_pallas_linearize_kernel import _FLAGS, _nodes, tiny_biped
from test_torch_model import _check


@pytest.fixture(scope="module")
def problem():
    model, info = tiny_biped()
    tm = convert.model_from_numpy(
        {f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)}, device="cpu"
    )
    ti = convert.info_from_numpy(dataclasses.asdict(info))
    data = _nodes(info, np.random.default_rng(7))
    np.testing.assert_array_equal(np.asarray(data[3].contact_flags), _FLAGS)  # all four contact modes
    nx, nu = info.state_dim, info.input_dim
    return model, info, tm, ti, data, np.diag(np.linspace(1.0, 3.0, nx)), np.diag(np.linspace(0.1, 0.5, nu))


@pytest.mark.parametrize("integrator", ["rk2", "euler"])
@pytest.mark.parametrize("gain", [0.0, 0.35])
def test_node_linearizer_matches_reference(problem, integrator, gain):
    model, info, tm, ti, data, Q, R = problem
    settings = JOcpSettings(position_error_gain=gain, integrator=integrator, linearize="pallas")
    ref = jax.jit(
        jax.vmap(lambda x, u, xn, r: j_linearize(model, info, settings, jnp.asarray(Q), jnp.asarray(R), x, u, xn, r))
    )(*data)
    xs, us, xns, refs = data
    T = lambda a: torch.as_tensor(np.array(a))
    linearize = make_node_linearizer(
        tm, ti, convert.settings_from_numpy(dataclasses.asdict(settings)), T(Q), T(R)
    )
    got = linearize(T(xs), T(us), T(xns), convert.refs_from_numpy(
        {k: np.asarray(v) for k, v in refs._asdict().items()}, device="cpu"))
    for f in got._fields:
        _check(f"{integrator}.gain{gain}.{f}", getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize(
    "change", [{"exact_rk2_sensitivity": True}, {"integrator": "rk4"}, {"model_type": 1}],
    ids=["exact_rk2_sensitivity", "rk4", "model_type"],
)
def test_node_linearizer_rejects_what_the_kernel_does_not_implement(problem, change):
    """As the reference's make_node_linearizer: the kernel implements the
    same-point RK2 and euler of FullCentroidalDynamics only."""
    _, _, tm, ti, _, Q, R = problem
    settings = OcpSettings(linearize="pallas")
    if "model_type" in change:
        ti = dataclasses.replace(ti, **change)
    else:
        settings = dataclasses.replace(settings, **change)
    with pytest.raises(NotImplementedError):
        make_node_linearizer(tm, ti, settings, torch.as_tensor(Q), torch.as_tensor(R))

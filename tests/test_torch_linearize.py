"""PyTorch port vs JAX reference: structured node linearization and node
evaluation (ocp/linearize.py), and the node functions of ocp/problem.py, on
the synthetic biped, float64.

Four nodes cover full stance, flight and both mixed contact modes, with a
nonzero position-error gain and swing references, for euler and same-point
rk2 (and exact rk2 sensitivity).  The port is batched over the node axis;
the reference is vmapped.  Tolerance 1e-9 relative to max(1, |ref|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.ocp.linearize import linearize_node_structured as j_linearize
from bipedal_control_tpu.ocp.linearize import node_eval as j_node_eval
from bipedal_control_tpu.ocp import problem as jp
from bipedal_control_tpu.ocp.problem import OcpSettings as JOcpSettings
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.ocp import problem as tp
from bipedal_control_tpu_torch.ocp.linearize import linearize_node_structured, node_eval

from test_pallas_linearize_kernel import _nodes, tiny_biped
from test_torch_model import _check


@pytest.fixture(scope="module")
def problem():
    model, info = tiny_biped()
    tm = convert.model_from_numpy(
        {f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)}, device="cpu"
    )
    ti = convert.info_from_numpy(dataclasses.asdict(info))
    xs, us, xns, refs = _nodes(info, np.random.default_rng(3))
    nx, nu = info.state_dim, info.input_dim
    Q = np.diag(np.linspace(1.0, 3.0, nx))
    R = np.diag(np.linspace(0.1, 0.5, nu))
    return model, info, tm, ti, (xs, us, xns, refs), Q, R


def _port_args(ti, settings, Q, R, data):
    xs, us, xns, refs = data
    T = lambda a: torch.as_tensor(np.array(a))
    tref = convert.refs_from_numpy({k: np.asarray(v) for k, v in refs._asdict().items()}, device="cpu")
    ts = convert.settings_from_numpy(dataclasses.asdict(settings))
    return ts, T(Q), T(R), T(xs), T(us), T(xns), tref


@pytest.mark.parametrize(
    "integrator,exact", [("rk2", False), ("euler", False), ("rk2", True)]
)
def test_linearize_node_structured_matches_reference(problem, integrator, exact):
    model, info, tm, ti, data, Q, R = problem
    settings = JOcpSettings(position_error_gain=0.35, integrator=integrator, exact_rk2_sensitivity=exact)
    ref = jax.jit(
        jax.vmap(lambda x, u, xn, r: j_linearize(model, info, settings, jnp.asarray(Q), jnp.asarray(R), x, u, xn, r))
    )(*data)
    ts, tQ, tR, *args = _port_args(ti, settings, Q, R, data)
    got = linearize_node_structured(tm, ti, ts, tQ, tR, *args)
    for f in got._fields:
        _check(f"{integrator}.{f}", getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize("integrator", ["rk2", "euler"])
def test_node_eval_matches_reference(problem, integrator):
    model, info, tm, ti, data, Q, R = problem
    settings = JOcpSettings(position_error_gain=0.35, integrator=integrator)
    ref = jax.jit(
        jax.vmap(lambda x, u, xn, r: j_node_eval(model, info, settings, jnp.asarray(Q), jnp.asarray(R), x, u, xn, r))
    )(*data)
    ts, tQ, tR, *args = _port_args(ti, settings, Q, R, data)
    got = node_eval(tm, ti, ts, tQ, tR, *args)
    for name, g, r in zip(("cost", "defect", "eq"), got, ref):
        _check(f"{integrator}.{name}", g, r)


@pytest.mark.parametrize("integrator", ["rk2", "euler", "rk4"])
def test_problem_node_functions_match_reference(problem, integrator):
    """discrete_dynamics, equality_residual, node_cost and the weight-
    compensating input of ocp/problem.py, node by node."""
    model, info, tm, ti, data, Q, R = problem
    settings = JOcpSettings(position_error_gain=0.35, integrator=integrator)
    xs, us, xns, refs = data
    jQ, jR = jnp.asarray(Q), jnp.asarray(R)
    ref = jax.jit(
        jax.vmap(
            lambda x, u, r: (
                jp.discrete_dynamics(model, info, settings, x, u, r.dt),
                jp.equality_residual(model, info, settings, x, u, r),
                jp.node_cost(model, info, settings, jQ, jR, x, u, r),
                jp.weight_compensating_input(info, r.contact_flags, info.input_dim),
            )
        )
    )(xs, us, refs)
    ts, tQ, tR, tx, tu, _, tref = _port_args(ti, settings, Q, R, data)
    got = (
        tp.discrete_dynamics(tm, ti, ts, tx, tu, tref.dt),
        tp.equality_residual(tm, ti, ts, tx, tu, tref),
        tp.node_cost(tm, ti, ts, tQ, tR, tx, tu, tref),
        tp.weight_compensating_input(ti, tref.contact_flags, ti.input_dim),
    )
    for name, g, r in zip(("F", "e", "cost", "u_nom"), got, ref):
        _check(f"{integrator}.{name}", g, r)

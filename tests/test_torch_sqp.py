"""PyTorch port vs JAX reference: the slice as a whole.

The port's make_batched_solver with riccati="pallas", merit="pallas" (their
plain versions on CPU tensors), and linearize "structured" or "pallas" (the
production configuration, which make_batched_solver sends through
solver/lanes_rti.py), against the reference's vmap(sqp_solve) with
riccati="sequential", merit="xla", on the synthetic biped with per-scenario
contact patterns and warm starts, float64.  Both port configurations share
one compiled reference per set of line-search alphas.  Bars are those of the
reference's batched-parity test (tests/test_lanes_rti.py): bit-level
differences in the stage data are amplified ~1e10 through the stage KKT, so
1e-5 relative (K 1e-3) is the honest bar, and the discrete line-search
outcome (step_size) must match exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.ocp.problem import OcpSettings as JOcpSettings
from bipedal_control_tpu.solver.sqp import sqp_solve as j_sqp_solve
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.parallel.batch_solver import make_batched_solver

from test_lanes_rti import _batched_problem
from test_pallas_linearize_kernel import tiny_biped

BARS = (("x_traj", 1e-5), ("u_traj", 1e-5), ("K", 1e-3), ("cost", 1e-5), ("defect_norm", 1e-5), ("eq_norm", 1e-5))


def _ref_settings(alphas):
    return JOcpSettings(
        position_error_gain=0.35, integrator="rk2", riccati="sequential", merit="xla",
        sqp_iterations=1, linesearch_alphas=alphas,
    )


def _weights(info):
    return np.diag(np.linspace(1.0, 3.0, info.state_dim)), np.diag(np.linspace(0.1, 0.5, info.input_dim))


@functools.lru_cache(maxsize=None)
def _reference(alphas):
    """The reference's vmap(sqp_solve) on _batched_problem."""
    model, info = tiny_biped()
    Q, R = _weights(info)
    settings = _ref_settings(alphas)
    return jax.jit(
        jax.vmap(
            lambda r, t, x, ws_x, ws_u: j_sqp_solve(
                model, info, settings, jnp.asarray(Q), jnp.asarray(R), r, t, x, ws_x, ws_u
            )
        )
    )(*_batched_problem(model, info))


def solve_pair(alphas, **port_settings):
    """(port solution, reference solution) on _batched_problem: the port's
    make_batched_solver on the CPU with the reference's settings changed by
    port_settings, and the reference's vmap(sqp_solve) with riccati
    "sequential", merit "xla"."""
    ref = _reference(alphas)
    model, info = tiny_biped()
    Q, R = _weights(info)
    ref_settings = _ref_settings(alphas)
    refs, t_nodes, x_init, xs_w, us_w = _batched_problem(model, info)
    tm = convert.model_from_numpy(
        {f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)}, device="cpu"
    )
    ti = convert.info_from_numpy(dataclasses.asdict(info))
    settings = dataclasses.replace(convert.settings_from_numpy(dataclasses.asdict(ref_settings)), **port_settings)
    solver = make_batched_solver(tm, ti, settings, Q, R, device="cpu")
    T = lambda a: torch.as_tensor(np.array(a))
    xs_t, us_t = T(xs_w), T(us_w)
    xs_before = xs_t.clone()
    got = solver(convert.refs_from_numpy({k: np.asarray(v) for k, v in refs._asdict().items()}, device="cpu"),
                 T(t_nodes), T(x_init), xs_t, us_t)
    assert torch.equal(xs_t, xs_before), "warm-start input was modified"
    return got, ref


def assert_within_bars(got, ref):
    for name, tol in BARS:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(ref, name))
        err = float(np.max(np.abs(g - w))) / max(1.0, float(np.max(np.abs(w))))
        assert err < tol, f"{name}: rel err {err:.3e}"
    np.testing.assert_array_equal(got.step_size.numpy(), np.asarray(ref.step_size))


@pytest.mark.parametrize(
    "alphas,linearize",
    [((1.0, 0.5), "structured"), ((1.0,), "structured"), ((), "structured"),
     ((1.0, 0.5), "pallas"), ((1.0,), "pallas"), ((), "pallas")],
    ids=["alphas0", "alphas1", "alphas2", "pallas-alphas0", "pallas-alphas1", "pallas-alphas2"],
)
def test_batched_solver_matches_vmap_sqp(alphas, linearize):
    assert_within_bars(*solve_pair(alphas, linearize=linearize, riccati="pallas", merit="pallas"))

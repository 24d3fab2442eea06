"""PyTorch port vs JAX reference: the slice as a whole.

The port's make_batched_solver with riccati="pallas", merit="pallas" (their
plain versions on CPU tensors) against the reference's vmap(sqp_solve) with
riccati="sequential", merit="xla", on the synthetic biped with per-scenario
contact patterns and warm starts, float64.  Bars are those of the
reference's batched-parity test (tests/test_lanes_rti.py): bit-level
differences in the stage data are amplified ~1e10 through the stage KKT, so
1e-5 relative (K 1e-3) is the honest bar, and the discrete line-search
outcome (step_size) must match exactly.
"""
import dataclasses

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


@pytest.mark.parametrize("alphas", [(1.0, 0.5), (1.0,), ()])
def test_batched_solver_matches_vmap_sqp(alphas):
    model, info = tiny_biped()
    nx, nu = info.state_dim, info.input_dim
    Q = np.diag(np.linspace(1.0, 3.0, nx))
    R = np.diag(np.linspace(0.1, 0.5, nu))
    ref_settings = JOcpSettings(
        position_error_gain=0.35, integrator="rk2", riccati="sequential", merit="xla",
        sqp_iterations=1, linesearch_alphas=alphas,
    )
    refs, t_nodes, x_init, xs_w, us_w = _batched_problem(model, info)
    ref = jax.jit(
        jax.vmap(
            lambda r, t, x, ws_x, ws_u: j_sqp_solve(
                model, info, ref_settings, jnp.asarray(Q), jnp.asarray(R), r, t, x, ws_x, ws_u
            )
        )
    )(refs, t_nodes, x_init, xs_w, us_w)

    tm = convert.model_from_numpy({f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)})
    ti = convert.info_from_numpy(dataclasses.asdict(info))
    settings = dataclasses.replace(
        convert.settings_from_numpy(dataclasses.asdict(ref_settings)), riccati="pallas", merit="pallas"
    )
    solver = make_batched_solver(tm, ti, settings, Q, R)
    T = lambda a: torch.as_tensor(np.asarray(a))
    xs_t, us_t = T(xs_w), T(us_w)
    xs_before = xs_t.clone()
    got = solver(convert.refs_from_numpy({k: np.asarray(v) for k, v in refs._asdict().items()}),
                 T(t_nodes), T(x_init), xs_t, us_t)
    assert torch.equal(xs_t, xs_before), "warm-start input was modified"

    for name, tol in BARS:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(ref, name))
        err = float(np.max(np.abs(g - w))) / max(1.0, float(np.max(np.abs(w))))
        assert err < tol, f"{name}: rel err {err:.3e}"
    np.testing.assert_array_equal(got.step_size.numpy(), np.asarray(ref.step_size))

"""PyTorch port vs JAX reference: the AL-iLQR solver (solver/ddp.py) and
MpcRunner(solver="ilqr"), float64 on the CPU.

ilqr_solve on the synthetic biped over three lanes of
tests/test_lanes_rti.py's problem (N = 4, per-lane contact patterns and warm
states), two iterations (iteration 0's penalized backward pass, then the
constrained stage KKT with multiplier updates), for the line-search and the
Levenberg-Marquardt strategies (LM with min_rel_cost, so the freeze runs),
with return_al_state and return_history, against the reference's
vmap(ilqr_solve): the solution at 1e-5 relative to max(1, max|ref|) (K 1e-3),
the multipliers at 1e-5 relative, rho and the history's accept flags
exactly.  Then MpcRunner(solver="ilqr", ddp_iterations=2) on G1's
configuration (configs/g1/* on tests/data/g1_shaped_biped.urdf, trot from
0.1 s): a cold and two warm replans against the reference's runner on the
same measured states, at the same bars.  The reference's iLQR compiles once
per strategy and per replan kind (~30 s each on this CPU).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.interface import make_interface as j_make_interface
from bipedal_control_tpu.ocp.problem import OcpSettings as JOcpSettings
from bipedal_control_tpu.runtime.mpc_runner import MpcRunner as JMpcRunner
from bipedal_control_tpu.solver import ddp as j_ddp
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.runtime.mpc_runner import MpcRunner
from bipedal_control_tpu_torch.solver import ddp

from test_lanes_rti import _batched_problem
from test_pallas_linearize_kernel import tiny_biped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))
BARS = (("x_traj", 1e-5), ("u_traj", 1e-5), ("K", 1e-3), ("cost", 1e-5), ("defect_norm", 1e-5), ("eq_norm", 1e-5))


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def _assert_solution(got, ref, lane=None):
    for name, bar in BARS:
        g = getattr(got, name)
        err = _rel(g.numpy() if lane is None else g[lane].numpy(), getattr(ref, name))
        assert err < bar, f"{name}: rel err {err:.3e}"


@pytest.mark.parametrize("strategy", ["line_search", "levenberg_marquardt"])
def test_ilqr_solve_matches_reference(strategy):
    model, info = tiny_biped()
    refs, t_nodes, x_init, xs, us = _batched_problem(model, info)
    Q, R = np.diag(np.linspace(1.0, 3.0, info.state_dim)), np.diag(np.linspace(0.1, 0.5, info.input_dim))
    settings = JOcpSettings(position_error_gain=0.35)
    knobs = dict(iterations=2, strategy=strategy, min_rel_cost=1e-3 if strategy == "levenberg_marquardt" else 0.0)
    j_settings = j_ddp.DdpSettings(**knobs)
    ref, (j_lam, j_rho), j_hist = jax.jit(jax.vmap(lambda r, t, x, u, xw: j_ddp.ilqr_solve(
        model, info, settings, j_settings, jnp.asarray(Q), jnp.asarray(R), r, t, x, u, x_warm=xw,
        return_al_state=True, return_history=True)))(refs, t_nodes, x_init, us, xs)

    tm = convert.model_from_numpy({f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)},
                                  device="cpu")
    T = lambda a: torch.as_tensor(np.array(a))
    got, (lam, rho), hist = ddp.ilqr_solve(
        tm, convert.info_from_numpy(dataclasses.asdict(info)), convert.settings_from_numpy(dataclasses.asdict(settings)),
        ddp.DdpSettings(**knobs), T(Q), T(R), convert.refs_from_numpy({k: np.asarray(v) for k, v in refs._asdict().items()},
                                                                      device="cpu"),
        T(t_nodes), T(x_init), T(us), x_warm=T(xs), return_al_state=True, return_history=True)
    _assert_solution(got, ref)
    np.testing.assert_array_equal(got.step_size.numpy(), np.asarray(ref.step_size))
    assert _rel(lam.numpy(), j_lam) < 1e-5
    np.testing.assert_array_equal(rho.numpy(), np.asarray(j_rho))
    assert hist.shape == j_hist.shape == (3, 2, 6)
    np.testing.assert_array_equal(hist[..., 0].numpy(), np.asarray(j_hist)[..., 0])
    assert _rel(hist[..., 1:].double().numpy(), np.asarray(j_hist)[..., 1:]) < 1e-5


@pytest.fixture(scope="module")
def runners():
    """(JAX runner, port runner), solver "ilqr" with two iterations."""
    j_mpc = JMpcRunner(j_make_interface(G1_URDF, *G1_FILES), solver="ilqr", ddp_iterations=2)
    t_mpc = MpcRunner(make_interface(G1_URDF, *G1_FILES, device="cpu"), solver="ilqr", ddp_iterations=2)
    for mpc in (j_mpc, t_mpc):
        mpc.rm.set_gait(mpc.iface.task.gait_library["trot"], 0.1)
    return j_mpc, t_mpc


def test_ilqr_runner_matches_reference(runners):
    """A cold and two warm replans of MpcRunner(solver="ilqr") against the
    reference's runner, on the same measured states; the runner's DDP
    settings are the reference's (the penalty floored at 100)."""
    j_mpc, t_mpc = runners
    assert dataclasses.asdict(t_mpc.ddp) == dataclasses.asdict(
        j_ddp.DdpSettings(iterations=2, constraint_penalty=100.0, penalty_increase_rate=2.0, strategy="line_search"))
    rng = np.random.default_rng(0)
    x0 = np.asarray(j_mpc.iface.initial_state)
    for t in (0.0, 0.02, 0.04):
        x = x0 + rng.normal(scale=0.005, size=x0.shape)
        ref = j_mpc.advance(t, jnp.asarray(x))
        got = t_mpc.advance(t, torch.as_tensor(x))
        _assert_solution(got, ref, lane=0)
        assert float(got.defect_norm[0]) < 1e-8  # single shooting
    assert not t_mpc.graphed  # the CPU runs op by op

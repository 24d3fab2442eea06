"""PyTorch port vs JAX reference: the parallel-in-time Riccati backends
(solver/parallel_riccati.py), float64 (and float32 for the square-root
form) on the CPU.

The problems are tests/test_parallel_riccati.py's random LQR problems
(tests/test_riccati.py::_random_problem, seeds 7-11), held against the
port's sequential sweep at that file's tolerances (unconstrained: dx, du
1e-8, K 1e-7 dense and 1e-7 / 1e-6 square-root; constrained at penalty 1e6:
dx, du 1e-5; float32 square root at penalty 1e4, N = 64: 1e-2 against the
float64 sequential sweep), and against the reference's
solve_lqr_parallel(_sqrt) at 1e-8 absolute.  The port's associative scan
runs jax.lax.associative_scan's recursion, so the unconstrained problems
agree with the reference to ~1e-15.  One case is not held at 1e-8: the dense
scan of a constrained problem at penalty 1e6 is conditioned so that the
reference's own result moves by up to ~2e-5 when its inputs move by one
ulp (measured on seeds 8 and 9), so no second implementation meets 1e-8
there; it is held against the sequential sweep at the reference test's
1e-5, and the dense scan of the same constrained problems at penalty 1e4 is
held against the reference at 1e-8.  Then the batched solve (three lanes at
once equal to each lane alone, 1e-12) and sqp_solve's dispatch of
riccati "parallel" and "parallel_sqrt" against the reference's SQP with the
same backend, at the batched-parity bars.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.solver import parallel_riccati as jpr
from bipedal_control_tpu_torch.ocp.problem import LinearizedNode
from bipedal_control_tpu_torch.solver import parallel_riccati as tpr
from bipedal_control_tpu_torch.solver.riccati import solve_lqr

from test_riccati import _random_problem

FIELDS = ("dx", "du", "K", "k")
# the reference's solves, jitted once per form (the penalty is traced)
J_SOLVE = {"dense": jax.jit(jpr.solve_lqr_parallel), "sqrt": jax.jit(jpr.solve_lqr_parallel_sqrt)}


def _problem(seed, N, constrained, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    nodes, masks = _random_problem(rng, N=N, constrained=constrained)
    dx0 = rng.normal(size=4) * 0.1
    T = lambda a: torch.as_tensor(np.array(a), dtype=dtype)[None]
    return (nodes, masks, jnp.asarray(dx0)), (LinearizedNode(*(T(f) for f in nodes)), T(masks), T(dx0))


def _max_err(got, want, names=FIELDS):
    return {n: float(np.max(np.abs(getattr(got, n)[0].double().numpy() - np.asarray(getattr(want, n)))))
            for n in names}


CASES = [  # (seed, N, constrained, penalty, (dx/du tol, K tol) against the sequential sweep)
    (7, 12, False, 1e6, (1e-8, 1e-7)),
    (8, 10, True, 1e6, (1e-5, None)),
]


@pytest.mark.parametrize("form", ["dense", "sqrt"])
@pytest.mark.parametrize("seed,N,constrained,penalty,tols", CASES, ids=["unconstrained", "constrained"])
def test_parallel_matches_sequential(form, seed, N, constrained, penalty, tols):
    seed = seed + (2 if form == "sqrt" else 0)  # the reference test's seeds: 7, 8 dense; 9, 10 square root
    _, (nodes, masks, dx0) = _problem(seed, N, constrained)
    seq = solve_lqr(nodes, masks, dx0)
    solve = tpr.solve_lqr_parallel if form == "dense" else tpr.solve_lqr_parallel_sqrt
    par = solve(nodes, masks, dx0, penalty)
    tol, k_tol = tols
    if form == "sqrt" and not constrained:
        tol, k_tol = 1e-7, 1e-6
    for name in ("dx", "du"):
        torch.testing.assert_close(getattr(par, name), getattr(seq, name), rtol=0, atol=tol)
    if k_tol is not None:
        torch.testing.assert_close(par.K, seq.K, rtol=0, atol=k_tol)


def test_sqrt_float32_stable():
    """The square-root scan in float32 stays finite and within 1e-2 of the
    float64 sequential sweep at N = 64, penalty 1e4; the dense scan refuses
    float32, as the reference's does."""
    _, (nodes, masks, dx0) = _problem(11, 64, True)
    seq64 = solve_lqr(nodes, masks, dx0)
    _, (n32, m32, d32) = _problem(11, 64, True, torch.float32)
    par32 = tpr.solve_lqr_parallel_sqrt(n32, m32, d32, penalty=1e4)
    assert bool(torch.isfinite(par32.dx).all()) and bool(torch.isfinite(par32.du).all())
    torch.testing.assert_close(par32.dx.double(), seq64.dx, rtol=0, atol=1e-2)
    torch.testing.assert_close(par32.du.double(), seq64.du, rtol=0, atol=1e-2)
    with pytest.raises(NotImplementedError, match="float64"):
        tpr.solve_lqr_parallel(n32, m32, d32)


@pytest.mark.parametrize("form,penalty", [("dense", 1e4), ("sqrt", 1e6), ("sqrt", 1e4)])
@pytest.mark.parametrize("seed,N,constrained", [(7, 12, False), (8, 10, True), (9, 13, True), (11, 64, True)],
                         ids=["unconstrained", "constrained-10", "constrained-13", "constrained-64"])
def test_parallel_matches_reference(form, penalty, seed, N, constrained):
    (j_nodes, j_masks, j_dx0), (nodes, masks, dx0) = _problem(seed, N, constrained)
    solve = tpr.solve_lqr_parallel if form == "dense" else tpr.solve_lqr_parallel_sqrt
    errs = _max_err(solve(nodes, masks, dx0, penalty), J_SOLVE[form](j_nodes, j_masks, j_dx0, penalty),
                    FIELDS + ("expected_decrease",))
    assert max(errs.values()) < 1e-8, errs


def test_dense_unconstrained_matches_reference_at_penalty_1e6():
    """The dense scan at its default penalty where the problem is
    well-conditioned (no constraint rows): the reference's association
    order, agreement to rounding."""
    (j_nodes, j_masks, j_dx0), (nodes, masks, dx0) = _problem(7, 12, False)
    errs = _max_err(tpr.solve_lqr_parallel(nodes, masks, dx0), J_SOLVE["dense"](j_nodes, j_masks, j_dx0, 1e6))
    assert max(errs.values()) < 1e-12, errs


@pytest.mark.parametrize("form", ["dense", "sqrt"])
def test_lanes_solve_alone(form):
    """Three problems as one batch equal each solved alone (1e-12)."""
    probs = [_problem(s, 10, True)[1] for s in (8, 10, 12)]
    batch = (LinearizedNode(*(torch.cat(f) for f in zip(*(p[0] for p in probs)))),
             torch.cat([p[1] for p in probs]), torch.cat([p[2] for p in probs]))
    solve = tpr.solve_lqr_parallel if form == "dense" else tpr.solve_lqr_parallel_sqrt
    both = solve(*batch, 1e4)
    for lane, p in enumerate(probs):
        alone = solve(*p, 1e4)
        for name in FIELDS + ("expected_decrease",):
            torch.testing.assert_close(getattr(both, name)[lane : lane + 1], getattr(alone, name), rtol=0,
                                       atol=1e-12, msg=name)


@pytest.mark.parametrize("riccati", ["parallel", "parallel_sqrt"])
def test_sqp_dispatches_parallel_backends(riccati):
    """sqp_solve, through make_batched_solver, takes riccati "parallel" and
    "parallel_sqrt" with riccati_penalty: one SQP iteration on the synthetic
    biped's batched problem (tests/test_lanes_rti.py's) against the
    reference's vmap(sqp_solve) with the same backend, at the batched-parity
    bars (1e-5 relative, K 1e-3, step_size exact).  (On this problem the
    penalty-folded backends land 2.2 away from the sequential sweep's
    exact stage KKT, in both packages.)"""
    from bipedal_control_tpu.ocp.problem import OcpSettings as JOcpSettings
    from bipedal_control_tpu.solver.sqp import sqp_solve as j_sqp_solve
    from bipedal_control_tpu_torch import convert
    from bipedal_control_tpu_torch.parallel.batch_solver import make_batched_solver

    from test_lanes_rti import _batched_problem
    from test_pallas_linearize_kernel import tiny_biped

    model, info = tiny_biped()
    refs, t_nodes, x_init, xs, us = _batched_problem(model, info)
    Q, R = np.diag(np.linspace(1.0, 3.0, info.state_dim)), np.diag(np.linspace(0.1, 0.5, info.input_dim))
    settings = JOcpSettings(position_error_gain=0.35, riccati=riccati, riccati_penalty=1e6,
                            linesearch_alphas=(1.0, 0.5))
    ref = jax.jit(jax.vmap(lambda r, t, x, a, u: j_sqp_solve(
        model, info, settings, jnp.asarray(Q), jnp.asarray(R), r, t, x, a, u)))(refs, t_nodes, x_init, xs, us)
    tm = convert.model_from_numpy({f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)},
                                  device="cpu")
    solver = make_batched_solver(tm, convert.info_from_numpy(dataclasses.asdict(info)),
                                 convert.settings_from_numpy(dataclasses.asdict(settings)), Q, R, device="cpu")
    T = lambda a: torch.as_tensor(np.array(a))
    got = solver(convert.refs_from_numpy({k: np.asarray(v) for k, v in refs._asdict().items()}, device="cpu"),
                 T(t_nodes), T(x_init), T(xs), T(us))
    for name, bar in (("x_traj", 1e-5), ("u_traj", 1e-5), ("K", 1e-3), ("cost", 1e-5), ("defect_norm", 1e-5),
                      ("eq_norm", 1e-5)):
        w = np.asarray(getattr(ref, name))
        err = float(np.max(np.abs(getattr(got, name).numpy() - w))) / max(1.0, float(np.max(np.abs(w))))
        assert err < bar, (name, err)
    np.testing.assert_array_equal(got.step_size.numpy(), np.asarray(ref.step_size))

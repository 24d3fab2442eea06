"""PyTorch port vs JAX reference: the hard and primal-dual friction cones of
the SQP (solver/sqp.py, cone "hard" and "ipm"), float64 on the CPU.

The scenario is the lean stress of tests/test_hard_cone.py on G1's
configuration (configs/g1/* on tests/data/g1_shaped_biped.urdf): mu = 0.05
ground, heavy forward-momentum tracking (vx weight 200, angular-momentum rows
free), a 0.3 s horizon (N = 20), a momentum target of 1.0 and 0.3 m of
displacement (the H1 test's 3.0 and 0.9 leave every G1 step rejected by the
filter's g_max band, in both packages).  The soft cone chains 12
one-iteration solves; the hard cone 2 solves of 4 iterations with
cone_mu_decay 0.1 (its barrier continuation: mu 0.1 -> 1e-4, delta 5 ->
0.01; the H1 test's 6 iterations at 0.25 cost the reference 50% more
compile time); the ipm refines the soft result in one solve of 4
iterations, as tests/test_ipm.py does.

The port runs two configurations: the plain backends (linearize
"structured", riccati "sequential", merit "xla") through sqp_solve, and the
production backends ("pallas": the kernels' plain versions on CPU tensors)
through make_batched_solver.  The production case holds the iteration's
settings in the linearizer and in the candidates' costs: given the base
settings instead, the hard and ipm solves leave their bars.  The reference
runs its plain backends.  Bars, those of the reference's batched-parity
test (tests/test_lanes_rti.py): x, u, cost, defect and eq 1e-5 relative to
max(1, max|ref|), K 1e-3, step_size exact, and the ipm's cone_slack and
cone_dual 1e-5.  Both packages must show the stress's properties: the hard
cone rides the boundary (every stance margin > -0.5 N, the least < 0.5 N),
the soft cone violates it (< -5 N) and tracks further, and the ipm restores
feasibility from the soft result (> -0.5 N).  The per-lane decisions
(the filter's pick, the ipm's fraction-to-boundary caps and dual steps) are
held by a port-only test: two lanes solved together equal each solved
alone, at the same bars (batched and single products round differently).
"""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.interface import make_interface as j_make_interface
from bipedal_control_tpu.ocp.problem import friction_cone_values as j_cone_values
from bipedal_control_tpu.reference.target import TargetTrajectories as JTargetTrajectories
from bipedal_control_tpu.solver.sqp import build_refs as j_build_refs
from bipedal_control_tpu.solver.sqp import initial_trajectory as j_initial_trajectory
from bipedal_control_tpu.solver.sqp import sqp_solve as j_sqp_solve
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.ocp.problem import friction_cone_values
from bipedal_control_tpu_torch.parallel.batch_solver import make_batched_solver
from bipedal_control_tpu_torch.solver.sqp import iteration_settings, sqp_solve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))
BARS = (("x_traj", 1e-5), ("u_traj", 1e-5), ("K", 1e-3), ("cost", 1e-5), ("defect_norm", 1e-5), ("eq_norm", 1e-5))
PLAIN = dict(linearize="structured", riccati="sequential", merit="xla")
PRODUCTION = dict(linearize="pallas", riccati="pallas", merit="pallas")
# cone -> (SQP iterations per solve, chained solves)
SCHEDULE = {"soft": (1, 12), "hard": (4, 2), "ipm": (4, 1)}
HARD_DECAY = 0.1


@pytest.fixture(scope="module")
def lean():
    """The lean stress on the reference's G1 interface: its settings and
    weights, node references and cold start (one lane), as numpy."""
    j_iface = j_make_interface(G1_URDF, *G1_FILES)
    settings = dataclasses.replace(j_iface.settings, horizon=0.3, friction_coefficient=0.05,
                                   cone_mu_decay=HARD_DECAY, **PLAIN)
    Q = np.asarray(j_iface.Q).copy()
    Q[0, 0] = 200.0  # vcom_x tracking dominates
    Q[3:6, 3:6] = 0.0  # free the angular momentum
    task = copy.deepcopy(j_iface.task)
    task.mpc.time_horizon = 0.3
    rm = dataclasses.replace(j_iface, settings=settings, task=task).make_reference_manager()
    x0 = np.asarray(j_iface.initial_state)
    s0, s1 = x0.copy(), x0.copy()
    s0[0] = s1[0] = 1.0  # normalized momentum vx reference
    s1[6] += 0.3
    rm.set_target(JTargetTrajectories(times=np.array([0.0, 0.3]), states=np.stack([s0, s1]),
                                      inputs=np.zeros((2, j_iface.info.input_dim))))
    frozen = rm.freeze(0.0)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = j_build_refs(j_iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    xs, us = j_initial_trajectory(j_iface.info, refs, jnp.asarray(x0), settings.num_intervals + 1)
    return dict(j_iface=j_iface, settings=settings, Q=Q, refs=refs, t_nodes=t_nodes, x_init=x0,
                xs=np.asarray(xs), us=np.asarray(us), stance=np.asarray(refs.contact_flags) > 0.5)


@pytest.fixture(scope="module")
def reference(lean):
    """The reference's solutions per cone (the ipm's from its soft one)."""
    j_iface, out = lean["j_iface"], {}
    for cone in ("soft", "hard", "ipm"):
        iters, chain = SCHEDULE[cone]
        settings = dataclasses.replace(lean["settings"], cone=cone, sqp_iterations=iters)
        solve = jax.jit(lambda xs, us, s=settings: j_sqp_solve(
            j_iface.model, j_iface.info, s, jnp.asarray(lean["Q"]), j_iface.R, lean["refs"], lean["t_nodes"],
            jnp.asarray(lean["x_init"]), xs, us))
        xs, us = (lean["xs"], lean["us"]) if cone != "ipm" else (out["soft"].x_traj, out["soft"].u_traj)
        for _ in range(chain):
            sol = solve(xs, us)
            xs, us = sol.x_traj, sol.u_traj
        out[cone] = sol
    return out


def _port_problem(lean, perturbed=(False,)):
    """The port's model, info, Q, R and the lean stress's inputs over one
    lane per entry of ``perturbed`` (a True lane starts with its momentum
    perturbed)."""
    j_iface = lean["j_iface"]
    model = convert.model_from_numpy(
        {f.name: np.asarray(getattr(j_iface.model, f.name)) for f in dataclasses.fields(j_iface.model)}, device="cpu")
    info = convert.info_from_numpy(dataclasses.asdict(j_iface.info))
    T = lambda a: torch.as_tensor(np.array(a))
    tile = lambda a: T(a)[None].expand((len(perturbed),) + np.shape(a)).contiguous()
    refs = convert.refs_from_numpy({k: np.asarray(v) for k, v in lean["refs"]._asdict().items()}, device="cpu")
    x_init = tile(lean["x_init"])
    x_init[torch.tensor(perturbed), 0:2] += torch.tensor([0.03, -0.02], dtype=torch.float64)
    inputs = (type(refs)(*(tile(f) for f in refs)), tile(lean["t_nodes"]), x_init, tile(lean["xs"]), tile(lean["us"]))
    return model, info, T(lean["Q"]), T(j_iface.R), inputs


def _port(lean, cone, backends, start=None, perturbed=(False,)):
    """The port's chain of solves for cone, on the CPU: sqp_solve for the
    plain backends, make_batched_solver for the production ones."""
    model, info, Q, R, (refs, t_nodes, x_init, xs, us) = _port_problem(lean, perturbed)
    iters, chain = SCHEDULE[cone]
    settings = dataclasses.replace(convert.settings_from_numpy(dataclasses.asdict(lean["settings"])), cone=cone,
                                   sqp_iterations=iters, **backends)
    if backends == PRODUCTION:
        solve = make_batched_solver(model, info, settings, Q, R, device="cpu")
    else:
        solve = lambda *a: sqp_solve(model, info, settings, Q, R, *a)
    if start is not None:
        xs, us = start
    for _ in range(chain):
        sol = solve(refs, t_nodes, x_init, xs, us)
        xs, us = sol.x_traj, sol.u_traj
    return sol, settings, info


def _assert_within_bars(got, ref, extra=()):
    for name, tol in BARS + extra:
        g, w = getattr(got, name)[0].numpy(), np.asarray(getattr(ref, name))
        err = float(np.max(np.abs(g - w))) / max(1.0, float(np.max(np.abs(w))))
        assert err < tol, f"{name}: rel err {err:.3e}"
    np.testing.assert_array_equal(got.step_size[0].numpy(), np.asarray(ref.step_size))


@pytest.fixture(scope="module")
def port_soft(lean):
    return {b: _port(lean, "soft", kw)[0] for b, kw in (("plain", PLAIN), ("production", PRODUCTION))}


@pytest.mark.parametrize("backends", ["plain", "production"])
@pytest.mark.parametrize("cone", ["soft", "hard", "ipm"])
def test_cone_solve_matches_reference(lean, reference, port_soft, cone, backends):
    kw = PLAIN if backends == "plain" else PRODUCTION
    if cone == "soft":
        got = port_soft[backends]
    else:
        start = None if cone == "hard" else (port_soft[backends].x_traj, port_soft[backends].u_traj)
        got = _port(lean, cone, kw, start)[0]
    extra = (("cone_slack", 1e-5), ("cone_dual", 1e-5)) if cone == "ipm" else ()
    _assert_within_bars(got, reference[cone], extra)
    if cone != "ipm":
        assert got.cone_slack is None and got.cone_dual is None


def _margins(settings, u_traj, info, stance, cone_values=friction_cone_values):
    return np.asarray(cone_values(settings, u_traj, info))[stance]


def test_hard_cone_rides_the_boundary_and_soft_does_not(lean, reference, port_soft):
    """The stress's properties, in both packages: the hard continuation
    holds every stance cone to > -0.5 N while the least margin is < 0.5 N
    (active); the soft barrier leaves it (< -5 N) and tracks the momentum
    target further."""
    hard, settings, info = _port(lean, "hard", PLAIN)
    soft = port_soft["plain"]
    j_settings, j_info, stance = lean["settings"], lean["j_iface"].info, lean["stance"]
    got = {c: _margins(settings, s.u_traj[0], info, stance) for c, s in (("hard", hard), ("soft", soft))}
    want = {c: _margins(j_settings, reference[c].u_traj, j_info, stance, jax.vmap(j_cone_values, (None, 0, None)))
            for c in ("hard", "soft")}
    for m, vx_h, vx_s in ((got, float(hard.x_traj[0, -1, 0]), float(soft.x_traj[0, -1, 0])),
                          (want, float(reference["hard"].x_traj[-1, 0]), float(reference["soft"].x_traj[-1, 0]))):
        assert -0.5 < m["hard"].min() < 0.5, m["hard"].min()
        assert m["soft"].min() < -5.0, m["soft"].min()
        assert vx_s > vx_h, (vx_s, vx_h)


def test_ipm_restores_feasibility_from_the_soft_result(lean, reference, port_soft):
    """From the soft result, whose stance cones are violated by > 5 N, the
    ipm's iterations bring every stance margin above -0.5 N with positive
    slacks and duals, in both packages."""
    start = (port_soft["plain"].x_traj, port_soft["plain"].u_traj)
    got, settings, info = _port(lean, "ipm", PLAIN, start)
    margins = _margins(settings, got.u_traj[0], info, lean["stance"])
    j_margins = _margins(lean["settings"], reference["ipm"].u_traj, lean["j_iface"].info, lean["stance"],
                         jax.vmap(j_cone_values, (None, 0, None)))
    assert margins.min() > -0.5 and j_margins.min() > -0.5, (margins.min(), j_margins.min())
    assert bool((got.cone_slack > 0).all()) and bool((got.cone_dual > 0).all())


@pytest.mark.parametrize("cone", ["hard", "ipm"])
def test_lanes_decide_alone(lean, cone):
    """Two lanes solved together (production backends) equal each lane
    solved alone at the parity bars, steps exactly: the filter's pick, the
    ipm's caps and dual steps are per lane (the second lane starts
    perturbed, and the lanes' results differ)."""

    def solve(perturbed):
        start = None
        if cone == "ipm":
            soft = _port(lean, "soft", PRODUCTION, perturbed=perturbed)[0]
            start = (soft.x_traj, soft.u_traj)
        return _port(lean, cone, PRODUCTION, start, perturbed)[0]

    both = solve((False, True))
    extra = (("cone_slack", 1e-5), ("cone_dual", 1e-5)) if cone == "ipm" else ()
    for lane, alone in enumerate((solve((False,)), solve((True,)))):
        one = type(both)(*(None if f is None else f[lane : lane + 1] for f in both))
        _assert_within_bars(one, type(alone)(*(None if f is None else f[0] for f in alone)), extra)
    assert not torch.equal(both.x_traj[0], both.x_traj[1])


def test_iteration_settings_and_refusals():
    """The hard cone's barrier continuation (mu and delta shrink by
    cone_mu_decay per iteration down to their floors), the ipm's barrier
    off, and the port raising where the reference raises: ipm without
    line-search candidates, the dense parallel Riccati in float32."""
    from bipedal_control_tpu_torch.ocp.problem import OcpSettings

    hard = OcpSettings(cone="hard", barrier_mu=0.1, barrier_delta=5.0, cone_mu_decay=0.25)
    got = [(s.barrier_mu, s.barrier_delta) for s in (iteration_settings(hard, k) for k in range(6))]
    want = [(max(0.1 * 0.25**k, 1e-3), max(5.0 * 0.25**k, 1e-2)) for k in range(6)]
    assert got == want
    assert iteration_settings(OcpSettings(cone="ipm"), 3).barrier_mu == 0.0
    assert iteration_settings(OcpSettings(), 3) == OcpSettings()
    make_ipm = lambda: sqp_solve(None, None, OcpSettings(cone="ipm", linesearch_alphas=()), None, None, None, None,
                                 torch.zeros(1, 3), torch.zeros(1, 2, 3), torch.zeros(1, 1, 2))
    with pytest.raises(NotImplementedError, match="linesearch"):
        make_ipm()

"""PyTorch port vs JAX reference: the scenario mesh, fleet telemetry, the
weak-scaling sweep and the dry run (bipedal_control_tpu_torch/parallel/,
graft_entry.py against bipedal_control_tpu/parallel/ and __graft_entry__.py),
float64 on the CPU.

The port runs in two gloo ranks on the CPU, spawned once for the module
(utils/distributed.py::spawn; the ranks' code is tests/torch_fleet_ranks.py,
which imports no JAX); the reference runs on two of the eight virtual CPU
devices of tests/conftest.py.  The problem is tests/test_lanes_rti.py's
batched problem on the tiny biped at B = 4, the port on its production
backends (the kernels' plain versions on the CPU), the reference on its XLA
ones, as in tests/test_torch_sqp.py.  Bars: the meshed solve at the batched
bars of tests/test_lanes_rti.py (1e-5, K 1e-3, step_size exact) against the
reference and 1e-8 against the port's unmeshed solve; fleet_stats 1e-12; the
sweep's mean_defect 1e-8 against the reference's fleet_stats of the same
chain of solves (the port's, unmeshed), and that chain's mean defect at the
batched bar (1e-5) against the reference's own chain.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from bipedal_control_tpu.ocp.problem import OcpSettings as JOcpSettings
from bipedal_control_tpu.parallel import make_batched_solver as j_make_batched_solver
from bipedal_control_tpu.parallel import shard_batch as j_shard_batch
from bipedal_control_tpu.parallel.scaling import fleet_stats as j_fleet_stats
from bipedal_control_tpu.parallel.scaling import make_two_level_mesh as j_make_two_level_mesh
from bipedal_control_tpu_torch.graft_entry import CONTRACTION, dryrun_multichip
from bipedal_control_tpu_torch.parallel.scaling import ScalingPoint
from bipedal_control_tpu_torch.utils.distributed import spawn

from test_lanes_rti import _batched_problem
from test_pallas_linearize_kernel import tiny_biped
from torch_fleet_ranks import fails_in_rank_1, fleet_rank, sleeps

BARS = (("x_traj", 1e-5), ("u_traj", 1e-5), ("K", 1e-3), ("cost", 1e-5), ("defect_norm", 1e-5), ("eq_norm", 1e-5))
B, WORLD = 4, 2
SCALING = {"scenario": 0, "per_device_batch": 2, "steps": 1, "warmup": 1}
J_SETTINGS = JOcpSettings(position_error_gain=0.35, integrator="rk2", riccati="sequential", merit="xla",
                          sqp_iterations=1, linesearch_alphas=(1.0, 0.5))


def _weights(info):
    return np.diag(np.linspace(1.0, 3.0, info.state_dim)), np.diag(np.linspace(0.1, 0.5, info.input_dim))


def _stats_inputs():
    rng = np.random.default_rng(3)
    return rng.uniform(1.0, 5.0, B), rng.uniform(0.0, 0.2, B), rng.choice([0.0, 0.5, 1.0], B)


def _spawn_ranks():
    """Each rank's results of torch_fleet_ranks.fleet_rank, one spawn of two
    gloo ranks on the CPU."""
    model, info = tiny_biped()
    problem = _batched_problem(model, info, B=B)
    refs, rest = problem[0], problem[1:]
    problem_np = ({k: np.asarray(v) for k, v in refs._asdict().items()}, *(np.asarray(a) for a in rest))
    settings = dict(dataclasses.asdict(J_SETTINGS), linearize="pallas", riccati="pallas", merit="pallas")
    model_np = {f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)}
    return spawn(fleet_rank, WORLD, model_np, dataclasses.asdict(info), settings, *_weights(info), problem_np,
                 _stats_inputs(), SCALING, device="cpu")


def _reference():
    """The reference's meshed solve of the problem on two devices, and of
    scenario SCALING["scenario"] tiled over the mesh after the sweep's chain
    of solves (warmup + steps), with its fleet_stats."""
    model, info = tiny_biped()
    Q, R = (jnp.asarray(w) for w in _weights(info))
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    solver = j_make_batched_solver(model, info, J_SETTINGS, Q, R, mesh, "data", donate_warm_start=False)
    problem = _batched_problem(model, info, B=B)
    sol = solver(*j_shard_batch(problem, mesh, "data"))
    s = SCALING["scenario"]
    tiled = jax.tree.map(lambda a: jnp.broadcast_to(a[s:s + 1], (B,) + a.shape[1:]), problem)
    refs_b, t_b, x_b, xs_b, us_b = j_shard_batch(tiled, mesh, "data")
    for _ in range(SCALING["warmup"] + SCALING["steps"]):
        chain = solver(refs_b, t_b, x_b, xs_b, us_b)
        xs_b, us_b = chain.x_traj, chain.u_traj
    return {"sol": sol, "chain_stats": j_fleet_stats(mesh, chain.cost, chain.defect_norm, chain.step_size)}


def _error_of(fn, *args, **kw):
    """The exception that spawn(fn, WORLD, *args, device="cpu", **kw) raised, or None."""
    try:
        spawn(fn, WORLD, *args, device="cpu", **kw)
    except Exception as e:  # noqa: BLE001 - the test reads what spawn raised
        return e
    return None


@pytest.fixture(scope="module")
def runs():
    """The port's spawns (the fleet ranks, dryrun_multichip(2) on the CPU, a
    world whose rank fails, a world past its time limit) wait on their
    processes in threads while the reference compiles."""
    with ThreadPoolExecutor(max_workers=4) as pool:
        fleet = pool.submit(_spawn_ranks)
        dryrun = pool.submit(dryrun_multichip, WORLD, device="cpu")
        failed = pool.submit(_error_of, fails_in_rank_1)
        late = pool.submit(_error_of, sleeps, 60.0, timeout=3.0)
        ref = _reference()
        return {"ranks": fleet.result(), "dryrun": dryrun.result(), "reference": ref, "failed": failed.result(),
                "late": late.result()}


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["ranks"]


@pytest.fixture(scope="module")
def reference(runs):
    return runs["reference"]


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def test_meshed_solve_matches_reference(ranks, reference):
    ref = reference["sol"]
    got = ranks[0]["meshed"]
    for name, tol in BARS:
        err = _rel(got[name], np.asarray(getattr(ref, name)))
        assert err < tol, f"{name}: rel err {err:.3e}"
    np.testing.assert_array_equal(got["step_size"], np.asarray(ref.step_size))
    for name, want in ranks[0]["unmeshed"].items():
        err = _rel(got[name], want)
        assert err <= 1e-8, f"meshed vs unmeshed {name}: {err:.3e}"
    assert [r["local_batch"] for r in ranks] == [B // WORLD] * WORLD
    for r in ranks:  # every rank reads the same global solution, from DTensors or from global inputs
        for name, want in got.items():
            np.testing.assert_array_equal(r["meshed"][name], want, err_msg=name)
            np.testing.assert_array_equal(r["meshed_global_inputs"][name], want, err_msg=name)


@pytest.mark.parametrize("mesh", ["flat", "1x2", "2x1"])
def test_fleet_stats_matches_reference(ranks, mesh):
    devices = jax.devices()[:WORLD]
    j_mesh = {"flat": lambda: Mesh(np.asarray(devices), ("data",)),
              "1x2": lambda: j_make_two_level_mesh(1, 2, devices),
              "2x1": lambda: j_make_two_level_mesh(2, 1, devices)}[mesh]()
    want = [float(v) for v in j_fleet_stats(j_mesh, *_stats_inputs())]
    for r in ranks:
        np.testing.assert_allclose(r["stats"][mesh], want, rtol=1e-12, atol=0.0)


def test_scaling_benchmark_points(ranks, reference):
    fields = [f.name for f in dataclasses.fields(ScalingPoint)]
    points = ranks[0]["points"]
    assert [list(p) for p in points] == [fields] * 2
    assert [(p["n_devices"], p["n_hosts"], p["batch"]) for p in points] == [(1, 1, 2), (2, 1, 4)]
    assert [p["n_devices"] for p in ranks[1]["points"]] == [2]  # rank 1 takes no part in the size-1 mesh
    # the sweep's reduction: the reference's fleet_stats of the port's chain of solves
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    want = float(j_fleet_stats(mesh, *ranks[0]["chain"])[1])
    for p in points:
        assert p["solves_per_s"] > 0 and p["solves_per_s_per_device"] > 0
        assert abs(p["mean_defect"] - want) <= 1e-8, (p["mean_defect"], want)
    # the chain itself against the reference's, at the batched bar
    assert abs(want - float(reference["chain_stats"][1])) <= 1e-5 * max(1.0, want)


def test_meshed_solver_refuses_uneven_batch(ranks):
    for r in ranks:
        assert r["uneven"] is not None and "not a multiple" in r["uneven"], r["uneven"]


def test_dryrun_multichip_on_cpu(runs):
    """dryrun_multichip(2, device="cpu") ran its three checks in both ranks."""
    results = runs["dryrun"]
    assert len(results) == WORLD
    for r in results:
        assert r["dtype"] == "torch.float64" and r["tol"] == 1e-8
        assert r["solve_err"] < 1e-8 and r["cascade_err"] < 1e-8
        assert r["defect_after_4"] < CONTRACTION[r["robot"]] * r["defect_first"]
        assert len(r["fell"]) == WORLD


def test_spawn_raises_what_a_rank_raised(runs):
    """A rank's exception reaches the caller (the other rank is stopped);
    a world past its time limit is stopped and raises TimeoutError."""
    assert runs["failed"] is not None and "rank 1 of the world fails" in str(runs["failed"])
    assert isinstance(runs["late"], TimeoutError), runs["late"]

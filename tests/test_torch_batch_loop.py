"""PyTorch port vs JAX reference: the batched closed loop of
sim/batch_loop.py against sim/batch_loop.py's make_batched_closed_loop on
G1's configuration and the synthetic G1-shaped URDF
(tests/data/g1_shaped_biped.urdf), float64 on the CPU.

- One episode of 3 lanes: two randomized (randomized_initial_states, seed
  0) and one pitched 1.7 rad, past the fall guard's 1.5 rad, so it falls
  on its first tick and stays frozen; chip_smoke.py phase 14(a)'s
  survival settings, dt 0.02 (N = 50) and one SQP iteration, 0.06 s (3
  replans of 10 ticks of 2 physics substeps), trot spliced in at 0.02 s,
  cmd_vel (0.3, 0, 0, 0.2) with the trim (ki 0.5) and the heading hold
  (kyaw 0.8, engaged at 0.02 s).  The reference runs its plain backends
  (structured, sequential, xla), the port the production settings
  (linearize, riccati and merit "pallas": the kernels' plain versions on
  the CPU).  ``fell`` equal; final q, v and anchors, base_z_min, tilt_max
  and defect_last within 1e-5 relative to max(1, max|ref|).  JAX's
  episode is compiled once for the module (~105 s here; the port's
  episode ~30 s).
- randomized_initial_states draws the reference's numbers (two seeds, two
  scales);
- the batched policy (evaluate_policy_batch) and build_refs over per-lane
  target tables, with the capture hook per lane, against the reference's
  vmapped functions at 1e-12.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.config.loader import CaptureConfig as JCaptureConfig
from bipedal_control_tpu.interface import make_interface as j_make_interface
from bipedal_control_tpu.model.centroidal import CentroidalModelInfo as JInfo
from bipedal_control_tpu.reference import target as jtg
from bipedal_control_tpu.runtime.mpc_runner import make_capture_hook as j_make_capture_hook
from bipedal_control_tpu.runtime.mrt import evaluate_policy as j_evaluate_policy
from bipedal_control_tpu.sim import batch_loop as jbl
from bipedal_control_tpu.solver.sqp import SqpSolution as JSqpSolution
from bipedal_control_tpu.solver.sqp import build_refs as j_build_refs
from bipedal_control_tpu_torch.config.loader import CaptureConfig
from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.model.centroidal import CentroidalModelInfo
from bipedal_control_tpu_torch.reference.target import TargetTable
from bipedal_control_tpu_torch.runtime.mpc_runner import make_capture_hook
from bipedal_control_tpu_torch.runtime.mrt import evaluate_policy_batch
from bipedal_control_tpu_torch.sim import batch_loop as tbl
from bipedal_control_tpu_torch.solver.sqp import SqpSolution, build_refs

from test_torch_reference import CAPTURE, INFO, _managers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))
PRODUCTION = dict(linearize="pallas", riccati="pallas", merit="pallas")
EPISODE = dict(gait="trot", gait_at=0.02, cmd_vel=(0.3, 0.0, 0.0, 0.2), cmd_vel_ki=0.5, cmd_vel_kyaw=0.8,
               cmd_vel_yaw_delay=0.02)
FALLEN_PITCH = 1.7  # rad, beyond BatchLoopConfig.fall_tilt (1.5)
RESULT_FIELDS = ("q", "v", "anchor", "base_z_min", "tilt_max", "defect_last")
SETTINGS = dict(dt=0.02, sqp_iterations=1)  # chip_smoke.py phase 14(a)'s


def _close(name, got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))
    print(f"{name}: rel err {err:.3e}")
    assert err <= tol, f"{name}: rel err {err:.3e} (bar {tol:g})"


def episode_states(iface):
    """(3, nx): two randomized lanes (seed 0) and the task's initial state
    pitched FALLEN_PITCH."""
    X = np.concatenate([jbl.randomized_initial_states(iface, 2, seed=0),
                        np.asarray(iface.initial_state)[None]])
    X[2, 10] = FALLEN_PITCH
    return X


@pytest.fixture(scope="module")
def g1():
    """(JAX interface, port interface on the CPU)."""
    return j_make_interface(G1_URDF, *G1_FILES), make_interface(G1_URDF, *G1_FILES, device="cpu")


def _fields(res):
    """The compared results as numpy: final q, v, anchor and the metrics."""
    state = res.final_state
    return {"q": state.q, "v": state.v, "anchor": state.anchor, "base_z_min": res.base_z_min,
            "tilt_max": res.tilt_max, "defect_last": res.defect_last}


@pytest.fixture(scope="module")
def episode(g1):
    """(port result, JAX result, the lanes' initial states) of one
    episode."""
    j, t = g1
    j = dataclasses.replace(j, settings=dataclasses.replace(j.settings, **SETTINGS))
    t = dataclasses.replace(t, settings=dataclasses.replace(t.settings, **SETTINGS, **PRODUCTION))
    X = episode_states(j)
    want = jbl.make_batched_closed_loop(j, jbl.BatchLoopConfig(duration=0.06), **EPISODE)(jnp.asarray(X))
    loop = tbl.make_batched_closed_loop(t, tbl.BatchLoopConfig(duration=0.06), device="cpu", **EPISODE)
    assert (loop.n_replans, loop.n_ticks, loop.n_sub, loop.num_nodes) == (3, 10, 2, 51)
    return loop(torch.as_tensor(X)), want, X


def test_closed_loop_matches_jax(episode):
    got, want, _ = episode
    np.testing.assert_array_equal(got.fell.numpy(), np.asarray(want.fell))
    np.testing.assert_array_equal(np.asarray(want.fell), [False, False, True])
    want_f, got_f = _fields(want), _fields(got)
    for name in RESULT_FIELDS:
        _close(name, got_f[name], want_f[name], 1e-5)


def test_fallen_lane_is_frozen(episode):
    """The lane pitched past the guard falls on its first tick and is held
    there: its final state is one tick of physics from rest."""
    got, _, X = episode
    q = got.final_state.q.numpy()
    assert np.all(np.isfinite(q)) and np.all(np.isfinite(got.final_state.v.numpy()))
    assert abs(q[2, 4]) + abs(q[2, 5]) > 1.5
    np.testing.assert_allclose(q[2, :6], X[2, 6:12], atol=1e-2)


def test_make_batched_closed_loop_needs_cuda_by_default(g1):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        tbl.make_batched_closed_loop(g1[1], tbl.BatchLoopConfig(duration=0.02))


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (7, 2.0)])
def test_randomized_initial_states_match_jax(g1, seed, scale):
    j, t = g1
    np.testing.assert_array_equal(tbl.randomized_initial_states(t, 16, seed=seed, scale=scale),
                                  np.asarray(jbl.randomized_initial_states(j, 16, seed=seed, scale=scale)))


def test_batched_policy_matches_jax():
    """evaluate_policy_batch at times before, inside and past each lane's
    own node grid, with and without feedback, against the reference's
    evaluate_policy vmapped over the lanes."""
    rng = np.random.default_rng(3)
    B, N, nx, nu = 4, 9, 24, 24
    t_nodes = np.sort(rng.uniform(0.0, 1.0, size=(B, N + 1)), axis=1)
    sol = dict(t_nodes=t_nodes, x_traj=rng.normal(size=(B, N + 1, nx)), u_traj=rng.normal(size=(B, N, nu)),
               K=rng.normal(size=(B, N, nu, nx)), cost=np.zeros(B), defect_norm=np.zeros(B), eq_norm=np.zeros(B),
               step_size=np.ones(B))
    got_sol = SqpSolution(**{k: torch.as_tensor(v) for k, v in sol.items()})
    want_sol = JSqpSolution(**{k: jnp.asarray(v) for k, v in sol.items()})
    x = rng.normal(size=(B, nx))
    for t in (-0.1, 0.0, 0.37, float(t_nodes[1, 4]), 1.2):
        for fb in (True, False):
            got = evaluate_policy_batch(got_sol, t, torch.as_tensor(x), use_feedback=fb)
            want = jax.vmap(lambda s, xm: j_evaluate_policy(s, t, xm, use_feedback=fb))(want_sol, jnp.asarray(x))
            for f in want._fields:
                np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=0,
                                           atol=1e-12, err_msg=f"{f} at t={t} feedback={fb}")
    one = evaluate_policy_batch(got_sol, torch.full((1,), 0.37, dtype=torch.float64), torch.as_tensor(x))
    np.testing.assert_array_equal(one.u_fb.numpy(), evaluate_policy_batch(got_sol, 0.37, torch.as_tensor(x)).u_fb)


@pytest.mark.parametrize("capture", ["none", "replan", "touchdown_sync"])
def test_batched_build_refs_matches_jax(capture):
    """build_refs over B = 3 per-lane cmd_vel target tables (each lane's
    own observation) with each lane's capture offsets (the hook on the
    batched table), against the reference's build_refs and hook vmapped
    over the lanes."""
    got_rm, want_rm = _managers()
    got_f, want_f = got_rm.freeze(0.55), want_rm.freeze(0.55)
    info, jinfo = CentroidalModelInfo(**INFO), JInfo(**INFO)
    rng = np.random.default_rng(11)
    x0 = np.asarray(want_rm.target.states[0])
    X = x0 + rng.normal(scale=0.03, size=(3, 24))
    X[:, 0:2] += [[0.05, -0.08], [-0.1, 0.06], [0.0, 0.12]]
    X[:, 6:8] += [[0.02, 0.04], [-0.05, 0.0], [0.01, -0.06]]
    X[:, 9] += [0.0, 0.4, -0.7]
    ccfg = jtg.CommandConfig(com_height=0.665, default_joint_state=x0[12:])
    tables = [jtg.cmd_vel_to_target_trajectories(np.array([0.3, 0.1, 0.0, 0.2]), 0.55, x, ccfg, 24).freeze(2)
              for x in X]
    jtable = jtg.TargetTable(*(jnp.stack([jnp.asarray(getattr(tb, f)) for tb in tables])
                               for f in jtg.TargetTable._fields))
    table = TargetTable(*(torch.as_tensor(np.asarray(a)) for a in jtable))
    cap = jcap = None
    if capture != "none":
        cap = CaptureConfig(**CAPTURE, touchdown_sync=capture == "touchdown_sync")
        jcap = JCaptureConfig(**CAPTURE, touchdown_sync=capture == "touchdown_sync")
    dq_fn, decay, ws = make_capture_hook(cap, 12)
    jdq_fn, _, _ = j_make_capture_hook(jcap, 12)
    t_nodes = jnp.asarray(want_f.t_nodes)
    dq = dq_fn(got_f.gait, table, got_f.t_nodes, torch.as_tensor(X))
    if capture == "none":
        jdq = None
        assert dq is None
    else:
        jdq = jax.vmap(lambda tb, x: jdq_fn(want_f.gait, tb, t_nodes, x))(jtable, jnp.asarray(X))
        np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), rtol=0, atol=1e-12, err_msg="capture dq")
        assert dq.shape == (3, 2, 12) and float(dq.abs().max()) > 0.0
    got = build_refs(info, got_f.gait, got_f.swing, table, got_f.t_nodes, dq, decay, ws)
    want = jax.vmap(lambda tb, d: j_build_refs(jinfo, want_f.gait, want_f.swing, tb, t_nodes, d, decay, ws))(
        jtable, jdq)
    for f in want._fields:
        assert getattr(got, f).shape[0] == 3, f
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=0, atol=1e-12,
                                   err_msg=f"build_refs {f}")

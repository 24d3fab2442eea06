"""PyTorch port vs JAX reference: the node time grid, the reference manager's
frozen tables, the command conversions, the node references (make_node_refs,
build_refs with the capture hook and the weight shift) and the warm start,
on G1's configuration, float64 on the CPU, to 1e-12.

The capture block is synthetic (G1's overrides.info has none): hip-roll
offsets with and without touchdownSync, each with a weight shift, on
measured states that push the errors past the deadbands.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.config.loader import CaptureConfig as JCaptureConfig
from bipedal_control_tpu.config.loader import load_task_config as j_load_task_config
from bipedal_control_tpu.gait.mode_schedule import GaitSchedule as JGaitSchedule
from bipedal_control_tpu.model.centroidal import CentroidalModelInfo as JInfo
from bipedal_control_tpu.ocp.problem import make_node_refs as j_make_node_refs
from bipedal_control_tpu.reference import manager as jman
from bipedal_control_tpu.reference import target as jtg
from bipedal_control_tpu.runtime.mpc_runner import make_capture_hook as j_make_capture_hook
from bipedal_control_tpu.solver.sqp import build_refs as j_build_refs
from bipedal_control_tpu.solver.sqp import warm_start_trajectories as j_warm_start
from bipedal_control_tpu_torch.config.loader import CaptureConfig, load_task_config
from bipedal_control_tpu_torch.gait.mode_schedule import GaitSchedule
from bipedal_control_tpu_torch.model.centroidal import CentroidalModelInfo
from bipedal_control_tpu_torch.ocp.problem import make_node_refs
from bipedal_control_tpu_torch.reference import manager as man
from bipedal_control_tpu_torch.reference import target as tg
from bipedal_control_tpu_torch.runtime.mpc_runner import make_capture_hook
from bipedal_control_tpu_torch.solver.sqp import (
    SqpSolution, build_refs, warm_start_from_solution, warm_start_trajectories,
)

from test_torch_config import G1_ARGS

INFO = dict(nj=12, contact_frame_ids=(24, 25, 26, 27), robot_mass=34.975)
CAPTURE = dict(left_index=1, right_index=7, kp=0.8, kv=0.3, max_offset=0.2, sign=-1.0, decay=0.3,
               pos_deadband=0.01, vel_deadband=0.02, weight_shift=0.02)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-12, err_msg=what)


def _managers(**kw):
    """(port, reference) ReferenceManagers on G1's config, trot from 0.1 s."""
    out = []
    for load, GS, mod in ((load_task_config, GaitSchedule, man), (j_load_task_config, JGaitSchedule, jman)):
        cfg = load(*G1_ARGS)
        tt = (tg if mod is man else jtg).TargetTrajectories(
            np.array([0.0, 1.5]), np.stack([cfg.initial_state, cfg.initial_state + 0.01]), np.zeros((2, 24)))
        gait = GS(cfg.initial_mode_schedule, cfg.default_gait, cfg.phase_transition_stance_time)
        extra = {"device": "cpu"} if mod is man else {}
        rm = mod.ReferenceManager(gait_schedule=gait, swing_config=cfg.swing, target=tt, horizon=1.0,
                                  num_intervals=67, max_phases=32, **extra, **kw)
        rm.set_gait(cfg.gait_library["trot"], 0.1)
        out.append(rm)
    return out


def _assert_frozen(got, want):
    for name in ("gait", "swing", "target"):
        for f in getattr(want, name)._fields:
            _close(getattr(getattr(got, name), f).numpy(), getattr(getattr(want, name), f), f"{name}.{f}")
    np.testing.assert_array_equal(got.t_nodes.numpy(), want.t_nodes)


@pytest.mark.parametrize("seed", range(4))
def test_build_time_grid_matches_reference(seed):
    """Random event sets: clustered events, events near the grid's ends,
    more events than intervals, and non-finite entries."""
    rng = np.random.default_rng(seed)
    t0 = rng.uniform(0.0, 5.0)
    ev = t0 + np.concatenate([rng.uniform(-0.2, 1.2, 6), rng.uniform(0.4, 0.41, 3), [np.inf, 0.001, 0.999]])
    for n, events in ((67, ev), (5, ev), (67, []), (3, t0 + np.linspace(0.05, 0.95, 10))):
        np.testing.assert_array_equal(man.build_time_grid(t0, 1.0, n, events), jman.build_time_grid(t0, 1.0, n, events))


@pytest.mark.parametrize("terrain", [False, True])
def test_freeze_matches_reference(terrain):
    """freeze() after set_gait at several replan times, flat and with a
    terrain_fn (swing heights and the re-based command z)."""
    kw = {}
    if terrain:
        kw = dict(terrain_fn=lambda x, y: 0.02 * np.sin(3.0 * x) + 0.01 * y,
                  foot_xy_offsets=np.array([[0.1, 0.1], [-0.05, 0.1], [0.1, -0.1], [-0.05, -0.1]]))
    got_rm, want_rm = _managers(**kw)
    for t0 in (0.0, 0.37, 1.2):
        _assert_frozen(got_rm.freeze(t0), want_rm.freeze(t0))


def test_command_conversions_match_reference():
    cfg = load_task_config(*G1_ARGS)
    ccfg = tg.CommandConfig(cfg.com_height, cfg.default_joint_state)
    jccfg = jtg.CommandConfig(cfg.com_height, cfg.default_joint_state)
    rng = np.random.default_rng(3)
    x = cfg.initial_state + rng.normal(scale=0.05, size=24)
    x[9] = 0.7  # a yawed base
    cmd = np.array([0.4, -0.1, 0.0, 0.3])
    for got, want in (
        (tg.cmd_vel_to_target_trajectories(cmd, 1.5, x, ccfg, 24),
         jtg.cmd_vel_to_target_trajectories(cmd, 1.5, x, jccfg, 24)),
        (tg.goal_to_target_trajectories(np.array([1.0, 2.0, 0.0, 0.5]), 1.5, x, ccfg, 24),
         jtg.goal_to_target_trajectories(np.array([1.0, 2.0, 0.0, 0.5]), 1.5, x, jccfg, 24)),
        (tg.stationary_target(1.5, x, ccfg, 24), jtg.stationary_target(1.5, x, jccfg, 24)),
    ):
        for f in ("times", "states", "inputs"):
            _close(getattr(got, f), getattr(want, f), f)
    follow = tg.CmdVelFollower(cmd, ccfg, 24, k_yaw=0.5, yaw_hold_delay_s=0.1)
    jfollow = jtg.CmdVelFollower(cmd, jccfg, 24, k_yaw=0.5, yaw_hold_delay_s=0.1)
    for k in range(12):
        xk = x + rng.normal(scale=0.02, size=24)
        got, want = follow.update(0.05 * k, xk), jfollow.update(0.05 * k, xk)
        assert (got is None) == (want is None)
        if got is not None:
            _close(got.states, want.states, f"follower step {k}")
    # the frozen table interpolates over a tensor of times like the reference per time
    traj = tg.cmd_vel_to_target_trajectories(cmd, 1.5, x, ccfg, 24)
    table = traj.freeze(4, device="cpu")
    jtable = jtg.cmd_vel_to_target_trajectories(cmd, 1.5, x, jccfg, 24).freeze(4)
    times = rng.uniform(1.0, 3.0, 32)
    for q in ("state_at", "input_at"):
        _close(getattr(table, q)(torch.as_tensor(times)).numpy(), jax.vmap(getattr(jtable, q))(jnp.asarray(times)), q)


@pytest.mark.parametrize("capture", ["none", "replan", "touchdown_sync"])
def test_node_refs_match_reference(capture):
    """make_node_refs over every node in one call, then build_refs with the
    capture offsets of each package's hook (with and without touchdownSync,
    both with the weight shift), against the reference's vmapped versions."""
    got_rm, want_rm = _managers()
    got_f, want_f = got_rm.freeze(0.55), want_rm.freeze(0.55)  # inside the trot
    info, jinfo = CentroidalModelInfo(**INFO), JInfo(**INFO)
    t, dt = got_f.t_nodes[:-1], got_f.t_nodes[1:] - got_f.t_nodes[:-1]
    got = make_node_refs(info, got_f.gait, got_f.swing, got_f.target, t, dt)
    want = jax.vmap(lambda tt, d: j_make_node_refs(jinfo, want_f.gait, want_f.swing, want_f.target, tt, d))(
        jnp.asarray(want_f.t_nodes[:-1]), jnp.diff(jnp.asarray(want_f.t_nodes)))
    for f in want._fields:
        _close(getattr(got, f).numpy(), getattr(want, f), f"make_node_refs {f}")

    cap = jcap = None
    if capture != "none":
        cap = CaptureConfig(**CAPTURE, touchdown_sync=capture == "touchdown_sync")
        jcap = JCaptureConfig(**CAPTURE, touchdown_sync=capture == "touchdown_sync")
    rng = np.random.default_rng(7)
    x = load_task_config(*G1_ARGS).initial_state + rng.normal(scale=0.03, size=24)
    x[0:2] += [0.05, -0.08]
    x[6:8] += [0.02, 0.04]
    dq_fn, decay, ws = make_capture_hook(cap, 12)
    jdq_fn, jdecay, jws = j_make_capture_hook(jcap, 12)
    assert (decay, ws) == (jdecay, jws)
    dq = dq_fn(got_f.gait, got_f.target, got_f.t_nodes, torch.as_tensor(x))
    jdq = jdq_fn(want_f.gait, want_f.target, jnp.asarray(want_f.t_nodes), jnp.asarray(x))
    if capture == "none":
        assert dq is None and jdq is None
    else:
        _close(dq.numpy(), jdq, "capture dq")
        assert float(dq.abs().max()) > 0.0
    got = build_refs(info, got_f.gait, got_f.swing, got_f.target, got_f.t_nodes, dq, decay, ws)
    want = j_build_refs(jinfo, want_f.gait, want_f.swing, want_f.target, jnp.asarray(want_f.t_nodes), jdq, jdecay, jws)
    for f in want._fields:
        assert getattr(got, f).shape[0] == 1
        _close(getattr(got, f)[0].numpy(), getattr(want, f), f"build_refs {f}")


def test_warm_start_matches_reference():
    """Trajectories shifted from one node grid onto a later one (and the
    same over a batch axis, each row its own grid)."""
    rng = np.random.default_rng(11)
    prev_t = np.sort(rng.uniform(0.0, 1.0, 68))
    prev_t[0] = 0.0
    xs, us = rng.normal(size=(68, 24)), rng.normal(size=(67, 24))
    for shift in (0.0, 0.02, 0.5, 2.0):
        t_nodes = np.linspace(shift, shift + 1.0, 68)
        got = warm_start_trajectories(*(torch.as_tensor(a) for a in (prev_t, xs, us, t_nodes)))
        want = j_warm_start(*(jnp.asarray(a) for a in (prev_t, xs, us, t_nodes)))
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    T = lambda a: torch.as_tensor(np.stack([a, a[::-1].copy()]) if a.ndim == 1 else np.stack([a, a]))
    bt = torch.stack([torch.as_tensor(prev_t), torch.as_tensor(np.sort(rng.uniform(0, 1, 68)))])
    bn = torch.as_tensor(np.stack([np.linspace(0.1, 1.1, 68), np.linspace(0.3, 1.3, 68)]))
    got = warm_start_trajectories(bt, T(xs), T(us), bn)
    prev = SqpSolution(bt, T(xs), T(us), *(None,) * 5)
    for g, w in zip(warm_start_from_solution(prev, bn), got):
        assert torch.equal(g, w)
    for b in range(2):
        want = j_warm_start(jnp.asarray(bt[b].numpy()), jnp.asarray(xs), jnp.asarray(us), jnp.asarray(bn[b].numpy()))
        for g, w in zip(got, want):
            _close(g[b].numpy(), w)

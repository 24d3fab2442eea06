"""PyTorch port vs JAX reference: the batched physics of sim/physics.py
against sim/jax_physics.py on G1's configuration and the synthetic
G1-shaped URDF (tests/data/g1_shaped_biped.urdf), float64 on the CPU,
inputs drawn from numpy seeds; errors relative to max(1, max|ref|):

- sim_step on 3 lanes (feet penetrating, airborne, and a lane whose anchor
  spring exceeds the friction cone so it slips) against JAX's vmapped
  sim_step (one step of the JAX loop below, compiled once for the module):
  1e-10;
- initial_sim_state, rbd_state_from_sim and hybrid_pd_torque_explicit:
  1e-12;
- a 200-step roll of 3 lanes (two under PD, dropped in and perturbed, one
  in free fall) against a JAX loop of the same steps: 1e-9; the free-fall
  lane held to the check of tests/test_jax_physics.py::
  test_free_fall_ballistic (dz of semi-implicit Euler within 1e-6, no
  rotation) over the roll's 200 steps.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bipedal_control_tpu.sim.jax_physics as JP
from bipedal_control_tpu.interface import make_interface as j_make_interface
from bipedal_control_tpu_torch.convert import sim_config_from_numpy, sim_state_from_numpy
from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.sim import physics as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))
ROLL_STEPS = 200


def _close(name, got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))
    assert err <= tol, f"{name}: rel err {err:.3e} (bar {tol:g})"


def _np(state):
    return {name: np.asarray(a) for name, a in state._asdict().items()}


@pytest.fixture(scope="module")
def g1():
    """(JAX interface, port interface on the CPU)."""
    return j_make_interface(G1_URDF, *G1_FILES), make_interface(G1_URDF, *G1_FILES, device="cpu")


def _three_lanes(j, seed):
    """Initial states (3, nx): lane 0 lowered 1 cm (feet penetrate), lane 1
    raised 0.2 m (airborne), lane 2 lowered 2 mm; the JAX initial sim state
    of each, with lane 0's anchors jittered by 0.1 mm and lane 2's moved
    5 cm (its anchor spring, 250 N, beyond the cone's mu f_n ~ 42 N: it
    slips)."""
    rng = np.random.default_rng(seed)
    X = np.tile(np.asarray(j.initial_state), (3, 1))
    X[:, 8] += [-0.01, 0.2, -0.002]
    st = jax.vmap(lambda x: JP.initial_sim_state(j.model, j.info, x))(jnp.asarray(X))
    anchor = np.array(st.anchor)
    anchor[0] += rng.normal(scale=1e-4, size=anchor[0].shape)
    anchor[2] += 0.05
    return X, st._replace(anchor=jnp.asarray(anchor)), rng


@pytest.fixture(scope="module")
def j_roll(g1):
    """JAX's roll, compiled once for the module: n steps (a traced count, so
    one compile serves every n) of the vmapped sim_step under the hybrid PD
    law with per-lane targets and gains -> (final state, last forces)."""
    j, _ = g1
    cfg = JP.JaxSimConfig()

    def lane_step(s, ff, qd, p, d):
        tau = JP.hybrid_pd_torque_explicit(qd, 0.0, p, d, ff, s.q[6:])
        return JP.sim_step(j.model, j.info, cfg, s, tau, joint_damping=d)

    @jax.jit
    def roll(s, ff, qd, p, d, n):
        nc = len(j.info.contact_frame_ids)
        f0 = jnp.zeros((ff.shape[0], nc, 3), ff.dtype)
        return jax.lax.fori_loop(0, n, lambda _, c: jax.vmap(lane_step)(c[0], ff, qd, p, d), (s, f0))

    return cfg, roll


def test_sim_step_matches_jax(g1, j_roll):
    j, t = g1
    cfg, roll = j_roll
    X, jst, rng = _three_lanes(j, 0)
    nv, nj = 6 + j.info.nj, j.info.nj
    v = rng.normal(scale=0.3, size=(3, nv))
    tau = rng.normal(scale=20.0, size=(3, nj))
    jst = jst._replace(v=jnp.asarray(v))
    # one step under tau with kp = 0 and the implicit joint damping 5
    want, want_f = roll(jst, jnp.asarray(tau), jnp.zeros((3, nj)), jnp.zeros(3), jnp.full(3, 5.0), 1)
    got, got_f = P.sim_step(t.model, t.info, sim_config_from_numpy(dataclasses.asdict(cfg)),
                            sim_state_from_numpy(_np(jst), device="cpu"), torch.as_tensor(tau), joint_damping=5.0)
    for name in ("q", "v", "anchor"):
        _close(name, getattr(got, name), getattr(want, name), 1e-10)
    _close("forces", got_f, want_f, 1e-10)
    f = np.asarray(want_f)
    assert np.all(f[0, :, 2] > 0.0) and np.all(f[1] == 0.0), "lane 0 must be in contact, lane 1 airborne"
    # lane 2 slips: its anchors moved off where they were put
    assert float(np.abs(np.asarray(want.anchor)[2] - np.asarray(jst.anchor)[2]).max()) > 1e-3


def test_state_conversions_and_pd_match_jax(g1):
    j, t = g1
    X, jst, rng = _three_lanes(j, 1)
    got = P.initial_sim_state(t.model, t.info, torch.as_tensor(X))
    want = jax.vmap(lambda x: JP.initial_sim_state(j.model, j.info, x))(jnp.asarray(X))
    for name in ("q", "v", "anchor"):
        _close(f"initial {name}", getattr(got, name), getattr(want, name), 1e-12)
    nv, nj = 6 + j.info.nj, j.info.nj
    jst = jst._replace(v=jnp.asarray(rng.normal(scale=0.5, size=(3, nv))))
    _close("rbd_state_from_sim", P.rbd_state_from_sim(t.model, sim_state_from_numpy(_np(jst), device="cpu")),
           jax.vmap(lambda s: JP.rbd_state_from_sim(j.model, s))(jst), 1e-12)
    pos, vel, ff, qj = (rng.normal(size=(3, nj)) for _ in range(4))
    kp, kd = rng.uniform(10.0, 100.0, size=(3, 1)), rng.uniform(1.0, 5.0, size=(3, 1))
    _close("hybrid_pd_torque_explicit",
           P.hybrid_pd_torque_explicit(*(torch.as_tensor(a) for a in (pos, vel, kp, kd, ff, qj))),
           JP.hybrid_pd_torque_explicit(*(jnp.asarray(a) for a in (pos, vel, kp, kd, ff, qj))), 1e-12)


def test_roll_and_free_fall_match_jax(g1, j_roll):
    """200 steps of 3 lanes: lane 0 dropped in from 1 cm under PD, lane 1
    perturbed (joints and base velocity) under PD, lane 2 released at 2 m
    with no torque (free fall)."""
    j, t = g1
    rng = np.random.default_rng(2)
    x0 = np.asarray(j.initial_state)
    nj = j.info.nj
    X = np.tile(x0, (3, 1))
    X[0, 8] += 0.01
    X[1, 12:] += rng.normal(scale=0.05, size=nj)
    X[2, 8] = 2.0
    kp = np.array([[80.0], [120.0], [0.0]])
    kd = np.array([[5.0], [8.0], [0.0]])
    q_des = np.tile(x0[12:], (3, 1))
    cfg, roll = j_roll
    jst = jax.vmap(lambda x: JP.initial_sim_state(j.model, j.info, x))(jnp.asarray(X))
    jst = jst._replace(v=jst.v.at[1].set(jnp.asarray(rng.normal(scale=0.2, size=6 + nj))))
    st = sim_state_from_numpy(_np(jst), device="cpu")
    want = roll(jst, jnp.zeros((3, nj)), jnp.asarray(q_des), jnp.asarray(kp[:, 0]), jnp.asarray(kd[:, 0]),
                ROLL_STEPS)[0]
    tcfg = sim_config_from_numpy(dataclasses.asdict(cfg))
    tq, tkp, tkd = (torch.as_tensor(a) for a in (q_des, kp, kd))
    for _ in range(ROLL_STEPS):
        tau = P.hybrid_pd_torque_explicit(tq, 0.0, tkp, tkd, 0.0, st.q[:, 6:])
        st = P.sim_step(t.model, t.info, tcfg, st, tau, joint_damping=tkd)[0]
    for name in ("q", "v", "anchor"):
        _close(f"roll {name}", getattr(st, name), getattr(want, name), 1e-9)
    # the free-fall lane: semi-implicit Euler, dz = -g dt^2 n (n + 1) / 2, no rotation
    dz = float(st.q[2, 2]) - 2.0
    expected = -9.81 * cfg.dt**2 * ROLL_STEPS * (ROLL_STEPS + 1) / 2
    assert abs(dz - expected) < 1e-6, (dz, expected)
    assert float(st.v[2, 3:6].abs().max()) < 1e-10
    assert bool(torch.isfinite(st.q).all() and torch.isfinite(st.v).all())

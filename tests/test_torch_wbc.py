"""PyTorch port vs JAX reference: the device WBC on G1's configuration
(configs/g1/* with overrides.info) and the synthetic G1-shaped URDF
(tests/data/g1_shaped_biped.urdf), float64 on the CPU, inputs drawn from
numpy seeds (the model layer under it: tests/test_torch_dynamics.py).

- solve_qp on a random QP and on the WBC's own QP (KKT inverse by K5's
  plain version): 1e-8 relative to max(1, max|ref|);
- wbc_update in full stance and in left and right single support, and the
  WBC of a few BipedalController(wbc_backend="device") ticks against JAX's
  wbc_update on the same (x_star, u_fb, rbd, flags): decision 1e-8 relative
  to max(1, max|ref|), ``solved`` equal.

JAX's WBC is compiled once for the module: one jitted, vmapped
wbc_update_batch over the three contact modes and the controller's ticks.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.interface import make_interface as j_make_interface
from bipedal_control_tpu.runtime.controller import wbc_config_from_task as j_wbc_config_from_task
from bipedal_control_tpu.wbc.qp import solve_qp as j_solve_qp
from bipedal_control_tpu.wbc.weighted_wbc import wbc_update_batch as j_wbc_update_batch
from bipedal_control_tpu_torch.convert import wbc_task_config_from_numpy
from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.ops import gj_kernel
from bipedal_control_tpu_torch.runtime.controller import (
    BipedalController,
    ControllerConfig,
    DeviceWbc,
    wbc_config_from_task,
)
from bipedal_control_tpu_torch.wbc import tasks as tt
from bipedal_control_tpu_torch.wbc.qp import solve_qp
from bipedal_control_tpu_torch.wbc.weighted_wbc import wbc_qp, wbc_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))
MODES = {"stance": [1.0, 1.0, 1.0, 1.0], "left_support": [1.0, 1.0, 0.0, 0.0], "right_support": [0.0, 0.0, 1.0, 1.0]}
CONTROLLER_TICKS = 3


def _close(name, got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))
    assert err <= tol, f"{name}: rel err {err:.3e} (bar {tol:g})"


def _standing_rbd(x0, nj):
    return np.concatenate([x0[9:12], x0[6:9], x0[12:], np.zeros(6 + nj)])


@pytest.fixture(scope="module")
def g1():
    """(JAX interface, port interface on the CPU)."""
    return j_make_interface(G1_URDF, *G1_FILES), make_interface(G1_URDF, *G1_FILES, device="cpu")


def _random_wbc_inputs(rng, t):
    """(x_des, u_des, rbd) near G1's stand: the MPC's desired point and a
    measurement a little off it."""
    x0, nj = np.asarray(t.initial_state), t.info.nj
    x = x0 + np.concatenate([rng.normal(scale=0.05, size=6), rng.normal(scale=0.01, size=6),
                             rng.normal(scale=0.05, size=nj)])
    u = np.concatenate([np.tile([0.0, 0.0, t.info.robot_mass * 9.81 / 4], 4) + rng.normal(scale=5.0, size=12),
                        rng.normal(scale=0.3, size=nj)])
    rbd = _standing_rbd(x0, nj) + np.concatenate([rng.normal(scale=0.02, size=6), rng.normal(scale=0.03, size=nj),
                                                  rng.normal(scale=0.1, size=6 + nj)])
    return x, u, rbd


@pytest.fixture(scope="module")
def wbc_runs(g1):
    """The port's WBC outputs and JAX's on the same inputs: the three
    contact modes on random inputs, then the WBC of CONTROLLER_TICKS
    synchronous ticks of a trotting BipedalController(wbc_backend="device"),
    whose inputs and outputs are recorded at DeviceWbc.update.  JAX's side
    is one jitted, vmapped wbc_update_batch over all of them."""
    j, t = g1
    rng = np.random.default_rng(11)
    cfg = wbc_config_from_task(t.task)
    inputs, port = [], []
    for flags in MODES.values():
        x, u, rbd = _random_wbc_inputs(rng, t)
        inputs.append((x, u, rbd, np.asarray(flags)))
        port.append(wbc_update(t.model, t.info, cfg, *(torch.as_tensor(a) for a in inputs[-1])))
    ctrl = BipedalController(t, ControllerConfig(wbc_backend="device"))
    ctrl.set_gait(t.task.gait_library["trot"], 0.0)
    recorded = []
    inner = ctrl.device_wbc.update

    def record(*args):
        out = inner(*args)
        recorded.append((tuple(np.array(a, dtype=np.float64) for a in args), out))
        return out

    ctrl.device_wbc.update = record
    rbd = _standing_rbd(np.asarray(t.initial_state), t.info.nj)
    ctrl.starting(0.0, rbd)
    cmds = [ctrl.update(0.3 + k * 0.0025, rbd + 0.01 * k) for k in range(CONTROLLER_TICKS)]
    inputs += [args for args, _ in recorded]
    stacked = [np.stack([inp[i] for inp in inputs]) for i in range(4)]
    j_cfg = j_wbc_config_from_task(j.task)
    ref = jax.jit(lambda *a: j_wbc_update_batch(j.model, j.info, j_cfg, *a))(*(jnp.asarray(a) for a in stacked))
    return {"inputs": inputs, "port": port, "recorded": recorded, "cmds": cmds, "ctrl": ctrl,
            "ref": jax.tree_util.tree_map(np.asarray, ref)}


def _random_qp(rng, n, m_eq, m_in):
    W = rng.normal(size=(n, n))
    A = rng.normal(size=(m_eq + m_in, n))
    b = rng.normal(size=m_eq)
    f = rng.uniform(0.1, 1.0, size=m_in)
    l = np.concatenate([b, np.full(m_in, -1e20)])  # noqa: E741
    return W @ W.T + 0.1 * np.eye(n), rng.normal(size=n), A, l, np.concatenate([b, f])


@pytest.mark.parametrize("case", ["random", "wbc"])
def test_solve_qp_matches_reference(g1, case):
    """solve_qp on a random QP (3 equality, 4 inequality rows) and on the
    WBC's QP at G1's widths (the 128 x 128 KKT), whose inverse on CPU
    tensors is K5's plain version (no kernel launch)."""
    j, t = g1
    rng = np.random.default_rng(4)
    if case == "random":
        qp = _random_qp(rng, 8, 3, 4)
    else:
        inputs = (*_random_wbc_inputs(rng, t), np.asarray(MODES["left_support"]))
        qp = [a.numpy() for a in wbc_qp(t.model, t.info, wbc_config_from_task(t.task),
                                        *(torch.as_tensor(a) for a in inputs))]
    launches = gj_kernel.gauss_jordan_solve_pallas.launches
    got = solve_qp(*(torch.as_tensor(a) for a in qp))
    assert gj_kernel.gauss_jordan_solve_pallas.launches == launches
    want = jax.jit(j_solve_qp)(*(jnp.asarray(a) for a in qp))
    for name in ("x", "y", "primal_residual", "dual_residual"):
        _close(name, getattr(got, name), getattr(want, name), 1e-8)
    assert bool(got.solved) == bool(want.solved)


@pytest.mark.parametrize("mode", list(MODES))
def test_wbc_update_matches_reference(wbc_runs, mode):
    k = list(MODES).index(mode)
    got, ref = wbc_runs["port"][k], wbc_runs["ref"]
    _close("decision", got.decision, ref.decision[k], 1e-8)
    _close("torque", got.torque, ref.torque[k], 1e-8)
    assert bool(got.qp.solved) == bool(ref.qp.solved[k])


def test_device_wbc_controller_matches_reference(wbc_runs):
    """The WBC of BipedalController(wbc_backend="device") ticks on the CPU
    equals JAX's wbc_update on the inputs the tick gave it, and the tick's
    torque command is that decision's torque."""
    ref, nj = wbc_runs["ref"], wbc_runs["ctrl"].iface.info.nj
    assert len(wbc_runs["recorded"]) == CONTROLLER_TICKS
    assert wbc_runs["ctrl"].backends["qp"] == "cpu"
    for k, ((_, (decision, residual)), cmd) in enumerate(zip(wbc_runs["recorded"], wbc_runs["cmds"])):
        i = len(MODES) + k
        _close("decision", decision, ref.decision[i], 1e-8)
        _close("primal residual", residual, ref.qp.primal_residual[i], 1e-8)
        np.testing.assert_array_equal(cmd.tau_ff, decision[-nj:])


def test_wbc_task_config_crosses_packages(g1):
    j, t = g1
    cfg = wbc_task_config_from_numpy(dataclasses.asdict(j_wbc_config_from_task(j.task)))
    assert cfg == wbc_config_from_task(t.task)
    assert tt.num_decision_vars(t.info) == 42


def test_set_wbc_weight_reaches_device_wbc(wbc_runs):
    """set_wbc_weight on the device path: the next tick's WBC computes with
    the new weight (on the card it drops the CUDA graph and recaptures)."""
    ctrl = wbc_runs["ctrl"]
    args, _ = wbc_runs["recorded"][-1]
    ctrl.set_wbc_weight("baseAccel", 3.0)
    assert ctrl.device_wbc.cfg.weight_base_accel == 3.0 == ctrl.wbc_cfg.weight_base_accel
    t = ctrl.iface
    want = wbc_update(t.model, t.info, ctrl.wbc_cfg, *(torch.as_tensor(a) for a in args)).decision.numpy()
    # the class's update, not the recording wrapper the fixture put on the instance
    np.testing.assert_array_equal(DeviceWbc.update(ctrl.device_wbc, *args)[0], want)

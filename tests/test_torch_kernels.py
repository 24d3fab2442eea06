"""The port's hand-written CUDA kernels against their plain PyTorch versions.

The comparisons need an NVIDIA GPU with nvcc: they carry the ``gpu`` marker
and skip elsewhere.  This file imports neither JAX nor the JAX package, so
on a GPU machine it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

float64 bars: 1e-9 for the Riccati sweep and the linearization (as the
reference's kernel tests), rtol 1e-10 for the merit sums, 1e-10 for the
Gauss-Jordan solve (also at the device WBC's 128 x 128 KKT, and after a
CUDA-graph replay; in float32 its backward error max|A X - B| at most 4 x
the plain version's + 1e-6); the device
WBC's graph replay against op by op 1e-12 (it replays the same kernels on
the same inputs), its batch against the plain version on the CPU 1e-8, the
Kalman step's graph against the plain step on the CPU 1e-9; the solver as a whole at the batched-parity bars (1e-5,
K 1e-3, step_size exact).  The float32 linearization is held at 1e-4
relative to max(1, max|ref|): both sides round every product to 24 bits, so
they differ by a few float32 ulps of the largest entries, far below 1e-4,
while a wrong entry is off by O(1e-2) or more.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.model.centroidal import make_info
from bipedal_control_tpu_torch.model.robot_model import from_description
from bipedal_control_tpu_torch.model.urdf import JOINT_PRISMATIC, JOINT_REVOLUTE, RobotDescription
from bipedal_control_tpu_torch.ocp.linearize import linearize_node_structured
from bipedal_control_tpu_torch.ocp.problem import LinearizedNode, NodeRefs, OcpSettings
from bipedal_control_tpu_torch.ops import gj_kernel, linearize_kernel, merit_kernel, riccati_kernel
from bipedal_control_tpu_torch.parallel.batch_solver import make_batched_solver
from bipedal_control_tpu_torch.runtime.mpc_runner import MpcRunner
from bipedal_control_tpu_torch.solver.riccati import _regs, riccati_plain

from bipedal_control_tpu_torch.estim.estimator import KalmanStateEstimator
from bipedal_control_tpu_torch.runtime.controller import DeviceWbc, wbc_config_from_task
from bipedal_control_tpu_torch.wbc.weighted_wbc import wbc_update, wbc_update_batch

from chip_smoke import (
    H1_CONTACTS,
    PARITY_BARS,
    VARIANT_BARS,
    controller_parity,
    g1_front_end,
    g1_settings,
    h1_shaped_description,
    k1_outputs_checked,
    lean_problem,
    lean_solve,
    meshed_kernel_check,
    profile_counts,
    quat_from_zyx,
    require_meshed_kernels,
    solution_errors,
    variant_errors,
    wbc_inputs,
    wbc_kkt,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = [os.path.join(REPO, "configs", "g1", f)
            for f in ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _biped(device):
    """4-joint biped with revolute and prismatic joints and skewed axes."""
    rot = lambda a, t: (lambda K: np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K)(
        np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) / np.linalg.norm(a)
    )
    axes = np.array([[0.1, 0.99, 0.0], [0.0, 1.0, 0.05], [0.0, 1.0, 0.0], [0.05, 0.0, 1.0]])
    desc = RobotDescription(
        name="kernel_test_biped", joint_names=["lh", "lk", "rh", "rs"],
        joint_parent_body=np.array([0, 1, 0, 3]),
        joint_type=np.array([JOINT_REVOLUTE, JOINT_REVOLUTE, JOINT_REVOLUTE, JOINT_PRISMATIC]),
        joint_offset_R=np.stack([rot([0, 0, 1], 0.1), rot([1, 0, 0], -0.15), rot([0, 1, 0], 0.07), rot([1, 1, 0], 0.12)]),
        joint_offset_p=np.array([[0.01, 0.11, -0.12], [0.02, 0.01, -0.31], [0.01, -0.11, -0.12], [-0.015, 0.005, -0.29]]),
        joint_axis=axes / np.linalg.norm(axes, axis=1, keepdims=True),
        joint_limit_lower=-2 * np.ones(4), joint_limit_upper=2 * np.ones(4),
        joint_limit_effort=100 * np.ones(4), joint_limit_velocity=20 * np.ones(4),
        body_mass=np.array([9.0, 1.6, 0.9, 1.5, 0.7]),
        body_com=np.array([[0.01, 0, 0.15], [0, 0.02, -0.14], [0.01, -0.005, -0.17], [0, -0.02, -0.15], [-0.01, 0.005, -0.16]]),
        body_inertia=np.stack([np.diag([0.02 + 0.01 * b, 0.024 + 0.012 * b, 0.016 + 0.008 * b]) for b in range(5)]),
        frame_names=["lt", "lh", "rt", "rh"], frame_body=np.array([2, 2, 4, 4]),
        frame_R=np.stack([rot([0, 1, 0], 0.05), rot([0, 1, 0], -0.05), rot([1, 0, 0], 0.04), np.eye(3)]),
        frame_p=np.array([[0.09, 0, -0.33], [-0.06, 0.01, -0.33], [0.09, -0.01, -0.31], [-0.06, 0, -0.31]]),
    )
    model = from_description(desc, device=device)
    return model, make_info(model, ["lt", "lh", "rt", "rh"])


def _h1_shaped(device):
    """H1's leg layout (10 revolute joints, 16 coordinates): the circuit
    kernels' lane groups are full, where the 4-joint biped's 10 coordinates
    leave 6 of 16 lanes without a column."""
    model = from_description(h1_shaped_description(), device=device)
    return model, make_info(model, H1_CONTACTS)


def _g1_shaped(device):
    """G1's leg layout (12 revolute joints, 18 coordinates): make_interface
    on configs/g1 and the synthetic tests/data/g1_shaped_biped.urdf.  The
    circuit kernels run one 32-lane group per instance (one per warp)."""
    iface = make_interface(G1_URDF, *G1_FILES, device=device)
    return iface.model, iface.info


ROBOTS = {"biped4": _biped, "h1_shaped": _h1_shaped, "g1_shaped": _g1_shaped}
# instance counts: one instance, the B = 1 solve's 67 nodes, 37 (a warp
# and a block left partly empty: 8 instances per block, 2 per warp at
# 16 lanes, 1 at 32), 300
RAGGED_M = [1, 67, 37, 300]


def _standing(info, x):
    """Lift the base and, for the H1- and G1-shaped bipeds, bend the knees,
    so the random states stay near a pose the robot can take."""
    x[:, 8] += {4: 0.6, 10: 0.98, 12: 0.665}[info.nj]
    if info.nj == 10:
        x[:, 12:] += np.array([0.0, 0.0, -0.4, 0.8, -0.4] * 2)
    if info.nj == 12:
        x[:, 12:] += np.array([-0.4, 0.0, 0.0, 0.8, -0.4, 0.0] * 2)


def _lqr(rng, B, N, nx, nu, ne, device, dtype, stable=False, masked_stage=None):
    """Random masked LQR; stable=True draws A near 0.9 I (for long horizons),
    masked_stage masks every constraint row of that stage."""
    spd = lambda n: (lambda W: W @ np.swapaxes(W, -1, -2) / n + np.eye(n))(rng.normal(size=(B, N, n, n)))
    mask = np.ones((B, N, ne))
    mask[:, 1::2, -1] = 0.0
    if masked_stage is not None:
        mask[:, masked_stage] = 0.0
    A = 0.9 * np.eye(nx) + 0.1 / np.sqrt(nx) * rng.normal(size=(B, N, nx, nx)) if stable else \
        np.eye(nx) + 0.3 * rng.normal(size=(B, N, nx, nx))
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()
    nodes = LinearizedNode(
        A=T(A), B=T(0.4 * rng.normal(size=(B, N, nx, nu))),
        c=T(0.1 * rng.normal(size=(B, N, nx))), C=T(0.5 * rng.normal(size=(B, N, ne, nx)) * mask[..., None]),
        D=T((rng.normal(size=(B, N, ne, nu)) + np.eye(ne, nu)) * mask[..., None]),
        e=T(0.2 * rng.normal(size=(B, N, ne)) * mask), Qxx=T(spd(nx)), Quu=T(spd(nu)),
        Qux=T(0.05 * rng.normal(size=(B, N, nu, nx))), qx=T(rng.normal(size=(B, N, nx))),
        qu=T(rng.normal(size=(B, N, nu))), cost=T(np.zeros((B, N))),
    )
    return nodes, T(mask), T(0.1 * rng.normal(size=(B, nx)))


# a batch just past what the 256-thread Riccati build holds resident on the
# card (read from the wrapper in the test), a partly filled last wave
PAST_RESIDENT = "past_resident"


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,N,nx,nu,ne,dtype,masked_stage",
    [
        (5, 6, 7, 5, 3, torch.float64, None),  # small odd shapes
        (3, 67, 22, 22, 16, torch.float64, None),  # the main path's shapes
        (1, 67, 22, 22, 16, torch.float32, None),  # B = 1, float32
        (2, 12, 22, 22, 16, torch.float64, 5),  # one stage with every constraint row masked
        (3, 67, 24, 24, 16, torch.float64, None),  # G1's shapes (NKP = 40)
        (1, 67, 24, 24, 16, torch.float32, None),
        (PAST_RESIDENT, 8, 24, 24, 16, torch.float32, None),  # G1's shapes where the wrapper may take 128 threads
        (PAST_RESIDENT, 8, 24, 24, 16, torch.float64, None),
    ],
)
def test_riccati_kernel_matches_plain(cuda, B, N, nx, nu, ne, dtype, masked_stage):
    """float64 at atol 1e-9; float32 at 1e-3 relative to max(1, max|ref|)
    (chip_smoke.py phase 3's bar: two float32 sweeps in different summation
    orders agree to ~1e-5, a wrong entry of K is O(0.1)).  The launch goes to
    the build the wrapper's rule picks (``wide_launches`` counts the
    128-thread one): the 256-thread build at B = 1, the 128-thread one past
    the 256-thread build's residency in float32 at G1's shapes (4 CTAs per
    SM against 2); float64 has no 128-thread build."""
    resident, sms = riccati_kernel.residency(nx, nu, ne, dtype, cuda)
    if B == PAST_RESIDENT:
        B = resident[256] * sms + 7
    wide = riccati_kernel.choose_threads(B, resident, sms) == 128
    if B == 1:
        assert not wide
    if B > resident[256] * sms and dtype == torch.float32 and (nx, nu, ne) == (24, 24, 16):
        assert resident == {256: 2, 128: 4} and wide
    if dtype == torch.float64:  # the 128-thread build is float32's alone
        assert resident[128] == 0 and not wide
    nodes, masks, dx0 = _lqr(np.random.default_rng(0), B, N, nx, nu, ne, cuda, dtype,
                             stable=N > 6, masked_stage=masked_stage)
    regs = _regs(dtype)
    before = riccati_kernel.riccati_solve.launches, riccati_kernel.riccati_solve.wide_launches
    got = riccati_kernel.riccati_solve(nodes, masks, dx0, *regs)
    assert riccati_kernel.riccati_solve.launches == before[0] + 1
    assert riccati_kernel.riccati_solve.wide_launches == before[1] + wide
    want = riccati_plain(nodes, masks, dx0, regs)
    for name, g, w in zip(("K", "k", "dx", "du"), got, want):
        if dtype == torch.float64:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-9, msg=name)
        else:
            g, w = g.double(), w.double()
            assert float((g - w).abs().max()) / max(1.0, float(w.abs().max())) <= 1e-3, name


@pytest.mark.gpu
@pytest.mark.parametrize("masked_stage", [None, 5])
@pytest.mark.parametrize("shapes", [(24, 24, 16), (22, 22, 16)])
def test_riccati_builds_agree_bitwise(cuda, shapes, masked_stage):
    """The 256- and 128-thread builds change only which thread computes an
    element, not its operations or their order, so they give the same bits
    (float32, the 128-thread build's one dtype; G1's shapes; H1's, whose
    stage pieces of 88 bytes go by element-sized copies; and with one stage
    whose constraint rows are all masked, the near-singular regularised KKT)."""
    nodes, masks, dx0 = _lqr(np.random.default_rng(3), 3, 67, *shapes, cuda, torch.float32, stable=True,
                             masked_stage=masked_stage)
    regs = _regs(torch.float32)
    before = riccati_kernel.riccati_solve.launches, riccati_kernel.riccati_solve.wide_launches
    a = riccati_kernel._launch(nodes, masks, dx0, *regs, 256)
    b = riccati_kernel._launch(nodes, masks, dx0, *regs, 128)
    torch.cuda.synchronize()
    # every launch is counted where it is made, whichever entry made it
    assert (riccati_kernel.riccati_solve.launches, riccati_kernel.riccati_solve.wide_launches) == \
        (before[0] + 2, before[1] + 1)
    for name, x, y in zip(("K", "k", "dx", "du"), a, b):
        assert bool(torch.isfinite(x).all()), name
        assert torch.equal(x, y), name


@pytest.mark.gpu
def test_riccati_kernel_refuses_misaligned_input(cuda):
    """The kernel's bulk copies need 16-byte aligned inputs: a view at an odd
    offset raises instead of being copied."""
    nodes, masks, dx0 = _lqr(np.random.default_rng(0), 2, 3, 7, 5, 3, cuda, torch.float64)
    odd = torch.empty(nodes.A.numel() + 1, dtype=torch.float64, device=cuda)[1:].view_as(nodes.A)
    odd.copy_(nodes.A)
    with pytest.raises(ValueError, match="aligned"):
        riccati_kernel.riccati_solve(nodes._replace(A=odd), masks, dx0, *_regs(torch.float64))


@pytest.mark.gpu
@pytest.mark.parametrize("M", RAGGED_M)
@pytest.mark.parametrize("robot", sorted(ROBOTS))
@pytest.mark.parametrize("integrator", ["rk2", "euler"])
def test_merit_kernel_matches_plain(cuda, integrator, robot, M):
    m, info = ROBOTS[robot](cuda)
    settings = OcpSettings(integrator=integrator, position_error_gain=0.35)
    rng = np.random.default_rng(1)
    nx, nu = info.state_dim, info.input_dim
    x = rng.normal(scale=0.4, size=(M, nx))
    _standing(info, x)
    u = rng.normal(size=(M, nu))
    u[:, 2:12:3] += 30.0
    flags = np.stack([(np.arange(M) >> k) & 1 for k in range(4)], axis=1).astype(float)
    T = lambda a: torch.as_tensor(a, device=cuda)
    args = (T(x), T(u), T(x + rng.normal(scale=0.05, size=(M, nx))), T(flags),
            T(rng.normal(scale=0.3, size=(M, 4))), T(rng.normal(scale=0.05, size=(M, 4))), T(np.full(M, 0.02)))
    before = merit_kernel.merit_sums_cuda.launches
    got = merit_kernel.make_merit_sums(m, info, settings)(*args)
    assert merit_kernel.merit_sums_cuda.launches == before + 1
    want = merit_kernel.merit_sums_plain(m, info, settings, *args)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def _nodes(rng, info, M, device, dtype):
    nx, nu = info.state_dim, info.input_dim
    x = rng.normal(scale=0.4, size=(M, nx))
    _standing(info, x)
    u = rng.normal(size=(M, nu))
    u[:, 2:12:3] += 30.0
    flags = np.stack([(np.arange(M) >> k) & 1 for k in range(4)], axis=1).astype(float)
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    refs = NodeRefs(
        t=T(np.zeros(M)), dt=T(rng.choice([0.015, 0.02, 0.035], size=M)), contact_flags=T(flags),
        swing_vref=T(rng.normal(scale=0.3, size=(M, 4))), swing_pref=T(rng.normal(scale=0.05, size=(M, 4))),
        x_nom=T(x + rng.normal(scale=0.1, size=(M, nx))), u_nom=T(u + rng.normal(scale=0.5, size=(M, nu))),
    )
    return T(x), T(u), T(x + rng.normal(scale=0.05, size=(M, nx))), refs


@pytest.mark.gpu
@pytest.mark.parametrize("M", RAGGED_M)
@pytest.mark.parametrize("robot", sorted(ROBOTS))
@pytest.mark.parametrize("dtype,integrator", [(torch.float64, "rk2"), (torch.float64, "euler"), (torch.float32, "rk2")])
def test_linearize_kernel_matches_plain(cuda, dtype, integrator, robot, M):
    model, info = ROBOTS[robot](cuda)
    model = model.to(dtype=dtype)
    settings = OcpSettings(integrator=integrator, position_error_gain=0.35)
    nx, nu = info.state_dim, info.input_dim
    Q = torch.diag(torch.linspace(1.0, 3.0, nx, dtype=dtype, device=cuda))
    R = torch.diag(torch.linspace(0.1, 0.5, nu, dtype=dtype, device=cuda))
    xs, us, xns, refs = _nodes(np.random.default_rng(4), info, M, cuda, dtype)
    before = linearize_kernel.linearize_cuda.launches
    got = linearize_kernel.make_node_linearizer(model, info, settings, Q, R)(xs, us, xns, refs)
    assert linearize_kernel.linearize_cuda.launches == before + 1
    want = linearize_node_structured(model, info, settings, Q, R, xs, us, xns, refs)
    bar = 1e-9 if dtype == torch.float64 else 1e-4
    for name in want._fields:
        g, w = getattr(got, name).double(), getattr(want, name).double()
        assert float((g - w).abs().max()) / max(1.0, float(w.abs().max())) < bar, name


def _gj_check(A, B, got):
    """gj_kernel.solution_error's bars: float64 within 1e-10 of the plain
    version relative to max(1, max|ref|); float32 the backward error
    max|A X - B| (in float64) at most 4 x the plain version's + 1e-6."""
    err, bar = gj_kernel.solution_error(A, B, got)
    assert err <= bar, (err, bar)


# (batch, n, m, k) and the launch each must take: a CTA shape and its CTAs
# per system (a thread-block cluster when > 1)
GJ_CASES = [
    ((40, 14, 4, 6), ("S40", 1)),
    ((67, 38, 16, 23), ("S40", 1)),
    ((3, 8, 2, 3), ("S40", 1)),
    ((1, 45, 15, 70), ("L64", 2)),  # n not a multiple of the panel, k > n
    ((131, 45, 15, 70), ("L64", 2)),
    ((133, 45, 15, 10), ("L64", 1)),  # k < n, one CTA per system
    ((2, 127, 40, 5), ("L64", 3)),
    ((1, 127, 40, 200), ("L64", 6)),
    ((2, 128, 42, 384), ("L64", 8)),  # the widest cluster
    ((2, 130, 44, 10), ("T64", 3)),  # 192-row CTAs
    ((1, 150, 50, 150), ("T64", 5)),
    ((3, 192, 64, 64), ("T64", 4)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case,launch", GJ_CASES, ids=[f"B{c[0]}_n{c[1]}_k{c[3]}" for c, _ in GJ_CASES])
def test_gauss_jordan_kernel_matches_plain(cuda, case, launch, dtype):
    """K5 against its plain version over every path of its launch: the
    small-system CTAs, 64-column CTAs of 128 and 192 rows alone and in
    clusters of 2-8, n not a multiple of the 8-pivot panel, k < n and
    k > n."""
    batch, n, m, k = case
    rng = np.random.default_rng(5)
    A = torch.as_tensor(gj_kernel.quasi_definite(rng, batch, n, m), dtype=dtype, device=cuda)
    B = torch.as_tensor(rng.normal(size=(batch, n, k)), dtype=dtype, device=cuda)
    cfg = gj_kernel.launch_config(batch, n, k, dtype)
    assert (cfg["kind"], cfg["ctas_per_system"]) == launch
    before = gj_kernel.gauss_jordan_solve_pallas.launches
    got = gj_kernel.gauss_jordan_solve_pallas(A, B)
    assert gj_kernel.gauss_jordan_solve_pallas.launches == before + 1
    _gj_check(A, B, got)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 256])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_gauss_jordan_kernel_in_cuda_graph(cuda, dtype, B):
    """K5 captured in a CUDA graph (at B = 1 a cluster launch, as in the
    device WBC's graph) and replayed on new inputs, against the plain
    version; the capture counts no launch."""
    rng = np.random.default_rng(7)
    A = torch.as_tensor(gj_kernel.quasi_definite(rng, B, 128, 86), dtype=dtype, device=cuda)
    I = torch.eye(128, dtype=dtype, device=cuda).expand(B, 128, 128).contiguous()
    gj_kernel.gauss_jordan_solve_pallas(A, I)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = gj_kernel.gauss_jordan_solve_pallas.launches
    with torch.cuda.graph(graph):
        X = gj_kernel.gauss_jordan_solve_pallas(A, I)
    assert gj_kernel.gauss_jordan_solve_pallas.launches == before
    for seed in (8, 9):
        A.copy_(torch.as_tensor(gj_kernel.quasi_definite(np.random.default_rng(seed), B, 128, 86), dtype=dtype))
        graph.replay()
        torch.cuda.synchronize()
        _gj_check(A, I, X)


@pytest.mark.gpu
def test_gauss_jordan_kernel_refuses_unsupported_shapes(cuda):
    """n > 192 or n + k > 512 raises instead of launching."""
    assert gj_kernel.limits() == (192, 512)
    z = lambda *s: torch.zeros(*s, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="n <= 192"):
        gj_kernel.gauss_jordan_solve_cuda(z(1, 193, 193), z(1, 193, 1))
    with pytest.raises(ValueError, match="n \\+ k <= 512"):
        gj_kernel.gauss_jordan_solve_cuda(z(1, 100, 100), z(1, 100, 413))


@pytest.mark.gpu
@pytest.mark.parametrize("linearize", ["structured", "pallas"])
def test_batched_solver_kernels_match_plain(cuda, linearize):
    """riccati and merit 'pallas' (with linearize 'pallas': the production
    configuration, K1 + K2K3 + K4) against the all-plain configuration."""
    model, info = _biped(cuda)
    nx, nu = info.state_dim, info.input_dim
    B, N = 3, 6
    rng = np.random.default_rng(2)
    xs = rng.normal(scale=0.3, size=(B, N + 1, nx))
    xs[..., 8] += 0.6
    us = rng.normal(scale=0.8, size=(B, N, nu))
    us[..., 2:12:3] += 30.0
    T = lambda a: torch.as_tensor(a, dtype=torch.float64, device=cuda)
    flags = np.stack([(np.arange(B * N) >> k) & 1 for k in range(4)], axis=1).reshape(B, N, 4).astype(float)
    refs = NodeRefs(
        t=T(np.zeros((B, N))), dt=T(np.full((B, N), 0.015)), contact_flags=T(flags),
        swing_vref=T(rng.normal(scale=0.3, size=(B, N, 4))), swing_pref=T(rng.normal(scale=0.05, size=(B, N, 4))),
        x_nom=T(xs[:, :-1] + rng.normal(scale=0.1, size=(B, N, nx))), u_nom=T(us + rng.normal(scale=0.4, size=(B, N, nu))),
    )
    args = (refs, T(np.zeros((B, N + 1))), T(xs[:, 0] + rng.normal(scale=0.02, size=(B, nx))), T(xs), T(us))
    Q, R = np.diag(np.linspace(1.0, 3.0, nx)), np.diag(np.linspace(0.1, 0.5, nu))
    sols = []
    for lin, ric, mer in ((linearize, "pallas", "pallas"), ("structured", "sequential", "xla")):
        settings = OcpSettings(position_error_gain=0.35, linearize=lin, riccati=ric, merit=mer,
                               linesearch_alphas=(1.0, 0.5))
        sols.append(make_batched_solver(model, info, settings, Q, R)(*args))
    for name, tol in (("x_traj", 1e-5), ("u_traj", 1e-5), ("K", 1e-3), ("cost", 1e-5), ("defect_norm", 1e-5)):
        g, w = getattr(sols[0], name), getattr(sols[1], name)
        err = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
        print(f"{linearize} {name}: relative error {err:.3e}, bar {tol:g}")  # the margin, shown by pytest -rP
        assert err < tol, name
    assert torch.equal(sols[0].step_size, sols[1].step_size)


@pytest.mark.gpu
def test_mpc_runner_kernels_match_plain(cuda):
    """One cold and one warm MpcRunner replan on G1's configuration (the
    G1-shaped URDF): the production settings (K1, K2+K3, K4 at kG = 32 and
    stage shapes 24/24/16) against the all-plain ones, float64, at the
    batched-parity bars."""
    iface = make_interface(G1_URDF, *G1_FILES, device=cuda)
    rng = np.random.default_rng(3)
    xs = [iface.initial_state + rng.normal(scale=0.005, size=iface.initial_state.shape) for _ in range(2)]
    sols, launched = {}, {}
    for lin, ric, mer in (("pallas", "pallas", "pallas"), ("structured", "sequential", "xla")):
        settings = dataclasses.replace(iface.settings, sqp_iterations=1, linesearch_alphas=(1.0,), linearize=lin,
                                       riccati=ric, merit=mer)
        mpc = MpcRunner(dataclasses.replace(iface, settings=settings))
        mpc.rm.set_gait(iface.task.gait_library["trot"], 0.1)
        before = linearize_kernel.linearize_cuda.launches, riccati_kernel.riccati_solve.launches
        sols[lin] = [mpc.advance(t, torch.as_tensor(x, device=cuda)) for t, x in zip((0.0, 0.02), xs)]
        launched[lin] = (linearize_kernel.linearize_cuda.launches - before[0],
                         riccati_kernel.riccati_solve.launches - before[1])
    assert launched == {"pallas": (2, 2), "structured": (0, 0)}
    for got, want in zip(sols["pallas"], sols["structured"]):
        for name, tol in (("x_traj", 1e-5), ("u_traj", 1e-5), ("K", 1e-3), ("cost", 1e-5), ("defect_norm", 1e-5)):
            g, w = getattr(got, name), getattr(want, name)
            err = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            print(f"replan {name}: relative error {err:.3e}, bar {tol:g}")
            assert err < tol, name
        assert torch.equal(got.step_size, want.step_size)


@pytest.mark.gpu
def test_mpc_runner_graph_replays_match_op_by_op(cuda):
    """Four replans (one cold, three warm) of an MpcRunner whose replans
    replay CUDA graphs against the same replans run op by op, float64 on
    G1's configuration; either way the device runs K1, K2+K3 and K4 once
    per replan (torch.profiler's kernel events), and the wrappers count
    only the launches they make: all four replans op by op, the first cold
    and the first warm replan graphed (the two later ones replay)."""
    iface = make_interface(G1_URDF, *G1_FILES, device=cuda)
    iface.settings = dataclasses.replace(iface.settings, sqp_iterations=1, linesearch_alphas=(1.0,),
                                         linearize="pallas", riccati="pallas", merit="pallas")
    rng = np.random.default_rng(4)
    xs = [iface.initial_state + rng.normal(scale=0.005, size=iface.initial_state.shape) for _ in range(4)]
    sols, launched = {}, {}
    for graphed in (True, False):
        mpc = MpcRunner(iface)
        assert mpc.graphed
        if not graphed:
            mpc._graphs = None  # every replan op by op
        mpc.rm.set_gait(iface.task.gait_library["trot"], 0.1)
        wrappers = (linearize_kernel.linearize_cuda, riccati_kernel.riccati_solve, merit_kernel.merit_sums_cuda)
        before = [k.launches for k in wrappers]
        replans = lambda: [mpc.advance(t, torch.as_tensor(x, device=cuda)) for t, x in zip((0.0, 0.02, 0.04, 0.06), xs)]
        _, _, ran = profile_counts(lambda: sols.update({graphed: replans()}), cpu=False)
        launched[graphed] = [k.launches - b for k, b in zip(wrappers, before)]
        assert [ran[k] for k in ("linearize", "riccati", "merit")] == [4, 4, 4], (graphed, ran)
    assert launched == {True: [2, 2, 2], False: [4, 4, 4]}
    for k, (got, want) in enumerate(zip(sols[True], sols[False])):
        for name in ("x_traj", "u_traj", "K", "cost", "defect_norm", "eq_norm", "step_size"):
            g, w = getattr(got, name), getattr(want, name)
            err = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            print(f"replan {k} {name}: graph vs op by op relative error {err:.3e}")
            assert err <= 1e-9, (k, name)


@pytest.mark.gpu
def test_controller_kernels_match_plain(cuda):
    """20 synchronous BipedalController ticks on G1's configuration (the
    G1-shaped URDF), float64: the production settings (K1, K2+K3, K4 in
    every replan) against the all-plain ones on the same replayed
    measurements (chip_smoke.controller_parity): pos_des, vel_des and
    tau_ff within 1e-5 relative to max(1, max|ref|), contact flags equal;
    the device runs K1, K2+K3 and K4 once in each of the three replans
    (torch.profiler's kernel events; the third replays a CUDA graph)."""
    iface = make_interface(G1_URDF, *G1_FILES, device=cuda)
    iface.settings = g1_settings(iface.settings, "production")
    par = controller_parity(iface)
    print(f"controller parity: {par}")  # the margins, shown by pytest -rP
    assert par["replans"] == 3 and [par["kernels"][k] for k in ("linearize", "riccati", "merit")] == [3, 3, 3]
    assert par["flags_equal"] and par["safe"]
    for name, err in par["errors"].items():
        assert err < 1e-5, name


@pytest.fixture
def g1_cuda(cuda):
    iface = make_interface(G1_URDF, *G1_FILES, device=cuda)
    iface.settings = g1_settings(iface.settings, "production")
    return iface


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 131, 133, 256])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_gauss_jordan_kernel_at_wbc_shapes(g1_cuda, dtype, B):
    """K5 on the device WBC's KKT systems (128 x 128 | eye(128): a cluster
    of 4 CTAs per system) against its plain version at batches below, near
    and above one system per SM: float64 within 1e-10 relative to
    max(1, max|ref|).  In float32 the KKT's 2e-6 torque pivots
    beside entries of ~1e4 leave a few digits, so the kernel is held to a
    backward error: its residual max|A X - I| (in float64) at most 4 times
    the plain version's plus 1e-6."""
    iface = g1_cuda.to(dtype=dtype)
    A, I = wbc_kkt(iface, wbc_inputs(iface, B, 17))
    before = gj_kernel.gauss_jordan_solve_pallas.launches
    got = gj_kernel.gauss_jordan_solve_pallas(A, I)
    assert gj_kernel.gauss_jordan_solve_pallas.launches == before + 1
    err, bar = gj_kernel.solution_error(A, I, got)
    print(f"K5 {dtype} B={B}: error {err:.3e}, bar {bar:.3e}")  # the margin, shown by pytest -rP
    assert err <= bar


@pytest.mark.gpu
def test_device_wbc_graph_matches_op_by_op(g1_cuda):
    """DeviceWbc (float64) replays its CUDA graph from the second tick on:
    its decision and primal residual equal wbc_update's op by op on the card
    for new inputs (1e-12 relative to max(1, max|ref|)), and the device runs
    K5 once per replayed tick (torch.profiler's kernel events).  After a
    weight change (replace_config, what set_wbc_weight calls) the ticks
    compute with the new weight."""
    iface = g1_cuda
    wbc = DeviceWbc(iface, wbc_config_from_task(iface.task))
    x, u, rbd, flags = wbc_inputs(iface, 3, 19)
    wbc.update(x[0], u[0], rbd[0], flags[0])  # op by op, then the capture
    for k in (1, 2):
        out = []
        _, _, ran = profile_counts(lambda: out.append(wbc.update(x[k], u[k], rbd[k], flags[k])), cpu=False)
        decision, residual = out[0]
        T = lambda a: torch.as_tensor(a, device=iface.device)
        ref = wbc_update(iface.model, iface.info, wbc.cfg, T(x[k]), T(u[k]), T(rbd[k]), T(flags[k]))
        want = ref.decision.cpu().numpy()
        err = float(np.abs(decision - want).max()) / max(1.0, float(np.abs(want).max()))
        print(f"tick {k}: graph replay vs op by op decision rel err {err:.3e}; device ran {ran}")
        assert err <= 1e-12 and abs(residual - float(ref.qp.primal_residual)) <= 1e-12
        assert ran["gauss_jordan"] == 1
    # a new weight drops the graph: the next tick runs op by op with it and recaptures
    wbc.replace_config(dataclasses.replace(wbc.cfg, weight_base_accel=3.0))
    T = lambda a: torch.as_tensor(a, device=iface.device)
    ref = wbc_update(iface.model, iface.info, wbc.cfg, T(x[1]), T(u[1]), T(rbd[1]), T(flags[1])).decision.cpu().numpy()
    for _ in range(2):  # op by op, then the new graph's first replay
        decision, _ = wbc.update(x[1], u[1], rbd[1], flags[1])
        assert float(np.abs(decision - ref).max()) / max(1.0, float(np.abs(ref).max())) <= 1e-12


@pytest.mark.gpu
def test_wbc_update_batch_launches_k5_once(g1_cuda):
    """wbc_update_batch (solve_qp_batch inside) at B = 8, float64: one K5
    launch for the batch; decision within 1e-8 relative to max(1, max|ref|)
    of the plain version on the CPU, ``solved`` equal."""
    iface = g1_cuda
    cfg = wbc_config_from_task(iface.task)
    inputs = wbc_inputs(iface, 8, 23)
    before = gj_kernel.gauss_jordan_solve_pallas.launches
    got = wbc_update_batch(iface.model, iface.info, cfg, *(torch.as_tensor(a, device=iface.device) for a in inputs))
    assert gj_kernel.gauss_jordan_solve_pallas.launches == before + 1
    cpu = iface.to(device="cpu")
    want = wbc_update_batch(cpu.model, cpu.info, cfg, *(torch.as_tensor(a) for a in inputs))
    err = float((got.decision.cpu() - want.decision).abs().max()) / max(1.0, float(want.decision.abs().max()))
    print(f"wbc_update_batch B=8 card vs CPU plain: decision rel err {err:.3e}")
    assert err <= 1e-8 and torch.equal(got.qp.solved.cpu(), want.qp.solved)


@pytest.mark.gpu
def test_kalman_graph_matches_plain(g1_cuda):
    """KalmanStateEstimator on the card (its step replayed from a CUDA graph)
    against the same estimator on the CPU (the plain step), float64, 50
    ticks with contact changes: rbdState within 1e-9."""
    iface = g1_cuda
    x0, nj = np.asarray(iface.initial_state), iface.info.nj
    cpu = iface.to(device="cpu")
    ests = [KalmanStateEstimator(m.model, m.info, debounce_ticks=1) for m in (iface, cpu)]
    rng = np.random.default_rng(29)
    quat = quat_from_zyx(np.array([0.2, 0.01, -0.02]))
    for est in ests:
        est.reset(quat, x0[12:], x0[6:9])
    for k in range(50):
        flags = np.array([1.0, 1.0, 0.0, 0.0]) if (k // 10) % 2 else np.ones(4)
        s = (quat_from_zyx(np.array([0.2 + 0.01 * k, 0.01, -0.02])), rng.normal(scale=0.05, size=3),
             np.array([0.0, 0.0, 9.81]) + rng.normal(scale=0.2, size=3), x0[12:] + rng.normal(scale=0.02, size=nj),
             rng.normal(scale=0.2, size=nj), flags)
        got, want = (est.update(*s) for est in ests)
        assert float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max())) <= 1e-9, k


# ------------------------------------------------------------------ the solver variants
@pytest.mark.gpu
@pytest.mark.parametrize("cone", ["hard", "ipm"])
def test_cone_solves_match_cpu(g1_cuda, cone):
    """chip_smoke.py phase 15(a)'s lean stress (4 SQP iterations, five
    candidates) with the hard and the ipm cone: the production backends on
    the card (K1, K2+K3, K4 every iteration) against the same settings on
    the CPU (their plain versions), float64, at phase 15's bars (the
    batched-parity bars, the ipm's slack and dual 1e-5), steps equal."""
    got, want = lean_solve(g1_cuda, "production", cone), lean_solve(g1_cuda.to(device="cpu"), "production", cone)
    errs = variant_errors(got, want)
    print(f"{cone}: {errs}")
    assert all(v <= VARIANT_BARS[n] for n, v in errs.items()), errs
    assert torch.equal(got.step_size.cpu(), want.step_size)


@pytest.mark.gpu
def test_hard_cone_solve_runs_k1_once_per_iteration(g1_cuda):
    """The op-by-op hard-cone solve (4 SQP iterations) after a warm-up, under
    torch.profiler, with K1's outputs allocated NaN-filled: the wrappers
    launch K1, K2+K3 and K4 4 times each and every K1 launch writes all of
    its outputs.  The profiler's records are printed, not held: after many
    earlier traces in one process it has recorded 3 of the 4 K1 runs
    (PERF.md §6), while the launches all ran."""
    solver, inputs = lean_problem(g1_cuda, "production", "hard")
    solver(*inputs)
    written = []
    wrappers = (linearize_kernel.linearize_cuda, riccati_kernel.riccati_solve, merit_kernel.merit_sums_cuda)
    before = [k.launches for k in wrappers]
    with k1_outputs_checked(written):
        _, _, ran = profile_counts(lambda: solver(*inputs), cpu=False)
    launched = [k.launches - b for k, b in zip(wrappers, before)]
    print(f"wrappers {launched}, K1 outputs written {written}, profiler {ran}")
    assert launched == [4, 4, 4] and written == [True] * 4


@pytest.mark.gpu
def test_ilqr_runner_graph_replays_match_op_by_op(g1_cuda):
    """Four replans (one cold, three warm) of MpcRunner(solver="ilqr",
    ddp_iterations=2) replaying its CUDA graphs (the front end with
    iteration 0, a later iteration, the evaluation) against the same
    replans run op by op, float64 on G1, within 1e-9; and the op-by-op
    replans against the CPU at the batched-parity bars."""
    rng = np.random.default_rng(41)
    x0 = g1_cuda.initial_state
    xs = [x0 + rng.normal(scale=0.005, size=x0.shape) for _ in range(4)]
    sols = {}
    for where in ("graphed", "op by op", "cpu"):
        iface = g1_cuda.to(device="cpu") if where == "cpu" else g1_cuda
        mpc = MpcRunner(iface, solver="ilqr", ddp_iterations=2)
        assert mpc.graphed == (where != "cpu")
        if where == "op by op":
            mpc._graphs = None
        mpc.rm.set_gait(iface.task.gait_library["trot"], 0.1)
        sols[where] = [mpc.advance(t, torch.as_tensor(x, device=iface.device))
                       for t, x in zip((0.0, 0.02, 0.04, 0.06), xs)]
    for k, (got, want, cpu) in enumerate(zip(sols["graphed"], sols["op by op"], sols["cpu"])):
        for name in ("x_traj", "u_traj", "K", "cost", "defect_norm", "eq_norm", "step_size"):
            g, w = getattr(got, name), getattr(want, name)
            err = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            assert err <= 1e-9, (k, name, err)
        errs = solution_errors(want, cpu)
        print(f"replan {k}: op by op vs the CPU {errs}")
        assert all(errs[n] <= PARITY_BARS[n] for n in PARITY_BARS), (k, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("riccati,penalty", [("parallel_sqrt", 1e4), ("parallel", 1e2)])
def test_parallel_riccati_solve_matches_cpu(g1_cuda, riccati, penalty):
    """chip_smoke.py phase 15(c): the G1 solve with a parallel Riccati scan
    (the dense one at penalty 1e2, where it is conditioned; the square-root
    one at 1e4), five candidates, float64 B = 8, card against CPU at the
    batched-parity bars, steps equal."""
    sols = {}
    for where in ("card", "cpu"):
        iface = g1_cuda if where == "card" else g1_cuda.to(device="cpu")
        settings = dataclasses.replace(iface.settings, riccati=riccati, riccati_penalty=penalty,
                                       linesearch_alphas=OcpSettings().linesearch_alphas)
        solver = make_batched_solver(iface.model, iface.info, settings, iface.Q, iface.R, device=iface.device)
        sols[where] = solver(*g1_front_end(dataclasses.replace(iface, settings=settings), 8, 21))
    errs = solution_errors(sols["card"], sols["cpu"])
    print(f"{riccati}: {errs}")
    assert all(errs[n] <= PARITY_BARS[n] for n in PARITY_BARS), errs
    assert torch.equal(sols["card"].step_size.cpu(), sols["cpu"].step_size)


@pytest.mark.gpu
def test_srbd_runner_matches_cpu(g1_cuda):
    """chip_smoke.py phase 15(d): G1 as SRBD (centroidalModelType 1 at the
    initial joint state; structured, sequential, xla: K1 and K4 refuse
    SRBD), MpcRunner float64 card against CPU over a cold and a warm replan
    at the batched-parity bars."""
    sols = {}
    for where in ("card", "cpu"):
        iface = g1_cuda if where == "card" else g1_cuda.to(device="cpu")
        info = dataclasses.replace(iface.info, model_type=1,
                                   q_j_nominal=tuple(float(v) for v in iface.initial_state[12:]))
        iface = dataclasses.replace(iface, info=info, circuit=None, settings=g1_settings(iface.settings, "plain"))
        runner = MpcRunner(iface)
        runner.rm.set_gait(iface.task.gait_library["trot"], 0.1)
        x = torch.as_tensor(iface.initial_state, device=iface.device)
        sols[where] = [runner.advance(t, x) for t in (0.0, 0.02)]
    for got, want in zip(sols["card"], sols["cpu"]):
        errs = solution_errors(got, want)
        assert all(errs[n] <= PARITY_BARS[n] for n in PARITY_BARS), errs


@pytest.fixture
def world_of_one(cuda):
    """A world of one on the card (utils/distributed.py: NCCL by its rule)."""
    import torch.distributed as dist

    from bipedal_control_tpu_torch.utils.distributed import init_world

    init_world()
    try:
        yield dist.get_backend()
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_meshed_solver_matches_unmeshed(g1_cuda, world_of_one):
    """chip_smoke.py phase 17(a): G1 float64 B = 8, production backends:
    the meshed solve (a 1-D mesh over a world of one) equals the unmeshed
    one to 1e-12, K1, K2+K3 and K4 once per meshed solve (a graph replay's
    trace and the wrappers, chip_smoke.meshed_kernel_check)."""
    from bipedal_control_tpu_torch.parallel import make_mesh, shard_batch

    assert world_of_one == "nccl"
    iface = g1_cuda
    inputs = g1_front_end(iface, 8, 21)
    mesh = make_mesh()
    meshed = make_batched_solver(iface.model, iface.info, iface.settings, iface.Q, iface.R, mesh=mesh)
    sharded = shard_batch(inputs, mesh)
    got = meshed(*sharded)
    want = make_batched_solver(iface.model, iface.info, iface.settings, iface.Q, iface.R)(*inputs)
    for name in PARITY_BARS:
        full = getattr(got, name).full_tensor()
        err = float((full - getattr(want, name)).abs().max()) / max(1.0, float(getattr(want, name).abs().max()))
        assert err <= 1e-12, (name, err)
    require_meshed_kernels(meshed_kernel_check(meshed, inputs, sharded))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_fleet_stats_on_the_card(world_of_one, dtype):
    """fleet_stats of card tensors, sharded over a 1-D and a 1 x 1
    two-level mesh, against torch's reductions (1e-12 in float64, 1e-6
    relative in float32)."""
    from bipedal_control_tpu_torch.parallel import make_mesh, shard_batch
    from bipedal_control_tpu_torch.parallel.scaling import batch_spec, fleet_stats, make_two_level_mesh

    rng = np.random.default_rng(4)
    T = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    cost, defect, step = T(rng.uniform(1, 5, 256)), T(rng.uniform(0, 0.2, 256)), T(rng.choice([0.0, 0.5, 1.0], 256))
    want = [float(cost.double().mean()), float(defect.double().mean()), float(defect.max()),
            float((step > 0).double().mean())]
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    for mesh in (make_mesh(), make_two_level_mesh(1, 1)):
        got = [float(v) for v in fleet_stats(mesh, *shard_batch((cost, defect, step), mesh, batch_spec(mesh)))]
        np.testing.assert_allclose(got, want, rtol=tol, atol=0.0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' CUDA entry points raise on CPU tensors instead of
    computing there (the plain versions are reached only through the
    dispatching wrappers, for CPU tensors)."""
    nodes, masks, dx0 = _lqr(np.random.default_rng(0), 1, 2, 3, 2, 1, "cpu", torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        riccati_kernel.riccati_solve_cuda(nodes, masks, dx0, 1e-9, 1e-9)
    z = lambda *s: torch.zeros(*s, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        merit_kernel.merit_sums_cuda(z(10), {}, 0.0, "rk2", z(2, 16), z(2, 16), z(2, 16), z(2, 4), z(2, 4), z(2, 4), z(2))
    with pytest.raises(ValueError, match="CUDA"):
        gj_kernel.gauss_jordan_solve_cuda(z(1, 4, 4), z(1, 4, 4))

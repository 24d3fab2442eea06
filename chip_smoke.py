"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles the hand-written kernels from csrc/ with nvcc (sm_90a);
  3. K2+K3 (Riccati sweep + rollout) vs its plain version at B=256, N=67,
     nx=nu=22, ne=16, float64 and float32;
  4. K4 (merit sums) vs its plain version at M=17,152 instances, all four
     contact modes, float64 and float32;
  5. the batched RTI solve (make_batched_solver) at B=8, N=67 in float64,
     kernels vs plain versions, at the batched-parity bars of the reference;
  6. the batched RTI solve at B=256 in float32: warm-chained solves timed
     with CUDA events, kernels vs plain, with launch counts;
then a JSON line of per-kernel results and, last, the device JSON line.

The robot is H1-shaped (10 leg joints, 4 sole contacts, upper body welded
into the base, ~47 kg): nx = nu = 22 and ne = 16 as for H1.  When
$BIPEDAL_ASSETS holds the H1 URDF, H1 itself is loaded instead.  Weights,
references and initial states are made from fixed numpy seeds.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from bipedal_control_tpu_torch.model.centroidal import make_info
from bipedal_control_tpu_torch.model.robot_model import from_description
from bipedal_control_tpu_torch.model.urdf import JOINT_REVOLUTE, RobotDescription, load_urdf
from bipedal_control_tpu_torch.ocp.problem import LinearizedNode, NodeRefs, OcpSettings, weight_compensating_input
from bipedal_control_tpu_torch.ops import merit_kernel, riccati_kernel
from bipedal_control_tpu_torch.parallel.batch_solver import make_batched_solver
from bipedal_control_tpu_torch.solver.riccati import _regs, riccati_plain
from bipedal_control_tpu_torch.solver.sqp import initial_trajectory
from bipedal_control_tpu_torch.utils.precision import set_full_f32_matmul

H1_LEG_JOINTS = [
    f"{side}_{j}_joint"
    for side in ("left", "right")
    for j in ("hip_yaw", "hip_roll", "hip_pitch", "knee", "ankle")
]
H1_CONTACTS = ["left_sole_1_link", "left_sole_2_link", "right_sole_1_link", "right_sole_2_link"]
H1_URDF = "bipedal_robot_example/unitree_h1/h1_description/urdf/h1_with_sole.urdf"
N_NODES, DT = 67, 0.015


# ------------------------------------------------------------------ robot
def h1_shaped_description() -> RobotDescription:
    """Synthetic biped with H1's joint layout and H1-class masses/lengths."""
    axes = {"hip_yaw": (0, 0, 1), "hip_roll": (1, 0, 0), "hip_pitch": (0, 1, 0), "knee": (0, 1, 0), "ankle": (0, 1, 0)}
    masses = {"hip_yaw": 2.2, "hip_roll": 2.2, "hip_pitch": 4.1, "knee": 1.7, "ankle": 0.55}
    coms = {"hip_yaw": (0.0, 0.0, -0.02), "hip_roll": (0.0, 0.0, 0.0), "hip_pitch": (0.0, 0.0, -0.18),
            "knee": (0.0, 0.0, -0.2), "ankle": (0.04, 0.0, -0.05)}
    inert = {"hip_yaw": (0.004, 0.004, 0.003), "hip_roll": (0.003, 0.004, 0.003), "hip_pitch": (0.08, 0.08, 0.012),
             "knee": (0.03, 0.03, 0.003), "ankle": (0.0008, 0.003, 0.003)}
    offsets = {"hip_yaw": (0.0, 0.0875, -0.1742), "hip_roll": (0.039468, 0.0, 0.0), "hip_pitch": (0.0, 0.11536, 0.0),
               "knee": (0.0, 0.0, -0.4), "ankle": (0.0, 0.0, -0.4)}
    names, parents, off_p, axis, mass, com, inertia = [], [], [], [], [25.0], [(0.0, 0.0, 0.2)], [np.diag([1.2, 1.0, 0.4])]
    frames, frame_body, frame_p = [], [], []
    for side, sgn in (("left", 1.0), ("right", -1.0)):
        for k, j in enumerate(("hip_yaw", "hip_roll", "hip_pitch", "knee", "ankle")):
            names.append(f"{side}_{j}_joint")
            parents.append(0 if k == 0 else len(names) - 1)
            o = offsets[j]
            off_p.append((o[0], sgn * o[1], o[2]))
            axis.append(axes[j])
            mass.append(masses[j])
            c = coms[j]
            com.append((c[0], sgn * c[1], c[2]))
            inertia.append(np.diag(inert[j]))
        ankle_body = len(names)
        for n, p in ((1, (0.13, 0.0, -0.065)), (2, (-0.06, 0.0, -0.065))):
            frames.append(f"{side}_sole_{n}_link")
            frame_body.append(ankle_body)
            frame_p.append(p)
    nj = len(names)
    return RobotDescription(
        name="h1_shaped_biped",
        joint_names=names,
        joint_parent_body=np.array(parents),
        joint_type=np.full(nj, JOINT_REVOLUTE),
        joint_offset_R=np.tile(np.eye(3), (nj, 1, 1)),
        joint_offset_p=np.array(off_p),
        joint_axis=np.array(axis, dtype=np.float64),
        joint_limit_lower=-np.pi * np.ones(nj),
        joint_limit_upper=np.pi * np.ones(nj),
        joint_limit_effort=200.0 * np.ones(nj),
        joint_limit_velocity=20.0 * np.ones(nj),
        body_mass=np.array(mass),
        body_com=np.array(com),
        body_inertia=np.stack(inertia),
        frame_names=frames,
        frame_body=np.array(frame_body),
        frame_R=np.tile(np.eye(3), (len(frames), 1, 1)),
        frame_p=np.array(frame_p),
    )


def load_robot():
    assets = os.environ.get("BIPEDAL_ASSETS", "")
    path = os.path.join(assets, H1_URDF) if assets else ""
    if path and os.path.exists(path):
        return load_urdf(path, H1_LEG_JOINTS), f"unitree H1 ({path})"
    return h1_shaped_description(), "H1-shaped synthetic biped (H1 URDF not in $BIPEDAL_ASSETS)"


def standing_state(nj: int) -> np.ndarray:
    """Standing pose: knees bent 0.8 rad, feet flat, base at 0.976 m."""
    x = np.zeros(12 + nj)
    x[8] = 0.976
    leg = [0.0, 0.0, -0.4, 0.8, -0.4]
    x[12:] = np.array(leg * (nj // 5))[:nj]
    return x


def trot_refs(info, nx: int, B: int, seed: int):
    """Alternating-foot trot over N_NODES nodes at DT: double support 0.05 s,
    single support 0.25 s per foot (period 0.6 s), 6 cm swing apex on a
    (1 - cos) profile (zero velocity at lift-off and touch-down); each
    scenario starts at its own phase.  Returns numpy arrays of NodeRefs
    fields (B, N, ...), node times (B, N+1) and perturbed x_init (B, nx)."""
    rng = np.random.default_rng(seed)
    period, ds, ss, apex = 0.6, 0.05, 0.25, 0.06
    t = np.arange(N_NODES) * DT
    phase0 = rng.uniform(0.0, period, size=(B, 1))
    tp = np.mod(t[None] + phase0, period)  # (B, N)
    right_swing = (tp >= ds) & (tp < ds + ss)
    left_swing = tp >= ds + ss + ds
    s_right = np.clip((tp - ds) / ss, 0.0, 1.0)
    s_left = np.clip((tp - 2 * ds - ss) / ss, 0.0, 1.0)
    flags = np.ones((B, N_NODES, 4))
    flags[..., 0:2] = np.where(left_swing, 0.0, 1.0)[..., None]
    flags[..., 2:4] = np.where(right_swing, 0.0, 1.0)[..., None]
    pref = np.zeros((B, N_NODES, 4))
    vref = np.zeros((B, N_NODES, 4))
    for cols, sw, s in (((0, 1), left_swing, s_left), ((2, 3), right_swing, s_right)):
        z = 0.5 * apex * (1.0 - np.cos(2.0 * np.pi * s))
        vz = apex * np.pi / ss * np.sin(2.0 * np.pi * s)
        for c in cols:
            pref[..., c] = np.where(sw, z, 0.0)
            vref[..., c] = np.where(sw, vz, 0.0)
    x_nom = np.broadcast_to(standing_state(info.nj), (B, N_NODES, nx)).copy()
    refs = dict(
        t=np.broadcast_to(t, (B, N_NODES)).copy(), dt=np.full((B, N_NODES), DT), contact_flags=flags,
        swing_vref=vref, swing_pref=pref, x_nom=x_nom,
    )
    t_nodes = np.broadcast_to(np.arange(N_NODES + 1) * DT, (B, N_NODES + 1)).copy()
    x_init = x_nom[:, 0] + rng.normal(scale=0.01, size=(B, nx))
    return refs, t_nodes, x_init


def weights(nx: int, nu: int):
    """Tracking weights in the pattern of the reference's biped task.info
    (configs/g1/g1_task.info Q/R), on H1's joint order per leg
    [hip yaw, hip roll, hip pitch, knee, ankle]."""
    leg = [500.0, 600.0, 20.0, 20.0, 20.0]
    q = np.concatenate([[15.0, 15.0, 30.0, 3000.0, 3000.0, 10.0], [500.0, 500.0, 500.0, 100.0, 200.0, 200.0],
                        np.array(leg * ((nx - 12) // 5))[: nx - 12]])
    r = np.concatenate([np.full(12, 5e-3), np.full(nu - 12, 2.0)])
    return np.diag(q), np.diag(r)


# ------------------------------------------------------------------ helpers
def rel_err(got, ref) -> float:
    """max |got - ref| / max(1, max |ref|), in float64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def cuda_time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ------------------------------------------------------------------ phases
def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: chip_smoke.py needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    return name, smi


def phase_build(model, info):
    t0 = time.perf_counter()
    rb = riccati_kernel.build()
    sm = merit_kernel.make_static_model(model, info.contact_frame_ids)
    mb = merit_kernel.build(merit_kernel.kernel_defines(sm))
    secs = time.perf_counter() - t0
    spills = [ln.strip() for ln in (rb.ptxas_report + mb.ptxas_report).splitlines() if "spill" in ln]
    print(f"[2 build] riccati.cu + merit.cu for sm_90a in {secs:.1f} s "
          f"(nvcc {rb.build_seconds:.1f} s + {mb.build_seconds:.1f} s); ptxas: {' | '.join(spills)}")
    return secs


def random_lqr(B: int, N: int, nx: int, nu: int, ne: int, seed: int, device, dtype):
    """Stable, well-conditioned constrained LQR with the last 4 constraint
    rows masked at random stages (as swing normal-velocity rows are)."""
    rng = np.random.default_rng(seed)
    spd = lambda n: (lambda W: W @ np.swapaxes(W, -1, -2) / n + np.eye(n))(rng.normal(size=(B, N, n, n)))
    A = 0.9 * np.eye(nx) + rng.normal(size=(B, N, nx, nx)) * 0.1 / np.sqrt(nx)
    Bm = rng.normal(size=(B, N, nx, nu)) * 0.3 / np.sqrt(nu)
    C = rng.normal(size=(B, N, ne, nx)) * 0.5 / np.sqrt(nx)
    D = rng.normal(size=(B, N, ne, nu)) / np.sqrt(nu) + np.eye(ne, nu)
    e = rng.normal(size=(B, N, ne)) * 0.2
    mask = np.ones((B, N, ne))
    mask[..., ne - 4:] = rng.integers(0, 2, size=(B, N, 4))
    C, D, e = C * mask[..., None], D * mask[..., None], e * mask
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()
    nodes = LinearizedNode(
        A=T(A), B=T(Bm), c=T(rng.normal(size=(B, N, nx)) * 0.1), C=T(C), D=T(D), e=T(e),
        Qxx=T(spd(nx)), Quu=T(spd(nu)), Qux=T(rng.normal(size=(B, N, nu, nx)) * 0.05),
        qx=T(rng.normal(size=(B, N, nx))), qu=T(rng.normal(size=(B, N, nu))), cost=T(np.zeros((B, N))),
    )
    return nodes, T(mask), T(rng.normal(size=(B, nx)) * 0.1)


def phase_riccati(device):
    """K2+K3 vs plain.  f32 bar 1e-3: the problem is stable and well
    conditioned (unit-dominant Hessians, dual_eps = 1.2e-5 in f32), so two
    float32 evaluations of the same sweep in different summation orders
    agree to ~1e-5; 1e-3 leaves room without hiding a wrong entry (a wrong
    element of K is O(0.1))."""
    out = {}
    B, N, nx, nu, ne = 256, N_NODES, 22, 22, 16
    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        nodes, masks, dx0 = random_lqr(B, N, nx, nu, ne, 7, device, dtype)
        regs = _regs(dtype)
        got = riccati_kernel.riccati_solve_cuda(nodes, masks, dx0, *regs)
        ref = riccati_plain(nodes, masks, dx0, regs)
        torch.cuda.synchronize()
        errs = {n: rel_err(g, r) for n, g, r in zip(("K", "k", "dx", "du"), got, ref)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        print(f"[3 riccati] {str(dtype)[6:]} B={B} N={N}: max rel err "
              + " ".join(f"{n} {v:.2e}" for n, v in errs.items()) + f" (bar {bar:g})")
        require(finite and max(errs.values()) <= bar, f"riccati kernel disagrees in {dtype}: {errs}")
        if dtype == torch.float32:
            out["max_abs_err"] = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
            out["ms"] = cuda_time_ms(lambda: riccati_kernel.riccati_solve_cuda(nodes, masks, dx0, *regs), 20)
            out["plain_ms"] = cuda_time_ms(lambda: riccati_plain(nodes, masks, dx0, regs), 3)
    print(f"[3 riccati] float32 B={B}: kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms")
    return out


def merit_instances(info, M: int, seed: int, device, dtype):
    rng = np.random.default_rng(seed)
    nx, nu = info.state_dim, info.input_dim
    x = standing_state(info.nj)[None] + rng.normal(scale=0.05, size=(M, nx))
    modes = rng.integers(0, 4, size=M)  # FLY / LF / RF / STANCE
    flags = np.stack([(modes & 1) > 0, (modes & 1) > 0, (modes & 2) > 0, (modes & 2) > 0], axis=1).astype(float)
    u = weight_compensating_input(info, torch.as_tensor(flags), nu).numpy() + rng.normal(scale=2.0, size=(M, nu))
    xn = x + rng.normal(scale=0.05, size=(M, nx))
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()
    return (T(x), T(u), T(xn), T(flags), T(rng.normal(scale=0.3, size=(M, 4))),
            T(rng.normal(scale=0.05, size=(M, 4))), T(np.full(M, DT)))


def phase_merit(model, info, device):
    """K4 vs plain.  Relative error per sum is |got - ref| / (|ref| + floor)
    with floor 1e-12 (f64) and 1e-6 (f32): the sums are O(1e-3..1e4)."""
    out = {}
    M = 1 * 256 * N_NODES
    settings = OcpSettings(integrator="rk2", position_error_gain=0.0)
    for dtype, bar, floor in ((torch.float64, 1e-10, 1e-12), (torch.float32, 1e-4, 1e-6)):
        m = model.to(device=device, dtype=dtype)
        fn = merit_kernel.make_merit_sums(m, info, settings)
        args = merit_instances(info, M, 3, device, dtype)
        got = fn(*args)
        ref = merit_kernel.merit_sums_plain(m, info, settings, *args)
        torch.cuda.synchronize()
        err = float(((got.double() - ref.double()).abs() / (ref.double().abs() + floor)).max())
        print(f"[4 merit] {str(dtype)[6:]} M={M}: max rel err {err:.2e} (bar {bar:g})")
        require(bool(torch.isfinite(got).all()) and err <= bar, f"merit kernel disagrees in {dtype}: {err:.3e}")
        if dtype == torch.float32:
            out["max_abs_err"] = float((got.double() - ref.double()).abs().max())
            out["ms"] = cuda_time_ms(lambda: fn(*args), 20)
            out["plain_ms"] = cuda_time_ms(lambda: merit_kernel.merit_sums_plain(m, info, settings, *args), 5)
    print(f"[4 merit] float32 M={M}: kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms")
    return out


def solver_inputs(model, info, settings, B: int, seed: int, device, dtype):
    nx, nu = info.state_dim, info.input_dim
    refs_np, t_nodes, x_init = trot_refs(info, nx, B, seed)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device).contiguous()
    flags = T(refs_np["contact_flags"])
    refs = NodeRefs(**{k: T(v) for k, v in refs_np.items()}, u_nom=weight_compensating_input(info, flags, nu))
    xs, us = initial_trajectory(info, refs, T(x_init), settings.num_intervals + 1)
    return refs, T(t_nodes), T(x_init), xs, us


def main_settings(riccati: str, merit: str) -> OcpSettings:
    return OcpSettings(
        dt=DT, horizon=N_NODES * DT, sqp_iterations=1, linesearch_alphas=(1.0,), cone="soft",
        integrator="rk2", linearize="structured", riccati=riccati, merit=merit,
    )


def phase_parity(model, info, device):
    """Main path in float64 at B=8: kernels vs plain versions, at the bars of
    the reference's batched-parity test (x/u/cost/defect/eq 1e-5, K 1e-3,
    step_size exact)."""
    nx, nu = info.state_dim, info.input_dim
    Q, R = weights(nx, nu)
    sols = {}
    for name, (ric, mer) in (("kernels", ("pallas", "pallas")), ("plain", ("sequential", "xla"))):
        settings = main_settings(ric, mer)
        solver = make_batched_solver(model, info, settings, Q, R).to(device=device, dtype=torch.float64)
        sols[name] = solver(*solver_inputs(model, info, settings, 8, 11, device, torch.float64))
    torch.cuda.synchronize()
    a, b = sols["kernels"], sols["plain"]
    errs = {n: rel_err(getattr(a, n), getattr(b, n)) for n in ("x_traj", "u_traj", "K", "cost", "defect_norm", "eq_norm")}
    bars = {"x_traj": 1e-5, "u_traj": 1e-5, "K": 1e-3, "cost": 1e-5, "defect_norm": 1e-5, "eq_norm": 1e-5}
    same_step = bool(torch.equal(a.step_size, b.step_size))
    print("[5 parity] float64 B=8 kernels vs plain: " + " ".join(f"{n} {v:.2e}" for n, v in errs.items())
          + f" step_size equal {same_step} ({a.step_size.tolist()})")
    require(all(errs[n] <= bars[n] for n in bars) and same_step, f"main path f64 parity failed: {errs}")


def phase_main(model, info, device, ric, mer):
    """Main path at B=256 in float32: 3 warm-up solves, then 10 warm-chained
    solves timed with CUDA events, kernels and plain versions in turn.
    ric/mer: phases 3 and 4's kernel and plain times, taken at these shapes
    (B=256, N=67; M = 1 candidate x 256 x 67)."""
    nx, nu = info.state_dim, info.input_dim
    Q, R = weights(nx, nu)
    B, warm, steps = 256, 3, 10
    res = {}
    counts = {}
    for name, modes in (("kernels", ("pallas", "pallas")), ("plain", ("sequential", "xla"))):
        settings = main_settings(*modes)
        solver = make_batched_solver(model, info, settings, Q, R).to(device=device, dtype=torch.float32)
        refs, t_nodes, x_init, xs, us = solver_inputs(model, info, settings, B, 5, device, torch.float32)
        for _ in range(warm):
            sol = solver(refs, t_nodes, x_init, xs, us)
            xs, us = sol.x_traj, sol.u_traj
        torch.cuda.synchronize()
        if name == "kernels":
            riccati_kernel.riccati_solve.launches = 0
            merit_kernel.merit_sums_cuda.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            sol = solver(refs, t_nodes, x_init, xs, us)
            xs, us = sol.x_traj, sol.u_traj
        end.record()
        torch.cuda.synchronize()
        if name == "kernels":
            counts = {"riccati": riccati_kernel.riccati_solve.launches, "merit": merit_kernel.merit_sums_cuda.launches}
        ms = start.elapsed_time(end) / steps
        finite = all(bool(torch.isfinite(getattr(sol, f)).all()) for f in ("x_traj", "u_traj", "K", "cost", "defect_norm", "eq_norm"))
        require(finite, f"{name}: non-finite solver output")
        require(tuple(sol.x_traj.shape) == (B, N_NODES + 1, nx) and tuple(sol.K.shape) == (B, N_NODES, nu, nx),
                f"{name}: unexpected output shapes")
        res[name] = {"ms_per_solve": ms, "solves_per_s": B * 1000.0 / ms,
                     "defect_l1": float(sol.defect_norm.double().mean()),
                     "last_step_accepted": float((sol.step_size > 0).double().mean())}
    print(f"[6 main] float32 B={B}: kernels {res['kernels']['solves_per_s']:.1f} solves/s "
          f"({res['kernels']['ms_per_solve']:.3f} ms/solve), plain {res['plain']['solves_per_s']:.1f} solves/s "
          f"({res['plain']['ms_per_solve']:.3f} ms/solve); defect_l1 mean kernels {res['kernels']['defect_l1']:.3e} "
          f"plain {res['plain']['defect_l1']:.3e}; share of scenarios whose last step was accepted "
          f"{res['kernels']['last_step_accepted']:.3f} (0 once converged: the filter keeps the iterate); "
          f"launches {counts}; kernel vs plain ms: riccati {ric['ms']:.3f} vs {ric['plain_ms']:.3f}, "
          f"merit {mer['ms']:.3f} vs {mer['plain_ms']:.3f}")
    require(counts["riccati"] > 0 and counts["merit"] > 0, f"a kernel of the path was not launched: {counts}")
    return res, counts


def main():
    set_full_f32_matmul()
    name, _ = phase_device()
    device = torch.device("cuda", 0)
    desc, robot = load_robot()
    model = from_description(desc)
    info = make_info(model, H1_CONTACTS)
    print(f"[robot] {robot}: nj={info.nj} nx={info.state_dim} nu={info.input_dim} mass={info.robot_mass:.2f} kg")
    phase_build(model, info)
    ric = phase_riccati(device)
    mer = phase_merit(model, info, device)
    phase_parity(model, info, device)
    res, counts = phase_main(model, info, device, ric, mer)
    kernels = [
        {"name": "riccati sweep + rollout (K2 backward, fused K3 rollout of pallas_riccati.py:356)", "route": "cuda",
         "source": "bipedal_control_tpu_torch/csrc/riccati.cu",
         "replaces": "bipedal_control_tpu/ops/pallas_riccati.py:281",
         "launches": counts["riccati"], "max_abs_err": ric["max_abs_err"], "ms": ric["ms"], "plain_ms": ric["plain_ms"]},
        {"name": "merit sums (K4)", "route": "cuda",
         "source": "bipedal_control_tpu_torch/csrc/merit.cu",
         "replaces": "bipedal_control_tpu/ops/pallas_merit.py:253",
         "launches": counts["merit"], "max_abs_err": mer["max_abs_err"], "ms": mer["ms"], "plain_ms": mer["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --profile   # phases 1-2, then a profile of the B=256 solve
    python3 chip_smoke.py --variants  # phases 1-2, then phase 15 (the solver variants)
    python3 chip_smoke.py --cli       # phases 1-2, then phase 16 (the command line)
    python3 chip_smoke.py --fleet     # phases 1-2, then phase 17 (the fleet)

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles the four hand-written kernel libraries from csrc/ with
     nvcc (sm_90a), and G1's builds of K1, K4 and K2+K3 (phase 10), one nvcc
     process each, all seven started together; prints ptxas's registers and
     spill stores per kernel;
  3. K2+K3 (Riccati sweep + rollout) vs its plain version at B=256, N=67,
     nx=nu=22, ne=16, float64 and float32, timed at B=256 and at B=1 (one
     CTA's chain) with its time per stage, barriers per stage, registers,
     spills and shared memory;
  4. K4 (merit sums) vs its plain version at M=17,152 instances, all four
     contact modes, float64 and float32; timed at M=17,152 and at M=67 (the
     B=1 solve's launch);
  5. K1 (whole-node linearization) vs its plain version (the structured
     linearization) at B=256 x N=67 instances, all four contact modes, rk2
     and euler, position-error gain 0 and 0.35, float64 and float32; timed
     at M=17,152 and at M=67;
  6. K5 (batched Gauss-Jordan) vs its plain version on the 17,152 stage-KKT
     systems (38 x 38 | 23) of phase 3's problem, float64 and float32,
     beside torch.linalg.solve on the same inputs; timed at 17,152 and 67
     systems; K5's launch in each type (systems per CTA, resident CTAs and
     warps per SM, registers, spills);
  Phases 3-5 print each kernel's resident blocks and warps per SM
  (cudaOccupancyMaxActiveBlocksPerMultiprocessor, float32).  K1's and K4's
  times and every M=67 time are device times from a CUDA graph of the
  launches: timed back to back, a launch shorter than its wrapper's host
  work (Python, checks, ctypes; ~0.1 ms) would time the host instead;
  7. the production batched RTI solve (make_batched_solver with linearize,
     riccati and merit "pallas": K1, K2+K3, K4) at B=8, N=67 in float64 vs
     the all-plain configuration, at the batched-parity bars of the reference;
  8. the batched solve at B=256 in float32, three configurations in turns
     (production; linearize "structured" with K2+K3 and K4; all plain):
     warm-chained solves timed with CUDA events and with the host clock
     (enqueue), with launch counts;
  9. the single solve (sqp_solve at B=1 with every kernel): warm-chained
     solves timed with CUDA events, with launch counts;
 10. the task-config front end at G1's widths: make_interface on G1's
     configuration (configs/g1/* with overrides.info) with bench.py's
     settings; K2+K3, K4 and K1 against their plain versions at G1's shapes
     as in phases 3-5 (stage shapes 24/24/16; 32 lanes per instance); then
     set_gait("trot", 0.1), freeze(0), build_refs, initial_trajectory and
     the production solve against the all-plain one in float64 at B=8, and
     the batched solve at B=256 in float32 timed as phase 8;
 11. the replan loop: MpcRunner (production settings, float32) inside
     run_dummy_loop, 1.0 s at 400 Hz MRT and 50 Hz MPC, trot from 0.1 s,
     held to tests/test_dummy_loop.py's checks at G1's comHeight; replan
     p50/p99 on CUDA events, host ms per replan, the MRT tick; then five
     warm replans under torch.profiler (device activities per replan; the
     device must run K1, K2+K3 and K4 once in each); then a cold, a warm and
     two replayed warm replans in float64, production against plain, at
     phase 7's bars;
 12. the controller: BipedalController on G1 (float32, production
     settings, host WBC with the native C++ backends, cheater estimator),
     trot from 0.1 s, measured by a kinematic replay (tick k > 0 measures
     the rbd state of tick k-1's policy point, on the host in numpy; in
     (a)'s traced run and (c) also by rbd_state_from_centroidal, held to
     1e-10):
     (a) synchronous, 400 ticks at 2.5 ms steps (50 replans), driven twice:
     under torch.profiler, whose kernel events must show K1, K2+K3 and K4
     run once per replan on the device (a replan after each kind's first
     replays a CUDA graph, which no wrapper counts), then untraced for the
     tick's time with and without a replan, the WBC's, the replan's on CUDA
     events, and the device activities and host synchronisations of a tick
     without a replan;
     (b) asynchronous (the MPC worker on the card), the tick paced to a
     2.5 ms wall grid for 1.0 s in plain Python, then 40 ticks with the
     worker stopped under torch.profiler (no device activity allowed),
     then under RtControllerRunner (the native RtLoop at 400 Hz) for 1.0 s:
     the tick's time, the policy's staleness, the worker's solve time and
     the loop's cycles (at least 300 ticks written), overruns and each
     cycle's start (how late its callback began after the later of its
     deadline and the previous cycle's end: the loop thread's wake-up and
     its wait for the GIL), read, update and write times; then the same
     loop with the worker stopped (no bar: the difference is the worker's
     share of the cycle); (c) 20
     synchronous ticks in float64, production against the all-plain
     configuration on the same replayed measurements
     (pos_des, vel_des, tau_ff 1e-5 relative to max(1, max|ref|), planned
     contact flags equal, K1, K2+K3 and K4 run once per production replan);
  every tick of phases 12 and 13 is held to finite commands and |tau_ff|
  within the WBC's torque limits plus the tick's QP primal residual plus
  1e-6 (the ADMM runs a fixed number of iterations, as in the JAX package);
 13. the device WBC and the Kalman estimator on G1:
     (a) K5 on the device WBC's KKT systems (128 x 128 | eye(128)) at B = 1
     and B = 256, float64 (1e-10 against its plain version) and float32
     (its residual max|A X - I| at most 4 x the plain version's + 1e-6),
     timed beside its plain version, torch.linalg.solve and torch.linalg.inv
     of the same systems, with its bound, its time per pivot and per panel
     at B = 1, its launch at each shape (CTAs per system: a thread-block
     cluster at the WBC's KKT; resident CTAs and warps per SM, registers,
     spills) and ptxas report;
     (b) wbc_update_batch at B = 256 on the card, float32, timed, one K5
     launch for the batch, its torque's distance from float64 printed
     beside the plain version's, and float64 against the plain version on
     the CPU at B = 8 (1e-8);
     (c) BipedalController(wbc_backend="device", estimator="kalman"), float32,
     trot from 0.1 s: starting_from_sensors, then 400 update_from_sensors
     ticks (50 replans) on the replay plant, whose rbd states give the
     sensors (IMU quaternion, gyro, accelerometer from the base velocity's
     difference over the tick, joint positions and velocities); the tick,
     the WBC and the Kalman step timed; the estimate held to the replay:
     base position 5e-3 m (the JAX package's standing bar), base velocity
     within 0.25 m/s of the replay's odometry gap on each tick (the replay
     is no physical plant: its stance feet move, so the base velocity that
     leg odometry measures differs from the replay's by up to ~3 m/s);
     then the estimator alone at G1's stand, started 5 cm off, 1200 steps
     (the JAX test's bars: base-to-foot and height 5e-3 m, velocity
     1e-2 m/s); then 4 ticks under torch.profiler, in each of which
     the device must run K5 once (the WBC replays its CUDA graph, which no
     wrapper counts; a window whose trace lacks a run, as the tracer drops
     records now and then, is traced again on the next 4 ticks, up to 3
     windows, and one of them must record every run); the float32 torque of every tick whose float64 QP is
     solved against the float64 WBC on the same inputs (5e-2 relative to
     max(1, max|tau|); float32 keeps a few digits through the KKT's 2e-6
     torque pivots), and the same inputs in float32 batches through K5 and
     through its plain version on the card (through K5 at most 4 x through
     the plain version + 1e-3) and through the plain versions on the CPU;
     then 20 ticks in
     float64, production on the card against the all-plain configuration
     on the CPU with the same sensors (pos_des, vel_des, tau_ff and the
     filter's state 1e-5 relative to max(1, max|ref|), planned flags equal);
 14. the batched closed loop (sim/batch_loop.py: replan -> policy -> WBC ->
     PD -> physics over a batch of scenarios, each replan and each tick a
     CUDA-graph replay) on G1 at tools/scenario_survival_torch.py's settings
     (dt 0.02: N = 50; one SQP iteration; five line-search candidates):
     (a) float64, 3 lanes (two randomized, seed 0, one pitched 1.7 rad past
     the fall guard), 0.06 s, trot from 0.02 s, cmd_vel (0.3, 0, 0, 0.2)
     with the trim and the heading hold: production on the card against
     all plain on the CPU, final q, v, anchors, base_z_min, tilt_max and
     defect_last within 1e-5 relative to max(1, max|ref|), fell equal;
     then the same episode with each step in a profiler window of its
     own: K1, K2+K3 and K4 once in every solve, K5 once in every tick;
     then the episode with riccati "parallel_sqrt" (penalty 1e4; its solves
     run op by op, as a capture refuses the scan's eigh) on the card
     against all plain on the CPU at the same 1e-5, fell equal;
     (b) float32, B = 64 randomized at scale 1.0 (seed 7), trot from 0.2 s,
     cmd_vel 0.3 m/s, 1.0 s, run twice (the first runs each step op by op
     and captures): every lane finite at the end; fell, upright and
     progressed fractions, wall time per episode second, scenario-seconds
     per second, each graph's replay time, its device activities and busy
     share;
 15. the solver variants on G1 (configs/g1/* on the same URDF):
     (a) the hard and ipm friction cones on tests/test_torch_cone.py's lean
     stress (mu 0.05, vx weight 200, a 0.3 s horizon; 4 SQP iterations, the
     hard cone's continuation at cone_mu_decay 0.1; the ipm from the soft
     result), production backends on the card in float64 against the same
     on the CPU (the plain versions) at phase 7's bars plus the ipm's slack
     and dual 1e-5, every stance margin above -0.5 N, and one solve of each
     captured in a CUDA graph (within 1e-9 of the op-by-op solve) whose replay,
     under torch.profiler, must run K1, K2+K3 and K4 once per SQP iteration,
     as the wrappers launch them op by op; then float32 B = 256 on the trot front end,
     soft (1 iteration), hard and ipm (4), five candidates, in turns:
     solves/s and wrapper launches per solve (one per iteration);
     (b) MpcRunner(solver="ilqr"): float64, a cold and two warm replans at
     ddp_iterations=2 on the card (CUDA-graph replays) against the CPU at
     phase 7's bars; then a float32 dummy loop at ddp_iterations=8, 0.2 s at
     400 Hz MRT / 50 Hz MPC, trot from 0.1 s: the replayed replans' p50/p99
     on CUDA events, the device activities of each graph kind (profiler) and
     so of a warm replan, base z's range (no bar: no reference run of the
     iLQR on G1), every state finite;
     (c) riccati "parallel" (penalty 1e2, where the dense scan is
     conditioned) and "parallel_sqrt" (1e4), five candidates, in the G1
     solve, float64 B = 8 card vs CPU at phase 7's bars; the LQR solves alone on the front
     end's float32 B = 256 stage data: parallel_sqrt (penalty 1e4) beside
     K2+K3 and the plain sequential sweep, on CUDA events;
     (d) SRBD (centroidalModelType 1 at the initial joint state; structured,
     sequential, xla: the kernels refuse SRBD): MpcRunner float64 card vs
     CPU over a cold and a warm replan at phase 7's bars, then the float32
     replan's ms (op by op);
 16. the command line (bipedal_control_tpu_torch/cli.py, the port's
     production backends) with the robot registry's G1 on the URDF of
     phases 10-15: ``plan --robot g1 --gait trot --duration 0.2 --out ...``
     on the card in float64 under torch.profiler (K1, K2+K3 and K4 run once
     per replan, 10 replans) against the same on the CPU through the plain
     versions (the saved states and inputs within 1e-5 relative to
     max(1, max|ref|), the times equal); then in float32, untraced: its wall
     time and the replans' p50/p99 (the runner's host timer); then ``gaits``
     and Visualizer(record_tf=True).update + export_json over the card's
     float64 trajectory (finite markers, the first frame's soles on the
     ground).  The phase imports neither mujoco nor matplotlib (the card's
     machine has neither): ``sim`` and ``save_figure`` are held on the CPU
     (tests/test_torch_sim.py, tests/test_torch_cli.py), the controller that
     ``sim`` drives by phases 12-13;
 17. the fleet (parallel/, graft_entry.py, cli.py bench-scaling) in a world
     of one on the card, in a fresh process that utils/distributed.spawn
     starts (late in this process the profiler drops K1's records), which
     the backend rule of utils/distributed.py puts on NCCL: (a) G1 at N = 67 on the production backends, float64,
     B = 8: the meshed solve (make_mesh, shard_batch, make_batched_solver
     with mesh=) against the unmeshed one (1e-12) and against the CPU's
     plain versions at phase 7's bars; a CUDA-graph replay of the meshed
     solve under torch.profiler runs K1, K2+K3 and K4 once each, an
     op-by-op one launches each once through the wrappers (K1's outputs
     written), and the two agree to 1e-12; (b) float32: run_scaling_benchmark at
     per-device batch 256, 5 steps (solves/s, mean_defect), and fleet_stats
     of a B = 256 meshed solve against the same reductions in torch on the
     gathered arrays (1e-6 relative); (c) graft_entry.dryrun_multichip(2):
     two spawned ranks share the card over gloo, with its own bars; (d)
     graft_entry.entry()'s solve op by op against its CUDA-graph replay
     (GraphedCall; 1e-12); (e) ``bench-scaling --robot g1 --per-device-batch
     256 --steps 5`` through cli.main (the registry's G1 on this URDF): exit
     0, one JSON line with ScalingPoint's fields;
then a JSON line of G1's solve and loop results, a JSON line of the
controller's, a JSON line of phase 13's, a JSON line of phase 14's, a JSON
line of phase 15's, a JSON line of phase 16's, a JSON line of phase 17's,
a JSON line of per-kernel results (with each model
kernel's G1 figures under "g1", K5's at the device WBC's shapes, with its
launches per controller tick, every kernel's launches per cascade replan
and tick, and K1's, K2+K3's and K4's per hard-cone and ipm solve, per
replan of the command line's plan and per meshed solve) and, last, the
device JSON line.
With --profile, phases 1-2 are followed by torch.profiler over warm B=256
float32 solves of the production and "structured" configurations (device
busy share, device time by kernel, the host's synchronising runtime calls).
With --variants, phases 1-2 are followed by phase 15 alone and its JSON
line; with --cli, by phase 16 alone and its JSON line; with --fleet, by
phase 17 alone and its JSON line.

The robot of phases 3-9 is H1-shaped (10 leg joints, 4 sole contacts, upper
body welded into the base, ~47 kg): nx = nu = 22 and ne = 16 as for H1.
When $BIPEDAL_ASSETS holds the H1 URDF, H1 itself is loaded instead.  The
robot of phases 10-17 is the synthetic G1-shaped biped of
tests/data/g1_shaped_biped.urdf (nx = nu = 24), or G1's own URDF when
$BIPEDAL_ASSETS holds it.  Weights,
references and initial states are made from fixed numpy seeds.  Each
kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its operations over 67 TFLOP/s (H100 SXM
float32 without tensor cores; NVIDIA's data sheet).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from bipedal_control_tpu_torch.estim.estimator import KalmanStateEstimator
from bipedal_control_tpu_torch.interface import make_interface
from bipedal_control_tpu_torch.model.centroidal import (
    centroidal_flow_map,
    contact_positions,
    make_info,
    rbd_state_from_centroidal,
)
from bipedal_control_tpu_torch.model.host_model import euler_rate_map_zyx_np, make_host_model, rotmat_from_zyx_np
from bipedal_control_tpu_torch.model.kinematics import frame_jacobians
from bipedal_control_tpu_torch.model.native_model import NativeHostModel
from bipedal_control_tpu_torch.model.robot_model import from_description
from bipedal_control_tpu_torch.model.urdf import JOINT_REVOLUTE, RobotDescription, load_urdf
from bipedal_control_tpu_torch.ocp.linearize import linearize_node_structured
from bipedal_control_tpu_torch.ocp.problem import LinearizedNode, NodeRefs, OcpSettings, weight_compensating_input
from bipedal_control_tpu_torch.ops import gj_kernel, linearize_kernel, merit_kernel, riccati_kernel
from bipedal_control_tpu_torch.ops.cuda_build import build_libraries, resident_per_sm
from bipedal_control_tpu_torch.ops.linalg import gauss_jordan_solve
from bipedal_control_tpu_torch.ops.static_model import circuit_static, make_static_model, tables_np
from bipedal_control_tpu_torch.parallel.batch_solver import make_batched_solver
from bipedal_control_tpu_torch.robots import get_assets
from bipedal_control_tpu_torch.runtime.controller import (
    BipedalController,
    ControllerConfig,
    DeviceWbc,
    wbc_config_from_task,
)
from bipedal_control_tpu_torch.runtime.mpc_runner import MpcRunner
from bipedal_control_tpu_torch.runtime.rt_runner import RtControllerRunner
from bipedal_control_tpu_torch.sim.dummy_loop import run_dummy_loop
from bipedal_control_tpu_torch.solver.riccati import _regs, riccati_plain
from bipedal_control_tpu_torch.solver.sqp import build_refs, initial_trajectory, sqp_solve, warm_start_trajectories
from bipedal_control_tpu_torch.utils.cuda_graph import GraphedCall
from bipedal_control_tpu_torch.utils.precision import set_full_f32_matmul
from bipedal_control_tpu_torch.wbc import qp as wbc_qp_module
from bipedal_control_tpu_torch.wbc.qp import kkt_matrix
from bipedal_control_tpu_torch.wbc.weighted_wbc import wbc_qp, wbc_update_batch

H1_LEG_JOINTS = [
    f"{side}_{j}_joint"
    for side in ("left", "right")
    for j in ("hip_yaw", "hip_roll", "hip_pitch", "knee", "ankle")
]
H1_CONTACTS = ["left_sole_1_link", "left_sole_2_link", "right_sole_1_link", "right_sole_2_link"]
H1_URDF = "bipedal_robot_example/unitree_h1/h1_description/urdf/h1_with_sole.urdf"
G1_SHAPED_URDF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "g1_shaped_biped.urdf")
N_NODES, DT = 67, 0.015
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_F64_OPS_PER_S = 67e12  # H100 SXM float64 on the tensor cores (34e12 outside them)
CONFIGS = {  # (linearize, riccati, merit)
    "production": ("pallas", "pallas", "pallas"),
    "structured": ("structured", "pallas", "pallas"),
    "plain": ("structured", "sequential", "xla"),
}


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
    """max |got - ref| / max(1, max |ref|), in float64 (on the CPU)."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
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


def graph_time_ms(fn, reps: int) -> float:
    """Device time per call of a launch too short to time back to back:
    `reps` calls captured in one CUDA graph and replayed under CUDA events,
    so the host's per-call work (Python, the wrapper's checks, ctypes) is
    not in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def bound(bytes_moved: float, ops: float, peak_ops: float = PEAK_F32_OPS_PER_S) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the dtype's peak rate, whichever is larger."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "ops": ops}


def reset_launches():
    for fn in (linearize_kernel.linearize_cuda, riccati_kernel.riccati_solve, merit_kernel.merit_sums_cuda,
               gj_kernel.gauss_jordan_solve_pallas):
        fn.launches = 0


def read_launches() -> dict:
    return {"linearize": linearize_kernel.linearize_cuda.launches, "riccati": riccati_kernel.riccati_solve.launches,
            "merit": merit_kernel.merit_sums_cuda.launches,
            "gauss_jordan": gj_kernel.gauss_jordan_solve_pallas.launches}


# Operation counts of the kernels' arithmetic on these shapes, read off the
# loops of csrc/ (each add, multiply, divide and sin/cos is one operation;
# data-dependent only through the robot's tree: revolute joints and the
# coordinate/body pairs where "coordinate l moves body b").
def _tree(sm):
    rev = sum(1 for t in sm.jtype if t == JOINT_REVOLUTE)
    moved = int(tables_np(sm)[1:].sum())
    return rev, moved


def _fk_fields_ops(sm) -> int:
    rev, _ = _tree(sm)
    fk = 31 + 203 * rev + 84 * (sm.nj - rev)
    fields = 36 + 27 * rev + 15 * (sm.nj - rev)
    return fk + fields


def _flow_tail_ops(sm, nc=4) -> int:
    """inv6, v and the flow value from the CMM."""
    return 388 + 6 * (2 * sm.nj + 2) + 72 + 18 * nc + 7


def k1_ops(sm, M: int, rk2: bool, nx: int, nu: int, ne: int = 16, nc: int = 4) -> float:
    """linearize.cu: one group-parallel centroidal pass per stage (two for
    rk2), the derivative columns per lane, then the output elements."""
    _, moved = _tree(sm)
    nb, nv, nj = sm.nb, sm.nv, sm.nj
    cmm = 6 * nv * nb + 46 * moved + 85 * nv
    one_pass = _fk_fields_ops(sm) + 108 * nb + 18 * nc + cmm + _flow_tail_ops(sm, nc)
    lane = 3 + 135 + 81 * nj + 159 * nb + 24 * nc + 72 + 66 + 12 * nc + 13 * 3 * nc
    deriv = nv * lane + 72 * nj
    out_A = 3 * (6 * 20 + nv * 16) + 6 * (6 * 23 + nv * 26)
    out_B = 12 + 3 * 12 * 3 + 3 * nj * 15 + 6 * 12 * 18 + 6 * nj * 17
    out_C = ne * (6 * 19 + nv)
    out_D = 12 + ne * nj * 14
    out_e = ne * (2 * nv + 5)
    per = (2 if rk2 else 1) * one_pass + deriv + out_A + out_B + out_C + out_D + out_e + 6 * nx
    return float(M * per)


def k4_ops(sm, M: int, rk2: bool, nx: int, nc: int = 4) -> float:
    """merit.cu: one or two per-thread flow passes (subtree sums), then the
    contact velocities and the four sums."""
    nb, nv = sm.nb, sm.nv
    flow = _fk_fields_ops(sm) + 133 * nb + 19 * (nb - 1) + 85 * nv + _flow_tail_ops(sm, nc)
    per = (2 if rk2 else 1) * flow + 3 * nx + nc * nv * 21 + 4 * nx + nc * 20
    return float(M * per)


def k23_ops(B: int, N: int, nx: int, nu: int, ne: int) -> float:
    """riccati.cu per stage: P = S [B | A | c] + s with S's symmetrisation,
    [H_uu | H_ux | h_u] = Q + B'P, the KKT's -Reg diagonal and H_uu's
    regularisation, the pivot-free elimination (per pivot pair: two
    multiply-adds per updated element, each column's two normalised row
    entries, each row's two factors, the pair's two reciprocals),
    G = H_uu [K|k] - [H_ux|h_u], [H_xx|h_x] = Q + A'P, U; then the rollout."""
    nkp = 2 * ((nu + ne + 1) // 2)
    w = nkp + nx + 1
    ldp, nxp = nu + nx + 1, nx + 1
    elim = sum(nkp * (w - p - 2) * 4 + (w - p - 2) * 4 + nkp * 4 + 4 for p in range(0, nkp, 2))
    stage = (2 * nx * nx + nx * ldp * 2 * nx + nx + nu * ldp * (2 * nx + 1) + 3 * ne + nu + elim
             + nu * nxp * (2 * nu + 1) + nx * nxp * (2 * nx + 1) + nx * nxp * 4 * nu)
    rollout = nu * (2 * nx + 1) + nx * (2 * nx + 2 * nu + 2)
    return float(B * N * (stage + rollout))


def k5_ops(batch: int, n: int, k: int) -> float:
    """The pivot-free Gauss-Jordan solve A X = B: per pivot i, one division
    for each column right of it in the pivot row and one multiply-add (two
    operations) for each such column in the n - 1 other rows (the
    function's work, as the plain version does it)."""
    W = n + k
    return float(batch * sum((W - 1 - i) * (1 + 2 * (n - 1)) for i in range(n)))


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


def ptxas_summary(report: str) -> list[str]:
    """'<dtype>: <registers> regs, <spill stores>' per kernel entry (K5's
    entries named by their CTA shape: '<dtype> L64: ...'; K2+K3's by their
    threads per scenario: '<dtype> 128t: ...')."""
    out, dtype, spill = [], None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '\S*?I([df])(EE|Li(\d+)EE|NS_4TileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E)", ln)
        if m:
            dtype, spill = ("f64" if m.group(1) == "d" else "f32"), ""
            if m.group(3):  # K2+K3's riccati_kernel<T, NTH>
                dtype += f" {m.group(3)}t"
            if m.group(4):  # K5's Tile<WR, WC, WGR, WGC, ...>: 8 WR WGR rows
                wr, wgr = int(m.group(4)), int(m.group(6))
                dtype += {40: " S40", 128: " L64", 192: " T64"}[8 * wr * wgr]
        elif dtype and "spill stores" in ln:
            spill = re.search(r"(\d+) bytes spill stores", ln).group(1)
        elif dtype and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{dtype}: {regs} regs, {spill} B spill stores")
            dtype = None
    return out


def phase_build(defines, shapes, g1_defines, g1_shapes):
    """shapes: the main path's (nx, nu, ne), compiled into the Riccati
    kernel; g1_defines and g1_shapes: the G1 front end's topology and stage
    shapes (phases 10-11), a second build of K1, K4 and K2+K3."""
    names = ("riccati", "merit", "linearize", "gauss_jordan", "riccati_g1", "merit_g1", "linearize_g1")
    t0 = time.perf_counter()
    libs = build_libraries([("riccati", "riccati.cu", riccati_kernel.shape_defines(*shapes)),
                            ("merit", "merit.cu", defines), ("linearize", "linearize.cu", defines),
                            ("gauss_jordan", "gauss_jordan.cu", {}),
                            ("riccati", "riccati.cu", riccati_kernel.shape_defines(*g1_shapes)),
                            ("merit", "merit.cu", g1_defines), ("linearize", "linearize.cu", g1_defines)])
    secs = time.perf_counter() - t0
    print(f"[2 build] riccati.cu merit.cu linearize.cu gauss_jordan.cu (and riccati, merit, linearize for G1) "
          f"for sm_90a in {secs:.1f} s "
          f"(nvcc in parallel: " + ", ".join(f"{n} {b.build_seconds:.1f} s" for n, b in zip(names, libs)) + ")")
    for n, b in zip(names, libs):
        print(f"[2 build] ptxas {n}: " + " | ".join(ptxas_summary(b.ptxas_report)))
    return dict(zip(names, libs))


def occupancy(lib, name: str, what: str, *shape: int) -> int:
    """Print the float32 kernel's resident blocks and warps per SM; return the warps."""
    blocks, warps = resident_per_sm(lib, name, 4, *shape)
    print(f"[{what}] float32 occupancy: {blocks} blocks = {warps} warps resident per SM")
    return warps


def k5_config(batch: int, n: int, k: int, dtype, what: str) -> dict:
    """Print and return K5's launch at this shape (gj_kernel.launch_config):
    its CTA shape, CTAs per system (the cluster size), systems per CTA,
    resident CTAs and warps per SM, co-resident clusters, registers and
    local (spill) bytes per thread, shared bytes per CTA."""
    cfg = gj_kernel.launch_config(batch, n, k, dtype)
    cluster = f", {cfg['max_active_clusters']} co-resident clusters" if cfg["ctas_per_system"] > 1 else ""
    print(f"[{what}] {str(dtype)[6:]} B={batch} ({n} x {n} | {k}): {cfg['kind']}, {cfg['ctas']} CTAs of "
          f"{cfg['threads_per_cta']} threads, {cfg['ctas_per_system']} CTA(s) per system, {cfg['systems_per_cta']} "
          f"system(s) per CTA; {cfg['ctas_per_sm']} CTAs = {cfg['warps_per_sm']} warps resident per SM{cluster}; "
          f"{cfg['registers']} registers and {cfg['local_bytes']} B local per thread, "
          f"{cfg['shared_bytes_per_cta']} B shared per CTA; {cfg['panels']} panels of 8 pivots")
    return cfg


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


def riccati_barriers_per_stage(nu: int, ne: int) -> int:
    """A constant of csrc/riccati.cu's design: after P = S [B | A | c], after
    the H blocks, after the KKT load, one per pivot pair but the last,
    after K, after H_xx and G, after U."""
    return (nu + ne + 1) // 2 + 5


def phase_riccati(device, lib, shapes=(22, 22, 16), tag="3 riccati", wide_batch=None):
    """K2+K3 vs plain at the stage shapes (nx, nu, ne).  f32 bar 1e-3: the problem is stable and well
    conditioned (unit-dominant Hessians, dual_eps = 1.2e-5 in f32), so two
    float32 evaluations of the same sweep in different summation orders
    agree to ~1e-5; 1e-3 leaves room without hiding a wrong entry (a wrong
    element of K is O(0.1)).  wide_batch: a float32 batch past the
    256-thread build's residency, where the wrapper takes the 128-thread
    build; it is checked against plain at the same bar and timed beside the
    256-thread build (out["wide"])."""
    out = {}
    B, N, (nx, nu, ne) = 256, N_NODES, shapes
    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        nodes, masks, dx0 = random_lqr(B, N, nx, nu, ne, 7, device, dtype)
        regs = _regs(dtype)
        got = riccati_kernel.riccati_solve_cuda(nodes, masks, dx0, *regs)
        ref = riccati_plain(nodes, masks, dx0, regs)
        torch.cuda.synchronize()
        errs = {n: rel_err(g, r) for n, g, r in zip(("K", "k", "dx", "du"), got, ref)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        print(f"[{tag}] {str(dtype)[6:]} B={B} N={N} nx={nx} nu={nu} ne={ne}: max rel err "
              + " ".join(f"{n} {v:.2e}" for n, v in errs.items()) + f" (bar {bar:g})")
        require(finite and max(errs.values()) <= bar, f"riccati kernel disagrees in {dtype}: {errs}")
        if dtype == torch.float32:
            out["max_abs_err"] = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
            out["ms"] = cuda_time_ms(lambda: riccati_kernel.riccati_solve_cuda(nodes, masks, dx0, *regs), 20)
            out["plain_ms"] = cuda_time_ms(lambda: riccati_plain(nodes, masks, dx0, regs), 3)
    # one CTA's chain: B = 1 at the main path's shapes, float32, held to the same bar
    nodes1, masks1, dx01 = random_lqr(1, N, nx, nu, ne, 8, device, torch.float32)
    regs = _regs(torch.float32)
    got = riccati_kernel.riccati_solve_cuda(nodes1, masks1, dx01, *regs)
    err = max(rel_err(g, r) for g, r in zip(got, riccati_plain(nodes1, masks1, dx01, regs)))
    require(err <= 1e-3, f"riccati kernel disagrees at B=1 in float32: {err:.3e}")
    out["b1_ms"] = cuda_time_ms(lambda: riccati_kernel.riccati_solve_cuda(nodes1, masks1, dx01, *regs), 50)
    out["ms_m67"] = out["b1_ms"]  # B = 1: the 67 stages of one scenario
    # the 128-thread build's chain alone (the wrapper takes it above the 256-thread build's residency)
    b1_wide_ms = cuda_time_ms(lambda: riccati_kernel._launch(nodes1, masks1, dx01, *regs, 128), 50)
    out["warps_per_sm"] = occupancy(lib.lib, "riccati", tag, 256)
    occupancy(lib.lib, "riccati", f"{tag} 128t", 128)
    s = 4
    stage_in = 2 * nx * nx + 2 * nx * nu + nu * nu + ne * nx + ne * nu + 2 * nx + nu + 2 * ne
    stage_out = nu * nx + 2 * nu
    out.update(bound(s * (B * N * (stage_in + stage_out) + B * nx + B * (N + 1) * nx), k23_ops(B, N, nx, nu, ne)))
    print(f"[{tag}] float32 B={B}: kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, "
          f"bound {out['bound_ms']:.4f} ms ({out['bound_by']})")
    if wide_batch is not None:
        out["wide"] = riccati_wide(wide_batch, N, (nx, nu, ne), device, tag)
        out["wide"]["b1_128t_ms"] = b1_wide_ms
    ptx = ptxas_summary(lib.ptxas_report)
    out["registers"] = " | ".join(ptx)
    smem = {f"{d} {th}t": lib.lib.riccati_smem_bytes(f, th) for d, f, th in (("f32", 0, 256), ("f32", 0, 128),
                                                                              ("f64", 1, 256))}
    print(f"[{tag}] float32 B=1: kernel {out['b1_ms']:.4f} ms, 128-thread build {b1_wide_ms:.4f} ms "
          f"(max rel err {err:.2e}, bar 1e-3); "
          f"{out['ms'] * 1e3 / N:.2f} us/stage at B={B}, {out['b1_ms'] * 1e3 / N:.2f} us/stage at B=1; "
          f"{riccati_barriers_per_stage(nu, ne)} barriers/stage; ptxas {' | '.join(ptx)}; "
          "shared memory per CTA " + ", ".join(f"{k} {v} B" for k, v in smem.items()))
    return out


def riccati_wide(B: int, N: int, shapes, device, tag: str) -> dict:
    """K2+K3 in float32 at a batch B past the 256-thread build's residency,
    through the wrapper: the launch must take the 128-thread build (one
    more ``wide_launches``), agree with plain at phase 3's bar (1e-3
    relative, on the card in float64), and is timed beside the 256-thread
    build on the same inputs and against its bound."""
    nx, nu, ne = shapes
    resident, sms = riccati_kernel.residency(nx, nu, ne, torch.float32, device)
    require(B > resident[256] * sms, f"B={B} is within the 256-thread build's residency {resident[256]} x {sms}")
    nodes, masks, dx0 = random_lqr(B, N, nx, nu, ne, 9, device, torch.float32)
    regs = _regs(torch.float32)
    before = riccati_kernel.riccati_solve.wide_launches
    got = riccati_kernel.riccati_solve_cuda(nodes, masks, dx0, *regs)
    moved = riccati_kernel.riccati_solve.wide_launches - before
    ref = riccati_plain(nodes, masks, dx0, regs)
    errs = {n: float((g.double() - r.double()).abs().max()) / max(1.0, float(r.double().abs().max()))
            for n, g, r in zip(("K", "k", "dx", "du"), got, ref)}
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    del got, ref
    require(moved == 1, f"B={B} took the 256-thread build (wide_launches moved by {moved}; resident {resident})")
    require(finite and max(errs.values()) <= 1e-3, f"riccati kernel's 128-thread build disagrees at B={B}: {errs}")
    before = riccati_kernel.riccati_solve.wide_launches
    wide_ms = cuda_time_ms(lambda: riccati_kernel.riccati_solve_cuda(nodes, masks, dx0, *regs), 10)
    narrow_ms = cuda_time_ms(lambda: riccati_kernel._launch(nodes, masks, dx0, *regs, 256), 10)
    timed_wide = riccati_kernel.riccati_solve.wide_launches - before
    require(timed_wide == 11, f"the timed wrapper launches took the 256-thread build ({timed_wide} of 11 wide)")
    s = 4
    stage_in = 2 * nx * nx + 2 * nx * nu + nu * nu + ne * nx + ne * nu + 2 * nx + nu + 2 * ne
    stage_out = nu * nx + 2 * nu
    b = bound(s * (B * N * (stage_in + stage_out) + B * nx + B * (N + 1) * nx), k23_ops(B, N, nx, nu, ne))
    res = {"batch": B, "resident_ctas_per_sm": resident, "sm_count": sms, "max_rel_err": max(errs.values()),
           "ms": wide_ms, "ms_256t": narrow_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
           "roofline_pct": 100.0 * b["bound_ms"] / wide_ms, "wide_launches": moved + timed_wide}
    print(f"[{tag}] float32 B={B} N={N} (past the 256-thread build's {resident[256]} x {sms} resident; "
          f"128-thread build {resident[128]} CTAs per SM): max rel err " + " ".join(f"{n} {v:.2e}" for n, v in errs.items())
          + f" (bar 1e-3); 128-thread build {wide_ms:.3f} ms ({res['roofline_pct']:.1f}% of its bound "
          f"{b['bound_ms']:.4f} ms, {b['bound_by']}), 256-thread build {narrow_ms:.3f} ms; "
          f"wide_launches {res['wide_launches']}")
    return res


def merit_instances(info, M: int, seed: int, device, dtype, x_stand=None):
    """M random node instances around the standing state x_stand (H1's
    standing_state when None), all four contact modes."""
    rng = np.random.default_rng(seed)
    nx, nu = info.state_dim, info.input_dim
    x_stand = standing_state(info.nj) if x_stand is None else np.asarray(x_stand)
    x = x_stand[None] + rng.normal(scale=0.05, size=(M, nx))
    modes = rng.integers(0, 4, size=M)  # FLY / LF / RF / STANCE
    flags = np.stack([(modes & 1) > 0, (modes & 1) > 0, (modes & 2) > 0, (modes & 2) > 0], axis=1).astype(float)
    u = weight_compensating_input(info, torch.as_tensor(flags), nu).numpy() + rng.normal(scale=2.0, size=(M, nu))
    xn = x + rng.normal(scale=0.05, size=(M, nx))
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()
    return (T(x), T(u), T(xn), T(flags), T(rng.normal(scale=0.3, size=(M, 4))),
            T(rng.normal(scale=0.05, size=(M, 4))), T(np.full(M, DT)))


def phase_merit(model, info, device, lib, x_stand=None, tag="4 merit"):
    """K4 vs plain, instances around x_stand (merit_instances).  Relative error per sum is |got - ref| / (|ref| + floor)
    with floor 1e-12 (f64) and 1e-6 (f32): the sums are O(1e-3..1e4)."""
    out = {}
    M = 1 * 256 * N_NODES
    settings = OcpSettings(integrator="rk2", position_error_gain=0.0)
    for dtype, bar, floor in ((torch.float64, 1e-10, 1e-12), (torch.float32, 1e-4, 1e-6)):
        m = model.to(dtype=dtype)
        fn = merit_kernel.make_merit_sums(m, info, settings)
        args = merit_instances(info, M, 3, device, dtype, x_stand)
        got = fn(*args)
        ref = merit_kernel.merit_sums_plain(m, info, settings, *args)
        torch.cuda.synchronize()
        err = float(((got.double() - ref.double()).abs() / (ref.double().abs() + floor)).max())
        print(f"[{tag}] {str(dtype)[6:]} M={M}: max rel err {err:.2e} (bar {bar:g})")
        require(bool(torch.isfinite(got).all()) and err <= bar, f"merit kernel disagrees in {dtype}: {err:.3e}")
        if dtype == torch.float32:
            out["max_abs_err"] = float((got.double() - ref.double()).abs().max())
            out["ms"] = graph_time_ms(lambda: fn(*args), 20)
            out["plain_ms"] = cuda_time_ms(lambda: merit_kernel.merit_sums_plain(m, info, settings, *args), 5)
            args67 = merit_instances(info, N_NODES, 4, device, dtype, x_stand)
            ref67 = merit_kernel.merit_sums_plain(m, info, settings, *args67).double()
            err67 = float(((fn(*args67).double() - ref67).abs() / (ref67.abs() + floor)).max())
            require(err67 <= bar, f"merit kernel disagrees at M={N_NODES}: {err67:.3e}")
            out["ms_m67"] = graph_time_ms(lambda: fn(*args67), 50)
    out["warps_per_sm"] = occupancy(lib.lib, "merit", tag)
    out["registers"] = " | ".join(ptxas_summary(lib.ptxas_report))
    nx, nu = info.state_dim, info.input_dim
    sm = make_static_model(model, info.contact_frame_ids)
    out.update(bound(4 * M * (2 * nx + nu + 12 + 1 + 4), k4_ops(sm, M, True, nx)))
    print(f"[{tag}] float32 M={M}: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.3f} ms, "
          f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}); M={N_NODES}: kernel {out['ms_m67']:.4f} ms "
          f"(max rel err {err67:.2e})")
    return out


def phase_linearize(model, info, device, lib, x_stand=None, weights_np=None, tag="5 linearize"):
    """K1 vs plain (ocp/linearize.py::linearize_node_structured) on B x N
    node instances around x_stand (merit_instances), with the tracking
    weights weights_np = (Q, R) (H1's pattern, weights(), when None).  float64 bar 1e-9 relative to max(1, max|ref|) per
    field, the reference kernel test's bar.  float32 bar 1e-4: both sides
    round every product to 24 bits and sum in different orders, so they
    differ by a few ulps of the largest entries (~1e-6 relative); a wrong
    entry is off by 1e-2 or more."""
    out = {}
    B, N = 256, N_NODES
    nx, nu = info.state_dim, info.input_dim
    defines, _ = circuit_static(model, info)
    launches_before = linearize_kernel.linearize_cuda.launches
    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        m = model.to(dtype=dtype)
        Q, R = (torch.as_tensor(w, dtype=dtype, device=device) for w in (weights_np or weights(nx, nu)))
        x, u, xn, flags, vref, pref, dt = merit_instances(info, B * N, 9, device, dtype, x_stand)
        lead = lambda a: a.reshape((B, N) + a.shape[1:])
        refs = NodeRefs(t=lead(torch.zeros_like(dt)), dt=lead(dt), contact_flags=lead(flags), swing_vref=lead(vref),
                        swing_pref=lead(pref), x_nom=lead(x), u_nom=lead(u))
        xs, us, xns = lead(x), lead(u), lead(xn)
        for integrator in ("rk2", "euler"):
            for gain in (0.0, 0.35):
                settings = OcpSettings(integrator=integrator, position_error_gain=gain, linearize="pallas")
                got = linearize_kernel.make_node_linearizer(m, info, settings, Q, R)(xs, us, xns, refs)
                ref = linearize_node_structured(m, info, settings, Q, R, xs, us, xns, refs)
                torch.cuda.synchronize()
                errs = {f: rel_err(getattr(got, f), getattr(ref, f)) for f in LinearizedNode._fields}
                finite = all(bool(torch.isfinite(t).all()) for t in got)
                print(f"[{tag}] {str(dtype)[6:]} B={B} N={N} {integrator} gain {gain}: max rel err "
                      + " ".join(f"{n} {v:.1e}" for n, v in errs.items()) + f" (bar {bar:g})")
                require(finite and max(errs.values()) <= bar, f"linearize kernel disagrees in {dtype}: {errs}")
                if dtype == torch.float32 and integrator == "rk2" and gain == 0.0:  # the main path's
                    out["max_abs_err"] = max(float((getattr(got, f).double() - getattr(ref, f).double()).abs().max())
                                             for f in ("A", "B", "c", "C", "D", "e"))
        if dtype == torch.float32:
            settings = OcpSettings(integrator="rk2", linearize="pallas")
            params = circuit_static(m, info)[1]
            flat = (x, u, xn, flags, vref, pref, dt)
            out["ms"] = graph_time_ms(lambda: linearize_kernel.linearize_cuda(params, defines, 0.0, "rk2", *flat), 20)
            plain = lambda: linearize_node_structured(m, info, settings, Q, R, xs, us, xns, refs)
            out["plain_ms"] = cuda_time_ms(plain, 3)
            # the B = 1 solve's launch: one scenario's N nodes, held to the same bar
            flat67 = tuple(a[:N] for a in flat)
            got67 = linearize_kernel.linearize_cuda(params, defines, 0.0, "rk2", *flat67)
            ref67 = linearize_node_structured(m, info, settings, Q, R, *(a[:1] for a in (xs, us, xns)), refs._replace(
                **{f: getattr(refs, f)[:1] for f in refs._fields}))
            err67 = max(rel_err(g, getattr(ref67, f).reshape(g.shape)) for g, f in zip(got67, ("A", "B", "c", "C", "D", "e")))
            require(err67 <= bar, f"linearize kernel disagrees at M={N}: {err67:.3e}")
            out["ms_m67"] = graph_time_ms(lambda: linearize_kernel.linearize_cuda(params, defines, 0.0, "rk2", *flat67), 50)
    out["warps_per_sm"] = occupancy(lib.lib, "linearize", tag)
    out["registers"] = " | ".join(ptxas_summary(lib.ptxas_report))
    ne, M = 16, B * N
    sm = make_static_model(model, info.contact_frame_ids)
    out.update(bound(4 * M * ((2 * nx + nu + 13) + nx * nx + nx * nu + nx + ne * nx + ne * nu + ne),
                     k1_ops(sm, M, True, nx, nu, ne)))
    print(f"[{tag}] float32 M={N} rk2: kernel {out['ms_m67']:.4f} ms (max rel err {err67:.2e})")
    print(f"[{tag}] float32 M={M} rk2: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.3f} ms, "
          f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}; {out['bytes'] / 1e6:.1f} MB, "
          f"{out['ops'] / 1e9:.2f} G operations); kernel launches in this phase "
          f"{linearize_kernel.linearize_cuda.launches - launches_before}")
    return out


def stage_kkt(nodes, masks, dtype):
    """The stage-KKT systems of riccati.cu with the Hessian block taken from
    the problem's Quu: [[Quu + r I, D'], [D, -Reg]] | [[Qux, qu], [C, e]],
    flattened to (B N, nu + ne, nu + ne) and (B N, nu + ne, nx + 1)."""
    dual_eps, huu_reg = _regs(dtype)
    nu, ne = nodes.Quu.shape[-1], nodes.D.shape[-2]
    eye = torch.eye(nu, dtype=dtype, device=nodes.Quu.device)
    reg = masks * dual_eps + (1.0 - masks)
    A = torch.cat([torch.cat([nodes.Quu + huu_reg * eye, nodes.D.transpose(-1, -2)], -1),
                   torch.cat([nodes.D, -torch.diag_embed(reg)], -1)], -2)
    B = torch.cat([torch.cat([nodes.Qux, nodes.qu[..., None]], -1), torch.cat([nodes.C, nodes.e[..., None]], -1)], -2)
    return A.reshape(-1, nu + ne, nu + ne).contiguous(), B.reshape(-1, nu + ne, B.shape[-1]).contiguous()


def phase_gauss_jordan(device):
    """K5 vs plain.  float64 bar 1e-10 relative to max(1, max|ref|).  f32
    bar 1e-3, as the Riccati kernel's: the same quasi-definite systems
    (dual_eps 1.2e-5) solved in the same order up to fused multiply-adds
    agree to ~1e-5; a wrong pivot step is off by O(0.1).  Prints K5's
    launch (CTA shape, resident CTAs and warps per SM, registers, spills)."""
    out = {}
    for dtype, bar in ((torch.float64, 1e-10), (torch.float32, 1e-3)):
        nodes, masks, _ = random_lqr(256, N_NODES, 22, 22, 16, 7, device, dtype)
        A, B = stage_kkt(nodes, masks, dtype)
        got = gj_kernel.gauss_jordan_solve_cuda(A, B)
        ref = gauss_jordan_solve(A, B)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        print(f"[6 gauss-jordan] {str(dtype)[6:]} {A.shape[0]} x ({A.shape[1]} x {A.shape[2]} | {B.shape[2]}): "
              f"max rel err {err:.2e} (bar {bar:g})")
        require(bool(torch.isfinite(got).all()) and err <= bar, f"Gauss-Jordan kernel disagrees in {dtype}: {err:.3e}")
        if dtype == torch.float32:
            out["max_abs_err"] = float((got.double() - ref.double()).abs().max())
            out["ms"] = cuda_time_ms(lambda: gj_kernel.gauss_jordan_solve_cuda(A, B), 20)
            out["plain_ms"] = cuda_time_ms(lambda: gauss_jordan_solve(A, B), 5)
            out["library_ms"] = cuda_time_ms(lambda: torch.linalg.solve(A, B), 20)
            batch, n, k = A.shape[0], A.shape[1], B.shape[2]
            A67, B67 = A[:N_NODES].contiguous(), B[:N_NODES].contiguous()
            out["ms_m67"] = graph_time_ms(lambda: gj_kernel.gauss_jordan_solve_cuda(A67, B67), 50)
        out.setdefault("config", {})[str(dtype)[6:]] = k5_config(A.shape[0], A.shape[1], B.shape[2], dtype,
                                                                 "6 gauss-jordan")
    out["warps_per_sm"] = out["config"]["float32"]["warps_per_sm"]
    out.update(bound(4 * batch * (n * n + 2 * n * k), k5_ops(batch, n, k)))
    print(f"[6 gauss-jordan] float32: kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, "
          f"torch.linalg.solve {out['library_ms']:.3f} ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']}); "
          f"{N_NODES} systems: kernel {out['ms_m67']:.4f} ms")
    return out


def solver_inputs(model, info, settings, B: int, seed: int, device, dtype):
    nx, nu = info.state_dim, info.input_dim
    refs_np, t_nodes, x_init = trot_refs(info, nx, B, seed)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device).contiguous()
    flags = T(refs_np["contact_flags"])
    refs = NodeRefs(**{k: T(v) for k, v in refs_np.items()}, u_nom=weight_compensating_input(info, flags, nu))
    xs, us = initial_trajectory(info, refs, T(x_init), settings.num_intervals + 1)
    return refs, T(t_nodes), T(x_init), xs, us


def main_settings(config: str) -> OcpSettings:
    linearize, riccati, merit = CONFIGS[config]
    return OcpSettings(
        dt=DT, horizon=N_NODES * DT, sqp_iterations=1, linesearch_alphas=(1.0,), cone="soft",
        integrator="rk2", linearize=linearize, riccati=riccati, merit=merit,
    )


# the reference's batched-parity bars (tests/test_lanes_rti.py)
PARITY_BARS = {"x_traj": 1e-5, "u_traj": 1e-5, "K": 1e-3, "cost": 1e-5, "defect_norm": 1e-5, "eq_norm": 1e-5}


def solution_errors(a, b) -> dict:
    return {n: rel_err(getattr(a, n), getattr(b, n)) for n in PARITY_BARS}


def phase_parity(model, info, device):
    """The production configuration (K1, K2+K3, K4) in float64 at B=8 vs
    the all-plain configuration, at the bars of the reference's
    batched-parity test (x/u/cost/defect/eq 1e-5, K 1e-3, step_size exact)."""
    nx, nu = info.state_dim, info.input_dim
    Q, R = weights(nx, nu)
    sols = {}
    for config in ("production", "plain"):
        settings = main_settings(config)
        solver = make_batched_solver(model, info, settings, Q, R).to(dtype=torch.float64)
        sols[config] = solver(*solver_inputs(model, info, settings, 8, 11, device, torch.float64))
    torch.cuda.synchronize()
    a, b = sols["production"], sols["plain"]
    errs = solution_errors(a, b)
    same_step = bool(torch.equal(a.step_size, b.step_size))
    print("[7 parity] float64 B=8 production vs plain: " + " ".join(f"{n} {v:.2e}" for n, v in errs.items())
          + f" step_size equal {same_step} ({a.step_size.tolist()})")
    require(all(errs[n] <= PARITY_BARS[n] for n in PARITY_BARS) and same_step, f"production f64 parity failed: {errs}")


def phase_main(model, info, device):
    """The batched solve at B=256 in float32, three configurations in turns
    (production, structured, plain, then plain, structured, production):
    per run 3 warm-up solves, then 10 warm-chained solves timed with CUDA
    events (device time per solve) and with the host clock without a
    synchronise (enqueue time per solve).  Launch counts are set to 0
    just before the 10 solves and read just after."""
    nx, nu = info.state_dim, info.input_dim
    Q, R = weights(nx, nu)
    B, warm, steps = 256, 3, 10
    solvers = {c: make_batched_solver(model, info, main_settings(c), Q, R).to(dtype=torch.float32) for c in CONFIGS}
    runs = []
    for config in ("production", "structured", "plain", "plain", "structured", "production"):
        solver = solvers[config]
        refs, t_nodes, x_init, xs, us = solver_inputs(model, info, main_settings(config), B, 5, device, torch.float32)
        for _ in range(warm):
            sol = solver(refs, t_nodes, x_init, xs, us)
            xs, us = sol.x_traj, sol.u_traj
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reset_launches()
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            sol = solver(refs, t_nodes, x_init, xs, us)
            xs, us = sol.x_traj, sol.u_traj
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        torch.cuda.synchronize()
        counts = read_launches()
        ms = start.elapsed_time(end) / steps
        finite = all(bool(torch.isfinite(getattr(sol, f)).all()) for f in ("x_traj", "u_traj", "K", "cost", "defect_norm", "eq_norm"))
        require(finite, f"{config}: non-finite solver output")
        require(tuple(sol.x_traj.shape) == (B, N_NODES + 1, nx) and tuple(sol.K.shape) == (B, N_NODES, nu, nx),
                f"{config}: unexpected output shapes")
        run = {"config": config, "ms_per_solve": ms, "solves_per_s": B * 1000.0 / ms, "host_enqueue_ms": host_ms,
               "defect_l1": float(sol.defect_norm.double().mean()),
               "last_step_accepted": float((sol.step_size > 0).double().mean()), "launches": counts}
        runs.append(run)
        print(f"[8 main] float32 B={B} {config} {CONFIGS[config]}: {run['solves_per_s']:.1f} solves/s "
              f"({ms:.3f} ms/solve on CUDA events, host enqueue {host_ms:.3f} ms/solve); defect_l1 mean "
              f"{run['defect_l1']:.4e}; share of scenarios whose last step was accepted "
              f"{run['last_step_accepted']:.3f}; launches {counts}")
        if config == "production":
            require(counts["linearize"] > 0 and counts["riccati"] > 0 and counts["merit"] > 0,
                    f"a kernel of the production path was not launched: {counts}")
    plain = [r["defect_l1"] for r in runs if r["config"] == "plain"]
    for r in runs:
        if r["config"] == "production":
            require(abs(r["defect_l1"] - plain[0]) <= 0.1 * plain[0],
                    f"production defect_l1 {r['defect_l1']:.4e} not within 10% of plain {plain[0]:.4e}")
    return runs


def phase_single(model, info, device):
    """The single solve: sqp_solve at B=1 with every kernel (K1, K2+K3, K4),
    its linearizer and merit evaluator built once; 3 warm-up and 10
    warm-chained solves under CUDA events.  Informational: no bar."""
    nx, nu = info.state_dim, info.input_dim
    settings = main_settings("production")
    m = model.to(dtype=torch.float32)
    Q, R = (torch.as_tensor(w, dtype=torch.float32, device=device) for w in weights(nx, nu))
    static = circuit_static(m, info)
    linearize = linearize_kernel.make_node_linearizer(m, info, settings, Q, R, static=static)
    merit = merit_kernel.make_merit_sums(m, info, settings, static=static)
    refs, t_nodes, x_init, xs, us = solver_inputs(model, info, settings, 1, 13, device, torch.float32)
    solve = lambda xs, us: sqp_solve(m, info, settings, Q, R, refs, t_nodes, x_init, xs, us,
                                     merit_sums=merit, linearize=linearize)
    for _ in range(3):
        sol = solve(xs, us)
        xs, us = sol.x_traj, sol.u_traj
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reset_launches()
    t0 = time.perf_counter()
    start.record()
    for _ in range(10):
        sol = solve(xs, us)
        xs, us = sol.x_traj, sol.u_traj
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    torch.cuda.synchronize()
    counts = read_launches()
    ms = start.elapsed_time(end) / 10
    require(all(bool(torch.isfinite(t).all()) for t in (sol.x_traj, sol.u_traj, sol.K)), "B=1: non-finite output")
    require(counts["linearize"] > 0, f"B=1: the linearize kernel was not launched: {counts}")
    print(f"[9 single] float32 B=1 sqp_solve, every kernel: {ms:.3f} ms/solve on CUDA events, host enqueue "
          f"{host_ms:.3f} ms/solve; launches {counts}")
    return {"ms_per_solve": ms, "host_enqueue_ms": host_ms, "launches": counts}


def phase_profile(model, info, device):
    """torch.profiler over 3 warm-chained B=256 float32 solves after 3
    warm-up solves, for the production and "structured" configurations:
    wall time per solve (host clock, ending in a synchronise), device busy
    time per solve (union of the kernel intervals), the busy share of the
    kernels' span, device time per solve by kernel, and the host's calls
    that wait for the device or copy (cudaStreamSynchronize,
    cudaDeviceSynchronize, cudaMemcpyAsync) per solve."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    nx, nu = info.state_dim, info.input_dim
    Q, R = weights(nx, nu)
    B, reps = 256, 3
    for config in ("production", "structured"):
        solver = make_batched_solver(model, info, main_settings(config), Q, R).to(dtype=torch.float32)
        refs, t_nodes, x_init, xs, us = solver_inputs(model, info, main_settings(config), B, 5, device, torch.float32)
        for _ in range(3):
            sol = solver(refs, t_nodes, x_init, xs, us)
            xs, us = sol.x_traj, sol.u_traj
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                sol = solver(refs, t_nodes, x_init, xs, us)
                xs, us = sol.x_traj, sol.u_traj
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        events = prof.events()
        spans = sorted((e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CUDA)
        require(len(spans) > 0, "the profiler recorded no device activity")
        busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s0, e0 in spans[1:]:
            if s0 > cur_e:
                busy, cur_s = busy + cur_e - cur_s, s0
            cur_e = max(cur_e, e0)
        busy += cur_e - cur_s
        span = spans[-1][1] - spans[0][0]
        by_name = {}
        for e in events:
            if e.device_type == DeviceType.CUDA:
                key = e.name[:48]
                by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        host = {}
        for e in events:
            if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync"):
                n, t = host.get(e.name, (0, 0.0))
                host[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start) / 1e3)
        print(f"[profile] float32 B={B} {config}: wall {wall:.3f} ms/solve, device busy {busy / 1e3 / reps:.3f} "
              f"ms/solve, busy share {busy / span:.3f} of the kernels' span ({span / 1e3 / reps:.3f} ms/solve), "
              f"{len(spans) / reps:.0f} device activities/solve")
        print(f"[profile] {config} device ms/solve by kernel: " + "; ".join(f"{k} {v:.3f}" for k, v in top))
        print(f"[profile] {config} host runtime calls per solve: "
              + "; ".join(f"{k} {n / reps:.1f} x, {t / reps:.3f} ms" for k, (n, t) in sorted(host.items())))


# ------------------------------------------------------------------ G1 front end
def g1_urdf() -> tuple[str, str]:
    """(URDF, description) of G1: its own URDF when $BIPEDAL_ASSETS holds
    it, else the synthetic G1-shaped biped of tests/data."""
    urdf = get_assets("g1").urdf
    if os.environ.get("BIPEDAL_ASSETS") and os.path.exists(urdf):
        return urdf, f"unitree G1 ({urdf})"
    return G1_SHAPED_URDF, "G1-shaped synthetic biped (G1 URDF not in $BIPEDAL_ASSETS)"


def load_g1(device, dtype=torch.float64):
    """make_interface on G1's configuration (configs/g1/* with
    overrides.info) and g1_urdf()'s URDF."""
    g1 = get_assets("g1")
    urdf, robot = g1_urdf()
    iface = make_interface(urdf, g1.task_info, g1.reference_info, g1.gait_info, g1.overrides_info,
                           device=device, dtype=dtype)
    iface.settings = g1_settings(iface.settings, "production")
    return iface, robot


def g1_settings(settings, config: str) -> OcpSettings:
    """bench.py's replacements (bench.py:210-217): one SQP iteration, the
    single candidate alpha = 1, and the configuration's backends."""
    linearize, riccati, merit = CONFIGS[config]
    return dataclasses.replace(settings, sqp_iterations=1, linesearch_alphas=(1.0,), linearize=linearize,
                               riccati=riccati, merit=merit)


def g1_front_end(iface, B: int, seed: int):
    """bench.py:205-247 on the port: trot from 0.1 s, freeze at 0, build_refs,
    initial_trajectory, then every input tiled over B scenarios (x_init
    perturbed per scenario from a seed, except at B = 256, as bench.py)."""
    rm = iface.make_reference_manager()
    rm.set_gait(iface.task.gait_library["trot"], 0.1)
    frozen = rm.freeze(0.0)
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, frozen.t_nodes)
    x0 = torch.as_tensor(iface.initial_state, dtype=iface.dtype, device=iface.device)
    xs, us = initial_trajectory(iface.info, refs, x0[None], iface.settings.num_intervals + 1)
    tile = lambda a: a.expand((B,) + a.shape[1:]).contiguous()
    x_b = x0[None].expand(B, -1).clone()
    if seed is not None:
        noise = np.random.default_rng(seed).normal(scale=0.005, size=tuple(x_b.shape))
        x_b += torch.as_tensor(noise, dtype=x_b.dtype, device=x_b.device)
    return NodeRefs(*(tile(f) for f in refs)), tile(frozen.t_nodes[None]), x_b, tile(xs), tile(us)


def phase_g1(device, libs, iface, robot):
    """Phase 10: the front end at G1's widths.  K1, K2+K3 and K4 against
    their plain versions at G1's shapes; the production solve against the
    all-plain one in float64 at B = 8; the front end's batched solve at
    B = 256 in float32, timed."""
    info, model = iface.info, iface.model
    nx, nu = info.state_dim, info.input_dim
    print(f"[10 g1] {robot}: nj={info.nj} nx={nx} nu={nu} mass={info.robot_mass:.3f} kg, "
          f"N={iface.settings.num_intervals}, dt={iface.settings.dt}, group width "
          f"{circuit_static(model, info)[0]['GROUP']} lanes")
    x_stand = iface.initial_state
    wts = (iface.Q.cpu().numpy(), iface.R.cpu().numpy())
    out = {"riccati": phase_riccati(device, libs["riccati_g1"], (nx, nu, 16), "10 g1 riccati", wide_batch=4096),
           "merit": phase_merit(model, info, device, libs["merit_g1"], x_stand, "10 g1 merit"),
           "linearize": phase_linearize(model, info, device, libs["linearize_g1"], x_stand, wts, "10 g1 linearize")}
    # float64 B=8: production vs all plain, from the front end's references
    sols = {}
    for config in ("production", "plain"):
        settings = g1_settings(iface.settings, config)
        solver = make_batched_solver(model, info, settings, *wts)
        sols[config] = solver(*g1_front_end(dataclasses.replace(iface, settings=settings), 8, 21))
    torch.cuda.synchronize()
    errs = solution_errors(sols["production"], sols["plain"])
    same_step = bool(torch.equal(sols["production"].step_size, sols["plain"].step_size))
    print("[10 g1] float64 B=8 production vs plain: " + " ".join(f"{n} {v:.2e}" for n, v in errs.items())
          + f" step_size equal {same_step} ({sols['production'].step_size.tolist()})")
    require(all(errs[n] <= PARITY_BARS[n] for n in PARITY_BARS) and same_step, f"G1 f64 parity failed: {errs}")
    # float32 B=256: the front end's batched solve, 3 warm-up + 10 warm-chained
    B, steps = 256, 10
    iface32 = iface.to(dtype=torch.float32)
    solver = make_batched_solver(model, info, iface.settings, *wts).to(dtype=torch.float32)
    refs, t_b, x_b, xs, us = g1_front_end(iface32, B, None)
    for _ in range(3):
        sol = solver(refs, t_b, x_b, xs, us)
        xs, us = sol.x_traj, sol.u_traj
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reset_launches()
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        sol = solver(refs, t_b, x_b, xs, us)
        xs, us = sol.x_traj, sol.u_traj
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    counts = read_launches()
    ms = start.elapsed_time(end) / steps
    require(all(bool(torch.isfinite(getattr(sol, f)).all()) for f in ("x_traj", "u_traj", "K", "defect_norm")),
            "G1 B=256: non-finite solver output")
    require(tuple(sol.x_traj.shape) == (B, iface.settings.num_intervals + 1, nx), "G1 B=256: unexpected shape")
    require(counts["linearize"] > 0 and counts["riccati"] > 0 and counts["merit"] > 0,
            f"G1 B=256: a kernel of the production path was not launched: {counts}")
    out["main"] = {"solves_per_s": B * 1000.0 / ms, "ms_per_solve": ms, "host_enqueue_ms": host_ms,
                   "defect_l1": float(sol.defect_norm.double().mean()), "launches": counts}
    print(f"[10 g1] float32 B={B} production from the front end's references: {B * 1000.0 / ms:.1f} solves/s "
          f"({ms:.3f} ms/solve on CUDA events, host enqueue {host_ms:.3f} ms/solve); defect_l1 mean "
          f"{out['main']['defect_l1']:.4e}; launches {counts}")
    return out


# the model kernels' names in csrc/, as the profiler's kernel events show them
KERNEL_NAMES = {"linearize": "linearize_kernel", "riccati": "riccati_kernel", "merit": "merit_kernel",
                "gauss_jordan": "gj_kernel"}


def trace(fn, cpu: bool = True):
    """(the device's activities, the host's synchronising calls) of one
    call of fn under torch.profiler: the kernels, copies and fills the
    device ran (events), and the host's cudaStreamSynchronize and
    synchronous cudaMemcpy calls (the profiler's own closing
    cudaDeviceSynchronize is not counted).  cpu=False traces the device's
    activities only (a long window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    syncs = sum(1 for e in events if e.name in ("cudaStreamSynchronize", "cudaMemcpy"))
    return [e for e in events if e.device_type == DeviceType.CUDA], syncs


def kernel_runs(device_events) -> dict:
    """How many times the device ran K1, K2+K3, K4 and K5, read from the
    kernel events' names, so the kernels a CUDA graph's replay ran count
    too."""
    return {k: sum(1 for e in device_events if re.search(rf"\b{n}\b", e.name)) for k, n in KERNEL_NAMES.items()}


def profile_counts(fn, cpu: bool = True) -> tuple[int, int, dict]:
    """(device activities, host synchronisations, kernel runs) of one call
    of fn (:func:`trace`, :func:`kernel_runs`)."""
    device, syncs = trace(fn, cpu)
    return len(device), syncs, kernel_runs(device)


def count_device_activities(fn) -> int:
    """Kernels, copies and fills the device ran for one call of fn."""
    return profile_counts(fn)[0]


def require_runs(ran: dict, replans: int, what: str) -> None:
    """Raise unless the device ran K1, K2+K3 and K4 once per replan."""
    require(all(ran[k] == replans for k in ("linearize", "riccati", "merit")),
            f"{what}: each of {replans} replans must run K1, K2+K3 and K4 once on the device; the profiler "
            f"saw {ran}")


def phase_loop(device, iface):
    """Phase 11: MpcRunner (production settings, float32) inside
    run_dummy_loop, 1.0 s at 400 Hz MRT and 50 Hz MPC, trot from 0.1 s,
    held to tests/test_dummy_loop.py's checks at G1's comHeight; then five
    warm replans under the profiler, each of which must run K1, K2+K3 and K4
    once on the device (the loop's replans after each kind's first replay
    CUDA graphs, which no wrapper counts); then four replans in float64
    (cold, warm, two warm replays), production against plain."""
    iface32 = iface.to(dtype=torch.float32)
    mpc = MpcRunner(iface32)
    mpc.rm.set_gait(iface32.task.gait_library["trot"], 0.1)
    advance, timed = mpc.advance, []

    def timed_advance(t, x):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        sol = advance(t, x)
        ev[1].record()
        timed.append((ev, time.perf_counter() - t0))
        return sol

    mpc.advance = timed_advance
    reset_launches()
    t0 = time.perf_counter()
    res = run_dummy_loop(iface32, mpc, iface32.initial_state, duration=1.0, mrt_frequency=400.0, mpc_frequency=50.0)
    wall = time.perf_counter() - t0
    counts = read_launches()
    n = res.mpc_stats["count"]
    replan_ms = np.array([a.elapsed_time(b) for (a, b), _ in timed])
    host_ms = np.array([h for _, h in timed]) * 1e3
    tick_ms = (wall * 1e3 - host_ms.sum()) / len(res.times)
    base = res.states[:, 6:12]
    com_height = iface32.task.com_height
    health = {"finite": bool(np.all(np.isfinite(res.states))),
              "max |z - comHeight|": float(np.abs(base[:, 2] - com_height).max()),
              "max |roll|,|pitch|": float(np.abs(base[:, 4:]).max()),
              "max |normalised momentum|": float(np.abs(res.states[:, 0:6]).max()), "replans": n}
    print(f"[11 loop] float32 1.0 s at 400 Hz MRT / 50 Hz MPC, trot from 0.1 s: {health}; final base "
          f"{np.round(base[-1], 4).tolist()}")
    require(health["finite"], "dummy loop: non-finite state")
    require(health["max |z - comHeight|"] <= 0.05, f"dummy loop: base z left comHeight {com_height} +- 0.05")
    require(health["max |roll|,|pitch|"] < 0.15, "dummy loop: roll/pitch beyond 0.15 rad")
    require(health["max |normalised momentum|"] < 1.0, "dummy loop: normalised momentum beyond 1")
    require(n >= 40, f"dummy loop: {n} replans (at least 40)")
    require(all(counts[k] >= 1 for k in ("linearize", "riccati", "merit")),
            f"dummy loop: a kernel's wrapper launched it no time in {n} replans: {counts}")
    x_last = torch.as_tensor(res.states[-1], device=device)
    prev = mpc.last_solution

    def front_end():  # a warm replan's references and warm start, without the solve
        fr = mpc.rm.freeze(1.0)
        build_refs(iface32.info, fr.gait, fr.swing, fr.target, fr.t_nodes)
        warm_start_trajectories(prev.t_nodes, prev.x_traj, prev.u_traj, fr.t_nodes[None])

    activities, _, ran = profile_counts(lambda: [mpc.advance(1.0 + 0.02 * i, x_last) for i in range(5)])
    require_runs(ran, 5, "dummy loop's runner, 5 warm replans")
    activities /= 5
    front = count_device_activities(front_end)
    flow = count_device_activities(lambda: centroidal_flow_map(iface32.model, iface32.info, x_last, prev.u_traj[0, 0]))
    out = {"replans": n, "replan_p50_ms": float(np.percentile(replan_ms, 50)),
           "replan_p99_ms": float(np.percentile(replan_ms, 99)), "host_ms_per_replan": float(host_ms.mean()),
           "mrt_tick_ms": float(tick_ms), "device_activities_per_replan": activities,
           "device_activities_front_end": front, "device_activities_per_flow_map": flow,
           "wrapper_launches_in_loop": counts, "kernel_runs_per_warm_replan": {k: v / 5 for k, v in ran.items()}}
    print(f"[11 loop] replan on CUDA events p50 {out['replan_p50_ms']:.3f} ms, p99 {out['replan_p99_ms']:.3f} ms "
          f"(first, cold: {replan_ms[0]:.3f} ms); host {out['host_ms_per_replan']:.3f} ms per replan (ends in a "
          f"synchronise); MRT tick {tick_ms:.3f} ms (policy + RK4 step); device activities (kernels, copies, "
          f"fills) per warm replan {activities:g}, of them {front} in the front end (freeze, build_refs, warm "
          f"start); {flow} per flow-map evaluation (the RK4 step runs four); kernel runs per warm replan (profiler) "
          f"{out['kernel_runs_per_warm_replan']}; the wrappers' own launches in the loop {counts} (each kind's "
          f"first replan; later ones replay its graph)")
    # float64: a cold, a warm and two replayed warm replans, production vs plain
    rng = np.random.default_rng(31)
    x0 = iface.initial_state
    times = (0.0, 0.02, 0.04, 0.06)
    xs = [x0 + rng.normal(scale=0.005, size=x0.shape) for _ in times]
    sols = {}
    for config in ("production", "plain"):
        runner = MpcRunner(dataclasses.replace(iface, settings=g1_settings(iface.settings, config)))
        require(runner.graphed == (config == "production"), f"{config} runner: graphed {runner.graphed}")
        runner.rm.set_gait(iface.task.gait_library["trot"], 0.1)
        sols[config] = [runner.advance(t, torch.as_tensor(x, device=device)) for t, x in zip(times, xs)]
    for k, what in enumerate(("cold", "warm", "warm (graph replay)", "warm (graph replay)")):
        a, b = sols["production"][k], sols["plain"][k]
        errs = solution_errors(a, b)
        same_step = bool(torch.equal(a.step_size, b.step_size))
        print(f"[11 loop] float64 {what} replan production vs plain: "
              + " ".join(f"{n} {v:.2e}" for n, v in errs.items()) + f" step_size equal {same_step}")
        require(all(errs[n] <= PARITY_BARS[n] for n in PARITY_BARS) and same_step,
                f"G1 f64 {what} replan parity failed: {errs}")
    return out


# ------------------------------------------------------------------ controller
TICK_S = 0.0025  # the 400 Hz control tick


def standing_rbd(iface) -> np.ndarray:
    """rbdState of the interface's initial state at rest
    (tests/test_commands.py:97)."""
    x0 = np.asarray(iface.initial_state)
    return np.concatenate([x0[9:12], x0[6:9], x0[12:], np.zeros(6 + iface.info.nj)])


class Replay:
    """Kinematic replay plant (the port has no simulator on the host): the
    first measurement is the standing rbd state; every later one is the rbd
    state of the policy point (x_star, u_fb) the controller tracked on its
    previous tick, computed on the host in float64, so the plant launches
    nothing on the card.  The conversion's generalized velocity is the
    desired side of the C++ host model's WBC kinematics
    (model/native_model.py, an instance of the plant's own), ~0.17 ms with
    the GIL released: the numpy twin (model/host_dynamics.py) takes ~0.5 ms
    of Python per tick, which under the native RtLoop cost phase 12(b) ~50
    of its 400 cycles, and the torch version,
    model/centroidal.py::rbd_state_from_centroidal, ~2-4 ms of torch CPU
    dispatch.  With check=True every measurement is also computed by the
    torch version and the largest difference kept (``check_err``)."""

    def __init__(self, iface, check: bool = False):
        self.model = iface.model.to(device="cpu", dtype=torch.float64)
        self.info = iface.info
        self.nm = NativeHostModel(make_host_model(iface.model, iface.info))
        self.check = check
        self.check_err = 0.0
        self.rbd = standing_rbd(iface)
        self.seconds: list[float] = []  # host time of each conversion

    def measure(self, ctrl) -> np.ndarray:
        if ctrl.last_policy is not None:
            t0 = time.perf_counter()
            x, u = ctrl.last_policy
            v = self.nm.wbc_kinematics(x, u, self.rbd).v_d
            omega = euler_rate_map_zyx_np(x[9:12]) @ v[3:6]
            self.rbd = np.concatenate([x[9:12], x[6:9], x[12:], omega, v[0:3], v[6:]])
            self.seconds.append(time.perf_counter() - t0)
            if self.check:
                ref = rbd_state_from_centroidal(self.model, self.info, torch.from_numpy(x), torch.from_numpy(u))
                self.check_err = max(self.check_err, float(np.abs(self.rbd - ref.numpy()).max()))
        return self.rbd


def trotting_controller(iface, **cfg) -> BipedalController:
    ctrl = BipedalController(iface, ControllerConfig(**cfg))
    ctrl.set_gait(iface.task.gait_library["trot"], 0.1)
    return ctrl


class TorqueReadings:
    """|tau_ff| against the WBC's torque limits over a run's ticks.  The QP
    holds the limits as constraints, which its ADMM (a fixed number of
    iterations, as in the JAX package) meets up to its primal residual: a
    tick's torque may leave them by at most that tick's residual plus 1e-6."""

    def __init__(self, limits):
        self.limits = limits
        self.beyond, self.max_excess, self.max_residual = 0, 0.0, 0.0

    def check(self, cmd, residual: float, what: str) -> None:
        """Raise unless the joint command is finite and its torque within
        the limits plus the tick's primal residual plus 1e-6."""
        require(all(bool(np.all(np.isfinite(c))) for c in cmd), f"{what}: non-finite joint command")
        excess = float(np.max(np.abs(cmd.tau_ff) - self.limits))
        require(excess <= residual + 1e-6, f"{what}: tau_ff {excess:.4f} N m beyond the torque limits, more than "
                f"the QP's primal residual {residual:.4f}")
        self.beyond += excess > 0.0
        self.max_excess = max(self.max_excess, excess)
        self.max_residual = max(self.max_residual, residual)

    def summary(self) -> dict:
        return {"ticks_beyond_limits": self.beyond, "max_excess_nm": self.max_excess,
                "max_primal_residual": self.max_residual}

    def __str__(self) -> str:
        return (f"tau_ff beyond the torque limits on {self.beyond} ticks (max excess {self.max_excess:.4f} N m; "
                f"largest QP primal residual {self.max_residual:.4f})")


def z_offset(rbd) -> float:
    """The replayed base z's distance from G1's comHeight (0.665 m)."""
    return abs(float(rbd[5]) - 0.665)


def percentiles(samples_s) -> dict:
    arr = np.asarray(samples_s) * 1e3
    return {"p50_ms": float(np.percentile(arr, 50)), "p99_ms": float(np.percentile(arr, 99)),
            "max_ms": float(arr.max()), "count": int(arr.size)}


def controller_parity(iface, ticks: int = 20) -> dict:
    """Synchronous controllers on the production and the all-plain
    configuration (iface's dtype and device) driven in lockstep on the same
    replayed measurements (the production controller's replay): the
    largest relative error of pos_des, vel_des and tau_ff over the ticks,
    whether the planned contact flags agreed on every tick, and the device's
    runs of each model kernel over the ticks (profile_counts; only the
    production controller's replans launch them)."""
    ctrls = {c: trotting_controller(dataclasses.replace(iface, settings=g1_settings(iface.settings, c)))
             for c in ("production", "plain")}
    plant = Replay(iface, check=True)
    errs = {"pos_des": 0.0, "vel_des": 0.0, "tau_ff": 0.0}
    flags_equal = []

    def drive():  # starting() runs the first replan
        for ctrl in ctrls.values():
            ctrl.starting(0.0, plant.rbd)
        for k in range(ticks):
            t = k * TICK_S
            rbd = plant.measure(ctrls["production"])
            got, want = (ctrls[c].update(t, rbd) for c in ("production", "plain"))
            for name in errs:
                a, b = getattr(got, name), getattr(want, name)
                errs[name] = max(errs[name], float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max())))
            t_q = torch.full((1,), t, dtype=iface.dtype, device=iface.device)
            flags = [ctrls[c].mpc.last_frozen.gait.contact_flags_at(t_q) for c in ("production", "plain")]
            flags_equal.append(bool(torch.equal(*flags)))

    _, _, ran = profile_counts(drive, cpu=False)
    return {"errors": errs, "flags_equal": all(flags_equal), "replay_check_err": plant.check_err,
            "safe": all(c.safe for c in ctrls.values()), "replans": ctrls["production"].mpc.timer.count,
            "kernels": ran}


def sync_run(iface32, torque: TorqueReadings, check_replay: bool):
    """400 synchronous ticks (1.0 s, 50 replans) of a trotting controller on
    the replay, each tick checked: (controller, plant, each replan's CUDA
    events, whether each tick replanned)."""
    ctrl = trotting_controller(iface32)
    advance, replans = ctrl.mpc.advance, []

    def timed_advance(t, x):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        sol = advance(t, x)
        ev[1].record()
        replans.append(ev)
        return sol

    ctrl.mpc.advance = timed_advance
    plant = Replay(iface32, check=check_replay)
    ctrl.starting(0.0, plant.rbd)
    replan_tick, z_dev = [], 0.0
    for k in range(400):
        n = len(replans)
        rbd = plant.measure(ctrl)
        cmd = ctrl.update(k * TICK_S, rbd)
        replan_tick.append(len(replans) > n)
        require(ctrl.safe, f"sync controller: unsafe at tick {k}")
        torque.check(cmd, ctrl.wbc_primal_residual, f"sync tick {k}")
        z_dev = max(z_dev, z_offset(rbd))
    require(z_dev <= 0.02, f"sync controller: replayed base z left 0.665 by {z_dev:.4f} m (bar 0.02)")
    require(plant.check_err <= 1e-10, f"replay: the native conversion is {plant.check_err:.3e} from "
            "rbd_state_from_centroidal (bar 1e-10)")
    require(len(replans) == 50, f"sync controller: {len(replans)} replans (50 expected)")
    return ctrl, plant, replans, np.asarray(replan_tick), z_dev


def rt_loop(iface32, worker: bool):
    """Phase 12(b)'s RtControllerRunner: a trotting async controller on the
    replay, 1.0 s at 400 Hz (priority 0), with its MPC worker running or
    stopped after its first replans.  (controller, runner, the loop's stats
    at the stop, plant, [(command, the tick's QP primal residual)] written
    on the loop's thread after each tick)."""
    ctrl = trotting_controller(iface32, mpc_async=True)
    plant = Replay(iface32)
    ctrl.starting(0.0, plant.rbd)
    if not worker:
        ctrl.async_mpc.stop()
    cmds = []
    runner = RtControllerRunner(ctrl, read=lambda: plant.measure(ctrl),
                                write=lambda cmd: cmds.append((cmd, ctrl.wbc_primal_residual)), frequency_hz=400.0,
                                priority=0)
    try:
        runner.start()
        time.sleep(1.0)
        loop_stats = runner.stats()
    finally:
        runner.stop()
        ctrl.stop()
    require(not runner.failed, f"RtControllerRunner: the tick raised {runner.exception!r}")
    require(ctrl.safe and (not worker or not ctrl.async_mpc.failed), "RtControllerRunner: unsafe or the worker failed")
    return ctrl, runner, loop_stats, plant, cmds


def rt_cycle_parts(runner) -> dict:
    """Percentiles of each part of the runner's cycles and of the cycle
    (read + update + write; the start, the wait before the callback, is
    its own part)."""
    cycle = np.asarray(runner.cycle_seconds)  # (cycles, 4): start, read, update, write
    parts = {name: percentiles(cycle[:, i]) for i, name in enumerate(("start", "read", "update", "write"))}
    parts["cycle"] = percentiles(cycle[:, 1:].sum(axis=1))
    return parts


def phase_controller(device, iface) -> dict:
    """Phase 12: BipedalController on G1 (see the module docstring)."""
    iface32 = iface.to(dtype=torch.float32)
    limits = np.tile(np.asarray(iface.task.wbc.torque_limits, dtype=np.float64), 2)
    out = {}
    # (a) synchronous, 400 ticks and 50 replans, driven twice: under the
    # profiler (device activities only), whose kernel events show what each
    # replan ran on the card, then untraced for the times
    torque = TorqueReadings(limits)
    traced = []
    reset_launches()
    _, _, ran = profile_counts(lambda: traced.append(sync_run(iface32, torque, check_replay=True)), cpu=False)
    counts = read_launches()
    _, plant, replans, _, _ = traced[0]
    n_replans = len(replans)
    require_runs(ran, n_replans, "sync controller")
    require(all(counts[k] >= 1 for k in ("linearize", "riccati", "merit")),
            f"sync controller: a kernel's wrapper launched it no time in {n_replans} replans: {counts}")
    check_err = plant.check_err
    ctrl, plant, replans, flag, z_dev = sync_run(iface32, torque, check_replay=False)
    torch.cuda.synchronize()
    replan_ms = [a.elapsed_time(b) for a, b in replans]
    ticks = np.asarray(ctrl.tick_timer.samples)
    rep = ctrl.report()
    # a replan tick (t = 1.0), then 5 ticks without one, profiled together
    ctrl.update(1.0, plant.measure(ctrl))
    quiet = lambda: [ctrl.update(1.0 + i * TICK_S, plant.measure(ctrl)) for i in range(1, 6)]
    activities, syncs, _ = profile_counts(quiet)
    replan_activities, replan_syncs, _ = profile_counts(lambda: ctrl.update(1.02, plant.measure(ctrl)))
    out["sync"] = {"ticks": int(ticks.size), "replans": n_replans, "tick_no_replan": percentiles(ticks[~flag]),
                   "tick_replan": percentiles(ticks[flag]), "wbc": percentiles(ctrl.wbc_timer.samples),
                   "tick_ex_wbc": percentiles(ctrl.tick_ex_timer.samples),
                   "replan_cuda_events": percentiles(np.asarray(replan_ms) / 1e3),
                   "device_activities_per_tick_no_replan": activities / 5, "host_syncs_per_tick_no_replan": syncs / 5,
                   "device_activities_replan_tick": replan_activities, "host_syncs_replan_tick": replan_syncs,
                   "max |replayed z - 0.665|": z_dev, "kernel_runs_per_replan": {k: v / n_replans for k, v in ran.items()},
                   "wrapper_launches": counts, "backends": ctrl.backends, "mpc_timer": rep["mpc"],
                   "torque": torque.summary(), "replay_native_vs_torch_max_abs": check_err}
    s = out["sync"]
    print(f"[12 controller] sync float32, 400 ticks, {n_replans} replans, backends {ctrl.backends}: the device ran "
          f"{ran} (profiler) in the traced run, the wrappers launched {counts} (each kind's first replan; the "
          f"others replay its CUDA graph); the untraced run: tick without "
          f"replan p50 {s['tick_no_replan']['p50_ms']:.3f} / p99 {s['tick_no_replan']['p99_ms']:.3f} ms, with "
          f"replan p50 {s['tick_replan']['p50_ms']:.3f} / p99 {s['tick_replan']['p99_ms']:.3f} ms; wbc p50 "
          f"{s['wbc']['p50_ms']:.3f} / p99 {s['wbc']['p99_ms']:.3f} ms; tick_ex_wbc p50 {s['tick_ex_wbc']['p50_ms']:.3f}"
          f" / p99 {s['tick_ex_wbc']['p99_ms']:.3f} ms; replan on CUDA events p50 "
          f"{s['replan_cuda_events']['p50_ms']:.3f} / p99 {s['replan_cuda_events']['p99_ms']:.3f} ms; per tick "
          f"without replan {activities / 5:g} device activities, {syncs / 5:g} host syncs (replan tick "
          f"{replan_activities}, {replan_syncs}); max |replayed z - 0.665| {z_dev:.4f} m; both runs: {torque}; "
          f"replay (native) vs rbd_state_from_centroidal max abs {check_err:.2e}")
    # (b) asynchronous: plain Python on a 2.5 ms wall grid, then the paused
    # window, then the native RtLoop
    ctrl = trotting_controller(iface32, mpc_async=True)
    plant = Replay(iface32)
    torque = TorqueReadings(limits)
    ctrl.starting(0.0, plant.rbd)
    try:
        t0, z_dev = time.perf_counter(), 0.0
        for k in range(400):
            wait = t0 + k * TICK_S - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            rbd = plant.measure(ctrl)
            cmd = ctrl.update(k * TICK_S, rbd)
            require(ctrl.safe and not ctrl.async_mpc.failed, f"async controller: unsafe or worker failed at tick {k}")
            torque.check(cmd, ctrl.wbc_primal_residual, f"async tick {k}")
            z_dev = max(z_dev, z_offset(rbd))
        wall = time.perf_counter() - t0
        rep = ctrl.report()
        require(rep["mpc_solves"] >= 40, f"async controller: {rep['mpc_solves']} replans published (at least 40)")
        ctrl.async_mpc.stop()  # the tick thread alone under the profiler
        paused = lambda: [ctrl.update(1.0 + i * TICK_S, plant.measure(ctrl)) for i in range(40)]
        activities, syncs, _ = profile_counts(paused)
        require(activities == 0, f"async controller: {activities} device activities in 40 ticks (0 allowed)")
        require(ctrl.safe, "async controller: unsafe in the paused window")
    finally:
        ctrl.stop()
    out["async"] = {"wall_s": wall, "tick": rep["tick"], "tick_ex_wbc": rep["tick_ex_wbc"], "wbc": rep["wbc"],
                    "policy_staleness_s": rep["policy_staleness_s"], "worker_solve": rep["mpc"],
                    "replans_published": rep["mpc_solves"], "device_activities_40_paused_ticks": activities,
                    "host_syncs_40_paused_ticks": syncs, "max |replayed z - 0.665|": z_dev,
                    "replay_plant": percentiles(plant.seconds), "torque": torque.summary()}
    a = out["async"]
    print(f"[12 controller] async float32, 400 ticks paced to 2.5 ms ({wall:.3f} s): tick p50 "
          f"{a['tick']['p50_ms']:.3f} / p99 {a['tick']['p99_ms']:.3f} / max {a['tick']['max_ms']:.3f} ms; staleness "
          f"p50 {a['policy_staleness_s']['p50'] * 1e3:.2f} / p99 {a['policy_staleness_s']['p99'] * 1e3:.2f} / max "
          f"{a['policy_staleness_s']['max'] * 1e3:.2f} ms; worker solve p50 {a['worker_solve']['p50_ms']:.3f} / p99 "
          f"{a['worker_solve']['p99_ms']:.3f} ms; {a['replans_published']} replans published; paused worker: "
          f"{activities} device activities in 40 ticks; max |replayed z - 0.665| {z_dev:.4f} m; replay plant p50 "
          f"{a['replay_plant']['p50_ms']:.3f} ms per tick (outside the tick's time); {torque}")
    ctrl, runner, loop_stats, plant, cmds = rt_loop(iface32, worker=True)
    parts = rt_cycle_parts(runner)
    torque = TorqueReadings(limits)
    rep = ctrl.report()
    out["rt_loop"] = {"loop": loop_stats, "ticks_written": len(cmds), "tick": rep["tick"],
                      "policy_staleness_s": rep["policy_staleness_s"], "worker_solve": rep["mpc"],
                      "replans_published": rep["mpc_solves"], "replay_plant": percentiles(plant.seconds),
                      "cycle_parts": parts}
    r = out["rt_loop"]
    # the same loop with the worker stopped after its first replans: what the worker's host code costs the cycle
    _, alone, alone_stats, _, alone_cmds = rt_loop(iface32, worker=False)
    r["worker_stopped"] = {"loop": alone_stats, "ticks_written": len(alone_cmds), "cycle_parts": rt_cycle_parts(alone)}
    fmt = lambda ps: "; ".join(f"{k} {v['p50_ms']:.3f} / {v['p99_ms']:.3f} / {v['max_ms']:.3f}" for k, v in ps.items())
    print(f"[12 controller] RtControllerRunner 400 Hz, priority 0, 1.0 s: {loop_stats['cycles']} cycles (a cycle is "
          f"the replay plant's read, the tick and the write, after its start: the loop thread's wake-up and its "
          f"wait for the GIL; at least 300), {loop_stats['overruns']} overruns, max cycle "
          f"{loop_stats['max_cycle_ns'] / 1e6:.3f} ms; per cycle (ms p50 / p99 / max) {fmt(parts)}; tick (update's "
          f"timer) p50 {r['tick']['p50_ms']:.3f} / p99 {r['tick']['p99_ms']:.3f} ms; replay plant "
          f"p50 {r['replay_plant']['p50_ms']:.3f} / p99 {r['replay_plant']['p99_ms']:.3f} ms; "
          f"staleness p50 {r['policy_staleness_s']['p50'] * 1e3:.2f} / p99 {r['policy_staleness_s']['p99'] * 1e3:.2f} "
          f"ms; worker solve p50 {r['worker_solve']['p50_ms']:.3f} ms; {r['replans_published']} replans published")
    print(f"[12 controller] RtControllerRunner with the MPC worker stopped (no bar; the difference is the worker's "
          f"share): {alone_stats['cycles']} cycles, {alone_stats['overruns']} overruns; per cycle "
          f"(ms p50 / p99 / max) {fmt(r['worker_stopped']['cycle_parts'])}")
    require(len(cmds) >= 300, f"RtControllerRunner: {len(cmds)} ticks in 1.0 s at 400 Hz (at least 300)")
    require(ctrl.async_mpc.solve_count >= 40,
            f"RtControllerRunner: {ctrl.async_mpc.solve_count} replans published (at least 40)")
    for k, (cmd, residual) in enumerate(cmds):
        torque.check(cmd, residual, f"rt tick {k}")
    r["torque"] = torque.summary()
    print(f"[12 controller] RtControllerRunner: {torque}")
    # (c) float64 parity, production against plain
    par = controller_parity(iface)
    print(f"[12 controller] float64 20 sync ticks production vs plain: "
          + " ".join(f"{n} {v:.2e}" for n, v in par["errors"].items())
          + f" (bar 1e-5); flags equal {par['flags_equal']}; safe {par['safe']}; {par['replans']} replans; the "
          f"device ran {par['kernels']} (profiler)")
    require(all(v <= 1e-5 for v in par["errors"].values()) and par["flags_equal"] and par["safe"]
            and par["replay_check_err"] <= 1e-10,
            f"controller f64 parity failed: {par}")
    require_runs(par["kernels"], par["replans"], "controller f64 parity, production")
    out["parity_f64"] = par
    return out


# ------------------------------------------------------------------ device WBC and Kalman estimator
WBC_MODES = ((1.0, 1.0, 1.0, 1.0), (1.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 1.0))  # stance, left, right support


def wbc_inputs(iface, B: int, seed: int):
    """(x_des, u_des, rbd, flags) numpy, (B, ...): the MPC's desired point
    near G1's stand, a measurement a little off it, the contact modes
    cycling stance / left / right support."""
    rng = np.random.default_rng(seed)
    x0, nj, mass = np.asarray(iface.initial_state), iface.info.nj, iface.info.robot_mass
    x = x0 + np.concatenate([rng.normal(scale=0.05, size=(B, 6)), rng.normal(scale=0.01, size=(B, 6)),
                             rng.normal(scale=0.05, size=(B, nj))], axis=1)
    u = np.concatenate([np.tile([0.0, 0.0, mass * 9.81 / 4], 4) + rng.normal(scale=5.0, size=(B, 12)),
                        rng.normal(scale=0.3, size=(B, nj))], axis=1)
    rbd = standing_rbd(iface) + np.concatenate([rng.normal(scale=0.02, size=(B, 6)),
                                                rng.normal(scale=0.03, size=(B, nj)),
                                                rng.normal(scale=0.1, size=(B, 6 + nj))], axis=1)
    flags = np.asarray([WBC_MODES[b % 3] for b in range(B)])
    return x, u, rbd, flags


def as_tensors(arrays, iface):
    return [torch.as_tensor(a, dtype=iface.dtype, device=iface.device) for a in arrays]


def wbc_kkt(iface, inputs):
    """The WBC's KKT systems at these inputs and the identity right-hand
    sides K5 inverts them against: (B, 128, 128) each, contiguous."""
    H, _, A, l, u = wbc_qp(iface.model, iface.info, wbc_config_from_task(iface.task), *as_tensors(inputs, iface))
    kkt = kkt_matrix(H, A, l, u)[1].contiguous()
    return kkt, torch.eye(kkt.shape[-1], dtype=kkt.dtype, device=kkt.device).expand(kkt.shape).contiguous()


def phase_wbc_kernel(device, lib, iface) -> dict:
    """Phase 13 (a): K5 on the device WBC's KKT systems (n = 128: 42
    decision variables and 86 rows at G1's widths, against eye(128)) at
    B = 1 (a controller tick) and B = 256 (wbc_update_batch), float64 and
    float32, against its plain version, with the library's inverse of the
    same systems (torch.linalg.solve against the identity, and
    torch.linalg.inv) timed beside it, and K5's launch at each shape (CTAs
    per system, resident CTAs and warps per SM, registers, spills) and, at
    B = 1, its time per pivot and per panel of 8 (the chain of n pivots).
    float64 bar 1e-10 relative to max(1, max|ref|).  In float32 the KKT's
    torque pivots, sigma + torque_reg = 2e-6 beside entries of order
    weight_swing_leg^2 = 1e4, leave a few digits of the inverse, so the
    kernel is held to a backward error, as the gpu test holds it: its
    residual max|A X - I| (in float64) at most 4 times the plain version's
    plus 1e-6."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        it = iface.to(dtype=dtype)
        res = {}
        for B in (1, 256):
            A, I = wbc_kkt(it, wbc_inputs(it, B, 41))
            got = gj_kernel.gauss_jordan_solve_cuda(A, I)
            ref = gauss_jordan_solve(A, I)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            residual = lambda X: float((A.double() @ X.double() - I.double()).abs().max())
            timer = graph_time_ms if B == 1 else cuda_time_ms
            r = {"rel_err": err, "max_abs_err": float((got.double() - ref.double()).abs().max()),
                 "max_abs_inverse": float(ref.abs().max()), "residual": residual(got),
                 "plain_residual": residual(ref),
                 "ms": timer(lambda: gj_kernel.gauss_jordan_solve_cuda(A, I), 50 if B == 1 else 20),
                 "plain_ms": cuda_time_ms(lambda: gauss_jordan_solve(A, I), 3),
                 "library_ms": cuda_time_ms(lambda: torch.linalg.solve(A, I), 10),
                 "library_inv_ms": cuda_time_ms(lambda: torch.linalg.inv(A), 10)}
            n = A.shape[-1]
            peak = PEAK_F64_OPS_PER_S if dtype == torch.float64 else PEAK_F32_OPS_PER_S
            r.update(bound(A.element_size() * B * 3 * n * n, k5_ops(B, n, n), peak))
            r["config"] = k5_config(B, n, n, dtype, "13 wbc-k5")
            r["us_per_pivot"] = r["ms"] * 1e3 / n
            r["us_per_panel"] = r["ms"] * 1e3 / r["config"]["panels"]
            print(f"[13 wbc-k5] {str(dtype)[6:]} B={B} ({n} x {n} | {n}): kernel {r['ms']:.4f} ms "
                  f"({r['us_per_pivot']:.3f} us per pivot, {r['us_per_panel']:.3f} us per panel), plain "
                  f"{r['plain_ms']:.3f} ms, torch.linalg.solve {r['library_ms']:.4f} ms, torch.linalg.inv "
                  f"{r['library_inv_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}); "
                  f"kernel vs plain max rel err {err:.2e} (max |inverse| {r['max_abs_inverse']:.3e}); residual "
                  f"max|A X - I| kernel {r['residual']:.3e}, plain {r['plain_residual']:.3e}")
            require(bool(torch.isfinite(got).all()), f"K5 at the WBC's KKT: non-finite inverse in {dtype} at B={B}")
            if dtype == torch.float64:
                require(err <= 1e-10, f"K5 at the WBC's KKT disagrees in float64 at B={B}: {err:.3e}")
            else:
                require(r["residual"] <= 4.0 * r["plain_residual"] + 1e-6,
                        f"K5 at the WBC's KKT, float32 B={B}: residual {r['residual']:.3e} over 4 x the plain "
                        f"version's {r['plain_residual']:.3e} + 1e-6")
            res[f"b{B}"] = r
        out[str(dtype)[6:]] = res
    out["registers"] = ptxas_summary(lib.ptxas_report)
    print(f"[13 wbc-k5] ptxas: {out['registers']}")
    return out


def phase_wbc_batch(device, iface) -> dict:
    """Phase 13 (b): wbc_update_batch at B = 256 on the card (one K5 launch
    for the batch, counted by its wrapper), float32, timed on CUDA events
    (op by op: it is the sweeps' entry, not the tick's); float64 on the card
    against the plain version on the CPU at B = 8 (decision 1e-8 relative
    to max(1, max|ref|), the CPU parity test's bar, and ``solved`` equal).
    The float32 torque's distance from float64 is printed, the kernel's on
    the card beside the plain version's on the CPU, without a bar: on these
    random inputs the ADMM's 120 iterations leave most QPs unconverged, and
    float32 rounding moves an unconverged iterate (phase 13 (a) holds the
    float32 inverse, phase 13 (c) the float32 torque on the controller's own
    inputs)."""
    B = 256
    inputs = wbc_inputs(iface, B, 43)
    cfg = wbc_config_from_task(iface.task)
    it32 = iface.to(dtype=torch.float32)
    run = lambda it, arrays: wbc_update_batch(it.model, it.info, cfg, *as_tensors(arrays, it))
    run(it32, inputs)
    reset_launches()
    res32 = run(it32, inputs)
    launches = read_launches()["gauss_jordan"]
    require(launches == 1, f"wbc_update_batch at B={B}: K5 launched {launches} times (1 expected)")
    ms = cuda_time_ms(lambda: run(it32, inputs), 3)
    res64 = run(iface, inputs)
    cpu = iface.to(device="cpu")
    plain32 = run(cpu.to(dtype=torch.float32), inputs)
    small = [a[:8] for a in inputs]
    ref = run(cpu, small)
    dec_err = rel_err(res64.decision[:8].cpu(), ref.decision)
    solved_equal = bool(torch.equal(res64.qp.solved[:8].cpu(), ref.qp.solved))
    out = {"batch": B, "ms_per_batch_f32": ms, "k5_launches_per_batch": launches,
           "f32_torque_rel_err_vs_f64": rel_err(res32.torque, res64.torque),
           "f32_plain_cpu_torque_rel_err_vs_f64": rel_err(plain32.torque, res64.torque.cpu()),
           "f64_vs_cpu_plain_decision_rel_err": dec_err, "solved_equal": solved_equal,
           "solved_f64": int(res64.qp.solved.sum()), "solved_f32": int(res32.qp.solved.sum()),
           "finite_f32": bool(torch.isfinite(res32.decision).all())}
    print(f"[13 wbc-batch] wbc_update_batch B={B} float32: {ms:.3f} ms per batch (op by op), K5 launches "
          f"{launches}; torque float32 vs float64: kernel on the card {out['f32_torque_rel_err_vs_f64']:.2e}, plain "
          f"on the CPU {out['f32_plain_cpu_torque_rel_err_vs_f64']:.2e} (no bar); float64 card vs CPU plain (B=8) "
          f"decision rel err {dec_err:.2e} (bar 1e-8), solved equal {solved_equal}; solved {out['solved_f64']} "
          f"(f64) / {out['solved_f32']} (f32) of {B}")
    require(out["finite_f32"], "wbc_update_batch float32: non-finite decision")
    require(dec_err <= 1e-8 and solved_equal, f"wbc_update_batch float64 vs plain: {dec_err:.3e}, {solved_equal}")
    return out


def quat_from_zyx(e) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of R = Rz(e0) Ry(e1) Rx(e2)."""
    cz, sz = np.cos(e[0] / 2), np.sin(e[0] / 2)
    cy, sy = np.cos(e[1] / 2), np.sin(e[1] / 2)
    cx, sx = np.cos(e[2] / 2), np.sin(e[2] / 2)
    return np.array([cz * cy * cx + sz * sy * sx, cz * cy * sx - sz * sy * cx,
                     cz * sy * cx + sz * cy * sx, sz * cy * cx - cz * sy * sx])


class Imu:
    """The sensors of a replayed rbdState: the IMU quaternion of its base
    orientation, the gyro (the world angular velocity in the base frame),
    the accelerometer (the base's acceleration minus gravity, in the base
    frame; the acceleration is the replay's base velocity differenced over
    the tick), and the joint positions and velocities."""

    def __init__(self, nj: int):
        self.nj, self.v_prev = nj, None

    def read(self, rbd):
        nj, nv = self.nj, 6 + self.nj
        euler, omega, v = rbd[0:3], rbd[nv : nv + 3], rbd[nv + 3 : nv + 6]
        R = rotmat_from_zyx_np(euler)
        a = np.zeros(3) if self.v_prev is None else (v - self.v_prev) / TICK_S
        self.v_prev = v.copy()
        return (quat_from_zyx(euler), R.T @ omega, R.T @ (a + np.array([0.0, 0.0, 9.81])), rbd[6 : 6 + nj],
                rbd[nv + 6 :])


def kalman_standing(iface, ticks: int = 1200) -> dict:
    """The controller's Kalman estimator alone at G1's stand, as the JAX
    package's test_kalman_converges_standing holds it: the sensors of the
    standing rbd state at rest, the estimate started 5 cm off the base
    position in every axis; after ``ticks`` steps (on the card, replays of
    its graph) the largest errors of the base-to-foot positions and the base
    height (bar 5e-3 m each) and of the base velocity (bar 1e-2 m/s).
    Absolute x and y are a gauge freedom of leg odometry and are not held."""
    rbd, nj = standing_rbd(iface), iface.info.nj
    est = KalmanStateEstimator(iface.model, iface.info)
    quat, q_j = quat_from_zyx(rbd[0:3]), rbd[6 : 6 + nj]
    est.reset(quat, q_j, rbd[3:6] + 0.05)
    accel = rotmat_from_zyx_np(rbd[0:3]).T @ np.array([0.0, 0.0, 9.81])
    for _ in range(ticks):
        est.update(quat, np.zeros(3), accel, q_j, np.zeros(nj), np.ones(4))
    z = est.state.z.double().cpu().numpy()
    q = torch.as_tensor(np.concatenate([np.zeros(3), rbd[0:3], q_j]), dtype=iface.dtype, device=iface.device)
    rel = contact_positions(iface.model, iface.info, q).double().cpu().numpy()
    return {"ticks": ticks, "foot_relative_m": float(np.abs(z[6:].reshape(-1, 3) - z[0:3] - rel).max()),
            "base_height_m": float(abs(z[2] - rbd[5])), "base_velocity_m_s": float(np.abs(z[3:6]).max())}


def kalman_controller(iface, **cfg) -> BipedalController:
    return trotting_controller(iface, wbc_backend="device", estimator="kalman", **cfg)


def odometry_gap(iface, rbds, flags) -> np.ndarray:
    """Per replayed rbd state, the largest difference between its base
    velocity and the base velocity that each stance foot's leg odometry
    gives, -(J_j dq + omega x r) (the Kalman filter's velocity measurement,
    at the flags the filter was given): how far the replay plant's own
    state sets the filter's velocity sources apart.  float64, on the CPU."""
    model, info = iface.model.to(device="cpu", dtype=torch.float64), iface.info
    nj, nv = info.nj, info.generalized_dim
    rbd = torch.as_tensor(np.stack(rbds))
    q = torch.cat([torch.zeros(len(rbds), 3, dtype=torch.float64), rbd[:, 0:3], rbd[:, 6 : 6 + nj]], -1)
    r = contact_positions(model, info, q)  # (T, nc, 3), base at the origin
    J = frame_jacobians(model, q, info.contact_frame_ids)[..., :3, 6:]  # (T, nc, 3, nj)
    omega = rbd[:, None, nv : nv + 3].expand(r.shape)
    v_odo = -(torch.einsum("tcij,tj->tci", J, rbd[:, nv + 6 :]) + torch.linalg.cross(omega, r, dim=-1))
    gap = (v_odo - rbd[:, None, nv + 3 : nv + 6]).abs().amax(-1).numpy()
    return (gap * (np.stack(flags) > 0.5)).max(-1)


def device_controller_run(iface32, torque: TorqueReadings, ticks: int = 400) -> dict:
    """A trotting BipedalController(wbc_backend="device", estimator="kalman")
    on the replay plant through its sensor entry points: starting_from_sensors,
    then ``ticks`` update_from_sensors at 2.5 ms steps, each tick checked,
    the estimate's base position and velocity held against the replay's.
    Returns the controller, plant and imu, the replans' CUDA events, the
    replan-tick flags, the Kalman steps' host seconds, the estimate's
    errors (position, velocity) and the replay's odometry gap per tick, and
    the WBC's calls as ((x_star, u_fb, rbd, flags), decision)."""
    ctrl = kalman_controller(iface32)
    advance, replans = ctrl.mpc.advance, []

    def timed_advance(t, x):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        sol = advance(t, x)
        ev[1].record()
        replans.append(ev)
        return sol

    ctrl.mpc.advance = timed_advance
    step, kalman_s, kalman_flags = ctrl.estimator.update, [], []

    def timed_step(*args):
        t0 = time.perf_counter()
        out = step(*args)
        kalman_s.append(time.perf_counter() - t0)
        kalman_flags.append(np.array(args[-1], dtype=np.float64))
        return out

    ctrl.estimator.update = timed_step
    wbc, wbc_calls = ctrl.device_wbc.update, []

    def recorded_wbc(*args):
        out = wbc(*args)
        wbc_calls.append((tuple(np.array(a, dtype=np.float64) for a in args), out[0]))
        return out

    ctrl.device_wbc.update = recorded_wbc
    plant, imu = Replay(iface32), Imu(iface32.info.nj)
    nv = iface32.info.generalized_dim
    ctrl.starting_from_sensors(0.0, *imu.read(plant.rbd), base_pos_guess=plant.rbd[3:6])
    replan_tick, err_p, err_v, rbds = [], [], [], []
    for k in range(ticks):
        n = len(replans)
        rbd = plant.measure(ctrl)
        cmd = ctrl.update_from_sensors(k * TICK_S, *imu.read(rbd))
        replan_tick.append(len(replans) > n)
        require(ctrl.safe, f"device-WBC controller: unsafe at tick {k}")
        torque.check(cmd, ctrl.wbc_primal_residual, f"device-WBC tick {k}")
        z = ctrl.estimator.state.z[0:6].double().cpu().numpy()
        err_p.append(float(np.abs(z[0:3] - rbd[3:6]).max()))
        err_v.append(float(np.abs(z[3:6] - rbd[nv + 3 : nv + 6]).max()))
        rbds.append(rbd.copy())
    return {"ctrl": ctrl, "plant": plant, "imu": imu, "replans": replans, "replan_tick": np.asarray(replan_tick),
            "kalman_s": kalman_s, "err_p": np.asarray(err_p), "err_v": np.asarray(err_v),
            "odometry_gap": odometry_gap(iface32, rbds, kalman_flags[-ticks:]), "wbc_calls": wbc_calls}


def f32_torque_errors(iface, cfg, wbc_calls) -> dict:
    """The float32 WBC's torque against the float64 WBC on the controller's
    own inputs (one float64 batch on the card), on the ticks whose float64
    QP is solved (primal residual under the QP's 1e-3): the largest error
    relative to max(1, max|tau|) of the ticks' own torque (K5 at B = 1 in
    each tick's graph), and, to tell K5's share from the other float32 ops,
    of float32 batches of the same inputs through K5 on the card, through
    K5's plain version on the card, and through the plain versions on the
    CPU."""
    arrays = [np.stack([args[i] for args, _ in wbc_calls]) for i in range(4)]
    ref = wbc_update_batch(iface.model, iface.info, cfg, *as_tensors(arrays, iface))
    tau64, solved = ref.torque.cpu().numpy(), ref.qp.solved.cpu().numpy()
    nj = iface.info.nj

    def err(tau32):
        tick = np.abs(tau32 - tau64).max(-1) / np.maximum(1.0, np.abs(tau64).max(-1))
        return float(tick[solved].max()), float(tick.max())

    it32, cpu32 = iface.to(dtype=torch.float32), iface.to(device="cpu", dtype=torch.float32)
    batch = lambda it: wbc_update_batch(it.model, it.info, cfg, *as_tensors(arrays, it)).torque.cpu().numpy()
    k5 = batch(it32)
    with mock.patch.object(wbc_qp_module, "gauss_jordan_solve_pallas", gauss_jordan_solve):
        plain_card = batch(it32)
    out = {"ticks": len(wbc_calls), "ticks_f64_solved": int(solved.sum()),
           "f64_max_primal_residual": float(ref.qp.primal_residual.max())}
    for name, tau in (("tick_k5_b1", np.stack([d[-nj:] for _, d in wbc_calls])), ("batch_k5", k5),
                      ("batch_plain_gj_card", plain_card), ("batch_plain_cpu", batch(cpu32))):
        out[name] = dict(zip(("solved_ticks", "all_ticks"), err(tau)))
    return out


def device_controller_parity(iface, ticks: int = 20) -> dict:
    """The device-WBC, Kalman-estimator controller in float64: production on
    the card (K1, K2+K3 and K4 in the replans, K5 in every tick's WBC, both
    the WBC and the filter replayed from CUDA graphs) against the all-plain
    configuration on the CPU (every kernel's plain version), driven in
    lockstep with the same sensors (the production controller's replay):
    the largest relative error of pos_des, vel_des, tau_ff and the filter's
    state over the ticks, and whether the planned contact flags agreed."""
    prod = kalman_controller(iface)
    cpu = iface.to(device="cpu")
    plain = kalman_controller(dataclasses.replace(cpu, settings=g1_settings(iface.settings, "plain")))
    plant, imu = Replay(iface), Imu(iface.info.nj)
    sensors = imu.read(plant.rbd)
    for ctrl in (prod, plain):
        ctrl.starting_from_sensors(0.0, *sensors, base_pos_guess=plant.rbd[3:6])
    errs = {"pos_des": 0.0, "vel_des": 0.0, "tau_ff": 0.0, "estimate_z": 0.0}
    flags_equal = True
    for k in range(ticks):
        t = k * TICK_S
        sensors = imu.read(plant.measure(prod))
        flags_equal &= bool(np.array_equal(prod._planned_flags(t), plain._planned_flags(t)))
        got, want = prod.update_from_sensors(t, *sensors), plain.update_from_sensors(t, *sensors)
        for name in ("pos_des", "vel_des", "tau_ff"):
            a, b = getattr(got, name), getattr(want, name)
            errs[name] = max(errs[name], float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max())))
        z, z_ref = prod.estimator.state.z.cpu(), plain.estimator.state.z
        errs["estimate_z"] = max(errs["estimate_z"], rel_err(z, z_ref))
    return {"errors": errs, "flags_equal": flags_equal, "safe": prod.safe and plain.safe,
            "replans": prod.mpc.timer.count, "backends": {"production": prod.backends, "plain": plain.backends}}


def phase_device_controller(device, iface) -> dict:
    """Phase 13 (c): the controller with the device WBC and the Kalman
    estimator on G1 (float32, production settings), trot from 0.1 s, fed by
    the replay plant's synthesised sensors (module docstring)."""
    iface32 = iface.to(dtype=torch.float32)
    limits = np.tile(np.asarray(iface.task.wbc.torque_limits, dtype=np.float64), 2)
    torque = TorqueReadings(limits)
    reset_launches()
    run = device_controller_run(iface32, torque)
    ctrl, plant, imu, replans, flag, wbc_calls = (run[k] for k in ("ctrl", "plant", "imu", "replans", "replan_tick",
                                                                  "wbc_calls"))
    err_p, err_v, gap = run["err_p"], run["err_v"], run["odometry_gap"]
    counts = read_launches()
    require(all(counts[k] >= 1 for k in ("linearize", "riccati", "merit", "gauss_jordan")),
            f"device-WBC controller: a kernel's wrapper launched it no time in 400 ticks: {counts}")
    n_replans = len(replans)
    require(n_replans == 50, f"device-WBC controller: {n_replans} replans (50 expected)")
    torch.cuda.synchronize()
    replan_ms = [a.elapsed_time(b) for a, b in replans]
    ticks = np.asarray(ctrl.tick_timer.samples)
    wbc_s, ex_s, kalman_s = list(ctrl.wbc_timer.samples), list(ctrl.tick_ex_timer.samples), run["kalman_s"][1:]
    # four more ticks, the first of them a replan, under the profiler: the
    # device's runs of each kernel per tick (every tick replays the WBC's
    # graph, which no wrapper counts).  A tick is ~9,000 device activities,
    # and the tracer drops a record now and then: a 10-tick window once
    # counted 9 of its 10 K5 runs, a 4-tick window 3 of 4 (PERF.md §6).  So a
    # window that records fewer runs than the ticks ran is traced again, on
    # the next four ticks, up to three windows in all; one that records more
    # fails at once, and one of the three must record every run.
    window_ticks, windows = 4, []
    for w in range(3):
        t_window, replans_before = 1.0 + w * window_ticks * TICK_S, ctrl.mpc.timer.count
        window = lambda: [ctrl.update_from_sensors(t_window + i * TICK_S, *imu.read(plant.measure(ctrl)))
                          for i in range(window_ticks)]
        _, _, ran = profile_counts(window, cpu=False)
        want = dict.fromkeys(("linearize", "riccati", "merit"), ctrl.mpc.timer.count - replans_before)
        want["gauss_jordan"] = window_ticks
        windows.append({"ran": ran, "expected": want})
        require(all(ran[k] <= n for k, n in want.items()), f"device-WBC controller: the device ran {ran} in "
                f"{window_ticks} ticks, more than once per tick and replan ({want})")
        if all(ran[k] == n for k, n in want.items()):
            break
    require(all(ran[k] == n for k, n in want.items()), f"device-WBC controller: no window of {window_ticks} ticks "
            f"recorded K5 once per tick and K1, K2+K3, K4 once per replan: {windows}")
    t_next = t_window + window_ticks * TICK_S
    tau = f32_torque_errors(iface, ctrl.wbc_cfg, wbc_calls)
    # the device activities (kernels, copies, fills) of one WBC and one
    # filter step, each a graph replay, called past the run's timing
    # wrappers; traced on the device only, as the other long windows are
    wbc_activities = profile_counts(lambda: DeviceWbc.update(ctrl.device_wbc, *wbc_calls[-1][0]), cpu=False)[0]
    sensors = imu.read(plant.measure(ctrl))
    flags = ctrl._planned_flags(t_next)
    kalman_activities = profile_counts(lambda: KalmanStateEstimator.update(ctrl.estimator, *sensors, flags),
                                       cpu=False)[0]
    settle = slice(40, None)  # after the first 0.1 s (the filter's settling and the trot's start)
    standing = kalman_standing(iface32)
    out = {"ticks": int(ticks.size), "replans": n_replans, "backends": ctrl.backends,
           "tick_no_replan": percentiles(ticks[~flag]), "tick_replan": percentiles(ticks[flag]),
           "wbc": percentiles(wbc_s), "tick_ex_wbc": percentiles(ex_s),
           "kalman_step": percentiles(kalman_s), "replan_cuda_events": percentiles(np.asarray(replan_ms) / 1e3),
           "k5_runs_per_tick": ran["gauss_jordan"] / window_ticks, "kernel_runs_window": ran,
           "window_ticks": window_ticks, "traced_windows": windows, "wrapper_launches": counts,
           "estimate_max_abs_err": {"base_position_m": float(err_p.max()), "base_velocity_m_s": float(err_v.max()),
                                    "base_position_m_after_0.1s": float(err_p[settle].max()),
                                    "base_velocity_beyond_odometry_gap_m_s": float((err_v - gap).max()),
                                    "replay_odometry_gap_m_s": float(gap.max())},
           "kalman_standing": standing,
           "torque": torque.summary(), "f32_torque_vs_f64": tau,
           "device_activities_per_wbc": wbc_activities, "device_activities_per_kalman_step": kalman_activities}
    print(f"[13 controller] device WBC + Kalman float32, 400 ticks, {n_replans} replans, backends "
          f"{ctrl.backends}: tick without replan p50 {out['tick_no_replan']['p50_ms']:.3f} / p99 "
          f"{out['tick_no_replan']['p99_ms']:.3f} ms, with replan p50 {out['tick_replan']['p50_ms']:.3f} / p99 "
          f"{out['tick_replan']['p99_ms']:.3f} ms; wbc p50 {out['wbc']['p50_ms']:.3f} / p99 {out['wbc']['p99_ms']:.3f}"
          f" ms; Kalman step (host, with its two copies) p50 {out['kalman_step']['p50_ms']:.3f} / p99 "
          f"{out['kalman_step']['p99_ms']:.3f} ms; device activities per WBC {wbc_activities}, per Kalman step "
          f"{kalman_activities}; replan p50 {out['replan_cuda_events']['p50_ms']:.3f} ms; the "
          f"device ran {ran} in {window_ticks} ticks, {want['linearize']} replan(s) among them (profiler; "
          f"{len(windows)} window(s) traced, the tracer recorded {[w['ran']['gauss_jordan'] for w in windows]} K5 "
          f"runs), the wrappers launched "
          f"{counts}; estimate vs replay max |base "
          f"position error| {err_p.max():.5f} m ({err_p[settle].max():.5f} after 0.1 s; bar 5e-3), |base velocity "
          f"error| {err_v.max():.4f} m/s (p99 {np.percentile(err_v, 99):.4f}), beyond the replay's odometry gap "
          f"{(err_v - gap).max():.4f} (bar 0.25; the gap up to {gap.max():.4f}); standing {standing['ticks']} steps: "
          f"foot relative {standing['foot_relative_m']:.2e} m, height {standing['base_height_m']:.2e} m (bars 5e-3), "
          f"velocity {standing['base_velocity_m_s']:.2e} m/s (bar 1e-2); {torque}; float32 torque vs the float64 WBC "
          f"on the same inputs, rel err on the {tau['ticks_f64_solved']} of {tau['ticks']} ticks whose float64 QP is "
          f"solved (on all; the float64 QP's largest primal residual {tau['f64_max_primal_residual']:.3e}): "
          + ", ".join(f"{k} {tau[k]['solved_ticks']:.2e} ({tau[k]['all_ticks']:.2e})" for k in
                      ("tick_k5_b1", "batch_k5", "batch_plain_gj_card", "batch_plain_cpu"))
          + " (bars: the ticks' 5e-2; through K5 at most 4 x through its plain version on the card + 1e-3)")
    tick, k5, plain = (tau[k]["solved_ticks"] for k in ("tick_k5_b1", "batch_k5", "batch_plain_gj_card"))
    require(tick <= 5e-2, f"device WBC float32 torque vs float64 on the solved ticks' inputs: {tick:.3e}")
    require(max(tick, k5) <= 4.0 * plain + 1e-3,
            f"device WBC float32 torque through K5 ({tick:.3e} per tick, {k5:.3e} batched) beyond 4 x that through "
            f"its plain version on the card ({plain:.3e}) + 1e-3")
    require(err_p.max() <= 5e-3 and (err_v - gap).max() <= 0.25,
            f"Kalman estimate left the replay: position {err_p.max():.5f} m (bar 5e-3), velocity beyond the "
            f"replay's odometry gap {(err_v - gap).max():.4f} m/s (bar 0.25)")
    require(max(standing["foot_relative_m"], standing["base_height_m"]) <= 5e-3
            and standing["base_velocity_m_s"] <= 1e-2, f"Kalman estimate standing: {standing}")
    par = device_controller_parity(iface)
    print(f"[13 controller] float64 20 ticks, production on the card vs all plain on the CPU: "
          + " ".join(f"{n} {v:.2e}" for n, v in par["errors"].items())
          + f" (bar 1e-5); flags equal {par['flags_equal']}; safe {par['safe']}; {par['replans']} replans")
    require(all(v <= 1e-5 for v in par["errors"].values()) and par["flags_equal"] and par["safe"],
            f"device-WBC controller f64 parity failed: {par}")
    out["parity_f64"] = par
    return out


# ------------------------------------------------------------------ the batched closed loop (cascade)
# phase 14(a)'s episode: trot spliced in at 0.02 s, cmd_vel with the trim and
# the heading hold (tests/test_torch_batch_loop.py's, at the survival settings)
CASCADE_EPISODE = dict(gait="trot", gait_at=0.02, cmd_vel=(0.3, 0.0, 0.0, 0.2), cmd_vel_ki=0.5, cmd_vel_kyaw=0.8,
                       cmd_vel_yaw_delay=0.02)
CASCADE_FIELDS = ("q", "v", "anchor", "base_z_min", "tilt_max", "defect_last")
FALLEN_PITCH = 1.7  # rad, beyond BatchLoopConfig.fall_tilt (1.5)


def cascade_iface(iface, config: str, device, dtype):
    """G1's interface at tools/scenario_survival_torch.py's settings (dt
    0.02: N = 50; one SQP iteration; the task's five line-search
    candidates) with the configuration's backends, on device in dtype."""
    linearize, riccati, merit = CONFIGS[config]
    iface = iface.to(device=device, dtype=dtype)
    return dataclasses.replace(iface, settings=dataclasses.replace(
        iface.settings, dt=0.02, sqp_iterations=1, linesearch_alphas=OcpSettings().linesearch_alphas,
        linearize=linearize, riccati=riccati, merit=merit))


def np_rel_err(got, ref) -> float:
    """max |got - ref| / max(1, max |ref|) of numpy arrays."""
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def cascade_fields(res) -> dict:
    """A BatchLoopResult's compared fields as float64 numpy."""
    st = res.final_state
    named = {"q": st.q, "v": st.v, "anchor": st.anchor, "base_z_min": res.base_z_min, "tilt_max": res.tilt_max,
             "defect_last": res.defect_last}
    return {k: v.to(device="cpu", dtype=torch.float64).numpy() for k, v in named.items()}


def device_profile(fn) -> dict:
    """One call of fn traced on the device only: its activities, the runs
    of K1, K2+K3, K4 and K5, the activities' summed durations (busy) and
    the span from the first one's start to the last one's end, in ms."""
    dev, _ = trace(fn, cpu=False)
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3 if dev else 0.0
    return {"activities": len(dev), "ran": kernel_runs(dev), "busy_ms": busy, "span_ms": span}


def profile_episode(loop, X) -> dict:
    """One episode of loop, each step (the cold solve, every replan, every
    tick) in a profiler window of its own (a window of ten ticks, ~10^5
    activities, has dropped kernel records: phase 13): the device's kernel
    runs and activities per step, held to K1, K2+K3 and K4 once in every
    solve and K5 never, K5 once in every tick and the others never."""
    box = [None]

    def step(f):
        prof = device_profile(lambda: box.__setitem__(0, f()))
        return prof, box[0]

    solves, ticks = [], []
    prof, state = step(lambda: loop.begin(X))
    solves.append(prof)
    for k in range(loop.n_replans):
        prof, state = step(lambda: loop.replan(k, state))
        solves.append(prof)
        for j in range(loop.n_ticks):
            prof, state = step(lambda: loop.tick(k, j, state))
            ticks.append(prof)
    model = ("linearize", "riccati", "merit")
    require(all(all(p["ran"][k] == 1 for k in model) and p["ran"]["gauss_jordan"] == 0 for p in solves),
            f"cascade: every solve must run K1, K2+K3 and K4 once and K5 never; the profiler saw "
            f"{[p['ran'] for p in solves]}")
    require(all(p["ran"]["gauss_jordan"] == 1 and all(p["ran"][k] == 0 for k in model) for p in ticks),
            f"cascade: every tick must run K5 once and no model kernel; the profiler saw "
            f"{[p['ran'] for p in ticks if p['ran']['gauss_jordan'] != 1]}")
    per = lambda profs, key: float(np.mean([p["ran"][key] for p in profs]))
    return {"solves": len(solves), "ticks": len(ticks),
            "launches_per_replan": {k: per(solves, k) for k in KERNEL_NAMES},
            "launches_per_tick": {k: per(ticks, k) for k in KERNEL_NAMES},
            "device_activities_per_replan": float(np.mean([p["activities"] for p in solves[1:]])),
            "device_activities_per_tick": float(np.mean([p["activities"] for p in ticks])),
            "tick_busy_ms": float(np.mean([p["busy_ms"] for p in ticks])),
            "tick_span_ms": float(np.mean([p["span_ms"] for p in ticks])),
            "replan_busy_ms": float(np.mean([p["busy_ms"] for p in solves[1:]])),
            "replan_span_ms": float(np.mean([p["span_ms"] for p in solves[1:]])),
            "result": state}


def step_times_ms(loop, state, reps: int = 10) -> dict:
    """CUDA-event times of the replan's and the tick's graph replays (input
    copies, replay, output copies) from one state, reps of each."""
    out = {}
    for name, call in (("replan", lambda: loop.replan(1, state)), ("tick", lambda: loop.tick(1, 3, state))):
        call()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            call()
        ev[1].record()
        torch.cuda.synchronize()
        out[name] = ev[0].elapsed_time(ev[1]) / reps
    return out


def phase_cascade(device, g1, batch: int = 64, duration: float = 1.0) -> dict:
    """Phase 14: the batched closed loop (sim/batch_loop.py) on G1.

    (a) float64, production on the card against the all-plain
    configuration on the CPU, 3 lanes (two randomized, seed 0, and one
    pitched past the fall guard), 0.06 s, CASCADE_EPISODE; then the same
    episode with every step under the profiler.
    (b) float32 production, B = batch randomized at scale 1.0 (seed 7),
    trot from 0.2 s, cmd_vel 0.3 m/s, for duration s (64 and 1.0 s): timed,
    every lane finite at the end."""
    from bipedal_control_tpu_torch.sim.batch_loop import (
        BatchLoopConfig,
        make_batched_closed_loop,
        randomized_initial_states,
    )

    t_phase = time.perf_counter()
    out = {}
    card = cascade_iface(g1, "production", device, torch.float64)
    X = np.concatenate([randomized_initial_states(card, 2, seed=0), np.asarray(card.initial_state)[None]])
    X[2, 10] = FALLEN_PITCH
    reset_launches()
    loop = make_batched_closed_loop(card, BatchLoopConfig(duration=0.06), **CASCADE_EPISODE)
    got_res = loop(X)
    fell = got_res.fell.cpu().numpy()
    got = cascade_fields(got_res)
    counts = read_launches()
    require(all(counts[k] >= 1 for k in KERNEL_NAMES),
            f"cascade: a kernel's wrapper launched it no time in the episode: {counts}")
    t0 = time.perf_counter()
    cpu_loop = make_batched_closed_loop(cascade_iface(g1, "plain", "cpu", torch.float64),
                                        BatchLoopConfig(duration=0.06), device="cpu", **CASCADE_EPISODE)
    want_res = cpu_loop(X)
    cpu_s = time.perf_counter() - t0
    want = cascade_fields(want_res)
    errs = {name: np_rel_err(got[name], want[name]) for name in CASCADE_FIELDS}
    print(f"[14 cascade] float64 3 lanes, 0.06 s (N = {loop.num_nodes - 1}, {loop.n_replans} replans of "
          f"{loop.n_ticks} ticks of {loop.n_sub} substeps), production on the card vs all plain on the CPU "
          f"({cpu_s:.1f} s): " + "; ".join(f"{n} {errs[n]:.2e}" for n in CASCADE_FIELDS) + " (bar 1e-5)"
          + f"; fell {fell.tolist()} vs {want_res.fell.numpy().tolist()}; the wrappers launched {counts}")
    require(np.array_equal(fell, want_res.fell.numpy()) and fell.tolist() == [False, False, True],
            f"cascade f64: fell {fell.tolist()} vs the plain CPU run's {want_res.fell.numpy().tolist()}")
    require(all(errs[n] <= 1e-5 for n in CASCADE_FIELDS), f"cascade f64 parity failed: {errs} (bar 1e-5)")
    prof = profile_episode(loop, X)
    replayed = cascade_fields(loop.result(prof.pop("result")))
    replay_err = max(np_rel_err(replayed[n], got[n]) for n in CASCADE_FIELDS)
    print(f"[14 cascade] float64 episode, each step profiled alone: kernel runs per replan "
          f"{prof['launches_per_replan']} (of {prof['solves']} solves), per tick {prof['launches_per_tick']} (of "
          f"{prof['ticks']} ticks); device activities per replan {prof['device_activities_per_replan']:.0f}, per "
          f"tick {prof['device_activities_per_tick']:.0f}; its result vs the first episode's {replay_err:.1e}")
    out["parity_f64"] = {"errors": errs, "fell": fell.tolist(),
                         "wrapper_launches": counts, "cpu_plain_s": cpu_s, "profile": prof,
                         "profiled_vs_first_episode": replay_err}
    # (a') the same episode with the square-root parallel Riccati scan (penalty 1e4): its
    # solves run op by op (a capture refuses eigh), the ticks replay their graph
    sqrt = lambda iface: dataclasses.replace(iface, settings=dataclasses.replace(
        iface.settings, riccati="parallel_sqrt", riccati_penalty=1e4))
    reset_launches()
    t0 = time.perf_counter()
    loop = make_batched_closed_loop(sqrt(card), BatchLoopConfig(duration=0.06), **CASCADE_EPISODE)
    got_res = loop(X)
    got = cascade_fields(got_res)
    card_s = time.perf_counter() - t0
    counts = read_launches()
    want_res = make_batched_closed_loop(sqrt(cascade_iface(g1, "plain", "cpu", torch.float64)),
                                        BatchLoopConfig(duration=0.06), device="cpu", **CASCADE_EPISODE)(X)
    want = cascade_fields(want_res)
    errs = {name: np_rel_err(got[name], want[name]) for name in CASCADE_FIELDS}
    fell = got_res.fell.cpu().numpy()
    print(f"[14 cascade] float64 3 lanes, 0.06 s, riccati parallel_sqrt (penalty 1e4; solves op by op, ticks "
          f"graphed; {card_s:.1f} s), the card vs all plain on the CPU: "
          + "; ".join(f"{n} {errs[n]:.2e}" for n in CASCADE_FIELDS) + f" (bar 1e-5); fell {fell.tolist()} vs "
          f"{want_res.fell.numpy().tolist()}; the wrappers launched {counts}")
    require(np.array_equal(fell, want_res.fell.numpy()) and all(errs[n] <= 1e-5 for n in CASCADE_FIELDS),
            f"cascade f64 parallel_sqrt parity failed: {errs}, fell {fell.tolist()}")
    require(counts["linearize"] >= 1 and counts["merit"] >= 1 and counts["gauss_jordan"] >= 1,
            f"cascade parallel_sqrt: K1, K4 or K5 not launched: {counts}")
    out["parallel_sqrt_f64"] = {"errors": errs, "fell": fell.tolist(), "wrapper_launches": counts, "card_s": card_s}

    # (b) the survival configuration, timed
    iface32 = cascade_iface(g1, "production", device, torch.float32)
    B = batch
    loop = make_batched_closed_loop(iface32, BatchLoopConfig(duration=duration), gait="trot", gait_at=0.2,
                                    cmd_vel=(0.3, 0.0, 0.0, 0.0))
    X = randomized_initial_states(iface32, B, seed=7, scale=1.0)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = loop(X)
    q = res.final_state.q.double().cpu().numpy()
    first_s = time.perf_counter() - t0
    counts = read_launches()
    t0 = time.perf_counter()
    res = loop(X)
    final = cascade_fields(res)
    wall = time.perf_counter() - t0
    q, tilt, fell = final["q"], final["tilt_max"], res.fell.cpu().numpy()
    finite = np.array([all(np.isfinite(final[k][b]).all() for k in ("q", "v", "anchor")) for b in range(B)])
    z_floor = 0.82 * float(iface32.task.com_height)
    upright = finite & (q[:, 2] > z_floor) & (tilt < 0.8)
    progressed = finite & (q[:, 0] > 0.3 * 0.3 * duration)
    state = loop.begin(X)
    state = loop.replan(0, state)
    times = step_times_ms(loop, state)
    replan_prof = device_profile(lambda: loop.replan(1, state))
    tick_prof = device_profile(lambda: loop.tick(1, 3, state))
    idle = 1.0 - tick_prof["busy_ms"] / max(tick_prof["span_ms"], 1e-9)
    busy_vs_replay = tick_prof["busy_ms"] / max(times["tick"], 1e-9)
    out["survival_f32"] = {
        "batch": B, "duration_s": duration, "first_episode_s": first_s, "episode_s": wall,
        "wall_s_per_episode_s": wall / duration, "scenario_s_per_s": B * duration / wall,
        "finite_frac": float(finite.mean()), "fell_frac": float(fell.mean()), "upright_frac": float(upright.mean()),
        "progressed_frac": float(progressed.mean()), "z_final_mean": float(q[finite, 2].mean()),
        "x_final_mean": float(q[finite, 0].mean()), "wrapper_launches_first_episode": counts,
        "replan_replay_ms": times["replan"], "tick_replay_ms": times["tick"],
        "device_activities_per_replan": replan_prof["activities"],
        "device_activities_per_tick": tick_prof["activities"],
        "tick_busy_ms": tick_prof["busy_ms"], "tick_span_ms": tick_prof["span_ms"], "tick_idle_share_traced": idle,
        "tick_busy_traced_over_replay": busy_vs_replay,
        "us_per_tick_activity": 1e3 * times["tick"] / tick_prof["activities"],
        "replan_busy_ms": replan_prof["busy_ms"], "replan_span_ms": replan_prof["span_ms"],
        "kernel_runs_replan": replan_prof["ran"], "kernel_runs_tick": tick_prof["ran"]}
    v = out["survival_f32"]
    print(f"[14 cascade] float32 B = {B}, {duration} s (trot from 0.2 s, cmd_vel 0.3 m/s, scale 1.0, seed 7): "
          f"episode {wall:.3f} s ({v['wall_s_per_episode_s']:.3f} s per episode second, "
          f"{v['scenario_s_per_s']:.2f} scenario-seconds per second; the first, op by op and capturing, "
          f"{first_s:.3f} s); finite {v['finite_frac']:.3f}, fell {v['fell_frac']:.3f}, upright "
          f"{v['upright_frac']:.3f}, progressed {v['progressed_frac']:.3f} (final z mean {v['z_final_mean']:.4f}, x "
          f"mean {v['x_final_mean']:.4f}); replay of the replan graph {times['replan']:.3f} ms "
          f"({replan_prof['activities']} device activities, busy {replan_prof['busy_ms']:.3f} of "
          f"{replan_prof['span_ms']:.3f} ms), of the tick graph {times['tick']:.3f} ms ({tick_prof['activities']} "
          f"activities, {v['us_per_tick_activity']:.3f} us each; traced: busy {tick_prof['busy_ms']:.3f} of "
          f"{tick_prof['span_ms']:.3f} ms, idle {idle:.1%}; the traced busy time is {busy_vs_replay:.2f} x the "
          f"untraced replay's); the "
          f"wrappers launched {counts} in the first episode")
    require(bool(finite.all()), f"cascade f32: {int((~finite).sum())} of {B} lanes not finite at the end")
    require(all(counts[k] >= 1 for k in KERNEL_NAMES), f"cascade f32: a wrapper launched its kernel no time: {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[14 cascade] phase wall {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------------ solver variants
# phase 15(a)'s lean stress (tests/test_torch_cone.py): mu 0.05 ground, vx
# weight 200 with the angular-momentum rows free, a 0.3 s horizon, momentum
# target 1.0 and 0.3 m; the hard cone's continuation at cone_mu_decay 0.1
LEAN_ITERS = 4  # SQP iterations of a hard or ipm solve
VARIANT_BATCH = 256  # 15(a)'s and 15(c)'s timed batch
ILQR_LOOP_S = 0.2  # 15(b)'s dummy loop
VARIANT_BARS = dict(PARITY_BARS, cone_slack=1e-5, cone_dual=1e-5)


def lean_problem(iface, backends: str, cone: str):
    """(solver, inputs) of the lean stress on iface's device and dtype: the
    batched solver of ``backends`` (a CONFIGS key) for ``cone``, and one
    lane's references, node grid, initial state and cold start."""
    import copy

    from bipedal_control_tpu_torch.reference.target import TargetTrajectories

    linearize, riccati, merit = CONFIGS[backends]
    settings = dataclasses.replace(
        iface.settings, horizon=0.3, friction_coefficient=0.05, cone=cone, cone_mu_decay=0.1,
        sqp_iterations=1 if cone == "soft" else LEAN_ITERS, linesearch_alphas=OcpSettings().linesearch_alphas,
        linearize=linearize, riccati=riccati, merit=merit)
    Q = iface.Q.clone()
    Q[0, 0] = 200.0
    Q[3:6, 3:6] = 0.0
    task = copy.deepcopy(iface.task)
    task.mpc.time_horizon = 0.3
    rm = dataclasses.replace(iface, settings=settings, task=task).make_reference_manager()
    x0 = np.asarray(iface.initial_state)
    s0, s1 = x0.copy(), x0.copy()
    s0[0] = s1[0] = 1.0
    s1[6] += 0.3
    rm.set_target(TargetTrajectories(times=np.array([0.0, 0.3]), states=np.stack([s0, s1]),
                                     inputs=np.zeros((2, iface.info.input_dim))))
    fr = rm.freeze(0.0)
    refs = build_refs(iface.info, fr.gait, fr.swing, fr.target, fr.t_nodes)
    x = torch.as_tensor(x0, dtype=iface.dtype, device=iface.device)[None]
    xs, us = initial_trajectory(iface.info, refs, x, settings.num_intervals + 1)
    solver = make_batched_solver(iface.model, iface.info, settings, Q, iface.R, device=iface.device)
    return solver, (refs, fr.t_nodes[None], x, xs, us)


def lean_solve(iface, backends: str, cone: str):
    """The lean stress's solution for cone: soft, 12 chained one-iteration
    solves; hard, 2 chained solves; ipm, one solve from the soft result."""
    solver, (refs, t_nodes, x, xs, us) = lean_problem(iface, backends, cone)
    if cone == "ipm":
        soft = lean_solve(iface, backends, "soft")
        xs, us = soft.x_traj, soft.u_traj
    for _ in range({"soft": 12, "hard": 2, "ipm": 1}[cone]):
        sol = solver(refs, t_nodes, x, xs, us)
        xs, us = sol.x_traj, sol.u_traj
    return sol


def variant_errors(a, b) -> dict:
    return {n: rel_err(getattr(a, n), getattr(b, n)) for n in VARIANT_BARS if getattr(b, n) is not None}


def cone_margin(iface, sol, cone: str) -> float:
    """The least friction-cone margin (N) over the stance cones of the
    lean stress's solution."""
    from bipedal_control_tpu_torch.ocp.problem import friction_cone_values

    solver, (refs, *_) = lean_problem(iface, "plain", cone)
    g = friction_cone_values(solver.settings, sol.u_traj, iface.info)
    return float(g[refs.contact_flags > 0.5].min())


@contextlib.contextmanager
def k1_outputs_checked(written: list):
    """Within the block, K1's wrapper allocates its outputs filled with NaN
    and, after each launch, synchronises and appends to ``written`` whether
    the kernel overwrote every entry: a launch that did not run shows."""
    class NanEmpty:  # torch, whose empty() fills with NaN
        def __getattr__(self, name):
            return getattr(torch, name)

        def empty(self, shape, dtype=None, device=None):
            return torch.full(shape, float("nan"), dtype=dtype, device=device)

    launch = linearize_kernel.linearize_cuda

    def checked(*args):
        outs = launch(*args)
        written.append(all(bool(torch.isfinite(o).all()) for o in outs))
        return outs

    # the wrapper counts its launches on the module's linearize_cuda, which is this one here
    checked.launches = launch.launches
    try:
        with mock.patch.object(linearize_kernel, "torch", NanEmpty()), \
                mock.patch.object(linearize_kernel, "linearize_cuda", checked):
            yield
    finally:
        launch.launches = checked.launches


def variants_cones(device, g1, out: dict) -> None:
    """15(a): the hard and ipm SQP on the card (production backends, K1,
    K2+K3, K4 every iteration), float64 against the plain versions on the
    CPU; the kernels' runs per solve by the profiler; float32 B = 256
    solves/s for soft, hard and ipm on the G1 trot front end."""
    card, cpu = g1.to(device=device, dtype=torch.float64), g1.to(device="cpu", dtype=torch.float64)
    for cone in ("hard", "ipm"):
        got, want = lean_solve(card, "production", cone), lean_solve(cpu, "production", cone)
        errs = variant_errors(got, want)
        same_step = bool(torch.equal(got.step_size.cpu(), want.step_size))
        margin = cone_margin(cpu, want, cone)
        solver, inputs = lean_problem(card, "production", cone)
        solver(*inputs)
        # the solve captured in a CUDA graph (as MpcRunner graphs these settings) and one
        # replay traced on the device; then the solve run op by op, traced too, with K1's
        # outputs allocated NaN-filled and checked after each launch: after phases 1-14 such
        # a trace has missed one K1 record (3 of 4, every window, the wrappers launching 4),
        # while a fresh process's traces miss none, nor do the graph replays' (PERF.md §6)
        kernels = ("linearize", "riccati", "merit")
        nr = len(NodeRefs._fields)
        refs, *rest = inputs
        flat = [*refs, *rest]
        graphed = GraphedCall(lambda *f: solver(NodeRefs(*f[:nr]), *f[nr:]))
        first = graphed(flat)
        dev, _ = trace(lambda: graphed(flat), cpu=False)
        replay = graphed(flat)
        ran = kernel_runs(dev)
        box, written = [], []
        reset_launches()
        with k1_outputs_checked(written):
            op_dev, _ = trace(lambda: box.append(solver(*inputs)), cpu=False)
        launched, op_ran = read_launches(), kernel_runs(op_dev)
        replay_err = max(rel_err(a, b) for a, b in zip(replay, first) if a is not None)
        op_err = max(rel_err(a, b) for a, b in zip(box[0], replay) if a is not None)
        out[cone] = {"f64_errors": errs, "step_size": got.step_size.tolist(), "least_margin_N": margin,
                     "kernel_runs_per_solve": ran, "wrapper_launches_per_solve": launched,
                     "kernel_runs_op_by_op_traced": op_ran, "k1_launches_wrote_outputs": written,
                     "op_by_op_traced_vs_replay": op_err}
        print(f"[15 variants] (a) {cone} cone, G1 lean stress, float64 card production vs CPU plain: "
              + " ".join(f"{n} {v:.2e}" for n, v in errs.items()) + f" step_size equal {same_step} "
              f"({got.step_size.tolist()}); least stance margin {margin:.4f} N; kernel runs per solve "
              f"(profiler, a CUDA-graph replay of the solve) {ran}; the wrappers' launches per solve (op by op) "
              f"{launched}; the replay vs the op-by-op solve {replay_err:.2e}; the op-by-op solve traced: the "
              f"profiler's records {op_ran}, K1's launches wrote their NaN-filled outputs {written}, its result vs "
              f"the replay's {op_err:.2e}")
        require(all(v <= VARIANT_BARS[n] for n, v in errs.items()) and same_step, f"{cone} f64 parity failed: {errs}")
        require(margin > -0.5, f"{cone}: least stance margin {margin:.3f} N (bar -0.5)")
        require(replay_err <= 1e-9 and op_err <= 1e-9,
                f"{cone}: the graph replay of the solve differs from its op-by-op runs: {replay_err}, {op_err}")
        require(len(written) == LEAN_ITERS and all(written),
                f"{cone}: a K1 launch left its outputs unwritten: {written}")
        require(all(ran[k] == launched[k] == LEAN_ITERS for k in kernels),
                f"{cone}: K1, K2+K3 and K4 must run once per SQP iteration ({LEAN_ITERS}); the profiler saw "
                f"{ran}, the wrappers launched {launched}")
    # float32 B = 256 on the trot front end: soft (one iteration), hard and ipm (LEAN_ITERS)
    B, steps = VARIANT_BATCH, 5
    iface32 = g1.to(device=device, dtype=torch.float32)
    out["b256"] = {}
    for cone in ("soft", "hard", "ipm", "ipm", "hard", "soft"):
        settings = dataclasses.replace(g1_settings(iface32.settings, "production"), cone=cone,
                                       sqp_iterations=1 if cone == "soft" else LEAN_ITERS,
                                       linesearch_alphas=OcpSettings().linesearch_alphas)
        solver = make_batched_solver(iface32.model, iface32.info, settings, iface32.Q, iface32.R, device=device)
        refs, t_b, x_b, xs, us = g1_front_end(dataclasses.replace(iface32, settings=settings), B, None)
        for _ in range(2):
            sol = solver(refs, t_b, x_b, xs, us)
            xs, us = sol.x_traj, sol.u_traj
        torch.cuda.synchronize()
        reset_launches()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(steps):
            sol = solver(refs, t_b, x_b, xs, us)
            xs, us = sol.x_traj, sol.u_traj
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / steps
        counts = read_launches()
        require(all(bool(torch.isfinite(getattr(sol, f)).all()) for f in ("x_traj", "u_traj", "K")),
                f"{cone} B=256: non-finite output")
        run = {"solves_per_s": B * 1000.0 / ms, "ms_per_solve": ms, "iterations": settings.sqp_iterations,
               "launches_per_solve": {k: v / steps for k, v in counts.items()},
               "defect_l1": float(sol.defect_norm.double().mean())}
        out["b256"].setdefault(cone, []).append(run)
        print(f"[15 variants] (a) float32 B={B} {cone} ({settings.sqp_iterations} SQP iterations, 5 candidates, "
              f"production): {run['solves_per_s']:.1f} solves/s ({ms:.3f} ms/solve on CUDA events); defect_l1 "
              f"mean {run['defect_l1']:.4e}; wrapper launches per solve {run['launches_per_solve']}")
        require(all(run["launches_per_solve"][k] == settings.sqp_iterations for k in ("linearize", "riccati", "merit")),
                f"{cone} B=256: K1, K2+K3, K4 must launch once per iteration: {counts}")


def variants_ilqr(device, g1, out: dict) -> None:
    """15(b): MpcRunner(solver="ilqr") on the card: float64 against the CPU
    over a cold and two warm replans at ddp_iterations=2 (the card's replay
    CUDA graphs), then a float32 dummy loop at ddp_iterations=8."""
    rng = np.random.default_rng(41)
    x0 = g1.initial_state
    times = (0.0, 0.02, 0.04)
    xs = [x0 + rng.normal(scale=0.005, size=x0.shape) for _ in times]
    sols = {}
    for where in ("card", "cpu"):
        iface = g1.to(device=device if where == "card" else "cpu", dtype=torch.float64)
        runner = MpcRunner(iface, solver="ilqr", ddp_iterations=2)
        require(runner.graphed == (where == "card"), f"ilqr runner on the {where}: graphed {runner.graphed}")
        runner.rm.set_gait(iface.task.gait_library["trot"], 0.1)
        sols[where] = [runner.advance(t, torch.as_tensor(x, device=iface.device)) for t, x in zip(times, xs)]
    errs = [{n: rel_err(getattr(a, n).cpu(), getattr(b, n)) for n in PARITY_BARS}
            for a, b in zip(sols["card"], sols["cpu"])]
    for k, (what, e) in enumerate(zip(("cold", "warm", "warm (graph replays)"), errs)):
        print(f"[15 variants] (b) float64 iLQR {what} replan, card vs CPU: "
              + " ".join(f"{n} {v:.2e}" for n, v in e.items()))
        require(all(e[n] <= PARITY_BARS[n] for n in PARITY_BARS), f"iLQR f64 {what} replan parity failed: {e}")
    out["ilqr_f64_errors"] = errs
    # float32 dummy loop at ddp_iterations=8
    iface32 = g1.to(device=device, dtype=torch.float32)
    mpc = MpcRunner(iface32, solver="ilqr", ddp_iterations=8)
    mpc.rm.set_gait(iface32.task.gait_library["trot"], 0.1)
    advance, timed = mpc.advance, []

    def timed_advance(t, x):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        sol = advance(t, x)
        ev[1].record()
        torch.cuda.synchronize()
        timed.append((ev[0].elapsed_time(ev[1]), time.perf_counter() - t0))
        return sol

    mpc.advance = timed_advance
    duration = ILQR_LOOP_S
    t0 = time.perf_counter()
    res = run_dummy_loop(iface32, mpc, iface32.initial_state, duration=duration, mrt_frequency=400.0,
                         mpc_frequency=50.0)
    wall = time.perf_counter() - t0
    replay_ms = np.array([d for d, _ in timed[2:]])
    z = res.states[:, 8]
    graphs = mpc._graphs or {}
    # a trace of ~1.3e5 activities takes seconds: the cold graph (the warm one's size) is not traced
    kinds = {k: device_profile(g._graph.replay)["activities"] for k, g in graphs.items() if k != "cold"}
    per_replan = kinds.get("warm", 0) + 7 * kinds.get("iterate", 0) + kinds.get("finish", 0)
    out["ilqr_loop"] = {"duration_s": duration, "replans": len(timed), "wall_s": wall,
                        "first_replans_ms": [d for d, _ in timed[:2]],
                        "replan_p50_ms": float(np.percentile(replay_ms, 50)),
                        "replan_p99_ms": float(np.percentile(replay_ms, 99)),
                        "host_ms_per_replay_replan": float(np.mean([h for _, h in timed[2:]]) * 1e3),
                        "device_activities_per_graph": kinds, "device_activities_per_warm_replan": per_replan,
                        "finite": bool(np.isfinite(res.states).all()), "base_z_min": float(z.min()),
                        "base_z_max": float(z.max())}
    v = out["ilqr_loop"]
    print(f"[15 variants] (b) float32 iLQR dummy loop, ddp_iterations=8, {duration} s at 400 Hz MRT / 50 Hz MPC "
          f"({wall:.1f} s wall): {v['replans']} replans; the first two (cold, warm: op by op, then captured) "
          f"{v['first_replans_ms'][0]:.1f} and {v['first_replans_ms'][1]:.1f} ms; graph-replayed replans p50 "
          f"{v['replan_p50_ms']:.2f} ms, p99 {v['replan_p99_ms']:.2f} ms (CUDA events; host "
          f"{v['host_ms_per_replay_replan']:.2f} ms); device activities per graph {kinds} -> per warm replan "
          f"{per_replan}; base z in [{v['base_z_min']:.4f}, {v['base_z_max']:.4f}] (no bar); finite {v['finite']}")
    require(v["finite"], "iLQR dummy loop: non-finite state")
    require(set(graphs) >= {"cold", "warm", "iterate", "finish"}, f"iLQR graphs: {sorted(graphs)}")


def variants_parallel(device, g1, out: dict) -> None:
    """15(c): riccati "parallel" and "parallel_sqrt" in the G1 solve,
    float64 B = 8 card vs CPU; then the LQR solves alone on the G1 front
    end's stage data at B = 256, float32: parallel_sqrt beside K2+K3 and
    the plain sequential sweep."""
    from bipedal_control_tpu_torch.solver import parallel_riccati
    from bipedal_control_tpu_torch.solver.riccati import solve_lqr, solve_lqr_pallas
    from bipedal_control_tpu_torch.solver.sqp import eq_mask_from_flags

    # the penalties: on G1's stage data the dense scan's result moves under a one-ulp change
    # of its inputs by 2.5e-4 (penalty 1e2), 3.8 (1e4) and 4e3 (1e6) of a du of ~115 N, the
    # reference's as the port's (ROADMAP queue 3), so it is held where it is conditioned
    for riccati, penalty in (("parallel", 1e2), ("parallel_sqrt", 1e4)):
        sols = {}
        for where in ("card", "cpu"):
            iface = g1.to(device=device if where == "card" else "cpu", dtype=torch.float64)
            settings = dataclasses.replace(g1_settings(iface.settings, "production"), riccati=riccati,
                                           riccati_penalty=penalty, linesearch_alphas=OcpSettings().linesearch_alphas)
            solver = make_batched_solver(iface.model, iface.info, settings, iface.Q, iface.R, device=iface.device)
            sols[where] = solver(*g1_front_end(dataclasses.replace(iface, settings=settings), 8, 21))
        errs = solution_errors(sols["card"], sols["cpu"])
        same_step = bool(torch.equal(sols["card"].step_size.cpu(), sols["cpu"].step_size))
        out[riccati] = {"f64_errors": errs}
        print(f"[15 variants] (c) riccati={riccati} (penalty {penalty:g}, 5 candidates) G1 float64 B=8 card vs CPU: "
              + " ".join(f"{n} {v:.2e}" for n, v in errs.items()) + f" step_size equal {same_step} "
              f"({sols['card'].step_size.tolist()})")
        require(all(errs[n] <= PARITY_BARS[n] for n in PARITY_BARS) and same_step, f"{riccati} f64 parity: {errs}")
    iface32 = g1.to(device=device, dtype=torch.float32)
    settings = g1_settings(iface32.settings, "production")
    refs, t_b, x_b, xs, us = g1_front_end(dataclasses.replace(iface32, settings=settings), VARIANT_BATCH, None)
    lin = linearize_kernel.make_node_linearizer(iface32.model, iface32.info, settings, iface32.Q, iface32.R,
                                                static=iface32.circuit)
    nodes = lin(xs[:, :-1], us, xs[:, 1:], refs)
    masks = eq_mask_from_flags(refs.contact_flags)
    dx0 = torch.zeros_like(x_b)
    solves = {"parallel_sqrt": lambda: parallel_riccati.solve_lqr_parallel_sqrt(nodes, masks, dx0, 1e4),
              "pallas (K2+K3)": lambda: solve_lqr_pallas(nodes, masks, dx0),
              "sequential (plain)": lambda: solve_lqr(nodes, masks, dx0)}
    times = {k: cuda_time_ms(fn, 3) for k, fn in solves.items()}
    ref = solves["sequential (plain)"]()
    sq = solves["parallel_sqrt"]()
    finite = bool(torch.isfinite(sq.du).all())
    out["lqr_b256_f32_ms"] = times
    out["lqr_b256_f32_sqrt_finite"] = finite
    out["lqr_b256_f32_sqrt_vs_sequential_du"] = rel_err(sq.du, ref.du) if finite else None
    # no bar on the float32 square-root scan's values: on this cold start's
    # stage data the reference's own solve_lqr_parallel_sqrt is not finite in
    # float32 either (ROADMAP queue 3)
    print(f"[15 variants] (c) float32 B={VARIANT_BATCH} G1 LQR solve (the cold start's stage data): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in times.items()) + f" (CUDA events); parallel_sqrt (penalty 1e4) "
          f"finite {finite}, du vs the sequential sweep {out['lqr_b256_f32_sqrt_vs_sequential_du']}")


def variants_srbd(device, g1, out: dict) -> None:
    """15(d): G1 with centroidalModelType 1 (SRBD at the initial joint
    state; linearize "structured", riccati "sequential", merit "xla": the
    kernels refuse SRBD, as the reference's do): MpcRunner float64 card vs
    CPU over a cold and a warm replan (1e-5), then the float32 replan's ms."""
    def srbd(iface):
        info = dataclasses.replace(iface.info, model_type=1,
                                   q_j_nominal=tuple(float(v) for v in iface.initial_state[12:]))
        return dataclasses.replace(iface, info=info, circuit=None, settings=g1_settings(iface.settings, "plain"))

    sols = {}
    for where in ("card", "cpu"):
        iface = srbd(g1.to(device=device if where == "card" else "cpu", dtype=torch.float64))
        runner = MpcRunner(iface)
        runner.rm.set_gait(iface.task.gait_library["trot"], 0.1)
        x = torch.as_tensor(iface.initial_state, device=iface.device)
        sols[where] = [runner.advance(t, x) for t in (0.0, 0.02)]
    errs = [solution_errors(a, b) for a, b in zip(sols["card"], sols["cpu"])]
    for what, e in zip(("cold", "warm"), errs):
        print(f"[15 variants] (d) SRBD float64 {what} replan card vs CPU: " + " ".join(f"{n} {v:.2e}" for n, v in e.items()))
        require(all(e[n] <= PARITY_BARS[n] for n in PARITY_BARS), f"SRBD f64 {what} replan parity failed: {e}")
    iface32 = srbd(g1.to(device=device, dtype=torch.float32))
    runner = MpcRunner(iface32)
    runner.rm.set_gait(iface32.task.gait_library["trot"], 0.1)
    x = torch.as_tensor(iface32.initial_state, dtype=torch.float32, device=device)
    ms = []
    for k in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        sol = runner.advance(0.02 * k, x)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    require(bool(torch.isfinite(sol.x_traj).all()), "SRBD float32 replan: non-finite")
    out["srbd"] = {"f64_errors": errs, "replan_ms": ms[1:], "replan_p50_ms": float(np.percentile(ms[1:], 50))}
    print(f"[15 variants] (d) SRBD float32 replan (op by op, structured / sequential / xla): p50 "
          f"{out['srbd']['replan_p50_ms']:.2f} ms over 5 warm replans (cold {ms[0]:.2f} ms)")


def phase_variants(device, g1) -> dict:
    """Phase 15: the solver variants on G1 ((a) hard and ipm cones, (b) the
    iLQR MPC, (c) the parallel Riccati scans, (d) SRBD)."""
    t_phase = time.perf_counter()
    out = {}
    for part in (variants_cones, variants_ilqr, variants_parallel, variants_srbd):
        t0 = time.perf_counter()
        part(device, g1, out)
        print(f"[15 variants] {part.__name__} {time.perf_counter() - t0:.1f} s")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[15 variants] phase wall {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------------ the command line
CLI_PLAN = ["plan", "--robot", "g1", "--gait", "trot", "--duration", "0.2"]


def cli_run(argv, device, dtype) -> tuple[int, str]:
    """(exit code, stdout) of bipedal_control_tpu_torch.cli.main(argv) on
    device in dtype; the output is printed after the run."""
    import io

    from bipedal_control_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device=device, dtype=dtype)
    return rc, buf.getvalue()


def mpc_timing(stdout: str) -> dict:
    """The replan timer's stats that plan prints ("mpc timing: {...}")."""
    line = next(ln for ln in stdout.splitlines() if ln.startswith("mpc timing: "))
    return json.loads(line[len("mpc timing: "):])


def phase_cli(device, g1_urdf: str) -> dict:
    """Phase 16: the command line on the card (see the module docstring)."""
    from bipedal_control_tpu_torch import robots
    from bipedal_control_tpu_torch.interface import make_interface_for
    from bipedal_control_tpu_torch.runtime.visualizer import Visualizer

    t_phase = time.perf_counter()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli")
    os.makedirs(out_dir, exist_ok=True)
    saved = robots.REGISTRY["g1"]
    robots.REGISTRY["g1"] = dataclasses.replace(saved, urdf=g1_urdf)
    try:
        runs, out = {}, {}
        # (a) float64 on the card, each replan in a profiler window of its own (the
        # device's kernel runs; the wrappers count each kind's first replan, the others
        # replay its graph), then the same on the CPU through the plain versions
        windows = []
        advance_frozen = MpcRunner.advance_frozen

        def traced_replan(runner, *args):
            box = []
            windows.append(profile_counts(lambda: box.append(advance_frozen(runner, *args)), cpu=False)[2])
            return box[0]

        for name, dev in (("card", device), ("cpu", "cpu")):
            path = os.path.join(out_dir, f"plan_{name}.npz")
            reset_launches()
            t0 = time.perf_counter()
            traced = mock.patch.object(MpcRunner, "advance_frozen", traced_replan)
            with traced if name == "card" else contextlib.nullcontext():
                rc, stdout = cli_run(CLI_PLAN + ["--out", path], dev, torch.float64)
            wall = time.perf_counter() - t0
            lines = [ln for ln in stdout.splitlines() if not ln.startswith("[config]")]
            print("\n".join(f"[16 cli] {name} float64 | {ln}" for ln in lines))
            require(rc == 0, f"cli plan on the {name}: exit {rc}")
            runs[name] = (dict(np.load(path)), mpc_timing(stdout), wall)
            if name == "card":
                launched = read_launches()
        (card, timing, wall), (cpu, _, cpu_wall) = runs["card"], runs["cpu"]
        replans = timing["count"]
        ran = {k: sum(w[k] for w in windows) for k in KERNEL_NAMES}
        errs = {k: np_rel_err(card[k], cpu[k]) for k in ("states", "inputs")}
        print(f"[16 cli] plan --robot g1 --gait trot --duration 0.2, float64: {card['states'].shape[0]} MRT steps, "
              f"{replans} replans; the card vs the CPU's plain versions: states {errs['states']:.2e}, inputs "
              f"{errs['inputs']:.2e} (bar 1e-5); times equal {np.array_equal(card['times'], cpu['times'])}; kernel "
              f"runs on the card (profiler, each replan alone) {ran}; the wrappers launched {launched}; wall "
              f"{wall:.1f} s (replans traced), CPU {cpu_wall:.1f} s")
        require(np.array_equal(card["times"], cpu["times"]) and all(v <= 1e-5 for v in errs.values()),
                f"cli plan: the card's trajectory left the CPU's: {errs}")
        require(bool(np.isfinite(card["states"]).all()), "cli plan: non-finite state")
        require(replans == len(windows) == 10, f"cli plan: {replans} replans in 0.2 s at 50 Hz (10 expected)")
        require(all(all(w[k] == 1 for k in ("linearize", "riccati", "merit")) for w in windows),
                f"cli plan: every replan must run K1, K2+K3 and K4 once on the device; the profiler saw {windows}")
        require(all(launched[k] >= 1 for k in ("linearize", "riccati", "merit")),
                f"cli plan: a kernel's wrapper launched it no time: {launched}")
        out["f64"] = {"replans": replans, "errors": errs, "kernel_runs": ran, "wrapper_launches": launched,
                      "base_z": [float(card["states"][:, 8].min()), float(card["states"][:, 8].max())]}
        # (b) float32 on the card, untraced: the wall time and the replans' times
        path = os.path.join(out_dir, "plan_card_f32.npz")
        t0 = time.perf_counter()
        rc, stdout = cli_run(CLI_PLAN + ["--out", path], device, torch.float32)
        wall = time.perf_counter() - t0
        timing = mpc_timing(stdout)
        f32 = np.load(path)
        f32_err = np_rel_err(f32["states"], card["states"])
        require(rc == 0 and bool(np.isfinite(f32["states"]).all()), "cli plan float32: failed or non-finite")
        out["f32"] = {"wall_s": wall, "replan_p50_ms": timing["p50_ms"], "replan_p99_ms": timing["p99_ms"],
                      "replans": timing["count"], "states_vs_f64": f32_err}
        print(f"[16 cli] plan float32 on the card: wall {wall:.3f} s (interface, runner, 0.2 s loop); replan p50 "
              f"{timing['p50_ms']:.3f} / p99 {timing['p99_ms']:.3f} / max {timing['max_ms']:.3f} ms (host clock, ends "
              f"in a synchronise; the first cold and warm replans run op by op and capture); states vs float64 "
              f"{f32_err:.2e}")
        # (c) gaits, and the visualizer's markers over the card's float64 trajectory
        rc, stdout = cli_run(["gaits", "--robot", "g1"], device, None)
        lines = [ln for ln in stdout.splitlines() if not ln.startswith("[config]")]
        iface = make_interface_for("g1", device=device)
        require(rc == 0 and len(lines) == len(iface.task.gait_library) and any(ln.startswith("trot:") for ln in lines),
                f"cli gaits: exit {rc}, {lines}")
        viz = Visualizer(iface.model, iface.info, max_update_frequency=100.0, record_tf=True)
        t0 = time.perf_counter()
        for t, x, u in zip(card["times"], card["states"], card["inputs"]):
            viz.update(t, x, u)
        viz_ms = (time.perf_counter() - t0) * 1e3 / len(viz.frames)
        path = os.path.join(out_dir, "markers.json")
        viz.export_json(path)
        with open(path) as fh:
            frames = json.load(fh)["frames"]
        f0 = viz.frames[0]
        require(len(frames) == len(viz.frames) >= 10 and all(np.isfinite(f.foot_positions).all()
                                                             and np.isfinite(f.body_positions).all()
                                                             for f in viz.frames),
                f"visualizer: {len(viz.frames)} frames (about 20 at 100 Hz over 0.2 s) or non-finite markers")
        require(float(np.abs(f0.foot_positions[:, 2]).max()) < 0.02,
                f"visualizer: the first frame's soles at z {f0.foot_positions[:, 2].tolist()} (standing: ~0)")
        out["gaits"] = lines
        out["visualizer"] = {"frames": len(frames), "ms_per_update": viz_ms, "json_bytes": os.path.getsize(path)}
        print(f"[16 cli] gaits: {lines}; Visualizer(record_tf=True) over the card's trajectory: {len(frames)} frames, "
              f"{viz_ms:.3f} ms per update (the markers and the {iface.model.nb}-body tree on the card, one copy "
              f"back), export_json {os.path.getsize(path)} bytes")
    finally:
        robots.REGISTRY["g1"] = saved
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[16 cli] phase wall {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------------ the fleet
def tree_to(tree, device):
    """A tensor tree (a tuple whose items are tensors or named tuples of them) on device."""
    return tuple(type(a)(*(f.to(device) for f in a)) if isinstance(a, tuple) else a.to(device) for a in tree)


def meshed_kernel_check(meshed, inputs, sharded) -> dict:
    """How one meshed solve ran the kernels: a CUDA-graph replay of it
    (built from the global inputs) under the profiler, whose records of a
    replay are complete (late in a long process it has dropped the records
    of op-by-op K1 launches: 0 of 1 in each window after phases 1-16); and
    one op-by-op solve of the sharded inputs under the profiler too, with
    the wrappers' launches and K1's NaN-filled outputs checked written
    (k1_outputs_checked); the replay against the op-by-op solve."""
    nr = len(NodeRefs._fields)
    refs, *rest = inputs
    graphed = GraphedCall(lambda *f: meshed(NodeRefs(*f[:nr]), *f[nr:]))
    flat = [*refs, *rest]
    graphed(flat)  # runs op by op and captures
    dev, _ = trace(lambda: graphed(flat), cpu=False)
    replay = graphed(flat)
    box, written = [], []
    reset_launches()
    with k1_outputs_checked(written):
        op_dev, _ = trace(lambda: box.append(meshed(*sharded)), cpu=False)
    full = lambda t: t.full_tensor()
    err = max(rel_err(full(a), full(b)) for a, b in zip(replay, box[0]) if a is not None)
    return {"replay_runs": kernel_runs(dev), "wrapper_launches": read_launches(),
            "op_by_op_traced": kernel_runs(op_dev), "k1_wrote_outputs": written, "replay_vs_op_by_op": err}


def require_meshed_kernels(k: dict) -> None:
    """K1, K2+K3 and K4 once in the replay's trace and once by the wrappers,
    K1's launch writing its outputs, the replay equal to op by op (1e-12)."""
    names = ("linearize", "riccati", "merit")
    require(all(k["replay_runs"][n] == 1 and k["wrapper_launches"][n] == 1 for n in names)
            and k["k1_wrote_outputs"] == [True] and k["replay_vs_op_by_op"] <= 1e-12,
            f"fleet: a meshed solve must run K1, K2+K3 and K4 once each: {k}")


def fleet_rank(rank: int, device, g1_urdf: str) -> dict:
    """Phase 17 (a), (b), (d), (e) in the one rank of a world that
    utils/distributed.spawn started on the card (see the module docstring)."""
    import torch.distributed as dist

    from bipedal_control_tpu_torch import graft_entry, robots
    from bipedal_control_tpu_torch.parallel import make_mesh, shard_batch
    from bipedal_control_tpu_torch.parallel.scaling import ScalingPoint, fleet_stats, run_scaling_benchmark

    out = {}
    backend = dist.get_backend()
    require(backend == "nccl" and dist.get_world_size() == 1,
            f"fleet: the world of one on the card took {backend} with {dist.get_world_size()} ranks")
    set_full_f32_matmul()
    g1, _ = load_g1(device)
    mesh = make_mesh()
    model, info, settings = g1.model, g1.info, g1.settings
    # (a) float64 B = 8: meshed against unmeshed, and against the CPU's plain versions
    t0 = time.perf_counter()
    inputs = g1_front_end(g1, 8, 21)
    meshed = make_batched_solver(model, info, settings, g1.Q, g1.R, mesh=mesh)
    sharded = shard_batch(inputs, mesh)
    sol = meshed(*sharded)
    full = type(sol)(*(None if f is None else f.full_tensor() for f in sol))
    unmeshed = make_batched_solver(model, info, settings, g1.Q, g1.R)(*inputs)
    cpu = g1.to(device="cpu")
    plain = make_batched_solver(cpu.model, info, settings, cpu.Q, cpu.R, device="cpu")(*tree_to(inputs, "cpu"))
    vs_unmeshed = {n: rel_err(getattr(full, n), getattr(unmeshed, n)) for n in PARITY_BARS}
    vs_cpu = solution_errors(full, plain)
    same_step = bool(torch.equal(full.step_size.cpu(), plain.step_size))
    kernels = meshed_kernel_check(meshed, inputs, sharded)
    print(f"[17 fleet] (a) {backend}, world 1, mesh {tuple(mesh.mesh_dim_names)}; float64 B=8 meshed vs unmeshed: "
          + " ".join(f"{n} {v:.2e}" for n, v in vs_unmeshed.items()) + " (bar 1e-12); vs the CPU's plain versions: "
          + " ".join(f"{n} {v:.2e}" for n, v in vs_cpu.items()) + f" step_size equal {same_step}; kernel runs "
          f"per meshed solve: {kernels}; {time.perf_counter() - t0:.1f} s")
    require(all(v <= 1e-12 for v in vs_unmeshed.values()), f"fleet: meshed != unmeshed solve: {vs_unmeshed}")
    require(all(vs_cpu[n] <= PARITY_BARS[n] for n in PARITY_BARS) and same_step,
            f"fleet: the meshed solve left the CPU's plain versions: {vs_cpu}")
    require_meshed_kernels(kernels)
    out["meshed_f64"] = {"vs_unmeshed": vs_unmeshed, "vs_cpu_plain": vs_cpu, "kernels": kernels}
    out["launches_per_meshed_solve"] = kernels["replay_runs"]
    # (b) float32: the weak-scaling sweep at per-device batch 256, and fleet_stats against torch
    t0 = time.perf_counter()
    g32 = g1.to(dtype=torch.float32)
    one = g1_front_end(g32, 1, None)
    points = run_scaling_benchmark(g32.model, info, settings, g32.Q, g32.R, *one, per_device_batch=256, steps=5)
    sol32 = make_batched_solver(g32.model, info, settings, g32.Q, g32.R, mesh=mesh)(
        *shard_batch(g1_front_end(g32, 256, 5), mesh))
    stats = [float(v) for v in fleet_stats(mesh, sol32.cost, sol32.defect_norm, sol32.step_size)]
    cost, defect, step = (f.full_tensor().double() for f in (sol32.cost, sol32.defect_norm, sol32.step_size))
    want = [float(cost.mean()), float(defect.mean()), float(defect.max()), float((step > 0).double().mean())]
    stats_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(stats, want))
    print(f"[17 fleet] (b) float32 sweep at per-device batch 256, 5 steps: "
          + "; ".join(f"{p.n_devices} device(s), batch {p.batch}: {p.solves_per_s:.1f} solves/s, mean_defect "
                      f"{p.mean_defect:.4e}" for p in points)
          + f"; fleet_stats {stats} vs torch on the gathered arrays {want}: rel {stats_err:.2e} (bar 1e-6); "
          f"{time.perf_counter() - t0:.1f} s")
    require(len(points) == 1 and points[0].batch == 256 and np.isfinite(points[0].mean_defect),
            f"fleet: the sweep's points {points}")
    require(stats_err <= 1e-6, f"fleet: fleet_stats {stats} != torch's {want}")
    out["scaling_f32"] = {"points": [dataclasses.asdict(p) for p in points], "fleet_stats": stats,
                          "fleet_stats_rel_err": stats_err}
    # (d) the entry point, op by op and replayed from a CUDA graph
    t0 = time.perf_counter()
    fn, (refs, t_nodes, x0, xs, us) = graft_entry.entry()
    k = len(refs)
    flat = [*refs, t_nodes, x0, xs, us]
    ref = fn(refs, t_nodes, x0, xs, us)
    graphed = GraphedCall(lambda *a: fn(type(refs)(*a[:k]), *a[k:]))
    graphed(flat)  # runs op by op and captures
    replay = graphed(flat)
    entry_err = {n: rel_err(getattr(replay, n), getattr(ref, n)) for n in PARITY_BARS}
    print(f"[17 fleet] (d) entry(): x_traj {tuple(ref.x_traj.shape)}, {ref.x_traj.dtype}; a graph replay vs op by "
          f"op: " + " ".join(f"{n} {v:.2e}" for n, v in entry_err.items()) + f" (bar 1e-12); "
          f"{time.perf_counter() - t0:.1f} s")
    require(all(v <= 1e-12 for v in entry_err.values()) and bool(torch.isfinite(ref.x_traj).all()),
            f"fleet: entry()'s replay left its op-by-op solve: {entry_err}")
    out["entry"] = {"replay_vs_op_by_op": entry_err}
    # (e) the command line's bench-scaling on the registry's G1 (this URDF)
    saved = robots.REGISTRY["g1"]
    robots.REGISTRY["g1"] = dataclasses.replace(saved, urdf=g1_urdf)
    t0 = time.perf_counter()
    try:
        rc, stdout = cli_run(["bench-scaling", "--robot", "g1", "--per-device-batch", "256", "--steps", "5"],
                             None, None)
    finally:
        robots.REGISTRY["g1"] = saved
    rows = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    print("\n".join(f"[17 fleet] (e) cli | {ln}" for ln in stdout.splitlines() if not ln.startswith("[config]")))
    fields = [f.name for f in dataclasses.fields(ScalingPoint)]
    require(rc == 0 and len(rows) == 1 and list(rows[0]) == fields and rows[0]["batch"] == 256,
            f"fleet: bench-scaling exit {rc}, rows {rows}")
    out["cli_bench_scaling"] = {"rows": rows, "s": time.perf_counter() - t0}
    return out


def phase_fleet(g1_urdf: str) -> dict:
    """Phase 17: the scenario mesh, fleet telemetry, the weak-scaling sweep
    and the entry points on the card (see the module docstring).  (a), (b),
    (d) and (e) run in a fresh process, a world of one that
    utils/distributed.spawn starts on the card: after phases 1-16 in this
    process the profiler records no K1 run of a meshed solve, op by op or
    replayed, while the wrapper launches K1 and its outputs are written;
    (c) spawns its own two ranks."""
    from bipedal_control_tpu_torch import graft_entry
    from bipedal_control_tpu_torch.utils.distributed import spawn

    t_phase = time.perf_counter()
    out = spawn(fleet_rank, 1, g1_urdf)[0]
    # (c) dryrun_multichip(2): two ranks share the card over gloo
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(2)
    secs = time.perf_counter() - t0
    print(f"[17 fleet] (c) dryrun_multichip(2) on the card: {dry}; {secs:.1f} s")
    out["dryrun"] = {"ranks": dry, "s": secs}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[17 fleet] phase wall {out['phase_s']:.1f} s")
    return out


def kernel_entry(name, source, replaces, launches, res):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": res.get("library_ms"),
            "ms_m67": res["ms_m67"], "warps_per_sm": res["warps_per_sm"]}


def k5_entry(wbc: dict, stage: dict, dev_ctl: dict) -> dict:
    """K5's entry: its numbers at the controller tick's shape (the device
    WBC's float32 KKT, B = 1, phase 13: with its time per pivot and per
    panel of 8), its launches in phase 13's controller run (the wrapper's:
    the first tick runs op by op, the rest replay its graph) and per tick
    (the profiler's), with the float64 and B = 256 figures and phase 6's
    stage-KKT ones beside them."""
    b1 = wbc["float32"]["b1"]
    return {"name": "batched Gauss-Jordan solve (K5; the device WBC's KKT inverse)", "route": "cuda",
            "source": "bipedal_control_tpu_torch/csrc/gauss_jordan.cu",
            "replaces": "bipedal_control_tpu/ops/pallas_gj.py:77",
            "launches": dev_ctl["wrapper_launches"]["gauss_jordan"], "max_abs_err": b1["max_abs_err"],
            "ms": b1["ms"], "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
            "library_ms": b1["library_ms"], "launches_per_controller_tick": dev_ctl["k5_runs_per_tick"],
            "us_per_pivot_b1": b1["us_per_pivot"], "us_per_panel_b1": b1["us_per_panel"],
            "ctas_per_system_b1": b1["config"]["ctas_per_system"], "warps_per_sm": b1["config"]["warps_per_sm"],
            "registers": wbc["registers"], "wbc_kkt": wbc,
            "stage_kkt": {k: stage[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by", "ms_m67", "warps_per_sm", "config")}}


def g1_entry(res: dict, launches: int) -> dict:
    """A kernel's results at G1's shapes (phase 10) for the kernels line."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "ms_m67", "warps_per_sm", "registers")
    return dict({k: res[k] for k in keys}, launches=launches)


def main():
    set_full_f32_matmul()
    name, _ = phase_device()
    device = torch.device("cuda", 0)
    desc, robot = load_robot()
    model = from_description(desc)
    info = make_info(model, H1_CONTACTS)
    print(f"[robot] {robot}: nj={info.nj} nx={info.state_dim} nu={info.input_dim} mass={info.robot_mass:.2f} kg")
    g1, g1_robot = load_g1(device)
    libs = phase_build(circuit_static(model, info)[0], (info.state_dim, info.input_dim, 16),
                       g1.circuit[0], (g1.info.state_dim, g1.info.input_dim, 16))
    if "--profile" in sys.argv[1:]:
        return phase_profile(model, info, device)
    if "--variants" in sys.argv[1:]:
        print(json.dumps({"variants": dict(phase_variants(device, g1), robot=g1_robot)}))
        return 0
    if "--cli" in sys.argv[1:]:
        print(json.dumps({"cli": dict(phase_cli(device, g1_urdf()[0]), robot=g1_robot)}))
        return 0
    if "--fleet" in sys.argv[1:]:
        print(json.dumps({"fleet": dict(phase_fleet(g1_urdf()[0]), robot=g1_robot)}))
        return 0
    ric = phase_riccati(device, libs["riccati"])
    mer = phase_merit(model, info, device, libs["merit"])
    lin = phase_linearize(model, info, device, libs["linearize"])
    gj = phase_gauss_jordan(device)
    phase_parity(model, info, device)
    runs = phase_main(model, info, device)
    phase_single(model, info, device)
    g1_res = phase_g1(device, libs, g1, g1_robot)
    loop = phase_loop(device, g1)
    ctl = phase_controller(device, g1)
    wbc_k5 = phase_wbc_kernel(device, libs["gauss_jordan"], g1)
    wbc_batch = phase_wbc_batch(device, g1)
    dev_ctl = phase_device_controller(device, g1)
    cascade = phase_cascade(device, g1)
    variants = phase_variants(device, g1)
    cli = phase_cli(device, g1_urdf()[0])
    fleet = phase_fleet(g1_urdf()[0])
    per_meshed = fleet["launches_per_meshed_solve"]
    per_cli = {k: v / cli["f64"]["replans"] for k, v in cli["f64"]["kernel_runs"].items()}
    per_hard, per_ipm = variants["hard"]["kernel_runs_per_solve"], variants["ipm"]["kernel_runs_per_solve"]
    per_cascade = cascade["parity_f64"]["profile"]
    per_replan = ctl["sync"]["kernel_runs_per_replan"]
    counts = runs[0]["launches"]  # the first production run at B=256: 10 solves
    g1_counts = g1_res["main"]["launches"]  # G1's B=256 production run: 10 solves
    src = "bipedal_control_tpu_torch/csrc/"
    kernels = [
        dict(kernel_entry("whole-node linearization (K1)", src + "linearize.cu",
                          "bipedal_control_tpu/ops/pallas_linearize_kernel.py:493", counts["linearize"], lin),
             registers=lin["registers"], g1=g1_entry(g1_res["linearize"], g1_counts["linearize"]),
             launches_per_controller_replan=per_replan["linearize"],
             launches_per_cascade_replan=per_cascade["launches_per_replan"]["linearize"],
             launches_per_cascade_tick=per_cascade["launches_per_tick"]["linearize"],
             launches_per_hard_cone_solve=per_hard["linearize"], launches_per_ipm_solve=per_ipm["linearize"],
             launches_per_cli_replan=per_cli["linearize"], launches_per_meshed_solve=per_meshed["linearize"]),
        dict(kernel_entry("riccati sweep + rollout (K2 backward, fused K3 rollout of pallas_riccati.py:356)",
                          src + "riccati.cu", "bipedal_control_tpu/ops/pallas_riccati.py:281", counts["riccati"], ric),
             b1_ms=ric["b1_ms"], registers=ric["registers"],
             g1=dict(g1_entry(g1_res["riccati"], g1_counts["riccati"]), b4096=g1_res["riccati"]["wide"]),
             launches_per_controller_replan=per_replan["riccati"],
             launches_per_cascade_replan=per_cascade["launches_per_replan"]["riccati"],
             launches_per_cascade_tick=per_cascade["launches_per_tick"]["riccati"],
             launches_per_hard_cone_solve=per_hard["riccati"], launches_per_ipm_solve=per_ipm["riccati"],
             launches_per_cli_replan=per_cli["riccati"], launches_per_meshed_solve=per_meshed["riccati"]),
        dict(kernel_entry("merit sums (K4)", src + "merit.cu", "bipedal_control_tpu/ops/pallas_merit.py:253",
                          counts["merit"], mer),
             registers=mer["registers"], g1=g1_entry(g1_res["merit"], g1_counts["merit"]),
             launches_per_controller_replan=per_replan["merit"],
             launches_per_cascade_replan=per_cascade["launches_per_replan"]["merit"],
             launches_per_cascade_tick=per_cascade["launches_per_tick"]["merit"],
             launches_per_hard_cone_solve=per_hard["merit"], launches_per_ipm_solve=per_ipm["merit"],
             launches_per_cli_replan=per_cli["merit"], launches_per_meshed_solve=per_meshed["merit"]),
        dict(k5_entry(wbc_k5, gj, dev_ctl),
             launches_per_cascade_replan=per_cascade["launches_per_replan"]["gauss_jordan"],
             launches_per_cascade_tick=per_cascade["launches_per_tick"]["gauss_jordan"],
             launches_per_meshed_solve=per_meshed["gauss_jordan"]),
    ]
    print(json.dumps({"g1": {"robot": g1_robot, "solve_b256": g1_res["main"], "dummy_loop": loop}}))
    print(json.dumps({"controller": dict(ctl, robot=g1_robot)}))
    print(json.dumps({"device_wbc": {"robot": g1_robot, "k5": wbc_k5, "wbc_update_batch": wbc_batch,
                                     "controller": dev_ctl}}))
    print(json.dumps({"cascade": dict(cascade, robot=g1_robot)}))
    print(json.dumps({"variants": dict(variants, robot=g1_robot)}))
    print(json.dumps({"cli": dict(cli, robot=g1_robot)}))
    print(json.dumps({"fleet": dict(fleet, robot=g1_robot)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

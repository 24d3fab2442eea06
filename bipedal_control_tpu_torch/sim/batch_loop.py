"""On-device batched closed loop: MPC -> policy -> WBC -> physics
(sim/batch_loop.py counterpart).

The whole 50 Hz / 500 Hz cascade -- SQP replan, policy interpolation with
Riccati feedback, whole-body QP, hybrid-joint PD, compliant-contact
rigid-body physics (sim/physics.py) -- over B domain-randomized scenarios
at once, every tensor batch-leading (the JAX package vmaps one scenario and
compiles the episode into one XLA program).  On the card the replan and the
control tick are each replayed from a CUDA graph (utils/cuda_graph.py): the
replan runs the batched solver's kernels (K1, K2+K3, K4 with the production
settings), the tick one K5 launch for the B whole-body QPs' KKT systems.
With riccati "parallel" or "parallel_sqrt" the replans (the cold start
too) run op by op, by a rule on the backend: a capture refuses their linear
algebra (the dense scan's batched ``inv_ex``, the square-root scan's
``eigh``, which checks its result on the host; measured on an H100), while
the ticks still replay their graph.
Time and the node grid enter the graphs as device tensors, and nothing in
them reads a value back to the host, so an episode synchronises the card
once, when its result is read.

Deviations from the host loop, as in the reference:
- gait, swing and target tables are frozen once over the episode's window
  on the host and sliced by time on the device (with ``cmd_vel`` each
  replan re-targets every scenario from its own observation);
- the event-aligned node grid of every replan index
  (reference/manager.py::build_time_grid) is computed on the host when the
  loop is built;
- the safety stop is a freeze-on-fall guard: once a scenario is fallen
  (base below ``fall_z_frac`` of the nominal standing height, |roll| +
  |pitch| beyond ``fall_tilt``, or a non-finite state) its plant state is
  held at the last finite pre-fall snapshot for the rest of the episode.
  The scenarios do not branch: a frozen one still computes, by a select.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..interface import RobotInterface
from ..model.centroidal import centroidal_state_from_rbd
from ..parallel.batch_solver import make_batched_solver
from ..reference.manager import build_time_grid
from ..reference.target import TargetTable
from ..runtime.mpc_runner import make_capture_hook
from ..runtime.mrt import evaluate_policy_batch
from ..solver.sqp import build_refs, initial_trajectory, warm_start_trajectories
from ..utils.cuda_graph import GraphedCall
from ..utils.device import resolve_device
from ..utils.precision import set_full_f32_matmul
from ..utils.rotations import rotmat_from_zyx
from ..wbc.weighted_wbc import wbc_update_batch
from .physics import SimConfig, SimState, hybrid_pd_torque_explicit, initial_sim_state, rbd_state_from_sim, sim_step


@dataclasses.dataclass(frozen=True)
class BatchLoopConfig:
    duration: float = 1.0
    replan_dt: float = 0.02  # 50 Hz MPC
    control_dt: float = 0.002  # 500 Hz WBC/PD tick
    joint_kp: float = 80.0
    joint_kd: float = 5.0
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    # freeze-on-fall guard (module docstring): fallen = base z below
    # fall_z_frac * nominal standing height, OR |roll|+|pitch| > fall_tilt,
    # OR non-finite state.  freeze_on_fall=False keeps integrating.
    freeze_on_fall: bool = True
    fall_z_frac: float = 0.5
    fall_tilt: float = 1.5


class BatchLoopResult(NamedTuple):
    final_state: SimState  # batched (B, ...)
    base_z_min: torch.Tensor  # (B,) min base height over the episode
    tilt_max: torch.Tensor  # (B,) max |roll|+|pitch| over the episode
    defect_last: torch.Tensor  # (B,) last replan's dynamics defect
    fell: torch.Tensor  # (B,) bool: the freeze-on-fall guard tripped


class LoopState(NamedTuple):
    """What the episode carries from tick to tick, batch-leading."""

    q: torch.Tensor  # (B, nv)
    v: torch.Tensor  # (B, nv)
    anchor: torch.Tensor  # (B, nc, 2)
    down: torch.Tensor  # (B,) bool: fallen (frozen)
    trim: torch.Tensor  # (B,) forward-velocity trim of cmd_vel
    yaw_ref: torch.Tensor  # (B,) heading-hold reference
    engaged: torch.Tensor  # (B,) bool: heading hold engaged
    t_nodes: torch.Tensor  # (B, N+1) the policy's node grid
    x_traj: torch.Tensor  # (B, N+1, nx)
    u_traj: torch.Tensor  # (B, N, nu)
    K: torch.Tensor  # (B, N, nu, nx) feedback gains
    defect: torch.Tensor  # (B,) the last solve's l1 dynamics defect
    z_min: torch.Tensor  # (B,) running min of the base height
    tilt_max: torch.Tensor  # (B,) running max of |roll| + |pitch|


class BatchedClosedLoop:
    """x0_batch (B, nx) -> :class:`BatchLoopResult`: one episode of the
    cascade for B scenarios (built by :func:`make_batched_closed_loop`).

    ``begin`` (the cold solve at t = 0), ``replan`` and ``tick`` are the
    episode's steps; ``__call__`` runs them all.  On the card each step is
    a :class:`GraphedCall`, one per step kind and batch size: its first
    call runs op by op and captures, later calls (this episode's and the
    next ones') replay; with a parallel Riccati scan ``begin`` and
    ``replan`` always run op by op."""

    def __init__(self, iface: RobotInterface, cfg: BatchLoopConfig, wbc_cfg, tables, grids, z_fall: float,
                 retarget, capture):
        self.iface, self.cfg, self.wbc_cfg = iface, cfg, wbc_cfg
        self.model, self.info = iface.model, iface.info
        self.device, self.dtype = iface.device, iface.dtype
        self.gait, self.swing, self.target = tables
        self.n_ticks = int(round(cfg.replan_dt / cfg.control_dt))
        self.n_sub = max(1, int(round(cfg.control_dt / cfg.sim.dt)))
        self.n_replans = grids.shape[0]
        self.num_nodes = grids.shape[1]
        # every time the episode queries, computed on the host as the
        # reference computes them (k * replan_dt, then + j * control_dt)
        t0 = np.arange(self.n_replans) * cfg.replan_dt
        ticks = t0[:, None] + np.arange(self.n_ticks)[None, :] * cfg.control_dt
        as_dev = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        self._grids, self._t_replan, self._t_tick = as_dev(grids), as_dev(t0), as_dev(ticks)
        self._z_fall = z_fall
        self._retarget = retarget
        self._capture_dq, self._cap_decay, self._cap_wshift = capture
        self.solver = make_batched_solver(self.model, self.info, iface.settings, iface.Q, iface.R, device=self.device)
        self._graphs = {} if self.device.type == "cuda" else None
        # step kinds that run op by op on the card: the solves of the parallel scans,
        # which a CUDA-graph capture refuses (module docstring)
        self._op_by_op = {"begin", "replan"} if iface.settings.riccati in ("parallel", "parallel_sqrt") else set()

    # ------------------------------------------------------------- steps
    def begin(self, x0_batch) -> LoopState:
        """The cold start: the plant at rest at x0_batch (B, nx), the first
        solve at t = 0 on the first replan's grid."""
        x0 = torch.as_tensor(x0_batch, dtype=self.dtype, device=self.device)
        return self._call("begin", self._begin, [x0])

    def replan(self, k: int, state: LoopState) -> LoopState:
        """Replan k (t = k * replan_dt): re-target, references, warm start
        on the k-th grid, the batched solve."""
        return self._call("replan", self._replan, [self._t_replan[k : k + 1], self._grids[k], *state])

    def tick(self, k: int, j: int, state: LoopState) -> LoopState:
        """Control tick j of replan k: policy, WBC, PD and the physics
        substeps, the freeze-on-fall select, the running metrics."""
        return self._call("tick", self._tick, [self._t_tick[k, j : j + 1], *state])

    def result(self, state: LoopState) -> BatchLoopResult:
        return BatchLoopResult(
            final_state=SimState(state.q, state.v, state.anchor), base_z_min=state.z_min,
            tilt_max=state.tilt_max, defect_last=state.defect, fell=state.down,
        )

    def __call__(self, x0_batch) -> BatchLoopResult:
        state = self.begin(x0_batch)
        for k in range(self.n_replans):
            state = self.replan(k, state)
            for j in range(self.n_ticks):
                state = self.tick(k, j, state)
        return self.result(state)

    def _call(self, name: str, fn, inputs):
        if self._graphs is None or name in self._op_by_op:
            return fn(*inputs)
        key = (name, inputs[-1].shape[0])  # one graph per step kind and batch size
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = GraphedCall(fn)
        return graph(inputs)

    # ------------------------------------------------- functions of tensors
    def _observe(self, q, v):
        """(rbd state, centroidal observation) of the plant (B, ...)."""
        rbd = rbd_state_from_sim(self.model, SimState(q, v, None))
        return rbd, centroidal_state_from_rbd(self.model, self.info, rbd)

    def _solve(self, t0, t_nodes, x_obs, trim, yaw_ref, engaged, warm=None):
        """(trim, yaw_ref, engaged, solution) of one replan at t0 (1,) on the
        grid t_nodes (N+1,): warm-started from ``warm`` = (t_nodes, x_traj,
        u_traj) of the previous solution, else cold."""
        B = x_obs.shape[0]
        if self._retarget is not None:
            trim, yaw_ref, engaged, target = self._retarget(t0, x_obs, trim, yaw_ref, engaged, cold=warm is None)
        else:
            target = self.target
        dq = self._capture_dq(self.gait, target, t_nodes, x_obs)
        refs = build_refs(self.info, self.gait, self.swing, target, t_nodes, dq, self._cap_decay, self._cap_wshift)
        refs = type(refs)(*(a.expand((B,) + a.shape[1:]) for a in refs))
        t_nodes_b = t_nodes.expand(B, -1)
        if warm is None:
            xs, us = initial_trajectory(self.info, refs, x_obs, self.num_nodes)
        else:
            xs, us = warm_start_trajectories(*warm, t_nodes_b)
        sol = self.solver(refs, t_nodes_b, x_obs, xs, us)
        return trim, yaw_ref, engaged, sol

    def _begin(self, x0) -> LoopState:
        B = x0.shape[0]
        sim = initial_sim_state(self.model, self.info, x0)
        _, x_obs = self._observe(sim.q, sim.v)
        zero = torch.zeros(B, dtype=self.dtype, device=self.device)
        no = torch.zeros(B, dtype=torch.bool, device=self.device)
        trim, yaw_ref, engaged, sol = self._solve(self._t_replan[0:1], self._grids[0], x_obs, zero, zero, no)
        return LoopState(
            q=sim.q, v=sim.v, anchor=sim.anchor, down=no, trim=trim, yaw_ref=yaw_ref, engaged=engaged,
            t_nodes=sol.t_nodes.contiguous(), x_traj=sol.x_traj, u_traj=sol.u_traj, K=sol.K, defect=sol.defect_norm,
            z_min=torch.full_like(zero, math.inf), tilt_max=torch.full_like(zero, -math.inf),
        )

    def _replan(self, t0, t_nodes, *fields) -> LoopState:
        s = LoopState(*fields)
        _, x_obs = self._observe(s.q, s.v)
        trim, yaw_ref, engaged, sol = self._solve(t0, t_nodes, x_obs, s.trim, s.yaw_ref, s.engaged,
                                                  warm=(s.t_nodes, s.x_traj, s.u_traj))
        return s._replace(trim=trim, yaw_ref=yaw_ref, engaged=engaged, t_nodes=sol.t_nodes.contiguous(),
                          x_traj=sol.x_traj, u_traj=sol.u_traj, K=sol.K, defect=sol.defect_norm)

    def _tick(self, t, *fields) -> LoopState:
        s = LoopState(*fields)
        cfg, nj = self.cfg, self.info.nj
        B = s.q.shape[0]
        rbd, x_obs = self._observe(s.q, s.v)
        pol = evaluate_policy_batch(s, t, x_obs, use_feedback=True)  # the state carries the policy's fields
        flags = self.gait.contact_flags_at(t).expand(B, -1).contiguous()
        res = wbc_update_batch(self.model, self.info, self.wbc_cfg, pol.x_star, pol.u_fb, rbd, flags)
        tau_ff = res.decision[:, -nj:]
        pos_des, vel_des = pol.x_star[:, 12 : 12 + nj], pol.u_fb[:, 12:]
        before = SimState(s.q, s.v, s.anchor)
        sim = before
        for _ in range(self.n_sub):
            tau = hybrid_pd_torque_explicit(pos_des, vel_des, cfg.joint_kp, cfg.joint_kd, tau_ff, sim.q[:, 6:])
            sim = sim_step(self.model, self.info, cfg.sim, sim, tau, joint_damping=cfg.joint_kd)[0]
        down = s.down
        if cfg.freeze_on_fall:
            # hold the last finite snapshot once fallen (a select, not a skip)
            hold = down | ~_finite(sim)
            sim = SimState(*(torch.where(hold.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
                             for a, b in zip(before, sim)))
            down = hold | self._fallen(sim)
        tilt = sim.q[:, 4].abs() + sim.q[:, 5].abs()
        return s._replace(q=sim.q, v=sim.v, anchor=sim.anchor, down=down,
                          z_min=torch.minimum(s.z_min, sim.q[:, 2]), tilt_max=torch.maximum(s.tilt_max, tilt))

    def _fallen(self, sim: SimState):
        geom = (sim.q[:, 2] < self._z_fall) | (sim.q[:, 4].abs() + sim.q[:, 5].abs() > self.cfg.fall_tilt)
        return geom | ~_finite(sim)


def _finite(sim: SimState):
    """(B,) bool: every entry of the scenario's state is finite."""
    return (torch.isfinite(sim.q).all(-1) & torch.isfinite(sim.v).all(-1)
            & torch.isfinite(sim.anchor).flatten(1).all(-1))


def _to(table, device, dtype):
    """A frozen table's tensors on ``device``: floating ones as ``dtype``."""
    return type(table)(*(a.to(device=device, dtype=dtype if a.is_floating_point() else a.dtype) for a in table))


def make_batched_closed_loop(
    iface: RobotInterface, cfg: BatchLoopConfig, wbc_cfg=None, gait: str | None = None,
    gait_at: float = 0.1, cmd_vel=None, cmd_vel_ki: float = 0.0,
    cmd_vel_kyaw: float = 0.0, cmd_vel_yaw_delay: float = 2.0,
    yaw_rate_max: float = 0.5, device=None,
) -> BatchedClosedLoop:
    """Build the episode function x0_batch (B, nx) -> BatchLoopResult on
    ``device``: the card when None (RuntimeError where CUDA is absent), the
    CPU for ``device="cpu"`` (the kernels' plain versions, no graphs).  The
    interface moves there; the solve takes the interface's settings through
    ``make_batched_solver`` (the production settings: K1, K2+K3, K4).

    The reference tables are frozen on the host over [0, duration+horizon]
    at build time (pass ``gait`` to splice a gait in at ``gait_at``; its
    periodic phases tile within the window, so the cascade steps).

    cmd_vel (vx, vy, vz, yaw_rate): every replan re-targets each scenario
    from its current observation (TargetTrajectoriesPublisher.cpp:77-100's
    cmd_vel conversion).  cmd_vel_ki: the CmdVelFollower's forward-velocity
    integral trim at the replan cadence, clamped to |cmd_vx| (default off).
    cmd_vel_kyaw: the heading hold: a per-scenario yaw reference integrates
    yaw_ref += cmd_yaw * replan_dt from the heading measured when it engages
    (at ``cmd_vel_yaw_delay``), and the commanded yaw rate is corrected by
    clip(kyaw * wrap(yaw_ref - yaw), +-yaw_rate_max) (default off)."""
    from ..runtime.controller import wbc_config_from_task

    dev = resolve_device(device)
    set_full_f32_matmul()
    if iface.device != dev:
        iface = iface.to(device=dev)
    info, settings, dtype = iface.info, iface.settings, iface.dtype
    wbc_cfg = wbc_cfg or wbc_config_from_task(iface.task)

    # the tables are frozen once, on the host in float64 (freezing tiles the
    # gait schedule, which mutates it), then moved to the device
    rm = dataclasses.replace(iface.make_reference_manager(), device="cpu", dtype=torch.float64)
    # widen the frozen window to the whole episode + horizon
    rm.max_phases = max(rm.max_phases, int(8 * (cfg.duration + 2 * rm.horizon)) + 24)
    if gait is not None:
        rm.set_gait(iface.task.gait_library[gait], start_time=gait_at)
    rm.horizon = cfg.duration + settings.horizon
    frozen = rm.freeze(0.0)
    tables = tuple(_to(tab, dev, dtype) for tab in (frozen.gait, frozen.swing, frozen.target))

    # event-aligned node grid per replan index (build_time_grid), host-side
    n_replans = int(round(cfg.duration / cfg.replan_dt))
    ev = frozen.gait.event_times.numpy()
    grids = np.stack([build_time_grid(k * cfg.replan_dt, settings.horizon, settings.num_intervals, ev)
                      for k in range(n_replans)])
    # nominal standing height for the fall detector
    z_fall = cfg.fall_z_frac * float(np.asarray(iface.initial_state)[8])
    retarget = None
    if cmd_vel is not None:
        retarget = _CmdVelRetarget(iface, cfg.replan_dt, cmd_vel, cmd_vel_ki, cmd_vel_kyaw, cmd_vel_yaw_delay,
                                   yaw_rate_max)
    capture = make_capture_hook(getattr(iface.task, "capture", None), info.nj)
    return BatchedClosedLoop(iface, cfg, wbc_cfg, tables, grids, z_fall, retarget, capture)


class _CmdVelRetarget:
    """The per-replan cmd_vel re-targeting of every scenario from its own
    observation (cmdVelToTargetTrajectories), with the trim integrator and
    the heading hold; a function of tensors (captured with the replan).

    __call__(t0 (1,), x_obs (B, nx), trim, yaw_ref, engaged (B,), cold) ->
    (trim, yaw_ref, engaged, a batched two-row TargetTable).  The cold
    solve at t = 0 re-targets with no trim and no heading correction and
    leaves the integrators as they are, as the reference's first solve."""

    def __init__(self, iface, replan_dt, cmd_vel, ki, kyaw, yaw_delay, yaw_rate_max):
        ccfg = iface.command_config
        self.cmd = [float(c) for c in np.asarray(cmd_vel, dtype=np.float64)]
        self.replan_dt, self.ki, self.kyaw = replan_dt, ki, kyaw
        self.yaw_delay, self.yaw_rate_max = yaw_delay, yaw_rate_max
        self.com_height, self.reach = ccfg.com_height, ccfg.target_reaching_duration
        # ki = 0 disables the trim entirely (the clamp collapses to 0)
        self.trim_lim = abs(self.cmd[0]) if ki else 0.0
        self.nx, self.nu = iface.info.state_dim, iface.info.input_dim
        self.default_joints = torch.as_tensor(np.asarray(ccfg.default_joint_state), dtype=iface.dtype,
                                              device=iface.device)

    def __call__(self, t0, x_obs, trim, yaw_ref, engaged, cold: bool):
        corr = torch.zeros_like(trim)
        if not cold:
            # the CmdVelFollower trim at the replan cadence
            yaw = x_obs[:, 9]
            v_fwd = torch.cos(yaw) * x_obs[:, 0] + torch.sin(yaw) * x_obs[:, 1]
            trim = torch.clamp(trim + self.ki * (self.cmd[0] - v_fwd) * self.replan_dt, -self.trim_lim,
                               self.trim_lim)
            if self.kyaw:
                on = (t0 >= self.yaw_delay).expand_as(engaged)
                # the first engaged replan anchors the reference at the measured yaw
                step = torch.where(engaged, torch.full_like(yaw_ref, self.cmd[3] * self.replan_dt),
                                   torch.zeros_like(yaw_ref))
                yaw_ref = torch.where(on & ~engaged, yaw, yaw_ref + step)
                err = torch.remainder(yaw_ref - yaw + math.pi, 2 * math.pi) - math.pi
                corr = torch.where(on, torch.clamp(self.kyaw * err, -self.yaw_rate_max, self.yaw_rate_max),
                                   torch.zeros_like(err))
                engaged = on
        return trim, yaw_ref, engaged, self._table(t0, x_obs, trim, corr)

    def _table(self, t0, x_obs, trim, corr) -> TargetTable:
        B = x_obs.shape[0]
        pose = x_obs[:, 6:12]
        zero = torch.zeros_like(trim)
        c = [torch.full_like(trim, v) for v in self.cmd]
        cmd_eff = torch.stack([c[0] + trim, c[1], c[2], c[3] + corr], dim=-1)
        v_world = (rotmat_from_zyx(pose[:, 3:6]) @ cmd_eff[:, :3, None])[..., 0]
        h = torch.full_like(trim, self.com_height)
        pose_now = torch.stack([pose[:, 0], pose[:, 1], h, pose[:, 3], zero, zero], dim=-1)
        pose_target = torch.stack([pose[:, 0] + v_world[:, 0] * self.reach, pose[:, 1] + v_world[:, 1] * self.reach,
                                   h, pose[:, 3] + cmd_eff[:, 3] * self.reach, zero, zero], dim=-1)
        joints = self.default_joints.expand(B, -1)
        row = lambda p: torch.cat([v_world, torch.zeros_like(v_world), p, joints], dim=-1)
        t0b = t0.expand(B)
        return TargetTable(times=torch.stack([t0b, t0b + self.reach], dim=-1),
                           states=torch.stack([row(pose_now), row(pose_target)], dim=1),
                           inputs=torch.zeros(B, 2, self.nu, dtype=trim.dtype, device=trim.device))


def randomized_initial_states(iface: RobotInterface, batch: int, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    """Domain-randomized initial conditions (batch, nx) around the task's
    initial state, as numpy float64: base position/orientation jitter and
    joint perturbations, ``scale`` multiplying every range.  The same
    ``np.random.default_rng`` draws in the same order as the reference's,
    so both packages start from the same states for a seed."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(iface.initial_state)
    X = np.tile(x0, (batch, 1))
    X[:, 6:8] += scale * rng.uniform(-0.05, 0.05, (batch, 2))  # base xy
    X[:, 8] += scale * rng.uniform(-0.01, 0.02, batch)  # base z
    X[:, 9:12] += scale * rng.uniform(-0.05, 0.05, (batch, 3))  # yaw/pitch/roll
    X[:, 12:] += scale * rng.uniform(-0.05, 0.05, (batch, x0.shape[0] - 12))
    return X

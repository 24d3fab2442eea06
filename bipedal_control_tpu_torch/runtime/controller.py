"""The full control cascade — BipedalController equivalent
(runtime/controller.py counterpart).

Per control tick (reference: BipedalController::update, cpp:186-276):
estimate -> observation -> (async) MPC replan -> policy interpolation ->
WBC torque QP -> hybrid joint command (posDes, velDes, kp, kd, tau_ff).

The MPC runs on the interface's device (the card unless the interface was
built with ``device="cpu"``); the observation runs on the host, in the C++
of native/host_model.cc (``native=False``: its numpy twin).  The WBC and the
estimator have two backends each:

- ``wbc_backend="host"`` (default): the WBC's model quantities in
  native/host_model.cc, its task rows, factorization and ADMM in one call
  of the port's native/host_wbc.cc: nothing of the WBC runs on the card.  ``"device"``: the WBC of
  wbc/weighted_wbc.py on the interface's device, its KKT inverted by K5;
  on the card each tick replays it from a CUDA graph captured at the first
  tick (one copy of its inputs to the card and one of the decision back).
- ``estimator="cheater"`` (default): the caller hands ``update`` the
  measured rbdState.  ``"kalman"``: the contact Kalman filter of
  estim/estimator.py on the interface's device (a CUDA graph on the card),
  fed raw sensors through ``starting_from_sensors``/``update_from_sensors``.

- Synchronous mode (``mpc_async=False``, dummy-loop style): the tick
  replans at mpcDesiredFrequency and evaluates the newest policy on the
  device; the policy point and the planned contact flags reach the host in
  one device-to-host copy, with the host backends the tick's only
  synchronisation outside a replan.
- Asynchronous mode (``mpc_async=True``): the MPC replans on a worker
  thread (runtime/async_mpc.py) and the tick evaluates its newest snapshot
  in numpy: with the host backends the tick touches no CUDA tensor.  The
  tick publishes its observation last, after its command.

tau_ff is the WBC's torque as its QP returns it, as in the JAX package.
The QP holds |tau| <= limit (torqueLimitsTask) as a hard constraint, but the
ADMM that stands in for qpOASES runs a fixed number of iterations and can
end outside the box by up to its primal residual: ``report()`` counts the
ticks whose torque left the limits and the largest excess, and
``wbc_primal_residual`` is the last tick's residual.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..estim.estimator import KalmanStateEstimator
from ..interface import RobotInterface
from ..model.host_model import centroidal_state_from_rbd_np, make_host_model
from ..model.native_model import NativeHostModel
from ..solver.sqp import scenario
from ..utils.cuda_graph import HostCall
from ..utils.timing import RepeatedTimer
from ..wbc.host_wbc import HostWbc
from ..wbc.tasks import WbcTaskConfig
from ..wbc.weighted_wbc import wbc_update
from .async_mpc import AsyncMpcRunner, contact_flags_at_np, evaluate_policy_np
from .mpc_runner import MpcRunner
from .mrt import evaluate_policy
from .safety import check_orientation


class JointCommand(NamedTuple):
    """HybridJointHandle::setCommand payload (HybridJointInterface.h:66-72)."""

    pos_des: np.ndarray
    vel_des: np.ndarray
    kp: np.ndarray
    kd: np.ndarray
    tau_ff: np.ndarray


@dataclasses.dataclass
class ControllerConfig:
    mpc_frequency: float = 50.0
    use_feedback_policy: bool = True
    joint_kp: float = 80.0  # BipedalControllerParams.cfg leg_motor_*_kp default
    joint_kd: float = 5.0
    # Asynchronous MPC worker (the reference's defining runtime split:
    # BipedalController.cpp:319-352 MPC thread at 50 Hz feeding the 400 Hz
    # control thread through a lock-free policy buffer).  When True the MPC
    # solve runs on a background thread publishing through the native
    # seqlock slot and update() never blocks on a solve; when False the
    # replan happens synchronously inside the tick (dummy-loop style).
    mpc_async: bool = False
    # State-estimator selection: "cheater" consumes ground-truth rbdState
    # (FromTopicStateEstimate semantics); "kalman" runs the contact LKF on
    # IMU + joint sensors via update_from_sensors (the estimator the
    # reference declares but never implemented — LinearKalmanFilter.h:27-67).
    estimator: str = "cheater"
    # Optional in-process WBC weight override (dynamic_reconfigure analogue,
    # BipedalController.cpp:407-478).  Persistent tuning belongs in the
    # robot's overrides.info overlay (configs/<robot>/overrides.info).
    weight_base_accel: float | None = None
    # Torque-path backend: "host" closes the WBC QP on the CPU (the
    # reference's architecture — qpOASES on the host inside the 2.5 ms tick,
    # WeightedWbc.cpp:53-81); "device" runs the WBC of wbc/weighted_wbc.py
    # on the interface's device (K5 inverts its KKT on the card).
    wbc_backend: str = "host"
    # First-order low-pass on the MEASURED joint velocities (Hz; 0 = off).
    # Contact impacts ring single-tick velocity spikes through light links,
    # which poison both the PD damping term and the MPC's momentum
    # observation; 0 keeps the raw signal.
    joint_vel_lpf_hz: float = 0.0


def wbc_config_from_task(task) -> WbcTaskConfig:
    return WbcTaskConfig(
        torque_limit_per_leg=tuple(task.wbc.torque_limits),
        friction_coefficient=task.wbc.friction_coefficient,
        swing_kp=task.wbc.swing_kp,
        swing_kd=task.wbc.swing_kd,
        base_kp=tuple(task.wbc.base_kp),
        base_kd=tuple(task.wbc.base_kd),
        no_contact_motion_tolerance=task.wbc.no_contact_motion_tolerance,
        weight_swing_leg=task.wbc.weight_swing_leg,
        weight_base_accel=task.wbc.weight_base_accel,
        weight_contact_force=task.wbc.weight_contact_force,
    )


class DeviceWbc:
    """The WBC of wbc/weighted_wbc.py on the interface's device, as the
    controller's tick calls it: numpy in, (decision, primal residual) out,
    both float64 on the host.  On the card the tick's WBC replays a CUDA
    graph captured at its first call (the counterpart of the reference's
    ``jax.jit``); :meth:`replace_config` drops the graph, so the next tick
    runs op by op with the new configuration and captures it anew."""

    def __init__(self, iface: RobotInterface, cfg: WbcTaskConfig):
        self.model, self.info, self.cfg = iface.model, iface.info, cfg
        self.dtype, self.device = iface.dtype, iface.device
        info = iface.info
        # x_star, u_fb, rbd, flags of one tick
        self._splits = (info.state_dim, info.input_dim, 2 * info.generalized_dim, 4)
        self._call = HostCall(self._step, sum(self._splits), self.dtype, self.device)

    @property
    def graphed(self) -> bool:
        return self._call.graphed

    def replace_config(self, cfg: WbcTaskConfig) -> None:
        self.cfg = cfg
        self._call = HostCall(self._step, sum(self._splits), self.dtype, self.device)

    def _step(self, packed):
        """[decision, primal residual] (ndec + 1,) of one WBC from its
        packed inputs: a function of tensors only (what the graph captures)."""
        x_star, u_fb, rbd, flags = torch.split(packed, self._splits)
        res = wbc_update(self.model, self.info, self.cfg, x_star, u_fb, rbd, flags)
        return torch.cat([res.decision, res.qp.primal_residual[None]])

    def update(self, x_star, u_fb, rbd, flags) -> tuple[np.ndarray, float]:
        out = self._call(x_star, u_fb, rbd, flags)
        return out[:-1], float(out[-1])


class BipedalController:
    """``native`` selects the host backends of the observation and the host
    WBC: the C++ of native/ (True; raises if it cannot be built) or its
    numpy twins (False).  ``backends`` records what runs."""

    def __init__(
        self,
        iface: RobotInterface,
        cfg: ControllerConfig | None = None,
        reference_manager=None,
        native: bool = True,
    ):
        self.iface = iface
        self.cfg = cfg or ControllerConfig()
        if self.cfg.wbc_backend not in ("host", "device"):
            raise ValueError(f"unknown wbc_backend {self.cfg.wbc_backend!r}")
        if self.cfg.estimator not in ("cheater", "kalman"):
            raise ValueError(f"unknown estimator {self.cfg.estimator!r}")
        # an externally built manager carries deployment state the default
        # lacks (e.g. a terrain_fn sampled from the world)
        self.mpc = MpcRunner(iface, reference_manager=reference_manager)
        self.wbc_cfg = wbc_config_from_task(iface.task)
        if self.cfg.weight_base_accel is not None:
            self.wbc_cfg = dataclasses.replace(
                self.wbc_cfg, weight_base_accel=self.cfg.weight_base_accel
            )
        self.last_yaw = 0.0
        self.last_mpc_time = -np.inf
        # per-joint PD gains, live-tunable via set_joint_gains
        self.joint_kp = np.full(iface.info.nj, self.cfg.joint_kp)
        self.joint_kd = np.full(iface.info.nj, self.cfg.joint_kd)
        self.last_wbc_decision = None
        self.torque_excess_ticks = 0  # ticks whose WBC torque left its limits
        self.max_torque_excess = 0.0  # the largest |tau| - limit over them [N m]
        self.wbc_primal_residual = 0.0  # the last tick's ADMM primal residual
        self.safe = True
        self.wbc_timer = RepeatedTimer("wbc")
        # full tick including the WBC QP (the deployment budget, task.info:178);
        # tick_ex_timer keeps the QP-excluded view for diagnosis
        self.tick_timer = RepeatedTimer("tick")
        self.tick_ex_timer = RepeatedTimer("tick_ex_wbc")
        self.staleness: list[float] = []  # t_tick - t_obs of consumed policy
        self.last_observation: tuple[float, np.ndarray] | None = None  # (t, x_obs)
        # (x_star, u_fb) the last tick tracked, float64 on the host
        self.last_policy: tuple[np.ndarray, np.ndarray] | None = None
        self.async_mpc = AsyncMpcRunner(self.mpc, self.cfg.mpc_frequency) if self.cfg.mpc_async else None

        # the observation (and the host WBC) run on the host: the model's
        # tensors come to the host once, here
        self._hm = make_host_model(iface.model, iface.info)
        graphs = lambda graphed: str(iface.device) + (" (CUDA graphs)" if graphed else "")
        self.host_wbc = self.device_wbc = None
        if self.cfg.wbc_backend == "host":
            self.host_wbc = HostWbc(iface.model, iface.info, self.wbc_cfg, hm=self._hm, native=native)
            self._nm: NativeHostModel | None = self.host_wbc.native_model
            wbc_backend = self.host_wbc.backend
        else:
            self.device_wbc = DeviceWbc(iface, self.wbc_cfg)
            self._nm = NativeHostModel(self._hm) if native else None
            wbc_backend = graphs(self.device_wbc.graphed)
        host = "native" if native else "numpy"
        self.backends = {"host_model": host, "qp": wbc_backend, "mpc": graphs(self.mpc.graphed)}
        self.estimator = None
        if self.cfg.estimator == "kalman":
            self.estimator = KalmanStateEstimator(iface.model, iface.info)
            self.backends["estimator"] = graphs(iface.device.type == "cuda")
        # synchronous mode: the measured state crosses to the card through a
        # pinned buffer without a synchronisation
        self._x_pinned = (
            torch.empty(iface.info.state_dim, dtype=iface.dtype, pin_memory=True)
            if iface.device.type == "cuda" and not self.cfg.mpc_async else None
        )

    # ------------------------------------------------------------------
    def starting(self, t: float, rbd_measured) -> None:
        """Reset + blocking initial solve (BipedalController::starting); in
        async mode the initial solve also primes the worker, which then
        replans in the background (cpp:147-157 initial-policy sync loop)."""
        self.last_yaw = float(rbd_measured[0])
        if self.host_wbc is not None:
            self.host_wbc.reset()
        x_obs = self._observation(rbd_measured)
        if self.async_mpc is not None:
            self.async_mpc.prime(t, x_obs)
            self.async_mpc.start()
        else:
            self.mpc.reset()
            self.mpc.advance(t, x_obs)
        self.last_mpc_time = t
        self.safe = True

    def stop(self) -> None:
        """Join the MPC worker (controller unload)."""
        if self.async_mpc is not None:
            self.async_mpc.stop()

    def _planned_flags(self, t: float) -> np.ndarray:
        """Planned contact flags at t from the latest policy's gait table;
        all-stance before the first policy (the reference hardcodes STANCE,
        BipedalController.cpp:372-377)."""
        if self.async_mpc is not None:
            snap = self.async_mpc.poll_policy()
            if snap is not None:
                return contact_flags_at_np(snap, t)
        elif self.mpc.last_frozen is not None:
            gait = self.mpc.last_frozen.gait
            t_dev = torch.full((1,), float(t), dtype=gait.event_times.dtype, device=gait.event_times.device)
            return gait.contact_flags_at(t_dev)[0].to(device="cpu", dtype=torch.float64).numpy()
        return np.ones(4)

    def _require_kalman(self) -> None:
        if self.estimator is None:
            raise RuntimeError("the sensor entry points need ControllerConfig(estimator='kalman')")

    def starting_from_sensors(
        self, t: float, imu_quat_wxyz, gyro_local, accel_local, joint_pos, joint_vel, base_pos_guess,
    ) -> None:
        """Kalman-estimator bring-up: seed the LKF at the known initial pose
        (the initial-pose controller hands over from a known configuration),
        then run the normal blocking initial solve."""
        self._require_kalman()
        self.estimator.reset(imu_quat_wxyz, joint_pos, base_pos_guess)
        rbd = self.estimator.update(imu_quat_wxyz, gyro_local, accel_local, joint_pos, joint_vel, np.ones(4))
        self.starting(t, rbd)

    def update_from_sensors(
        self, t: float, imu_quat_wxyz, gyro_local, accel_local, joint_pos, joint_vel, contact_flags_meas=None,
    ) -> JointCommand:
        """One control tick from raw sensors: LKF estimate -> cascade.
        contact_flags_meas (a contact-sensor readout, when the platform has
        one) overrides the planned gait flags fed to the filter."""
        self._require_kalman()
        flags = (
            np.asarray(contact_flags_meas, dtype=float) if contact_flags_meas is not None
            else self._planned_flags(t)
        )
        rbd = self.estimator.update(imu_quat_wxyz, gyro_local, accel_local, joint_pos, joint_vel, flags)
        return self.update(t, rbd)

    # -- runtime reconfigure (dynamic_reconfigure analogue,
    #    BipedalController.cpp:407-478: WBC weights + per-motor PD gains
    #    tunable on a RUNNING controller) --------------------------------
    WBC_WEIGHT_FIELDS = {
        "baseAccel": "weight_base_accel",
        "swingLeg": "weight_swing_leg",
        "contactForce": "weight_contact_force",
    }

    def set_wbc_weight(self, name: str, value: float) -> None:
        """Change one WBC task weight live (task.info weight.* names)."""
        field = self.WBC_WEIGHT_FIELDS.get(name)
        if field is None:
            raise ValueError(
                f"unknown WBC weight {name!r} (try {sorted(self.WBC_WEIGHT_FIELDS)})"
            )
        self.wbc_cfg = dataclasses.replace(self.wbc_cfg, **{field: float(value)})
        if self.host_wbc is not None:
            # constant rows rebuilt; ADMM warm-start state survives
            self.host_wbc.replace_config(self.wbc_cfg)
        else:
            # the next tick runs op by op with the new weight and recaptures
            self.device_wbc.replace_config(self.wbc_cfg)

    def set_joint_gains(self, pattern: str, kp: float, kd: float) -> int:
        """Set PD gains on every joint whose name contains ``pattern``
        (empty pattern = all).  Matching by substring gives the reference's
        left/right mirroring for free ('hip_pitch' hits both legs).
        Returns the number of joints changed."""
        hits = 0
        for j, nm in enumerate(self.iface.task.joint_names):
            if pattern in nm:
                self.joint_kp[j] = float(kp)
                self.joint_kd[j] = float(kd)
                hits += 1
        return hits

    def set_gait(self, template, start_time: float) -> None:
        """Gait command entry point, safe in both modes (GaitReceiver)."""
        if self.async_mpc is not None:
            self.async_mpc.set_gait(template, start_time)
        else:
            self.mpc.rm.set_gait(template, start_time)

    def set_target(self, target) -> None:
        """Target-trajectory command (TargetTrajectoriesPublisher sink)."""
        if self.async_mpc is not None:
            self.async_mpc.set_target(target)
        else:
            self.mpc.rm.set_target(target)

    def report(self) -> dict:
        """Runtime timing/staleness summary (the shutdown printout of
        BipedalController.cpp:44-50, plus the policy-staleness metric)."""
        out = {
            "tick": self.tick_timer.stats(),
            "tick_ex_wbc": self.tick_ex_timer.stats(),
            "wbc": self.wbc_timer.stats(),
        }
        if self.staleness:
            arr = np.asarray(self.staleness)
            out["policy_staleness_s"] = {
                "p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)),
                "max": float(arr.max()),
            }
        out["torque_excess"] = {"ticks": self.torque_excess_ticks, "max_excess_nm": self.max_torque_excess}
        if self.async_mpc is not None:
            out["mpc"] = self.async_mpc.solve_timer.stats()
            out["mpc_solves"] = self.async_mpc.solve_count
        else:
            out["mpc"] = self.mpc.timer.stats()
        return out

    def _observation(self, rbd_measured):
        rbd = np.asarray(rbd_measured, dtype=np.float64)
        if self._nm is not None:
            x = self._nm.observation(rbd)
        else:
            x = centroidal_state_from_rbd_np(self._hm, rbd)
        # yaw continuity (BipedalController.cpp:400-403): shift by 2*pi
        # multiples to land nearest the previous yaw (numpy unwrap_near)
        yaw = x[9]
        yaw = self.last_yaw + (np.mod(yaw - self.last_yaw + np.pi, 2 * np.pi) - np.pi)
        self.last_yaw = float(yaw)
        x[9] = yaw
        return x

    def _sync_policy(self, t: float, x_obs: np.ndarray):
        """Synchronous mode: replan when due, evaluate the policy on the
        device, and bring (x_star, u_fb, flags) to the host in one copy."""
        iface = self.iface
        if self._x_pinned is not None:
            self._x_pinned.numpy()[:] = x_obs
            x_dev = self._x_pinned.to(iface.device, non_blocking=True)
        else:
            x_dev = torch.as_tensor(x_obs, dtype=iface.dtype, device=iface.device)
        if t - self.last_mpc_time >= 1.0 / self.cfg.mpc_frequency - 1e-9:
            self.mpc.advance(t, x_dev)
            self.last_mpc_time = t
        sol = scenario(self.mpc.last_solution, 0)  # the one scenario
        t_dev = torch.full((1,), float(t), dtype=sol.t_nodes.dtype, device=sol.t_nodes.device)
        pol = evaluate_policy(sol, t_dev, x_dev, use_feedback=self.cfg.use_feedback_policy)
        # planned contact flags at t from the frozen gait of this solve
        # (t of shape (1,): a 0-dim index would synchronise)
        flags = self.mpc.last_frozen.gait.contact_flags_at(t_dev)[0]
        host = torch.cat([pol.x_star, pol.u_fb, flags.to(pol.x_star.dtype)]).to(
            device="cpu", dtype=torch.float64).numpy()
        nx = iface.info.state_dim
        return host[:nx], host[nx:-4], host[-4:]

    def update(self, t: float, rbd_measured) -> JointCommand:
        """One 400-500 Hz control tick.  In async mode this never blocks on
        an MPC solve: it publishes the observation, consumes the newest
        policy snapshot, and evaluates it host-side (BipedalHWLoop consumer
        semantics)."""
        tick_t0 = time.perf_counter()
        rbd = np.asarray(rbd_measured, dtype=np.float64)
        if self.cfg.joint_vel_lpf_hz > 0.0:
            nj = self.iface.info.nj
            dqj = rbd[12 + nj : 12 + 2 * nj]
            prev = getattr(self, "_dqj_filt", None)
            t_prev = getattr(self, "_lpf_t", None)
            if prev is None or t_prev is None or t <= t_prev:
                filt = dqj.copy()
            else:
                a = 1.0 - np.exp(
                    -2.0 * np.pi * self.cfg.joint_vel_lpf_hz * (t - t_prev)
                )
                filt = prev + a * (dqj - prev)
            self._dqj_filt, self._lpf_t = filt, t
            rbd = rbd.copy()
            rbd[12 + nj : 12 + 2 * nj] = filt
        x_obs = self._observation(rbd)
        self.last_observation = (t, x_obs)

        if not check_orientation(rbd):
            self.safe = False
        # worker died on an exception -> controller stop (the reference
        # shuts the controller down on an MPC-thread exception)
        if self.async_mpc is not None and self.async_mpc.failed:
            self.safe = False
        if not self.safe:
            nj = self.iface.info.nj
            zero = np.zeros(nj)
            return JointCommand(zero, zero, zero, self.joint_kd.copy(), zero)

        if self.async_mpc is not None:
            snap = self.async_mpc.poll_policy()
            self.staleness.append(t - snap.t_obs)
            pol = evaluate_policy_np(
                snap, t, x_obs, use_feedback=self.cfg.use_feedback_policy
            )
            x_star, u_fb = pol.x_star, pol.u_fb
            flags = contact_flags_at_np(snap, t)
        else:
            x_star, u_fb, flags = self._sync_policy(t, x_obs)
        self.last_policy = (x_star, u_fb)

        t_pre_wbc = time.perf_counter()
        with self.wbc_timer:
            flags = np.asarray(flags, dtype=float)
            if self.host_wbc is not None:
                # host torque path: C++ (or numpy) kinematics + ADMM, nothing
                # on the card (the reference's qpOASES-on-CPU split)
                wbc = self.host_wbc.update(x_star, u_fb, rbd, flags)
                decision_host, self.wbc_primal_residual = wbc.decision, wbc.primal_residual
            else:
                decision_host, self.wbc_primal_residual = self.device_wbc.update(x_star, u_fb, rbd, flags)
        t_post_wbc = time.perf_counter()
        # qpOASES-failure fallback: reuse last solution (WeightedWbc.cpp:77-81).
        # Only genuine failures (non-finite) reject; finite-iteration ADMM
        # residuals are normal and must not freeze the torque on a stale value.
        if np.all(np.isfinite(decision_host)) or self.last_wbc_decision is None:
            decision = decision_host
            self.last_wbc_decision = decision
        else:
            decision = self.last_wbc_decision

        nj = self.iface.info.nj
        tau = decision[-nj:]
        limits = np.tile(np.asarray(self.wbc_cfg.torque_limit_per_leg, dtype=np.float64), 2)
        excess = float(np.max(np.abs(tau) - limits))
        if excess > 0.0:
            self.torque_excess_ticks += 1
            self.max_torque_excess = max(self.max_torque_excess, excess)
        cmd = JointCommand(
            pos_des=x_star[12 : 12 + nj],
            vel_des=u_fb[12:],
            kp=self.joint_kp.copy(),
            kd=self.joint_kd.copy(),
            tau_ff=tau,
        )
        if self.async_mpc is not None:
            # published last: a replan it makes due wakes the worker, which then takes the
            # GIL as the tick ends instead of interrupting it
            self.async_mpc.set_observation(t, x_obs)
        t_end = time.perf_counter()
        self.tick_timer.samples.append(t_end - tick_t0)
        self.tick_ex_timer.samples.append((t_pre_wbc - tick_t0) + (t_end - t_post_wbc))
        return cmd

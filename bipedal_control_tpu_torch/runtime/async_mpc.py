"""Asynchronous MPC worker: the 50 Hz / 400 Hz producer-consumer split
(runtime/async_mpc.py counterpart).

The reference's defining runtime architecture is an MPC worker thread feeding
a real-time control thread through a lock-free policy buffer
(bipedal_controllers/src/BipedalController.cpp:319-352 spawns the worker;
bipedal_hw/src/BipedalHWLoop.cpp:31-85 is the SCHED_FIFO consumer; the
handoff is OCS2's MPC_MRT_Interface policy buffer).  Here:

- the control tick publishes its latest observation ``(t, x)`` through a
  native seqlock slot (``native/rt_runtime.cc`` PolicySlot — the
  realtime_tools::RealtimeBuffer equivalent);
- a background worker thread pulls the freshest observation, runs one
  warm-started solve on the interface's device (``MpcRunner.advance_frozen``,
  blocking only *itself* on the card), gathers the full policy of scenario 0
  — node grid, state/input trajectories, Riccati feedback gains, and the
  frozen gait table — into one buffer on the card, brings it to the host in
  one copy, and publishes it as one flat float64 snapshot through a second
  seqlock slot (the JAX package's layout, field for field);
- the control tick consumes whatever snapshot is newest, evaluates the
  policy host-side in numpy, and never blocks on a solve: it touches no
  CUDA tensor.

Replan pacing is gated on *observation time*, not wall time: the worker
solves again once the consumer's clock has advanced one MPC period past the
last solve's observation.  Under a real-time consumer (hardware, or a sim
running at 1x) this is exactly ``executeAndSleep(advanceMpc, 50 Hz)``
(BipedalController.cpp:332-343); under a faster/slower-than-real-time sim it
keeps the replan cadence fixed in *robot* time, which is what stability
depends on.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..utils.timing import RepeatedTimer
from .mpc_runner import MpcRunner
from .native_rt import PolicySlot


class PolicySnapshot(NamedTuple):
    """Host-side numpy view of one published policy (PrimalSolution + the
    frozen gait table it was solved under)."""

    seq: int
    t_obs: float  # observation time the solve used
    defect: float
    eq_norm: float
    solve_wall_ms: float
    t_nodes: np.ndarray  # (N+1,)
    x_traj: np.ndarray  # (N+1, nx)
    u_traj: np.ndarray  # (N, nu)
    K: np.ndarray  # (N, nu, nx)
    gait_event_times: np.ndarray  # (P,) padded +inf
    gait_contacts: np.ndarray  # (P+1, 4)


class PolicyEvalNp(NamedTuple):
    x_star: np.ndarray
    u_star: np.ndarray
    u_fb: np.ndarray


def evaluate_policy_np(
    snap: PolicySnapshot, t: float, x_measured: np.ndarray, use_feedback: bool = True
) -> PolicyEvalNp:
    """Numpy twin of runtime/mrt.py::evaluate_policy for the non-blocking
    torque path (linear interpolation + Riccati feedback term)."""
    times = snap.t_nodes
    idx = int(np.clip(np.searchsorted(times, t, side="right"), 1, times.shape[0] - 1))
    t0, t1 = times[idx - 1], times[idx]
    alpha = float(np.clip((t - t0) / max(t1 - t0, 1e-9), 0.0, 1.0))
    x_star = snap.x_traj[idx - 1] * (1 - alpha) + snap.x_traj[idx] * alpha
    iu = min(idx - 1, snap.u_traj.shape[0] - 1)
    iu1 = min(idx, snap.u_traj.shape[0] - 1)
    u_star = snap.u_traj[iu] * (1 - alpha) + snap.u_traj[iu1] * alpha
    if use_feedback:
        u_fb = u_star - snap.K[iu] @ (np.asarray(x_measured) - x_star)
    else:
        u_fb = u_star
    return PolicyEvalNp(x_star=x_star, u_star=u_star, u_fb=u_fb)


def contact_flags_at_np(snap: PolicySnapshot, t: float) -> np.ndarray:
    """(4,) planned contact flags at t from the snapshot's gait table
    (GaitTable.contact_flags_at twin)."""
    p = int(np.searchsorted(snap.gait_event_times, t, side="right"))
    return snap.gait_contacts[p]


class _PolicyLayout:
    """Fixed flat-float64 layout for one policy snapshot."""

    def __init__(self, num_nodes: int, nx: int, nu: int, max_phases: int):
        self.N1, self.nx, self.nu, self.P = num_nodes, nx, nu, max_phases
        N = num_nodes - 1
        self.sizes = [
            4,  # header: t_obs, defect, eq, solve_wall_ms
            num_nodes,  # t_nodes
            num_nodes * nx,  # x_traj
            N * nu,  # u_traj
            N * nu * nx,  # K
            max_phases,  # gait event times
            (max_phases + 1) * 4,  # gait contacts
        ]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.total = int(self.offsets[-1])
        self._staging: torch.Tensor | None = None  # pinned host buffer of one gather

    def pack(self, t_obs, sol, gait, solve_wall_ms) -> np.ndarray:
        """Scenario 0 of the batched solution ``sol`` and the frozen gait
        table's tensors, gathered on their device into one buffer and brought
        to the host in one copy (into pinned memory for a CUDA device)."""
        parts = [sol.defect_norm[0:1], sol.eq_norm[0:1], sol.t_nodes[0], sol.x_traj[0], sol.u_traj[0], sol.K[0],
                 gait.event_times, gait.contacts]
        dev = sol.x_traj.device
        gathered = torch.cat([p.reshape(-1).to(torch.float64) for p in parts])
        if dev.type == "cuda":
            if self._staging is None:
                self._staging = torch.empty(self.total - 2, dtype=torch.float64, pin_memory=True)
            self._staging.copy_(gathered, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            host = self._staging.numpy()
        else:
            host = gathered.numpy()
        out = np.empty(self.total, dtype=np.float64)
        out[0], out[3] = t_obs, solve_wall_ms
        out[1:3] = host[0:2]
        out[4:] = host[2:]
        return out

    def unpack(self, seq: int, flat: np.ndarray) -> PolicySnapshot:
        o = self.offsets
        N = self.N1 - 1
        hdr = flat[o[0] : o[1]]
        return PolicySnapshot(
            seq=seq,
            t_obs=float(hdr[0]),
            defect=float(hdr[1]),
            eq_norm=float(hdr[2]),
            solve_wall_ms=float(hdr[3]),
            t_nodes=flat[o[1] : o[2]].copy(),
            x_traj=flat[o[2] : o[3]].reshape(self.N1, self.nx).copy(),
            u_traj=flat[o[3] : o[4]].reshape(N, self.nu).copy(),
            K=flat[o[4] : o[5]].reshape(N, self.nu, self.nx).copy(),
            gait_event_times=flat[o[5] : o[6]].copy(),
            gait_contacts=flat[o[6] : o[7]].reshape(self.P + 1, 4).copy(),
        )


# sys.setswitchinterval is process-global: refcount the override so two
# runners in one process (multi-controller tests) restore the true original
# only when the last one stops, regardless of stop() ordering.
_SWITCH_LOCK = threading.Lock()
_SWITCH_COUNT = 0
_SWITCH_SAVED: float | None = None


def _acquire_fast_switch(interval: float = 2e-4) -> None:
    global _SWITCH_COUNT, _SWITCH_SAVED
    import sys

    with _SWITCH_LOCK:
        if _SWITCH_COUNT == 0:
            _SWITCH_SAVED = sys.getswitchinterval()
            sys.setswitchinterval(interval)
        _SWITCH_COUNT += 1


def _release_fast_switch() -> None:
    global _SWITCH_COUNT, _SWITCH_SAVED
    import sys

    with _SWITCH_LOCK:
        if _SWITCH_COUNT == 0:
            return
        _SWITCH_COUNT -= 1
        if _SWITCH_COUNT == 0 and _SWITCH_SAVED is not None:
            sys.setswitchinterval(_SWITCH_SAVED)
            _SWITCH_SAVED = None


class AsyncMpcRunner:
    """Background MPC worker around an :class:`MpcRunner`.

    Lifecycle: ``prime(t0, x0)`` (synchronous first solve — the blocking
    initial-policy loop of BipedalController::starting, cpp:147-157), then
    ``start()`` spawns the worker; the consumer calls ``set_observation`` and
    ``poll_policy`` every tick; ``stop()`` joins the worker.
    """

    def __init__(self, runner: MpcRunner, mpc_frequency: float = 50.0):
        self.runner = runner
        self.period = 1.0 / mpc_frequency
        iface = runner.iface
        nx, nu = iface.info.state_dim, iface.info.input_dim
        num_nodes = iface.settings.num_intervals + 1
        self.device = torch.device(iface.device)
        self._layout = _PolicyLayout(num_nodes, nx, nu, runner.rm.max_phases)
        self._obs_slot = PolicySlot(1 + nx)
        self._policy_slot = PolicySlot(self._layout.total)
        # reference-manager mutations (gait/target commands) vs the worker's
        # freeze() — the GaitReceiver mutex (GaitReceiver.cpp:50-56)
        self._rm_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # set by set_observation when a replan is due: the worker sleeps on it
        self._due = threading.Event()
        self._crashed = False
        self._last_snap: PolicySnapshot | None = None
        self._last_solved_t = -np.inf
        self.solve_timer = RepeatedTimer("mpc_async", device=self.device)
        self.solve_count = 0

    # -- commands (any thread) -----------------------------------------
    def set_gait(self, template, start_time: float) -> None:
        with self._rm_lock:
            self.runner.rm.set_gait(template, start_time)

    def set_target(self, target) -> None:
        with self._rm_lock:
            self.runner.rm.set_target(target)

    # -- consumer side (control tick) ----------------------------------
    def set_observation(self, t: float, x_obs: np.ndarray) -> None:
        self._obs_slot.write(np.concatenate([[t], np.asarray(x_obs, dtype=np.float64)]))
        if t - self._last_solved_t >= self.period - 1e-9:
            self._due.set()  # wake the worker: this observation is due for a replan

    def poll_policy(self) -> PolicySnapshot | None:
        """Latest published policy; parse cached by sequence number."""
        seq, flat = self._policy_slot.read()
        if seq == 0:
            return self._last_snap
        if self._last_snap is None or seq != self._last_snap.seq:
            self._last_snap = self._layout.unpack(seq, flat)
        return self._last_snap

    # -- worker side ----------------------------------------------------
    def prime(self, t0: float, x0) -> PolicySnapshot:
        """Synchronous first solves + publish.  Runs the replan TWICE so both
        paths (cold start and warm start) have run once — and every kernel
        library they load has been built — before the worker goes live."""
        self.runner.reset()
        x0 = np.asarray(x0, dtype=np.float64)
        self._solve_and_publish(t0, x0)
        self._solve_and_publish(t0, x0)
        return self.poll_policy()

    def _solve_and_publish(self, t_obs: float, x_obs: np.ndarray) -> None:
        t1 = time.perf_counter()
        with self._rm_lock:
            # freeze() reads the mutable gait schedule; the device solve
            # below runs outside the lock
            frozen = self.runner.rm.freeze(t_obs)
        with self.solve_timer:
            sol = self.runner.advance_frozen(t_obs, x_obs, frozen)
        wall_ms = (time.perf_counter() - t1) * 1e3
        self._policy_slot.write(self._layout.pack(t_obs, sol, frozen.gait, wall_ms))
        self._last_solved_t = t_obs
        self.solve_count += 1

    def _worker(self) -> None:
        # the interface's device, named for this thread: CUDA's current
        # device is per thread
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._worker_loop()
        else:
            self._worker_loop()

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            # sleep (the GIL released) until an observation is due for a replan.  A
            # worker that polled the slot every 0.2 ms took the GIL ~5,000 times a
            # second, and a tick running at that moment had to hand it over and wait
            # to get it back (on the slow host of an H100 80GB HBM3 machine at 700 W,
            # ~0.4 ms of the tick's p50 and ~6 ms of its p99: PERF.md §6)
            if not self._due.wait(timeout=0.05):
                continue
            self._due.clear()
            seq, obs = self._obs_slot.read()
            if seq == 0:
                continue
            t_obs, x_obs = float(obs[0]), obs[1:]
            # replan cadence in observation (robot) time
            if t_obs - self._last_solved_t < self.period - 1e-9:
                continue
            try:
                self._solve_and_publish(t_obs, x_obs)
            except Exception:  # noqa: BLE001 — worker death == controller stop
                self._crashed = True
                self._stop.set()
                raise

    def start(self) -> None:
        if self._thread is not None:
            return
        # The worker's host-side work (reference freeze, the solve's
        # enqueues, result packing) is Python holding the GIL; the
        # interpreter's default 5 ms switch interval would block the RT tick
        # for up to that long.  0.2 ms caps
        # the tick's GIL-wait at well under the 2.5 ms budget (the in-process
        # analogue of the reference's thread-priority split,
        # BipedalController.cpp:332-351 vs BipedalHWLoop SCHED_FIFO).
        _acquire_fast_switch()
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, name="mpc_worker", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._due.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
            _release_fast_switch()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive() and not self._stop.is_set()

    @property
    def failed(self) -> bool:
        """True when the worker died on an exception (as opposed to a
        deliberate stop()) — the consumer must treat the policy stream as
        dead, like the reference's MPC-thread-exception shutdown
        (BipedalController.cpp:344-348)."""
        return self._crashed

    def wait_until_fresh(self, t: float, max_staleness: float, timeout: float = 120.0) -> bool:
        """Block (sim-driver use only) until the newest policy was solved
        within ``max_staleness`` of observation time ``t``.

        A real-time deployment never calls this — wall clock paces the robot
        and the 50 Hz worker keeps up by construction.  A *simulated* plant
        can outrun the solver on a slow host, which no real system does; the
        reference's MuJoCo node solves this by slowing physics to wall clock
        (bipedal_mujoco/src/main.cc:267-389 CPU-sim sync).  This is the
        equivalent throttle for the as-fast-as-possible sim drivers.  False
        when the worker stops first or the timeout passes."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            snap = self.poll_policy()
            if snap is not None and t - snap.t_obs <= max_staleness:
                return True
            if not self.running:
                return False
            time.sleep(5e-4)
        return False

    def close(self) -> None:
        self.stop()
        self._obs_slot.close()
        self._policy_slot.close()

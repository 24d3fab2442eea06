"""Import externally recorded OCS2 trajectories and compare against our solve
(reference/ocs2_import.py counterpart: the numpy part is a copy, as the JAX
package's ``reference`` modules import jax; the solve runs the port's
``sqp_solve``).

BASELINE.md's correctness target is "control sequence bit-tolerant vs
reference OCS2 SQP", but OCS2/ROS cannot run in this environment — every
oracle in-repo is self-referential (dense-KKT) or physics-based (MuJoCo).
This module makes the claim externally testable the day reference data
exists: record a trajectory from the reference's dummy loop
(ocs2_bipedal_robot_ros/src/BipedalRobotDummyNode.cpp:44-90 prints
SystemObservation {time, state, input} at mrtDesiredFrequency), save it in
the format below, and `compare` reports per-node deviation of our solver's
trajectory from the recording.

File format (either):
- ``.npz``: arrays ``times`` (T,), ``states`` (T, nx), ``inputs`` (T, nu).
- ``.csv``: header ``t,x0..x{nx-1},u0..u{nu-1}``, one row per observation.

State/input layouts are the shared OCS2 centroidal conventions (SURVEY §1):
x = [h/m(6), basePose(6), q_j], u = [F(3*4, world), v_j]; euler-zyx angles.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RecordedTrajectory:
    times: np.ndarray  # (T,)
    states: np.ndarray  # (T, nx)
    inputs: np.ndarray  # (T, nu)

    def __post_init__(self):
        self.times = np.asarray(self.times, dtype=float)
        self.states = np.asarray(self.states, dtype=float)
        self.inputs = np.asarray(self.inputs, dtype=float)
        T = self.times.shape[0]
        if self.states.shape[0] != T or self.inputs.shape[0] != T:
            raise ValueError(
                f"length mismatch: times {T}, states {self.states.shape[0]}, "
                f"inputs {self.inputs.shape[0]}"
            )
        if np.any(np.diff(self.times) <= 0):
            raise ValueError("times must be strictly increasing")

    def state_at(self, t: float) -> np.ndarray:
        return _interp(self.times, self.states, t)

    def input_at(self, t: float) -> np.ndarray:
        return _interp(self.times, self.inputs, t)


def _interp(times, rows, t):
    idx = int(np.clip(np.searchsorted(times, t, side="right"), 1, len(times) - 1))
    t0, t1 = times[idx - 1], times[idx]
    a = 0.0 if t1 <= t0 else float(np.clip((t - t0) / (t1 - t0), 0.0, 1.0))
    return rows[idx - 1] * (1.0 - a) + rows[idx] * a


def load_recorded_trajectory(path: str) -> RecordedTrajectory:
    """Load a recorded OCS2 trajectory (.npz or .csv — format in module doc)."""
    if path.endswith(".npz"):
        z = np.load(path)
        missing = {"times", "states", "inputs"} - set(z.files)
        if missing:
            raise ValueError(f"{path}: missing arrays {sorted(missing)}")
        return RecordedTrajectory(z["times"], z["states"], z["inputs"])
    if path.endswith(".csv"):
        data = np.genfromtxt(path, delimiter=",", names=True)
        names = list(data.dtype.names)
        if names[0] != "t":
            raise ValueError(f"{path}: first column must be 't', got {names[0]}")
        xcols = [n for n in names if n.startswith("x")]
        ucols = [n for n in names if n.startswith("u")]
        arr = np.stack([data[n] for n in names], axis=1)
        nx, nu = len(xcols), len(ucols)
        return RecordedTrajectory(arr[:, 0], arr[:, 1 : 1 + nx], arr[:, 1 + nx :])
    raise ValueError(f"unsupported trajectory format: {path} (.npz or .csv)")


def save_recorded_trajectory(path: str, times, states, inputs) -> None:
    """Write the .npz form (also used to fabricate test fixtures)."""
    np.savez(path, times=np.asarray(times), states=np.asarray(states), inputs=np.asarray(inputs))


@dataclasses.dataclass
class ComparisonReport:
    """Per-node deviation of our solve vs a recorded trajectory."""

    times: np.ndarray  # (N,) node times compared at
    state_err: np.ndarray  # (N,) inf-norm per node
    input_err: np.ndarray  # (N,) inf-norm per node
    state_err_by_block: dict  # block name -> max over nodes
    input_err_by_block: dict

    @property
    def max_state_err(self) -> float:
        return float(np.max(self.state_err)) if len(self.state_err) else 0.0

    @property
    def max_input_err(self) -> float:
        return float(np.max(self.input_err)) if len(self.input_err) else 0.0

    def summary(self) -> str:
        lines = [
            f"compared {len(self.times)} nodes over "
            f"t = [{self.times[0]:.3f}, {self.times[-1]:.3f}]",
            f"state max|err|: {self.max_state_err:.3e}  "
            f"input max|err|: {self.max_input_err:.3e}",
        ]
        for name, v in self.state_err_by_block.items():
            lines.append(f"  state.{name}: {v:.3e}")
        for name, v in self.input_err_by_block.items():
            lines.append(f"  input.{name}: {v:.3e}")
        return "\n".join(lines)


def compare_trajectories(
    t_nodes, xs, us, recorded: RecordedTrajectory, nj: int
) -> ComparisonReport:
    """Compare our stacked solution (t_nodes (N,), xs (N, nx), us (N or N-1, nu))
    against the recording, interpolating the recording at our node times.
    Only the overlap of the two time ranges is compared."""
    t_nodes = np.asarray(t_nodes, dtype=float)
    xs = np.asarray(xs, dtype=float)
    us = np.asarray(us, dtype=float)
    lo, hi = recorded.times[0], recorded.times[-1]
    mask = (t_nodes >= lo - 1e-9) & (t_nodes <= hi + 1e-9)
    idx = np.nonzero(mask)[0]
    idx_u = idx[idx < us.shape[0]]
    if len(idx) == 0:
        raise ValueError(
            f"no overlap: our nodes span [{t_nodes[0]:.3f}, {t_nodes[-1]:.3f}], "
            f"recording spans [{lo:.3f}, {hi:.3f}]"
        )
    x_ref = np.stack([recorded.state_at(t) for t in t_nodes[idx]])
    u_ref = np.stack([recorded.input_at(t) for t in t_nodes[idx_u]])
    dx = np.abs(xs[idx] - x_ref)
    du = np.abs(us[idx_u] - u_ref)
    sblocks = {
        "momentum": (0, 6),
        "base_pose": (6, 12),
        "joints": (12, 12 + nj),
    }
    ublocks = {"forces": (0, 12), "joint_vel": (12, 12 + nj)}
    return ComparisonReport(
        times=t_nodes[idx],
        state_err=np.max(dx, axis=1),
        input_err=np.max(du, axis=1) if len(du) else np.zeros(0),
        state_err_by_block={k: float(np.max(dx[:, a:b])) for k, (a, b) in sblocks.items()},
        input_err_by_block={
            k: (float(np.max(du[:, a:b])) if len(du) else 0.0) for k, (a, b) in ublocks.items()
        },
    )


def compare_solve_to_recording(
    iface, recorded: RecordedTrajectory, gait: str | None = None,
    gait_start: float | None = None,
) -> ComparisonReport:
    """Solve our OCP from the recording's initial state and report deviation.

    The recording's first observation pins x_init and the solve time; the
    gait (by library name) and the target default to stance-at-initial-pose —
    pass the same gait the recording ran.  This is the one-shot analogue of
    the reference's MPC-vs-dummy-loop consistency check.  The solve is the
    port's ``sqp_solve`` at B = 1 on the interface's device and dtype, with
    the interface's settings (``"pallas"`` backends: the kernels on the card,
    their plain versions on the CPU)."""
    import torch

    from ..solver.sqp import build_refs, initial_trajectory, sqp_solve

    t0 = float(recorded.times[0])
    x0 = torch.as_tensor(recorded.states[0], dtype=iface.dtype, device=iface.device)[None]
    rm = iface.make_reference_manager()
    if gait is not None:
        rm.set_gait(
            iface.task.gait_library[gait],
            start_time=t0 if gait_start is None else gait_start,
        )
    frozen = rm.freeze(t0)
    t_nodes = frozen.t_nodes
    refs = build_refs(
        iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes
    )
    xs, us = initial_trajectory(
        iface.info, refs, x0, iface.settings.num_intervals + 1
    )
    sol = sqp_solve(
        iface.model, iface.info, iface.settings, iface.Q, iface.R,
        refs, t_nodes[None], x0, xs, us,
    )
    as_np = lambda t: t.detach().to(device="cpu", dtype=torch.float64).numpy()
    return compare_trajectories(
        as_np(t_nodes), as_np(sol.x_traj[0]), as_np(sol.u_traj[0]),
        recorded, iface.info.nj,
    )

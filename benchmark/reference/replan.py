"""The reference's replan of one robot: what the port's
``runtime/mpc_runner.py::MpcRunner.advance`` does for the plain SQP (freeze
the references at t, the capture-stepping offsets, ``build_refs``, the cold
or warm start, the solve at B = 1), on this package's frozen copies.
``capture_dq_from_state`` and ``make_capture_hook`` are copies of the
port's."""
from __future__ import annotations

import dataclasses

import torch

from .frontend import make_problem
from .solver.sqp import build_refs, initial_trajectory, sqp_solve, warm_start_trajectories


def capture_dq_from_state(cap, nj: int, x, x_ref, gait_table=None, t0=None):
    """(..., 2, nj) swing-leg joint-reference offsets from the measured
    lateral error (config.loader.CaptureConfig semantics): rotate the
    world-frame base-position / CoM-velocity errors into the body frame by
    the measured yaw, form dq = sign * clip(kp e_y + kv edot_y, +-max_offset),
    and place it on each leg's hip-roll slot.  x, x_ref (..., nx) tensors
    (a leading scenario axis for the batched closed loop); t0 a 0-dim
    tensor shared by the scenarios.

    cap.touchdown_sync (with gait_table/t0 supplied): each leg's (e_y,
    edot_y) are LIPM-propagated to that leg's next touchdown
    (GaitTable.next_touchdown_per_leg):
        e(dt) = e cosh(w dt) + (edot/w) sinh(w dt),  w = sqrt(g/z_ref)."""
    yaw = x[..., 9]
    s, c = torch.sin(yaw), torch.cos(yaw)
    pe = x[..., 6:8] - x_ref[..., 6:8]  # world base-position error
    ve = x[..., 0:2] - x_ref[..., 0:2]  # world CoM-velocity error (h/m)
    e_y = -s * pe[..., 0] + c * pe[..., 1]  # body-frame lateral components
    edot_y = -s * ve[..., 0] + c * ve[..., 1]
    # soft deadband: exactly zero in nominal locomotion
    dz = lambda v, db: torch.sign(v) * torch.clamp(torch.abs(v) - db, min=0.0)

    def _dq(e, edot):
        return cap.sign * torch.clamp(
            cap.kp * dz(e, cap.pos_deadband) + cap.kv * dz(edot, cap.vel_deadband),
            -cap.max_offset,
            cap.max_offset,
        )

    if getattr(cap, "touchdown_sync", False) and gait_table is not None:
        w = torch.sqrt(9.81 / torch.clamp(x_ref[..., 8], min=0.3))[..., None]
        # per-leg horizon to touchdown, capped at one swing's worth
        dt_td = torch.clamp(gait_table.next_touchdown_per_leg(t0) - t0, 0.0, 0.6)
        ch, sh = torch.cosh(w * dt_td), torch.sinh(w * dt_td)  # (..., 2)
        e, edot = e_y[..., None], edot_y[..., None]
        dq_legs = _dq(e * ch + (edot / w) * sh, e * w * sh + edot * ch)  # (..., 2)
    else:
        dq_legs = _dq(e_y, edot_y)[..., None].expand(e_y.shape + (2,))
    out = torch.zeros(e_y.shape + (2, nj), dtype=x.dtype, device=x.device)
    out[..., 0, cap.left_index] = dq_legs[..., 0]
    out[..., 1, cap.right_index] = dq_legs[..., 1]
    return out


def make_capture_hook(cap, nj: int):
    """(dq_fn, decay, weight_shift): dq_fn(gait, target, t_nodes, x_obs)
    returns the (2, nj) swing joint-reference offsets ((B, 2, nj) for the
    observations (B, nx) of a batched target table), or None when no
    captureStepping block is configured."""

    def dq_fn(gait, target, t_nodes, x_obs):
        if cap is None:
            return None
        return capture_dq_from_state(cap, nj, x_obs, target.state_at(t_nodes[0]), gait, t_nodes[0])

    decay = cap.decay if (cap is not None and cap.decay > 0) else None
    ws = cap.weight_shift if (cap is not None and getattr(cap, "weight_shift", 0.0) > 0) else None
    return dq_fn, decay, ws


class Replanner:
    """files, solver: the configuration's raw files and solver settings;
    gait spliced in at gait_at; reg_dtype: the configuration's dtype (its
    KKT regularisation, as in ``solve.ReferenceSolve``)."""

    def __init__(self, files: dict, solver: dict, gait: str, gait_at: float, device, dtype, reg_dtype,
                 capture: bool = True):
        iface = make_problem(files, solver, device, dtype)
        if not capture:
            iface = dataclasses.replace(iface, task=dataclasses.replace(iface.task, capture=None))
        self.iface, self.reg_dtype, self.gait, self.gait_at = iface, reg_dtype, gait, gait_at
        self.dq, self.decay, self.wshift = make_capture_hook(getattr(iface.task, "capture", None), iface.info.nj)

    def event_near(self, t: float, within: float):
        """The gait's switch time nearest to t where it lies within
        ``within`` seconds of t, else None."""
        rm = self.iface.make_reference_manager()
        rm.set_gait(self.iface.task.gait_library[self.gait], self.gait_at)
        ev = rm.gait_schedule.get_mode_schedule(t - rm.horizon, t + 2 * rm.horizon).event_times
        near = min(ev, key=lambda e: abs(e - t), default=None)
        return near if near is not None and abs(near - t) <= within else None

    def replan(self, t: float, x_obs, prev=None):
        """(solution (B = 1), xs, us: the start it stepped from) of the
        replan at t from the measured state x_obs (nx,), warm-started from
        ``prev`` = (t_nodes, x_traj, u_traj) of the previous solution (each
        with the leading axis 1), or cold where it is None."""
        it = self.iface
        T = lambda a: torch.as_tensor(a, device=it.device).to(it.dtype)
        # a manager of its own for each replan: its schedule keeps the
        # events from one horizon before t on, as a runner's that went
        # through every replan before t does (its first call tiles up to
        # t, the freeze's call drops what lies before)
        rm = it.make_reference_manager()
        rm.set_gait(it.task.gait_library[self.gait], self.gait_at)
        rm.gait_schedule.get_mode_schedule(t - rm.horizon, t + 2 * rm.horizon)
        frozen = rm.freeze(t)
        x = T(x_obs).reshape(-1)
        gait, swing, target, t_nodes = frozen.gait, frozen.swing, frozen.target, frozen.t_nodes
        dq = self.dq(gait, target, t_nodes, x)
        refs = build_refs(it.info, gait, swing, target, t_nodes, dq, self.decay, self.wshift)
        if prev is None:
            xs, us = initial_trajectory(it.info, refs, x[None], it.settings.num_intervals + 1)
        else:
            xs, us = warm_start_trajectories(*(T(p) for p in prev), t_nodes[None])
        sol = sqp_solve(it.model, it.info, it.settings, it.Q, it.R, refs, t_nodes[None], x[None], xs, us,
                        reg_dtype=self.reg_dtype)
        return sol, xs, us

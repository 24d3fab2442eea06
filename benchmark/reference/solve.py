"""The reference's batched solve of a cell's scenarios: its own problem,
tables, node grids and references from the raw files and the traffic
(each scenario's phase), its own warm-start shift, then the plain
SQP (``solver/sqp.py`` here) in blocks of scenarios so that it fits beside
what the run keeps.

``tf32=True`` computes it in float32 with TF32 matmuls allowed: the
control of a float32-with-TF32-off configuration.
"""
from __future__ import annotations

import contextlib

import torch

from .frontend import frozen_tables, lane_refs, make_problem
from .ocp.problem import NodeRefs
from .solver.sqp import initial_trajectory, sqp_solve, warm_start_trajectories


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 matmuls in TF32 (tf32) or in full float32 inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[0], prev[1]
        torch.set_float32_matmul_precision(prev[2])


class ReferenceSolve:
    """files: the configuration's raw files (absolute paths); solver: its
    solver settings; traffic: the cell's gait entries; inputs: the
    generated phase start times ``phase_t0`` and the tables' ``span``;
    reg_dtype: the configuration's dtype, whose Riccati regularisation
    (100 eps) is part of the problem it states, whatever dtype computes it."""

    def __init__(self, files: dict, solver: dict, traffic: dict, inputs: dict, device, dtype, tf32: bool = False,
                 reg_dtype=None):
        self.iface = make_problem(files, solver, device, dtype)
        self.reg_dtype = reg_dtype
        self.tf32 = tf32
        tables = frozen_tables(self.iface, traffic["gait"], traffic["gait_at"], inputs["span"])
        self.table, self.grids = lane_refs(self.iface, tables[:3], tables[3], inputs["phase_t0"])

    def solve(self, phase, x_init, warm, block: int, cold=None) -> dict:
        """Fields of the solution of every scenario in float64 (its node
        grid ``t_nodes`` too), with the start it stepped from (``xs_in``,
        ``us_in``).  phase (B,): each
        scenario's phase index; x_init (B, nx): its measured state; warm:
        (t_nodes, x_traj, u_traj) of the previous solution, shifted here onto
        the phase's grid, or None for the reference's own cold start; cold
        (B,) bool: scenarios started cold in spite of ``warm``."""
        it = self.iface
        T = lambda a: torch.as_tensor(a, device=it.device).to(it.dtype)
        idx = torch.as_tensor(phase, device=it.device).long()
        x0 = T(x_init)
        B = x0.shape[0]
        parts = {f: [] for f in ("t_nodes", "x_traj", "u_traj", "defect_norm", "step_size", "xs_in", "us_in")}
        with matmul_precision(self.tf32):
            for a in range(0, B, block):
                b = min(B, a + block)
                refs = NodeRefs(*(f.index_select(0, idx[a:b]) for f in self.table))
                t_nodes = self.grids.index_select(0, idx[a:b])
                xs, us = initial_trajectory(it.info, refs, x0[a:b], it.settings.num_intervals + 1)
                if warm is not None:
                    xw, uw = warm_start_trajectories(*(T(w[a:b]) for w in warm), t_nodes)
                    c = torch.zeros(b - a, dtype=torch.bool, device=it.device) if cold is None else \
                        torch.as_tensor(cold[a:b], device=it.device)
                    xs, us = torch.where(c[:, None, None], xs, xw), torch.where(c[:, None, None], us, uw)
                sol = sqp_solve(it.model, it.info, it.settings, it.Q, it.R, refs, t_nodes, x0[a:b], xs, us,
                                reg_dtype=self.reg_dtype)
                for f, v in (("t_nodes", t_nodes), ("x_traj", sol.x_traj), ("u_traj", sol.u_traj), ("defect_norm", sol.defect_norm),
                             ("step_size", sol.step_size), ("xs_in", xs), ("us_in", us)):
                    parts[f].append(v.double())
        return {f: torch.cat(v) for f, v in parts.items()}

    def chain(self, last: dict, steps, block: int) -> dict:
        """The reference's own chain of solves after ``last`` (fields of a
        solve of :meth:`solve`): each step (phase (B,), shift (B,) seconds
        by which the last grid's times are put back, noise (B, nx), cold
        (B,) bool, x_init (B, nx)) is the next solve, warm-started from the
        last one shifted onto its phase's grid and observing the shift's
        first state plus the noise, or cold from x_init where cold.
        Returns the last solve's fields."""
        it = self.iface
        T = lambda a: torch.as_tensor(a, device=it.device).to(it.dtype)
        for phase, shift, noise, cold, x_init in steps:
            t_nodes = self.grids.index_select(0, torch.as_tensor(phase, device=it.device).long())
            warm = (T(last["t_nodes"]) - T(shift)[:, None], T(last["x_traj"]), T(last["u_traj"]))
            with matmul_precision(self.tf32):
                x_first = warm_start_trajectories(*warm, t_nodes)[0][:, 0]
            c = torch.as_tensor(cold, device=it.device)
            x_obs = torch.where(c[:, None], T(x_init), x_first + T(noise))
            last = self.solve(phase, x_obs, warm, block, cold=c)
        return last

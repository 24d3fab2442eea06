"""Cells of batched RTI solves chained as an MPC replans (``BatchedSolver.forward``).

Traffic (``benchmark/workloads/<cell>.json``, kind "batched_solve"):
``batch`` scenarios, each at its own phase of ``gait``: one of the phases
``start_after + m * phase_step`` over one gait period, drawn from the seed,
with its own initial state (the configuration's, plus Gaussian noise of
``x_init_noise``).  Solve k of the chain is each scenario's replan
``replan_dt`` later than solve k-1: its node grid and references are its
phase's (the gait is periodic, so each scenario's time is kept modulo the
period), its warm start is solve k-1's trajectories shifted onto the new
grid, and its measured state is the shifted trajectory's first state plus
Gaussian noise of ``obs_noise`` (one of ``noise_sets`` draws, centred over
the draws).  So every solve makes a real Newton step.  Each scenario's
chain is cut into episodes of ``episode_solves`` solves (1000: the 20 s
episodes of Rudin et al., arXiv:2109.11978, at 50 Hz), at an offset of its
own: at its episode's start a scenario is solved cold from its initial
state, as a fresh robot.  Everything between solves runs on the
device from tables made in set-up; the window dispatches solves back to
back, with no host synchronisation, for its seconds.

The check, every number against the reference's solves
(``benchmark/reference``, float64, with the configuration's KKT
regularisation):
- ``step_*``: the last solve of the window, every scenario, from the same
  inputs: the reference starts from the program's solve k-1 (shifted by
  the reference itself) and its measured states;
- ``cold_*``: the first (cold) solve, every scenario, from the reference's
  own cold start;
- ``chain_*``: the program's solve ``warmup_solves`` (the end of set-up),
  on ``check.chain`` scenarios drawn from the seed, against the
  reference's own chain from its own first solve, with the traffic's
  noise draws and restarts: an error the program carries along the chain
  is compared too.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..checks import judge_solves
from ..core import sync, topology
from ..traffic import noise_pool, perturbed_states


class Driver:
    def __init__(self, cell, fault=None):
        self.cell, self.fault = cell, fault
        self.t = cell.traffic
        self.B = int(self.t["batch"])
        self.samples = {}

    # ------------------------------------------------------------ set-up
    def setup(self):
        from bipedal_control_tpu_torch.interface import make_interface
        from bipedal_control_tpu_torch.ocp.problem import make_node_refs
        from bipedal_control_tpu_torch.parallel.batch_solver import make_batched_solver
        from bipedal_control_tpu_torch.reference.manager import build_time_grid
        from bipedal_control_tpu_torch.solver.sqp import initial_trajectory, warm_start_trajectories

        from .program import frozen_tables, program_settings

        cfg, dev = self.cell.config, self.cell.device
        dtype = getattr(torch, cfg["dtype"])
        files = {k: self.cell.path(v) for k, v in cfg["files"].items()}
        iface = make_interface(files["urdf"], files["task"], files["reference"], files["gaits"], files["overrides"],
                               device=dev, dtype=dtype)
        iface = program_settings(iface, cfg)
        self.iface, self.shift = iface, warm_start_trajectories
        self.solver = make_batched_solver(iface.model, iface.info, iface.settings, iface.Q, iface.R, device=dev)
        self.inputs = self.traffic(iface)
        inp, s = self.inputs, iface.settings
        gait, swing, target, ev = frozen_tables(iface, self.t["gait"], self.t["gait_at"], inp["span"])
        grids = np.stack([build_time_grid(float(t0), s.horizon, s.num_intervals, ev) for t0 in inp["phase_t0"]])
        self.grids = torch.as_tensor(grids, dtype=dtype, device=dev)
        t = self.grids[:, :-1].contiguous()
        self.table = make_node_refs(iface.info, gait, swing, target, t, self.grids[:, 1:] - t)
        self.phase = torch.as_tensor(inp["phase"], device=dev)
        self.noise = torch.as_tensor(inp["noise"], dtype=dtype, device=dev)
        self.period = float(inp["period"])
        self.cold_start, self.E = initial_trajectory, int(self.t["episode_solves"])
        self.offset = torch.as_tensor(inp["offset"], device=dev)
        self.x0 = torch.as_tensor(inp["x_init"], dtype=dtype, device=dev)
        refs, t_nodes, _ = self.replan_inputs(0)
        x0 = self.x0
        xs, us = initial_trajectory(iface.info, refs, x0, s.num_intervals + 1)
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        sol = self.solver(refs, t_nodes, x0, xs, us)
        if self.fault is not None:
            sol = self.fault(self, sol, {"x_traj": xs, "u_traj": us})
        self.first, self.last = sol, sol
        self.k = 1
        for _ in range(int(self.t["warmup_solves"])):
            self.solve()
        # the chain's end, on the scenarios that the check follows
        lanes = np.random.default_rng([self.cell.seed, 2]).choice(self.B, min(self.B, int(self.t["check"]["chain"])),
                                                                  replace=False)
        self.chain_lanes = torch.as_tensor(np.sort(lanes), device=dev)
        self.chain_end = {f: getattr(self.last, f).index_select(0, self.chain_lanes).double()
                          for f in ("x_traj", "u_traj", "step_size")}
        sync(dev)

    def traffic(self, iface) -> dict:
        """The cell's inputs from the seed: each scenario's phase index, its
        initial state, and the pool of observation noise."""
        rng = np.random.default_rng(self.cell.seed)
        period = float(iface.task.gait_library[self.t["gait"]].duration)
        M = int(round(period / self.t["phase_step"]))
        x0 = np.asarray(iface.initial_state, dtype=np.float64)
        nx = x0.shape[0]
        return {
            "period": period,
            "phase_t0": self.t["start_after"] + np.arange(M) * self.t["phase_step"],
            "advance": int(round(self.t["replan_dt"] / self.t["phase_step"])),
            "phase": rng.integers(0, M, self.B),
            "offset": rng.integers(0, int(self.t["episode_solves"]), self.B),
            "x_init": perturbed_states(rng, x0, self.B, self.t["x_init_noise"]),
            "noise": noise_pool(rng, int(self.t["noise_sets"]), (self.B, nx), self.t["obs_noise"]),
            "span": self.t["start_after"] + 2 * period,
        }

    def replan_inputs(self, k: int):
        """(refs, node grids, wrap) of solve k: each scenario's phase index
        (phase + k * advance) mod M, and wrap = 1 where the phase passed the
        period's end since solve k-1 (its time went on by one period)."""
        M, adv = self.grids.shape[0], self.inputs["advance"]
        step = self.phase + k * adv
        idx = torch.remainder(step, M)
        wrap = torch.div(step, M, rounding_mode="floor") - torch.div(step - adv, M, rounding_mode="floor")
        refs = type(self.table)(*(f.index_select(0, idx) for f in self.table))
        return refs, self.grids.index_select(0, idx), wrap

    def cold_lanes(self, k: int):
        """(B,) bool: the scenarios whose episode starts at solve k."""
        return torch.remainder(self.offset + k, self.E) == 0

    # ------------------------------------------------------------ the work
    def solve(self):
        k, prev = self.k, self.last
        refs, t_nodes, wrap = self.replan_inputs(k)
        prev_t = prev.t_nodes - (wrap * self.period).to(prev.t_nodes.dtype)[:, None]
        xs, us = self.shift(prev_t, prev.x_traj, prev.u_traj, t_nodes)
        x_obs = xs[:, 0] + self.noise[k % self.noise.shape[0]]
        cold = self.cold_lanes(k)
        xs_c, us_c = self.cold_start(self.iface.info, refs, self.x0, t_nodes.shape[1])
        xs = torch.where(cold[:, None, None], xs_c, xs)
        us = torch.where(cold[:, None, None], us_c, us)
        x_obs = torch.where(cold[:, None], self.x0, x_obs)
        sol = self.solver(refs, t_nodes, x_obs, xs, us)
        if self.fault is not None:
            sol = self.fault(self, sol, {"x_traj": xs, "u_traj": us})
        self.prev = (k, prev, x_obs)
        self.last = sol
        self.bad += (~torch.isfinite(sol.u_traj).flatten(1).all(1)).sum()
        self.k += 1

    def window(self, seconds: float) -> dict:
        k0, dev = self.k, self.cell.device
        sync(dev)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.solve()
        sync(dev)
        wall = time.perf_counter() - t0
        solves = self.k - k0
        self.attempted, self.failed = solves * self.B, int(self.bad)
        return {"solves_per_s": solves * self.B / wall, "window_s": wall, "solves": solves}

    def trace_segment(self, profile):
        """Host enqueue of single solves (from an idle device), then solves
        back to back under the profiler."""
        dev = self.cell.device
        enq = []
        for _ in range(int(self.t["enqueue_probes"])):
            sync(dev)
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.solve"):
                self.solve()
            enq.append((time.perf_counter() - t0) * 1e3)
        sync(dev)
        n = int(self.t["trace_solves"])
        with profile() as prof:
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                with torch.profiler.record_function("bench.solve"):
                    self.solve()
            sync(dev)
            wall = time.perf_counter() - t0
        self.samples = {"enqueue_ms": enq}
        return prof, wall, {"solves": n}

    def shapes(self) -> dict:
        info, s = self.iface.info, self.iface.settings
        return {"B": self.B, "N": s.num_intervals, "nx": info.state_dim, "nu": info.input_dim, "ne": 16,
                "rk2": s.integrator == "rk2", "topology": topology(self.cell)}

    # ------------------------------------------------------------ the check
    def release(self):
        """Keep what the check reads, in float64, and free the program's
        state."""
        k, prev, x_obs = self.prev
        d = lambda a: a.double()
        _, _, wrap = self.replan_inputs(k)
        self.kept = {
            "wrap": wrap, "x_obs": d(x_obs),
            "prev": (d(prev.t_nodes), d(prev.x_traj), d(prev.u_traj)),
            "last": {f: d(getattr(self.last, f)) for f in ("x_traj", "u_traj", "step_size")},
            "first": {f: d(getattr(self.first, f)) for f in ("x_traj", "u_traj", "step_size")},
            "phase": torch.remainder(self.phase + k * self.inputs["advance"], self.grids.shape[0]),
            "cold": self.cold_lanes(k),
            "chain_lanes": self.chain_lanes.cpu(), "chain_end": self.chain_end,
        }
        del self.solver, self.iface, self.table, self.grids, self.last, self.first, self.prev, self.noise, self.x0

    @staticmethod
    def lanes_of(sol: dict, lanes) -> dict:
        return {f: v.index_select(0, lanes.to(v.device)) for f, v in sol.items()}

    def chain_steps(self, lanes):
        """The inputs of solves 1 .. warmup_solves of the scenarios
        ``lanes``, as the traffic makes them (for ``ReferenceSolve.chain``)."""
        inp, lanes = self.inputs, lanes.cpu().numpy()
        M, adv, E = len(inp["phase_t0"]), inp["advance"], self.E
        phase, offset = inp["phase"][lanes], inp["offset"][lanes]
        steps = []
        for k in range(1, int(self.t["warmup_solves"]) + 1):
            step = phase + k * adv
            wrap = step // M - (step - adv) // M
            steps.append((step % M, wrap * inp["period"], inp["noise"][k % inp["noise"].shape[0]][lanes],
                          (offset + k) % E == 0, inp["x_init"][lanes]))
        return steps

    def check(self, control: str | None = None) -> list:
        """[(name, value, limit)] of the comparison with the reference;
        ``control`` ("tf32") puts the reference in the program's place at
        that precision instead (the check's control)."""
        from ..reference.solve import ReferenceSolve

        cfg, kept, inp = self.cell.config, self.kept, self.inputs
        files = {k: self.cell.path(v) for k, v in cfg["files"].items()}
        stated = getattr(torch, cfg["dtype"])
        block = int(self.t["check"]["block"])
        make = lambda dtype, tf32=False: ReferenceSolve(files, cfg["solver"], self.t, inp, self.cell.device,
                                                        dtype, tf32, reg_dtype=stated)
        ref = make(torch.float64)
        prev_t = kept["prev"][0] - kept["wrap"].double()[:, None] * inp["period"]
        warm = (prev_t, kept["prev"][1], kept["prev"][2])
        phase0 = torch.as_tensor(inp["phase"])
        lanes = kept["chain_lanes"]
        want_last = ref.solve(kept["phase"], kept["x_obs"], warm, block, cold=kept["cold"])
        want_first = ref.solve(phase0, inp["x_init"], None, block)
        want_chain = ref.chain(self.lanes_of(want_first, lanes), self.chain_steps(lanes), block)
        got_last, got_first, got_chain = kept["last"], kept["first"], kept["chain_end"]
        if control is not None:
            ctl = make(torch.float32, tf32=control == "tf32")
            got_last = ctl.solve(kept["phase"], kept["x_obs"], warm, block, cold=kept["cold"])
            got_first = ctl.solve(phase0, inp["x_init"], None, block)
            got_chain = ctl.chain(self.lanes_of(got_first, lanes), self.chain_steps(lanes), block)
            del ctl
        lim = self.t["check"]["limits"]
        out = []
        for prefix, got, want in (("step", got_last, want_last), ("cold", got_first, want_first),
                                  ("chain", got_chain, want_chain)):
            start = {"x_traj": want["xs_in"], "u_traj": want["us_in"]}
            out += judge_solves(got, {f: want[f] for f in start}, start, got["step_size"], want["step_size"], prefix)
        return [(name, value, lim.get(name)) for name, value in out]

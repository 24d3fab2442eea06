"""Cells of one robot's MPC replans (``MpcRunner.advance``), back to back.

Traffic (``benchmark/workloads/<cell>.json``, kind "replan"): the runner
(the configuration's settings; on the card each replan replays a CUDA
graph) with ``gait`` spliced in at ``gait_at``; the first replan at
``t_start`` is cold from the configuration's initial state plus Gaussian
noise of ``x_init_noise``.  Replan k is at ``t_start + k * replan_dt``, on
one clock that runs on through the whole run, and observes the previous
solution's state at that time (the MRT's interpolation) plus Gaussian noise
of ``obs_noise`` (one of ``noise_sets`` draws from the seed, centred over
the draws).  Each replan
is timed on the host from the call to its result, which the runner
synchronises.

The check, against the reference's replans (``benchmark/reference/
replan.py``, float64 with the configuration's KKT regularisation):
- ``step_*``: the last replan of the window and ``check.samples`` more
  drawn from the seed among the window's (a reservoir sample), each from
  the program's time, measured state and previous solution;
- ``cold``: the first replan, from the same time and state;
- ``chain_*``: the program's replans 1 .. ``warmup_replans`` (the
  set-up's) against the reference's own chain of replans from the same
  initial state, times and noise draws, so that an error carried along
  the chain is compared too.
Where a gait switch falls on a replan's time (0.1 + 0.3 j s meets
0.02 k s every 15 replans), the switch's last-bit rounding decides the
first node's mode, which either side may take: such a replan is held to
the nearer of the reference's replans just before and just after the
switch.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from ..checks import lane_errors
from ..reference.runtime.mrt import evaluate_policy_batch
from ..traffic import noise_pool
from ..core import sync

# a gait switch this close to a replan's time is a tie, and the reference
# replans this far to either side of it
TIE_S, NUDGE_S = 1e-4, 1e-7


def step_error(got: dict, want: dict, start: dict):
    """One replan's step error (``checks.lane_errors``): inf where the
    program's answer is not finite, None where both sides refused the step."""
    if not all(bool(torch.isfinite(got[f]).all()) for f in start):
        return float("inf")
    if float(got["step_size"].max()) <= 0 and float(want["step_size"].max()) <= 0:
        return None
    return float(lane_errors({f: got[f] for f in start}, {f: want[f] for f in start}, start).max())


class Driver:
    def __init__(self, cell, fault=None):
        self.cell, self.fault = cell, fault
        self.t = cell.traffic
        self.samples = {}

    # ------------------------------------------------------------ set-up
    def setup(self):
        from bipedal_control_tpu_torch.interface import make_interface
        from bipedal_control_tpu_torch.runtime.mpc_runner import MpcRunner
        from bipedal_control_tpu_torch.runtime.mrt import evaluate_policy
        from bipedal_control_tpu_torch.solver.sqp import scenario, warm_start_trajectories

        from .program import program_settings

        cfg, dev = self.cell.config, self.cell.device
        dtype = getattr(torch, cfg["dtype"])
        files = {k: self.cell.path(v) for k, v in cfg["files"].items()}
        iface = program_settings(make_interface(files["urdf"], files["task"], files["reference"], files["gaits"],
                                                files["overrides"], device=dev, dtype=dtype), cfg)
        self.iface, self.policy, self.scenario, self.shift = iface, evaluate_policy, scenario, warm_start_trajectories
        self.runner = MpcRunner(iface)
        self.runner.set_gait(iface.task.gait_library[self.t["gait"]], self.t["gait_at"])
        rng = np.random.default_rng(self.cell.seed)
        x0 = np.asarray(iface.initial_state, dtype=np.float64)
        self.x_init = x0 + rng.normal(scale=self.t["x_init_noise"], size=x0.shape)
        self.noise_np = noise_pool(rng, int(self.t["noise_sets"]), x0.shape, self.t["obs_noise"])
        self.noise = torch.as_tensor(self.noise_np, dtype=dtype, device=dev)
        self.pick = np.random.default_rng([self.cell.seed, 1])
        self.reservoir, self.seen = [], 0  # replaced after set-up: the sample is drawn from the window on
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.lat = []
        t0 = float(self.t["t_start"])
        sol = self.advance(t0, torch.as_tensor(self.x_init, dtype=dtype, device=dev))
        self.first = {"t": t0, "x_obs": self.x_init, "out": self.keep(sol)}
        self.k = 1
        self.chain = []
        for _ in range(int(self.t["warmup_replans"])):
            self.replan()
            self.chain.append(self.keep(self.runner.last_solution))
        self.reservoir, self.seen, self.lat = [], 0, []

    @staticmethod
    def keep(sol) -> dict:
        return {f: getattr(sol, f).detach().double() for f in ("t_nodes", "x_traj", "u_traj", "step_size")}

    def advance(self, t: float, x):
        prev = self.runner.last_solution
        sol = self.runner.advance(t, x)
        if self.fault is not None:
            if prev is None:  # the cold start: the state held, no input
                xs, us = sol.x_traj[:, :1].expand_as(sol.x_traj).clone(), torch.zeros_like(sol.u_traj)
            else:
                xs, us = self.shift(prev.t_nodes, prev.x_traj, prev.u_traj, sol.t_nodes)
            sol = self.fault(self, sol, {"x_traj": xs, "u_traj": us})
            self.runner.last_solution = sol
        return sol

    # ------------------------------------------------------------ the work
    def replan(self):
        k, prev = self.k, self.runner.last_solution
        t = float(self.t["t_start"]) + k * float(self.t["replan_dt"])
        x_star = self.policy(self.scenario(prev, 0), t, prev.x_traj[0, 0], use_feedback=False).x_star
        x = x_star + self.noise[k % self.noise.shape[0]]
        sync(self.cell.device)
        t0 = time.perf_counter()
        sol = self.advance(t, x)
        self.lat.append((time.perf_counter() - t0) * 1e3)
        self.bad += (~torch.isfinite(sol.u_traj)).any().to(torch.int64)
        self.last = {"t": t, "x_obs": x, "prev": prev, "out": sol}
        self.seen += 1
        size = int(self.t["check"]["samples"])
        if len(self.reservoir) < size:
            self.reservoir.append(self.last)
        else:
            j = int(self.pick.integers(0, self.seen))
            if j < size:
                self.reservoir[j] = self.last
        self.k += 1

    def window(self, seconds: float) -> dict:
        k0 = self.k
        self.lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.replan()
        wall = time.perf_counter() - t0
        self.attempted, self.failed = self.k - k0, int(self.bad)
        lat = np.asarray(self.lat)
        self.window_lat = lat
        return {"replan_p95_ms": float(np.percentile(lat, 95)), "replans": len(lat), "window_s": wall}

    def trace_segment(self, profile):
        n = int(self.t["trace_replans"])
        lat = self.window_lat
        dev = self.cell.device
        with profile() as prof:
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                with torch.profiler.record_function("bench.replan"):
                    self.replan()
            sync(dev)
            wall = time.perf_counter() - t0
        self.samples = {"replan_ms": list(lat)}
        return prof, wall, {"replans": n}

    def shapes(self) -> dict:
        return {"B": 1}

    # ------------------------------------------------------------ the check
    def release(self):
        sampled = [dict(r, prev=None if r["prev"] is None else self.keep(r["prev"]), out=self.keep(r["out"]))
                   for r in self.reservoir + [self.last]]
        self.kept = {"first": self.first, "sampled": sampled, "chain": self.chain}
        del self.runner, self.iface, self.reservoir, self.last

    def check(self, control: str | None = None) -> list:
        """[(name, value, limit)]: the step errors of the sampled replans
        and the last one, of the cold replan and of the chain's replans;
        ``control`` ("tf32") puts the reference in float32
        in the program's place (the check's control)."""
        from ..reference.replan import Replanner
        from ..reference.solve import matmul_precision

        cfg = self.cell.config
        files = {k: self.cell.path(v) for k, v in cfg["files"].items()}
        stated = getattr(torch, cfg["dtype"])
        make = lambda dtype: Replanner(files, cfg["solver"], self.t["gait"], self.t["gait_at"], self.cell.device,
                                       dtype, stated, cfg.get("capture_stepping", True))
        ref = make(torch.float64)
        ctl = make(torch.float32) if control is not None else None
        as_dict = lambda sol: {f: getattr(sol, f).double() for f in ("x_traj", "u_traj", "step_size")}

        def judged(r):
            """The error of replan record r against the reference's replan
            from its time, state and start (the nearer side of a tie)."""
            p = r.get("prev")
            prev = None if p is None else (p["t_nodes"], p["x_traj"], p["u_traj"])
            got = r["out"]
            if ctl is not None:
                with matmul_precision(control == "tf32"):
                    got = as_dict(ctl.replan(r["t"], r["x_obs"], prev)[0])
            times = [r["t"]]
            ev = ref.event_near(r["t"], TIE_S)
            if ev is not None:
                times.append(ev + NUDGE_S if ev >= r["t"] else ev - NUDGE_S)
            errs = []
            for t in times:
                want, xs, us = ref.replan(t, r["x_obs"], prev)
                errs.append(step_error(got, as_dict(want), {"x_traj": xs.double(), "u_traj": us.double()}))
            # both sides refused the step on one side of a tie: they agree
            return None if None in errs else min(errs)

        def chain(side, tf32=False):
            """``side``'s own chain of replans 1 .. warmup_replans after its
            cold replan from the initial state, with the times and the noise
            draws: [(solution, the start it stepped from)]."""
            t0, dt, n = float(self.t["t_start"]), float(self.t["replan_dt"]), self.noise_np.shape[0]
            out = []
            with matmul_precision(tf32):
                sol = side.replan(t0, self.x_init, None)[0]
                for k in range(1, int(self.t["warmup_replans"]) + 1):
                    t = t0 + k * dt
                    one = SimpleNamespace(t_nodes=sol.t_nodes, x_traj=sol.x_traj, u_traj=sol.u_traj, K=None)
                    x_star = evaluate_policy_batch(one, t, sol.x_traj[:, 0], use_feedback=False).x_star[0]
                    x = x_star + torch.as_tensor(self.noise_np[k % n], dtype=x_star.dtype, device=x_star.device)
                    sol, xs, us = side.replan(t, x, (sol.t_nodes, sol.x_traj, sol.u_traj))
                    out.append((as_dict(sol), {"x_traj": xs.double(), "u_traj": us.double()}))
            return out

        def summary(errs, prefix):
            e = torch.tensor([v for v in errs if v is not None] or [float("inf")], dtype=torch.float64)
            return [(f"{prefix}_worst", float(e.max())), (f"{prefix}_median", float(e.median()))]

        cold = judged(self.kept["first"])
        wants = chain(ref)
        gots = self.kept["chain"] if ctl is None else [g for g, _ in chain(ctl, control == "tf32")]
        out = (summary(map(judged, self.kept["sampled"]), "step") + [("cold", float("inf") if cold is None else cold)]
               + summary([step_error(g, w, start) for g, (w, start) in zip(gots, wants)], "chain"))
        lim = self.t["check"]["limits"]
        return [(name, value, lim.get(name)) for name, value in out]

"""Kinematic dummy loop (sim/dummy_loop.py counterpart; the reference's
MRT_ROS_Dummy_Loop).

Closes the loop on the MPC's own model with no physics, WBC, or estimation:
integrate the centroidal flow map (RK4) under the interpolated (optionally
feedback) policy at mrtFrequency, on the interface's device, while the MPC
replans at mpcFrequency.  The states stay on the device through the run and
come to the host once, at its end.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..interface import RobotInterface
from ..model.centroidal import centroidal_flow_map
from ..runtime.mpc_runner import MpcRunner
from ..runtime.mrt import evaluate_policy
from ..solver.sqp import scenario


@dataclasses.dataclass
class DummyLoopResult:
    times: np.ndarray  # (T,)
    states: np.ndarray  # (T, nx)
    inputs: np.ndarray  # (T, nu)
    mpc_stats: dict


def run_dummy_loop(
    iface: RobotInterface,
    mpc: MpcRunner,
    x0,
    t0: float = 0.0,
    duration: float = 1.0,
    mrt_frequency: float = 400.0,
    mpc_frequency: float = 50.0,
    use_feedback: bool = True,
    on_step=None,
) -> DummyLoopResult:
    """``on_step(t, x)`` (optional) runs once per MRT tick: the hook a live
    command channel uses to re-target a running loop."""
    model, info = iface.model, iface.info
    dt = 1.0 / mrt_frequency

    def step(x, u):
        f = lambda xx: centroidal_flow_map(model, info, xx, u)
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        k3 = f(x + 0.5 * dt * k2)
        k4 = f(x + dt * k3)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    x = torch.as_tensor(x0, dtype=iface.dtype, device=iface.device).reshape(-1)
    t = t0
    mpc.reset()
    mpc.advance(t, x)
    last_plan = t

    times, states, inputs = [], [], []
    n_steps = int(round(duration * mrt_frequency))
    for _ in range(n_steps):
        if on_step is not None:
            on_step(t, x)
        if t - last_plan >= 1.0 / mpc_frequency - 1e-9:
            mpc.advance(t, x)
            last_plan = t
        sol = scenario(mpc.last_solution, 0)  # the one scenario
        pol = evaluate_policy(sol, t, x, use_feedback=use_feedback)
        times.append(t)
        states.append(x)
        inputs.append(pol.u_fb)
        x = step(x, pol.u_fb)
        t += dt
    return DummyLoopResult(
        times=np.asarray(times),
        states=torch.stack(states).cpu().numpy(),
        inputs=torch.stack(inputs).cpu().numpy(),
        mpc_stats=mpc.timer.stats(),
    )

#!/usr/bin/env python
"""RTI line-search candidate safety sweep of the PyTorch port on one GPU.

    python3 tools/alpha_sweep_torch.py

The port's counterpart of tools/alpha_sweep.py: whether a single-candidate
line search (alphas (1.0,)) is as safe as the two-candidate one ((1.0,
0.5)) in the situations where a fixed step could misbehave: a cold start, a
gait switch mid-run, state disturbances and stale observations.  Each runs
the port's MpcRunner (the production backends, interface.production_settings:
K1, K2+K3 and K4 on the card; one SQP iteration) in float64 with
runtime/mrt.py::evaluate_policy following the plan, as the reference tool
does.  The robot is H1 when $BIPEDAL_ASSETS holds it, otherwise G1's
configuration on the synthetic G1-shaped URDF of tests/data.

It writes build/SWEEP_ALPHAS_torch.json, never the committed
SWEEP_ALPHAS_r03.json (the reference's record), and prints each run's line
and the verdict: the single candidate's worst defect within 2x of the two
candidates' (or below 5e-3) in every situation.  It runs on the card and
raises without CUDA.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bipedal_control_tpu_torch.graft_entry import default_interface, default_robot  # noqa: E402
from bipedal_control_tpu_torch.interface import production_settings  # noqa: E402
from bipedal_control_tpu_torch.runtime.mpc_runner import MpcRunner  # noqa: E402
from bipedal_control_tpu_torch.runtime.mrt import evaluate_policy  # noqa: E402
from bipedal_control_tpu_torch.solver.sqp import scenario  # noqa: E402

OUT = os.path.join(REPO, "build", "SWEEP_ALPHAS_torch.json")


def _step(iface, mpc, t, x):
    """One replan at t from x; (solution of the scenario, the plan's state at t + 0.02)."""
    sol = scenario(mpc.advance(t, x), 0)
    x_next = evaluate_policy(sol, t + 0.02, torch.as_tensor(x, dtype=iface.dtype, device=iface.device)).x_star
    return sol, x_next.cpu().numpy()


def run_sweep(iface, alphas) -> dict:
    iface = dataclasses.replace(iface, settings=dataclasses.replace(
        iface.settings, sqp_iterations=1, linesearch_alphas=tuple(alphas)))
    gaits = iface.task.gait_library
    x_init = np.asarray(iface.initial_state)
    out = {}

    # cold start: repeated RTI solves from the Initializer trajectory
    mpc = MpcRunner(iface)
    mpc.rm.set_gait(gaits["trot"], start_time=0.1)
    defects = [float(scenario(mpc.advance(0.0, x_init), 0).defect_norm) for _ in range(8)]
    out["cold"] = {"defects": defects, "final": defects[-1]}

    # rolling replans with a gait switch at t = 0.5 and a switch back at 1.0
    mpc = MpcRunner(iface)
    x, defects, steps = x_init, [], []
    for k in range(75):  # 1.5 s at 50 Hz
        t = 0.02 * k
        if k == 25:
            mpc.rm.set_gait(gaits["trot"], start_time=t + 0.1)
        if k == 50:
            mpc.rm.set_gait(gaits["stance"], start_time=t + 0.1)
        sol, x = _step(iface, mpc, t, x)
        defects.append(float(sol.defect_norm))
        steps.append(float(sol.step_size))
    out["gait_switch"] = {"max_defect_after_warmup": float(np.max(defects[5:])), "final": defects[-1],
                          "min_step": float(np.min(steps))}

    # disturbance: 0.3 m/s lateral velocity + 5 cm base drops mid-run
    mpc = MpcRunner(iface)
    mpc.rm.set_gait(gaits["trot"], start_time=0.1)
    x, defects = x_init, []
    for k in range(40):
        t = 0.02 * k
        if k in (15, 25):
            x = x.copy()
            x[1] += 0.3  # lateral momentum kick
            x[8] -= 0.05  # base drop
        sol, x = _step(iface, mpc, t, x)
        defects.append(float(sol.defect_norm))
    out["disturbance"] = {"max_defect_after_warmup": float(np.max(defects[5:])), "final": defects[-1]}

    # stale observation: the state from two replans ago
    mpc = MpcRunner(iface)
    mpc.rm.set_gait(gaits["trot"], start_time=0.1)
    x_hist, defects = [x_init] * 3, []
    for k in range(40):
        t = 0.02 * k
        sol = scenario(mpc.advance(t, x_hist[0]), 0)  # 40 ms stale
        defects.append(float(sol.defect_norm))
        x_new = evaluate_policy(sol, t + 0.02, torch.as_tensor(x_hist[-1], dtype=iface.dtype,
                                                                device=iface.device)).x_star
        x_hist = x_hist[1:] + [x_new.cpu().numpy()]
    out["stale_obs"] = {"max_defect_after_warmup": float(np.max(defects[5:])), "final": defects[-1]}
    return out


def main():
    card = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
    iface = default_interface()  # on the card: raises without CUDA
    iface.settings = production_settings(iface.settings, iface.info)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    s = iface.settings
    results = {"robot": default_robot()[1], "device": {"kind": card, "nvidia_smi": smi},
               "backends": {"linearize": s.linearize, "riccati": s.riccati, "merit": s.merit},
               "dtype": str(iface.dtype)}
    for name, alphas in [("two", (1.0, 0.5)), ("one", (1.0,))]:
        t0 = time.perf_counter()
        results[name] = run_sweep(iface, alphas)
        results[name]["wall_s"] = time.perf_counter() - t0
        print(name, json.dumps(results[name]), flush=True)
    # the single candidate's worst defect within 2x of the two candidates'
    # in every situation, and absolutely small
    ok = True
    for scen in ("cold", "gait_switch", "disturbance", "stale_obs"):
        a = results["one"][scen].get("max_defect_after_warmup", results["one"][scen]["final"])
        b = results["two"][scen].get("max_defect_after_warmup", results["two"][scen]["final"])
        if not (a < max(2.0 * b, 5e-3)):
            ok = False
    results["equivalent"] = ok
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(results, fh, indent=1)
    print("equivalent:", ok, "->", OUT)


if __name__ == "__main__":
    main()

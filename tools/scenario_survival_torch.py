"""Domain-randomized batched-walking survival sweep of the PyTorch port on one GPU.

    python3 tools/scenario_survival_torch.py
    SURV_BATCH=64 SURV_DURATION=1.0 SURV_SCALES=1.0 python3 tools/scenario_survival_torch.py

The port's counterpart of tools/scenario_survival.py: the on-device walking
cascade (bipedal_control_tpu_torch/sim/batch_loop.py: replan -> policy ->
whole-body QP -> PD -> physics, replayed from CUDA graphs) over randomized
initial states at several jitter scales, recording per scale the survival
fraction (upright AND progressed), the upright, progressed, finite and fell
fractions, and the wall time.  It runs on the card and raises without CUDA.

Survival (per scenario, cmd_vel for `duration` s of walking): final base z
above 0.82 of the commanded CoM height, max tilt below 0.8 rad, forward
progress beyond 0.3 * cmd * duration.

Settings (environment; the reference tool's names): SURV_BATCH (64),
SURV_DURATION (3.0 s), SURV_SCALES ("0.5,1.0,1.5,2.0"), SURV_CMD (0.3 m/s),
SURV_GAIT ("trot", spliced in at 0.2 s), SURV_ROBOT ("g1": G1's
configuration on its URDF from $BIPEDAL_ASSETS, else on the committed
synthetic G1-shaped URDF; another name needs its assets), SURV_RICCATI
("pallas"), SURV_RICCATI_PENALTY (1e4), SURV_SQP_ITERS (1), SURV_CMD_KI
(0), SURV_KYAW (0), SURV_CAPTURE ("on"; "off" drops captureStepping),
SURV_CAP_KV/KP/MAXOFF/POSDB/VELDB (capture gains), SURV_SEED (7),
SURV_OUT (build/SCENARIOS_torch.json).  The linearization and the merit
run the production backends (interface.production_settings: "pallas", K1
and K4 where they implement the robot's configuration; with SURV_RICCATI at
its default, K2+K3 too).  The episode runs in float32, except with
SURV_RICCATI="parallel", whose dense scan refuses float32 and so runs in
float64; the output names the backends and the dtype.  The settings
SURV_MATMUL_PRECISION and SURV_REGS of the reference tool are TPU and JAX
knobs and have no counterpart: float32 matmuls run in full float32
(utils/precision.py).  The node step is dt 0.02 as in the reference tool.
It never overwrites the committed SCENARIOS_r0*.json, the reference's TPU
records.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bipedal_control_tpu_torch.interface import make_interface, make_interface_for, production_settings  # noqa: E402
from bipedal_control_tpu_torch.robots import get_assets  # noqa: E402
from bipedal_control_tpu_torch.sim.batch_loop import (  # noqa: E402
    BatchLoopConfig,
    make_batched_closed_loop,
    randomized_initial_states,
)

G1_SHAPED_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")


def load_robot(name: str, dtype):
    """(interface on the card, its description): G1's configuration on the
    committed G1-shaped URDF when $BIPEDAL_ASSETS lacks G1's own."""
    if name == "g1":
        g1 = get_assets("g1")
        urdf, desc = g1.urdf, f"unitree G1 ({g1.urdf})"
        if not (os.environ.get("BIPEDAL_ASSETS") and os.path.exists(urdf)):
            urdf, desc = G1_SHAPED_URDF, "G1-shaped synthetic biped (G1 URDF not in $BIPEDAL_ASSETS)"
        return make_interface(urdf, g1.task_info, g1.reference_info, g1.gait_info, g1.overrides_info,
                              dtype=dtype), desc
    return make_interface_for(name, dtype=dtype), name


def output_path() -> str:
    path = os.path.abspath(os.environ.get("SURV_OUT", os.path.join(REPO, "build", "SCENARIOS_torch.json")))
    if os.path.dirname(path) == REPO and fnmatch.fnmatch(os.path.basename(path), "SCENARIOS_r0*.json"):
        raise ValueError(f"{path} is a committed record of the JAX package on a TPU; write elsewhere")
    return path


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def main():
    batch = int(os.environ.get("SURV_BATCH", "64"))
    duration = float(os.environ.get("SURV_DURATION", "3.0"))
    scales = [float(s) for s in os.environ.get("SURV_SCALES", "0.5,1.0,1.5,2.0").split(",")]
    cmd = (float(os.environ.get("SURV_CMD", "0.3")), 0.0, 0.0, 0.0)
    gait_name = os.environ.get("SURV_GAIT", "trot")
    robot = os.environ.get("SURV_ROBOT", "g1")
    riccati = os.environ.get("SURV_RICCATI", "pallas")
    dtype = torch.float64 if riccati == "parallel" else torch.float32
    path = output_path()

    iface, desc = load_robot(robot, dtype)
    settings = production_settings(iface.settings, iface.info)
    settings = dataclasses.replace(
        settings, dt=0.02, sqp_iterations=int(os.environ.get("SURV_SQP_ITERS", "1")),
        riccati_penalty=float(os.environ.get("SURV_RICCATI_PENALTY", "1e4")), riccati=riccati,
    )
    iface = dataclasses.replace(iface, settings=settings)
    backends = {"linearize": settings.linearize, "riccati": settings.riccati, "merit": settings.merit}
    capture_on = os.environ.get("SURV_CAPTURE", "on") != "off"
    if not capture_on:
        iface = dataclasses.replace(iface, task=dataclasses.replace(iface.task, capture=None))
    elif iface.task.capture is not None:
        cap_over = {
            field: float(os.environ[env])
            for field, env in (("kv", "SURV_CAP_KV"), ("kp", "SURV_CAP_KP"), ("max_offset", "SURV_CAP_MAXOFF"),
                               ("pos_deadband", "SURV_CAP_POSDB"), ("vel_deadband", "SURV_CAP_VELDB"))
            if os.environ.get(env)
        }
        if cap_over:
            print("capture overrides:", cap_over)
            iface = dataclasses.replace(
                iface, task=dataclasses.replace(iface.task, capture=dataclasses.replace(iface.task.capture, **cap_over))
            )
    run = make_batched_closed_loop(
        iface, BatchLoopConfig(duration=duration), gait=gait_name, gait_at=0.2, cmd_vel=cmd,
        cmd_vel_ki=float(os.environ.get("SURV_CMD_KI", "0.0")), cmd_vel_kyaw=float(os.environ.get("SURV_KYAW", "0.0")),
    )

    # upright = z above ~82% of the commanded CoM height, tilt < 0.8 rad,
    # progress > 30% of the commanded distance
    z_floor = 0.82 * float(iface.task.com_height)
    out = {
        "metric": "randomized_walking_survival",
        "robot": robot,
        "robot_description": desc,
        "gait": gait_name,
        "z_floor": round(z_floor, 3),
        "batch": batch,
        "duration_s": duration,
        "cmd_vel": cmd[0],
        "platform": "gpu",
        "device": card(),
        "dtype": str(dtype).replace("torch.", ""),
        "backends": backends,
        "riccati": backends["riccati"],
        "matmul_precision": torch.get_float32_matmul_precision(),
        "capture_stepping": capture_on and iface.task.capture is not None,
        "sqp_iterations": iface.settings.sqp_iterations,
        "num_intervals": iface.settings.num_intervals,
        "per_scale": [],
    }
    print(f"[survival] {out['device']}; {desc}; B = {batch}, {duration} s, backends {backends}, {out['dtype']}")
    progress_min = 0.3 * cmd[0] * duration
    seed = int(os.environ.get("SURV_SEED", "7"))
    for scale in scales:
        X = randomized_initial_states(iface, batch, seed=seed, scale=scale)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(X)
        q = res.final_state.q.to(device="cpu", dtype=torch.float64).numpy()  # the episode's one synchronisation
        wall = time.perf_counter() - t0
        tilt = res.tilt_max.to(device="cpu", dtype=torch.float64).numpy()
        fell = res.fell.cpu().numpy()
        finite = np.isfinite(q).all(axis=1)
        upright = finite & (np.nan_to_num(q[:, 2]) > z_floor) & (np.nan_to_num(tilt, nan=np.inf) < 0.8)
        progressed = finite & (np.nan_to_num(q[:, 0]) > progress_min)
        surv = upright & progressed
        out["per_scale"].append(
            {
                "jitter_scale": scale,
                "survival_frac": float(np.mean(surv)),
                "upright_frac": float(np.mean(upright)),
                "progressed_frac": float(np.mean(progressed)),
                "finite_frac": float(np.mean(finite)),
                "fell_frac": float(np.mean(fell)),
                "x_mean_m": float(np.mean(q[finite, 0])) if finite.any() else None,
                "z_final_mean_m": float(np.mean(q[finite, 2])) if finite.any() else None,
                "wall_s": wall,
                "scenario_s_per_s": batch * duration / wall,
                # the first episode runs each step op by op once and captures its CUDA graph
                "includes_graph_capture": scale == scales[0],
            }
        )
        print(json.dumps(out["per_scale"][-1]), flush=True)

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()

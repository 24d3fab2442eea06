"""Command-line entry points mirroring the reference's node set (cli.py
counterpart):

  python -m bipedal_control_tpu_torch.cli plan   — planner-only dummy loop
                  (bipedal_robot_sqp.launch / dummy node)
  python -m bipedal_control_tpu_torch.cli sim    — MuJoCo closed loop with the
                  full MPC+WBC cascade (bringup_mujoco.launch + restart_mujoco.py)
  python -m bipedal_control_tpu_torch.cli gaits  — list the robot's gait
                  library (GaitKeyboardPublisher's menu)
  python -m bipedal_control_tpu_torch.cli bench-scaling — solves/s
                  weak-scaling table over mesh sizes 1, 2, 4, .., W ranks
  torchrun --nproc-per-node N -m bipedal_control_tpu_torch.cli bench-scaling
                  — the same over N cards, one process per card

All take --robot {h1,g1,hunter,openloong} (assets resolved via
$BIPEDAL_ASSETS), with the JAX command line's flags and defaults.  The JAX
command line's bench (bench.py) has no counterpart here yet: it waits for
the port's own benchmark.  bench-scaling initialises a world of one when no
process group is initialised (under torchrun: torchrun's, env://), and its
rank 0 prints one JSON line per scaling point.

The commands run on the card: without CUDA they raise.  From Python,
``main(argv, device="cpu")`` runs them on the CPU and ``dtype=`` sets the
interface's dtype (float64 by default).  The MPC runs the port's production
backends (``interface.production_settings``: linearize, riccati and merit
"pallas", K1, K2+K3 and K4 on the card and their plain versions on the CPU,
each where its kernel implements the robot's configuration), and ``plan``
and ``sim`` print the backends they chose.  ``sim`` needs the ``mujoco``
package and ``plan --viz`` matplotlib; each is imported inside the function
that needs it, so the module imports without them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from .utils.device import resolve_device


def _add_robot_arg(p):
    p.add_argument("--robot", default="h1", choices=["h1", "g1", "hunter", "openloong"])


def _interface(args):
    from .interface import make_interface_for, production_settings

    iface = make_interface_for(args.robot, device=args.device, dtype=args.dtype)
    iface.settings = production_settings(iface.settings, iface.info)
    s = iface.settings
    print(f"backends: linearize {s.linearize}, riccati {s.riccati}, merit {s.merit}")
    return iface


def cmd_plan(args):
    from .reference.target import cmd_vel_to_target_trajectories
    from .runtime.mpc_runner import MpcRunner
    from .sim.dummy_loop import run_dummy_loop

    iface = _interface(args)
    mpc = MpcRunner(
        iface,
        solver=getattr(args, "solver", "sqp"),
        ddp_iterations=getattr(args, "ddp_iterations", None),
    )
    if args.gait != "stance":
        mpc.rm.set_gait(iface.task.gait_library[args.gait], start_time=0.1)
    x0 = np.asarray(iface.initial_state)
    if any(abs(v) > 0 for v in args.cmd_vel):
        mpc.rm.set_target(
            cmd_vel_to_target_trajectories(
                np.asarray(args.cmd_vel), 0.0, x0, iface.command_config, iface.info.input_dim
            )
        )
    res = run_dummy_loop(
        iface, mpc, x0, duration=args.duration,
        mrt_frequency=args.mrt_frequency, mpc_frequency=args.mpc_frequency,
    )
    base = res.states[:, 6:12]
    print(f"ran {args.duration}s: base z [{base[:, 2].min():.3f}, {base[:, 2].max():.3f}], "
          f"xy displacement ({base[-1, 0] - base[0, 0]:.3f}, {base[-1, 1] - base[0, 1]:.3f})")
    print("mpc timing:", json.dumps(res.mpc_stats))
    if args.out:
        np.savez(args.out, times=res.times, states=res.states, inputs=res.inputs)
        print("saved trajectory to", args.out)
    if args.viz:
        from .runtime.visualizer import Visualizer

        viz = Visualizer(iface.model, iface.info, max_update_frequency=100.0)
        for t, x, u in zip(res.times, res.states, res.inputs):
            viz.update(t, x, u)
        viz.save_figure(args.viz)
        if args.viz.endswith(".png"):
            viz.export_json(args.viz[:-4] + ".json")
        print("saved visualization to", args.viz)
    return 0


def cmd_sim(args):
    import mujoco  # where it is missing, the ImportError comes before anything is built

    from .robots import get_assets
    from .runtime.controller import BipedalController, ControllerConfig
    from .sim.mujoco_backend import MujocoSimBackend, MujocoSimConfig

    iface = _interface(args)
    assets = get_assets(args.robot)
    mjcf = assets.mjcf
    if not mjcf:
        # no vendor scene (e.g. Hunter): generate one from the URDF, with
        # the per-robot actuator model (simulation.jointArmature) applied
        from .sim.urdf_mjcf import build_mjcf_scene_from_urdf

        mjcf = build_mjcf_scene_from_urdf(
            assets.urdf, list(iface.task.joint_names),
            armature=iface.task.sim_joint_armature,
        )
        print(f"generated scene: {mjcf}")
    sim = MujocoSimBackend(
        mjcf, list(iface.task.joint_names),
        MujocoSimConfig(command_delay_s=args.delay),
    )
    upper = {}
    if iface.task.upper_joint_names and iface.task.default_upper_joint_state is not None:
        upper = dict(zip(iface.task.upper_joint_names, iface.task.default_upper_joint_state))
    x0 = iface.initial_state
    sim.reset(
        base_pos=x0[6:9], base_quat_wxyz=np.array([1.0, 0, 0, 0]),
        joint_pos=x0[12:], upper_joint_targets=upper,
    )
    ctrl = BipedalController(
        iface,
        ControllerConfig(mpc_async=args.mpc_async, estimator=args.estimator),
    )
    channel = None
    viewer = None
    try:
        if args.gait != "stance":
            ctrl.set_gait(iface.task.gait_library[args.gait], start_time=sim.time + 0.3)
        if args.estimator == "kalman":
            imu = sim.imu()
            qj, dqj = sim.joint_states()
            ctrl.starting_from_sensors(
                sim.time, imu["imu_quat"], imu["imu_gyro"], imu["imu_acc"], qj, dqj,
                base_pos_guess=sim.ground_truth()[0],
            )
        else:
            ctrl.starting(sim.time, sim.rbd_state())
        if args.interactive:
            from .runtime.commands import CommandRouter, StdinCommandChannel

            router = CommandRouter(ctrl, iface, observation=lambda: ctrl.last_observation)
            channel = StdinCommandChannel(router)
            channel.start()
        interact = None
        if getattr(args, "view", False):
            # live 3D window (the role of the reference's vendored MuJoCo
            # `simulate` GUI, bipedal_mujoco/src/main.cc:505-556) — a
            # passive viewer synced once per control tick, with the GUI's
            # interactive control surface (sim/interactive.py): SPACE
            # pause, -/= slow-motion, p lateral push, n sensor noise; the
            # passive viewer natively adds mouse perturbation
            import mujoco.viewer

            from .sim.interactive import SimInteraction

            interact = SimInteraction()
            try:
                if sys.platform.startswith("linux") and not (
                    os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
                ):
                    # MuJoCo's window fails to initialise GLFW without a display
                    # and ends the process (exit code 1) instead of raising
                    raise RuntimeError("no display: neither DISPLAY nor WAYLAND_DISPLAY is set")
                viewer = mujoco.viewer.launch_passive(
                    sim.model, sim.data, key_callback=interact.key_callback
                )
            except Exception as e:  # noqa: BLE001 — headless hosts
                print(f"viewer unavailable ({e}); continuing headless", file=sys.stderr)
                interact = None
        control_dt = 1.0 / args.control_frequency
        substeps = max(1, int(round(control_dt / sim.timestep)))
        steps = int(round(args.duration / control_dt))
        if interact is not None:
            import time as _time

            _free = [
                j for j in range(sim.model.njnt)
                if sim.model.jnt_type[j] == mujoco.mjtJoint.mjJNT_FREE
            ]
            _base_body = int(sim.model.jnt_bodyid[_free[0]]) if _free else 1
        for k in range(steps):
            if interact is not None:
                while interact.paused and viewer is not None and viewer.is_running():
                    viewer.sync()
                    _time.sleep(0.05)
                if interact.sleep_factor() > 1.0:
                    _time.sleep((interact.sleep_factor() - 1.0) * control_dt)
                wrench = interact.push_wrench(sim.time)
                sim.data.xfrc_applied[_base_body, :] = (
                    wrench if wrench is not None else 0.0
                )
            if ctrl.async_mpc is not None:
                # sim-to-solver pacing (the MuJoCo node's CPU-sim sync):
                # never let simulated time outrun the worker by more than
                # max_staleness — a real-time plant can't either
                ctrl.async_mpc.wait_until_fresh(sim.time, args.max_staleness)
            if args.estimator == "kalman":
                imu = sim.imu()
                qj, dqj = sim.joint_states()
                if interact is not None:
                    imu, qj, dqj = interact.corrupt_sensors(imu, qj, dqj)
                cmd = ctrl.update_from_sensors(
                    sim.time, imu["imu_quat"], imu["imu_gyro"], imu["imu_acc"], qj, dqj
                )
            else:
                rbd = sim.rbd_state(last_yaw=ctrl.last_yaw)
                cmd = ctrl.update(sim.time, rbd)
            if not ctrl.safe:
                print(f"safety stop at t={sim.time:.3f}s (tilt limit)")
                break
            sim.apply_command(cmd)
            sim.step(substeps)
            if viewer is not None:
                if not viewer.is_running():
                    print("viewer closed; stopping")
                    break
                viewer.sync()
    finally:
        ctrl.stop()
        if channel is not None:
            channel.close()
        if viewer is not None:
            viewer.close()
    pos, _, _, _ = sim.ground_truth()
    print(f"sim done at t={sim.time:.2f}s base at ({pos[0]:.3f}, {pos[1]:.3f}, {pos[2]:.3f}) "
          f"safe={ctrl.safe}")
    print("report:", json.dumps(ctrl.report()))
    return 0 if ctrl.safe else 2


def cmd_gaits(args):
    from .gait.mode_schedule import MODE_NAMES
    from .interface import make_interface_for

    iface = make_interface_for(args.robot, device=args.device, dtype=args.dtype)
    for name, tpl in iface.task.gait_library.items():
        seq = "-".join(MODE_NAMES[m] for m in tpl.mode_sequence)
        print(f"{name}: duration {tpl.duration:.2f}s, sequence {seq}")
    return 0


def cmd_bench_scaling(args):
    """Weak-scaling table: solves/s at mesh sizes 1, 2, 4, .., W ranks
    (parallel/scaling.py), on the front end of bench.py's problem with
    one SQP iteration and the line-search candidates (1.0, 0.5)."""
    import torch.distributed as dist

    from .parallel.scaling import run_scaling_benchmark
    from .solver.sqp import build_refs, initial_trajectory
    from .utils.distributed import init_world

    own = not dist.is_initialized()
    if own:  # a world of one, or torchrun's (env://)
        args.device = init_world(device=args.device)
    try:
        iface = _interface(args)
        settings = dataclasses.replace(iface.settings, sqp_iterations=1, linesearch_alphas=(1.0, 0.5))
        rm = iface.make_reference_manager()
        rm.set_gait(iface.task.gait_library[args.gait], start_time=0.1)
        frozen = rm.freeze(0.0)
        refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, frozen.t_nodes)
        x0 = torch.as_tensor(np.asarray(iface.initial_state), dtype=iface.dtype, device=iface.device)[None]
        xs, us = initial_trajectory(iface.info, refs, x0, settings.num_intervals + 1)
        points = run_scaling_benchmark(
            iface.model, iface.info, settings, iface.Q, iface.R,
            refs, frozen.t_nodes[None], x0, xs, us,
            per_device_batch=args.per_device_batch, steps=args.steps,
            chips_per_host=args.chips_per_host, device=args.device,
        )
        if dist.get_rank() == 0:
            for pt in points:
                print(json.dumps(dataclasses.asdict(pt)))
    finally:
        if own:
            dist.destroy_process_group()
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bc-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan", help="planner-only dummy loop")
    _add_robot_arg(p)
    p.add_argument("--gait", default="trot")
    p.add_argument("--solver", default="sqp", choices=["sqp", "ilqr"],
                   help="replan backend: multiple-shooting SQP or AL-iLQR (DDP node analogue)")
    p.add_argument("--ddp-iterations", type=int, default=8,
                   help="iLQR iterations per replan (overrides task.info ddp.maxNumIterations)")
    p.add_argument("--duration", type=float, default=2.0)
    p.add_argument("--mrt-frequency", type=float, default=400.0)
    p.add_argument("--mpc-frequency", type=float, default=50.0)
    p.add_argument("--cmd-vel", type=float, nargs=4, default=[0, 0, 0, 0],
                   metavar=("VX", "VY", "VZ", "WYAW"))
    p.add_argument("--out", default=None, help="save trajectory .npz")
    p.add_argument("--viz", default=None, help="render markers figure (.png) + .json export")
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("sim", help="MuJoCo closed loop (MPC+WBC cascade)")
    _add_robot_arg(p)
    p.add_argument("--gait", default="stance")
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--control-frequency", type=float, default=500.0)
    p.add_argument("--delay", type=float, default=0.0, help="actuation delay [s]")
    p.add_argument("--mpc-async", action="store_true",
                   help="run the MPC on a background worker (50/400 Hz split)")
    p.add_argument("--max-staleness", type=float, default=0.2,
                   help="async mode: throttle sim so policies never age past this [s]")
    p.add_argument("--estimator", default="cheater", choices=["cheater", "kalman"],
                   help="cheater (ground truth) or the contact Kalman filter")
    p.add_argument("--view", action="store_true",
                   help="live MuJoCo 3D window (passive viewer synced per tick)")
    p.add_argument("--interactive", action="store_true",
                   help="stdin command channel: gait/cmd_vel/goal/stop on the running loop")
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("gaits", help="list gait library")
    _add_robot_arg(p)
    p.set_defaults(fn=cmd_gaits)

    p = sub.add_parser("bench-scaling", help="solves/s scaling table over mesh sizes")
    _add_robot_arg(p)
    p.add_argument("--gait", default="trot")
    p.add_argument("--per-device-batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--chips-per-host", type=int, default=None,
                   help="enable the two-level (dcn, ici) mesh above this size")
    p.set_defaults(fn=cmd_bench_scaling)
    return ap


def main(argv=None, *, device=None, dtype=None):
    """Run one command.  ``device``: None for the card (raises without
    CUDA), ``"cpu"`` for the CPU; ``dtype``: the interface's (float64 when
    None)."""
    args = build_parser().parse_args(argv)
    args.device = resolve_device(device)
    args.dtype = torch.float64 if dtype is None else dtype
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

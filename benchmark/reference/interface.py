"""The plain problem of the benchmark's reference (a frozen copy of the
port's interface.py without the kernels' tables and the robot registry).

Assembles the model, the centroidal info, the cost weights (with the
task-space R mapping), the OCP settings and a ReferenceManager from a URDF
and its config files, on the device and in the dtype asked for.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config.loader import TaskConfig, build_input_cost_weight, load_task_config
from .gait.mode_schedule import GaitSchedule, ModeSchedule
from .model.centroidal import CentroidalModelInfo, make_info
from .model.kinematics import forward_kinematics, frame_position
from .model.robot_model import RobotModel, from_description
from .model.urdf import load_urdf
from .ocp.problem import OcpSettings
from .reference.manager import ReferenceManager
from .reference.target import CommandConfig, TargetTrajectories
from .utils.device import resolve_device


@dataclasses.dataclass
class RobotInterface:
    """Bundle of model + problem data (getOptimalControlProblem analogue)."""

    model: RobotModel
    info: CentroidalModelInfo
    settings: OcpSettings
    Q: torch.Tensor
    R: torch.Tensor
    task: TaskConfig | None = None
    command_config: CommandConfig | None = None

    @property
    def device(self) -> torch.device:
        return self.model.body_mass.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    @property
    def initial_state(self) -> np.ndarray:
        return self.task.initial_state

    def make_reference_manager(self) -> ReferenceManager:
        """Fresh host-side reference manager seeded from reference.info; it
        freezes its tables on the interface's device and dtype."""
        init_sched = self.task.initial_mode_schedule
        gait = GaitSchedule(
            ModeSchedule(list(init_sched.event_times), list(init_sched.mode_sequence)),
            self.task.default_gait,
            self.task.phase_transition_stance_time,
        )
        x0 = self.task.initial_state
        target = TargetTrajectories(
            times=np.array([0.0]),
            states=x0[None, :].copy(),
            inputs=np.zeros((1, self.info.input_dim)),
        )
        # Size the static phase table for the densest gait in this robot's
        # library: freeze() tiles over [t0-T, tf+T] (3 horizons).
        min_phase = self.task.mpc.time_horizon  # upper bound
        for tpl in self.task.gait_library.values():
            if len(tpl.mode_sequence) > 1 and tpl.duration > 0:
                min_phase = min(min_phase, tpl.duration / len(tpl.mode_sequence))
        needed = int(np.ceil(3.0 * self.task.mpc.time_horizon / max(min_phase, 1e-3))) + 8
        # body-frame contact xy offsets at the nominal pose (for the terrain
        # feed's foot-placement prediction; yaw-rotated at query time)
        model = self.model.to(device="cpu", dtype=torch.float64)
        kin = forward_kinematics(model, torch.as_tensor(np.asarray(x0, dtype=np.float64)[6:]))
        offsets = np.stack(
            [frame_position(model, kin, fid).numpy()[:2] - x0[6:8] for fid in self.info.contact_frame_ids]
        )
        return ReferenceManager(
            gait_schedule=gait,
            swing_config=self.task.swing,
            target=target,
            horizon=self.task.mpc.time_horizon,
            num_intervals=self.settings.num_intervals,
            max_phases=max(24, needed),
            foot_xy_offsets=offsets,
            device=self.device,
            dtype=self.dtype,
        )


def ocp_settings_from_task(task) -> OcpSettings:
    """task.info sqp/ipm blocks -> OcpSettings.  When the task selects the
    hard cone (useAnalyticalGradientsConstraints) the `ipm` block binds onto
    the barrier continuation: targetBarrierParameter -> cone_mu_final,
    barrierLinearDecreaseFactor -> cone_mu_decay, ipmIteration floors the
    iteration count.  (The port's solver implements the soft cone only.)"""
    settings = OcpSettings(
        dt=task.sqp.dt,
        horizon=task.mpc.time_horizon,
        sqp_iterations=task.sqp.sqp_iterations,
        friction_coefficient=task.friction_coefficient,
        cone=task.cone_mode,
        barrier_mu=task.sqp.inequality_constraint_mu,
        barrier_delta=task.sqp.inequality_constraint_delta,
        position_error_gain=task.position_error_gain,
        integrator=task.sqp.integrator,
    )
    if task.cone_mode == "hard":
        settings = dataclasses.replace(
            settings,
            sqp_iterations=max(task.ipm.iterations, settings.sqp_iterations),
            cone_mu_decay=task.ipm.decrease_factor,
            cone_mu_final=task.ipm.target_barrier,
        )
    return dataclasses.replace(
        settings,
        ipm_mu_init=max(task.ipm.initial_barrier, task.ipm.target_barrier),
        ipm_mu_target=task.ipm.target_barrier,
        ipm_mu_decay=task.ipm.decrease_factor,
        ipm_fraction_to_boundary=task.ipm.fraction_to_boundary,
    )


def make_interface(
    urdf_path: str,
    task_file: str,
    reference_file: str,
    gait_file: str | None = None,
    overrides_file: str | None = None,
    extra_gait_file: str | None = None,
    device=None,
    dtype=torch.float64,
) -> RobotInterface:
    device = resolve_device(device)
    task = load_task_config(
        task_file, reference_file, gait_file, overrides_file, extra_gait_file
    )
    # Upper-body joints are welded at the *held* pose (defaultUpperJointState)
    # rather than at zero, as in the JAX package.
    locked = {}
    if task.upper_joint_names and task.default_upper_joint_state is not None:
        locked = dict(
            zip(task.upper_joint_names, (float(v) for v in task.default_upper_joint_state))
        )
    desc = load_urdf(
        urdf_path,
        task.joint_names,
        locked_joint_positions=locked or None,
        extra_frames=task.extra_frames or None,
    )
    model = from_description(desc, dtype=dtype, device=device)
    info = make_info(
        model,
        task.contact_names,
        model_type=task.centroidal_model_type,
        q_j_nominal=tuple(task.initial_state[12:]) if task.centroidal_model_type == 1 else (),
    )
    R = build_input_cost_weight(model, info, task.R_task, task.initial_state)
    command_config = CommandConfig(
        com_height=task.com_height,
        default_joint_state=task.default_joint_state,
        target_displacement_velocity=task.target_displacement_velocity,
        target_rotation_velocity=task.target_rotation_velocity,
    )
    T = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    return RobotInterface(
        model=model,
        info=info,
        settings=ocp_settings_from_task(task),
        Q=T(task.Q),
        R=T(R),
        task=task,
        command_config=command_config,
    )

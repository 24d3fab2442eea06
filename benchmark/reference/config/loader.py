"""Typed robot/task configuration, loadable from OCS2-style .info files
(config/loader.py counterpart: the same parser on the port's own copy of
utils/info_format.py; :func:`build_input_cost_weight` takes the port's
RobotModel).

Users of the reference stack keep their per-robot config sets
(task.info / reference.info / gait.info, Boost INFO format); this loader reads
those files directly into a typed :class:`TaskConfig`
(utils/info_format.py handles the format), replicating the knobs documented in
SURVEY.md §5.6 knob-for-knob.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..gait.mode_schedule import MODE_BY_NAME, ModeSchedule, ModeSequenceTemplate
from ..gait.swing import SwingConfig
from ..utils import info_format as info


@dataclasses.dataclass
class SqpConfig:
    dt: float = 0.015
    sqp_iterations: int = 1
    use_feedback_policy: bool = True
    integrator: str = "rk2"
    inequality_constraint_mu: float = 0.1
    inequality_constraint_delta: float = 5.0


@dataclasses.dataclass
class DdpConfig:
    """task.info `ddp` block (reference task.info:86-156) — the knobs the
    AL-iLQR path consumes; ODE/threading knobs are solver-internal there."""

    algorithm: str = "ilqr"  # ddp.algorithm (ILQR / SLQ)
    max_iterations: int = 10  # ddp.maxNumIterations (1 in MPC mode = RTI)
    constraint_penalty: float = 20.0  # ddp.constraintPenaltyInitialValue
    penalty_increase_rate: float = 2.0  # ddp.constraintPenaltyIncreaseRate
    min_step_length: float = 1e-2  # ddp.lineSearch.minStepLength
    # ddp.strategy: LINE_SEARCH or LEVENBERG_MARQUARDT (solver/ddp.py
    # DdpSettings.strategy — LM adapts the Quu shift instead of the step)
    strategy: str = "line_search"
    # ddp.minRelCost: relative merit-improvement termination threshold
    # (DdpSettings.min_rel_cost; opt-in — the RTI replan path runs small
    # fixed iteration counts where early freeze is moot)
    min_rel_cost: float = 0.0


@dataclasses.dataclass
class IpmConfig:
    """task.info `ipm` block (task.info:86-156) — the interior-point solver
    settings the reference's DDP/IPM node consumes (BipedalRobotDdpMpcNode).

    Our TPU-first equivalent of the primal-dual IPM is the hard-cone barrier
    CONTINUATION (solver/sqp.py, cone="hard"): the relaxed log-barrier's mu
    and switch point shrink geometrically across SQP iterations toward a
    near-true log barrier, which reproduces the central-path march without
    per-constraint slack/dual vectors (those would add 20 extra decision
    rows per node of sequential fraction-to-boundary logic — control flow
    XLA can't batch).  The mapping:

        targetBarrierParameter      -> cone_mu_final (final barrier weight)
        barrierLinearDecreaseFactor -> cone_mu_decay (per-iteration shrink)
        ipmIteration                -> sqp_iterations for the hard path

    What a true primal-dual variant would add: explicit slack/dual iterates
    with a fraction-to-boundary step rule (fractionToBoundaryMargin) and
    independent dual step sizes (usePrimalStepSizeForDual) — faster
    convergence deep inside the horizon for very active cones, at the cost
    of the extra per-node state.  The continuation reaches the same KKT
    points (tests/test_hard_cone.py pins active-cone solutions against the
    activity oracle)."""

    iterations: int = 1  # ipm.ipmIteration
    dt: float = 0.015  # ipm.dt
    initial_barrier: float = 1e-4  # ipm.initialBarrierParameter
    target_barrier: float = 1e-4  # ipm.targetBarrierParameter
    decrease_factor: float = 0.2  # ipm.barrierLinearDecreaseFactor
    superlinear_power: float = 1.5  # ipm.barrierSuperlinearDecreasePower
    fraction_to_boundary: float = 0.995  # ipm.fractionToBoundaryMargin (doc only)
    use_feedback_policy: bool = True  # ipm.useFeedbackPolicy


@dataclasses.dataclass
class MpcConfig:
    time_horizon: float = 1.0
    mpc_desired_frequency: float = 50.0
    mrt_desired_frequency: float = 400.0
    cold_start: bool = False


@dataclasses.dataclass
class WbcConfig:
    torque_limits: np.ndarray = None  # per-leg joint limits (nj/2,)
    friction_coefficient: float = 0.3
    swing_kp: float = 350.0
    swing_kd: float = 37.0
    base_kp: np.ndarray = None  # (6,)
    base_kd: np.ndarray = None  # (6,)
    no_contact_motion_tolerance: float = 5.0
    weight_swing_leg: float = 100.0
    weight_base_accel: float = 1.0
    weight_contact_force: float = 0.01


@dataclasses.dataclass
class CaptureConfig:
    """Lateral capture-point step placement (authored extension — the
    reference ships NO stepping balance; its line-footed robots OpenLoong and
    Hunter were never closed-loop stepped, see tests/test_mujoco_openloong.py
    docstring).  At every replan the swing leg's hip-roll joint *reference*
    is offset by

        dq = sign * clip(kp * e_y + kv * edot_y, +-max_offset)

    with (e_y, edot_y) the body-frame lateral base-position / CoM-velocity
    errors at the replan instant — i.e. the foot is steered toward the
    instantaneous capture point p + sqrt(z/g) v (kv ~ sqrt(z0/g)/leg_len,
    kp ~ 1/leg_len).  Applied per-node only where the leg is in swing, so
    stance references are untouched and the MPC's own contact constraints
    keep the planted foot where it landed.

    ``pos_deadband``/``vel_deadband`` soft-threshold the errors before the
    gains (dz(v) = sign(v) max(|v|-db, 0)): capture then acts as a RECOVERY
    reflex that engages only on large perturbations and traces out exactly
    zero in nominal locomotion.  Measured on H1 (chip, B=64 randomized
    walking): without deadbands the always-on bias destabilizes the nominal
    in-place trot and fights commanded arc turns; with 0.04 m / 0.12 m/s the
    nominal envelopes are untouched while jittered-scenario survival keeps
    the capture gain."""

    left_index: int  # hip-roll index within joint_names (left leg)
    right_index: int
    kp: float = 0.0  # rad per m of lateral base-position error
    kv: float = 0.0  # rad per m/s of lateral CoM-velocity error
    max_offset: float = 0.3  # rad clip on the reference offset
    sign: float = 1.0  # +1 when +hip-roll moves the foot toward body +y
    decay: float = 0.4  # [s] horizon decay of the offset (build_refs dq_decay)
    pos_deadband: float = 0.0  # [m] soft threshold on e_y (0 = always on)
    vel_deadband: float = 0.0  # [m/s] soft threshold on edot_y
    # touchdownSync: evaluate the capture errors at each leg's NEXT
    # TOUCHDOWN (LIPM-propagated with the gait table's
    # next_touchdown_per_leg) instead of at the replan instant — the
    # per-replan bias otherwise chases the intra-swing phase of a rocking
    # mode it can only damp (the OpenLoong ~2 s limit cycle).
    touchdown_sync: bool = False
    # weightShift [m]: phase-locked base-y reference offset toward the
    # stance foot in single support (build_refs) — pre-loads the lateral
    # CoM transfer each stance phase instead of letting the MPC react.
    weight_shift: float = 0.0


@dataclasses.dataclass
class TaskConfig:
    """Everything task.info + reference.info + gait.info provide."""

    joint_names: list[str]
    contact_names: list[str]
    upper_joint_names: list[str]
    # task.info:1 — 0: FullCentroidalDynamics, 1: Single Rigid Body Dynamics
    centroidal_model_type: int
    position_error_gain: float
    phase_transition_stance_time: float
    swing: SwingConfig
    sqp: SqpConfig
    mpc: MpcConfig
    initial_state: np.ndarray  # (12 + nj,)
    Q: np.ndarray  # (nx, nx)
    R_task: np.ndarray  # (3nc + 3nc, ...) task-space input weights
    friction_coefficient: float
    # hard friction-cone path ("hard" = barrier-continuation interior point;
    # mapped from the reference's useAnalyticalGradientsConstraints flag,
    # BipedalRobotInterface.cpp:159-163 — true selects the analytic hard
    # FrictionConeConstraint used with the IPM solver)
    cone_mode: str = "soft"
    wbc: WbcConfig = None
    ddp: DdpConfig = dataclasses.field(default_factory=DdpConfig)
    ipm: IpmConfig = dataclasses.field(default_factory=IpmConfig)
    # reference.info
    com_height: float = 0.9
    default_joint_state: np.ndarray = None  # (nj,)
    default_upper_joint_state: np.ndarray = None
    target_displacement_velocity: float = 0.5
    target_rotation_velocity: float = 0.3
    initial_mode_schedule: ModeSchedule = None
    default_gait: ModeSequenceTemplate = None
    # gait.info
    gait_library: dict[str, ModeSequenceTemplate] = dataclasses.field(default_factory=dict)
    # optional massless contact frames (name -> (parent link, xyz)) for robots
    # whose URDF lacks sole links (e.g. Unitree G1)
    extra_frames: dict = dataclasses.field(default_factory=dict)
    # optional lateral capture stepping (captureStepping block, overrides.info)
    capture: CaptureConfig | None = None
    # per-robot TPU matmul-precision deployment knob (utils/precision.py;
    # top-level `matmulPrecision` key, usually authored in overrides.info).
    # None = framework default (full float32). Env BIPEDAL_MATMUL_PRECISION
    # still wins for one-off experiments.
    matmul_precision: str | None = None
    # per-robot plant-actuator model for GENERATED MuJoCo scenes
    # (`simulation { jointArmature x }`, overrides.info): reflected rotor
    # inertia added to every leg joint by sim/urdf_mjcf.py.  The role Gazebo
    # transmissions fill for the reference (create_urdf_for_gazebo.py); 0.0
    # = trust the URDF.  Hunter NEEDS ~0.01 kg m^2 (its URDF ships zero
    # reflected inertia; see configs/hunter/overrides.info).
    sim_joint_armature: float = 0.0

    @property
    def num_joints(self) -> int:
        return len(self.joint_names)

    @property
    def state_dim(self) -> int:
        return 12 + self.num_joints

    @property
    def input_dim(self) -> int:
        return 3 * len(self.contact_names) + self.num_joints


def _mode_sequence_template(tree: dict, key: str) -> ModeSequenceTemplate:
    modes = [MODE_BY_NAME[m] for m in info.get_string_list(tree, f"{key}.modeSequence")]
    times = info.get_scalar_list(tree, f"{key}.switchingTimes")
    return ModeSequenceTemplate(times, modes)


def _merge_overrides(tree: dict, overrides: dict, prefix: str = "") -> list[str]:
    """Deep-merge an override tree into a task tree; returns the overridden
    leaf paths (dynamic-reconfigure analogue: BipedalControllerParams.cfg
    applied at BipedalController.cpp:407-478, here as a declarative file)."""
    applied = []
    for key, val in overrides.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            sub = tree.setdefault(key, {})
            if not isinstance(sub, dict):
                tree[key] = sub = {}
            applied += _merge_overrides(sub, val, path + ".")
        else:
            applied.append(f"{path} = {val}" + (f" (was {tree[key]})" if key in tree else ""))
            tree[key] = val
    return applied


def load_task_config(
    task_file: str,
    reference_file: str,
    gait_file: str | None = None,
    overrides_file: str | None = None,
    extra_gait_file: str | None = None,
) -> TaskConfig:
    t = info.load_info(task_file)
    r = info.load_info(reference_file)
    if overrides_file and os.path.exists(overrides_file):
        ov = info.load_info(overrides_file)
        # a top-level `reference { ... }` block overlays the COMMAND
        # reference tree (comHeight / defaultJointState / ...) instead of the
        # task tree — needed where the authored stance pose differs from the
        # reference's (e.g. Hunter's equilibrium leg-tilt trim)
        ref_ov = ov.pop("reference", None)
        applied = _merge_overrides(t, ov)
        if isinstance(ref_ov, dict):
            applied += [
                f"reference.{line}" for line in _merge_overrides(r, ref_ov)
            ]
        for line in applied:
            print(f"[config] override ({os.path.basename(overrides_file)}): {line}")

    joint_names = info.get_string_list(t, "model_settings.jointNames")
    contact_names = info.get_string_list(t, "model_settings.contactNames3DoF")
    upper_names = info.get_string_list(t, "model_settings.upperJointNames")
    nj = len(joint_names)
    nx = 12 + nj
    nc = len(contact_names)

    swing = SwingConfig(
        lift_off_velocity=info.get_scalar(t, "swing_trajectory_config.liftOffVelocity", 0.05),
        touch_down_velocity=info.get_scalar(t, "swing_trajectory_config.touchDownVelocity", 0.0),
        swing_height=info.get_scalar(t, "swing_trajectory_config.swingHeight", 0.05),
        touchdown_after_horizon=info.get_scalar(
            t, "swing_trajectory_config.touchdownAfterHorizon", 0.2
        ),
        swing_time_scale=info.get_scalar(t, "swing_trajectory_config.swingTimeScale", 0.15),
    )
    sqp = SqpConfig(
        dt=info.get_scalar(t, "sqp.dt", 0.015),
        sqp_iterations=int(info.get_scalar(t, "sqp.sqpIteration", 1)),
        use_feedback_policy=info.get_bool(t, "sqp.useFeedbackPolicy", True),
        integrator=info.get_string(t, "sqp.integratorType", "RK2").lower(),
        inequality_constraint_mu=info.get_scalar(t, "sqp.inequalityConstraintMu", 0.1),
        inequality_constraint_delta=info.get_scalar(t, "sqp.inequalityConstraintDelta", 5.0),
    )
    mpc = MpcConfig(
        time_horizon=info.get_scalar(t, "mpc.timeHorizon", 1.0),
        mpc_desired_frequency=info.get_scalar(t, "mpc.mpcDesiredFrequency", 50.0),
        mrt_desired_frequency=info.get_scalar(t, "mpc.mrtDesiredFrequency", 400.0),
        cold_start=info.get_bool(t, "mpc.coldStart", False),
    )
    ipm = IpmConfig(
        iterations=int(info.get_scalar(t, "ipm.ipmIteration", 1)),
        dt=info.get_scalar(t, "ipm.dt", 0.015),
        initial_barrier=info.get_scalar(t, "ipm.initialBarrierParameter", 1e-4),
        target_barrier=info.get_scalar(t, "ipm.targetBarrierParameter", 1e-4),
        decrease_factor=info.get_scalar(t, "ipm.barrierLinearDecreaseFactor", 0.2),
        superlinear_power=info.get_scalar(t, "ipm.barrierSuperlinearDecreasePower", 1.5),
        fraction_to_boundary=info.get_scalar(t, "ipm.fractionToBoundaryMargin", 0.995),
        use_feedback_policy=info.get_bool(t, "ipm.useFeedbackPolicy", True),
    )
    ddp = DdpConfig(
        algorithm=info.get_string(t, "ddp.algorithm", "ILQR").lower(),
        max_iterations=int(info.get_scalar(t, "ddp.maxNumIterations", 10)),
        constraint_penalty=info.get_scalar(t, "ddp.constraintPenaltyInitialValue", 20.0),
        penalty_increase_rate=info.get_scalar(t, "ddp.constraintPenaltyIncreaseRate", 2.0),
        min_step_length=info.get_scalar(t, "ddp.lineSearch.minStepLength", 1e-2),
        strategy=info.get_string(t, "ddp.strategy", "LINE_SEARCH").lower(),
        min_rel_cost=info.get_scalar(t, "ddp.minRelCost", 0.0),
    )
    wbc = WbcConfig(
        torque_limits=info.get_matrix(t, "torqueLimitsTask", max(nj // 2, 1)),
        friction_coefficient=info.get_scalar(t, "frictionConeTask.frictionCoefficient", 0.3),
        swing_kp=info.get_scalar(t, "swingLegTask.kp", 350.0),
        swing_kd=info.get_scalar(t, "swingLegTask.kd", 37.0),
        base_kp=info.get_matrix(t, "baseAccelPDTask.baseKp", 6),
        base_kd=info.get_matrix(t, "baseAccelPDTask.baseKd", 6),
        no_contact_motion_tolerance=info.get_scalar(t, "noContactMotionTask.tolerance", 5.0),
        weight_swing_leg=info.get_scalar(t, "weight.swingLeg", 100.0),
        weight_base_accel=info.get_scalar(t, "weight.baseAccel", 1.0),
        weight_contact_force=info.get_scalar(t, "weight.contactForce", 0.01),
    )

    capture = None
    cap_node = info.get_node(t, "captureStepping")
    if isinstance(cap_node, dict):
        lname = info.get_string(t, "captureStepping.hipRollLeft", "")
        rname = info.get_string(t, "captureStepping.hipRollRight", "")
        if not (lname in joint_names and rname in joint_names):
            # a present-but-misnamed block would otherwise silently disable
            # the feature (advisor r3); fail loudly like other overrides
            print(
                "[config] WARNING: captureStepping block present but joint "
                f"names {lname!r}/{rname!r} do not resolve against "
                f"{list(joint_names)}; capture stepping DISABLED"
            )
        else:
            capture = CaptureConfig(
                left_index=joint_names.index(lname),
                right_index=joint_names.index(rname),
                kp=info.get_scalar(t, "captureStepping.kp", 0.0),
                kv=info.get_scalar(t, "captureStepping.kv", 0.0),
                max_offset=info.get_scalar(t, "captureStepping.maxOffset", 0.3),
                sign=info.get_scalar(t, "captureStepping.sign", 1.0),
                decay=info.get_scalar(t, "captureStepping.decay", 0.4),
                pos_deadband=info.get_scalar(t, "captureStepping.posDeadband", 0.0),
                vel_deadband=info.get_scalar(t, "captureStepping.velDeadband", 0.0),
                touchdown_sync=info.get_bool(t, "captureStepping.touchdownSync", False),
                weight_shift=info.get_scalar(t, "captureStepping.weightShift", 0.0),
            )
            print(
                f"[config] captureStepping: {lname}/{rname} "
                f"kp={capture.kp} kv={capture.kv}"
            )

    extra_frames = {}
    ef_node = info.get_node(t, "extra_frames")
    if isinstance(ef_node, dict):
        for fname, sub in ef_node.items():
            if isinstance(sub, dict) and "parent" in sub:
                xyz = tuple(float(v) for v in str(sub.get("xyz", "0 0 0")).split())
                extra_frames[fname] = (sub["parent"], xyz)

    cfg = TaskConfig(
        joint_names=joint_names,
        contact_names=contact_names,
        upper_joint_names=upper_names,
        centroidal_model_type=int(info.get_scalar(t, "centroidalModelType", 0)),
        position_error_gain=info.get_scalar(t, "model_settings.positionErrorGain", 0.0),
        phase_transition_stance_time=info.get_scalar(
            t, "model_settings.phaseTransitionStanceTime", 0.4
        ),
        swing=swing,
        sqp=sqp,
        mpc=mpc,
        ddp=ddp,
        ipm=ipm,
        initial_state=info.get_matrix(t, "initialState", nx),
        Q=info.get_matrix(t, "Q", nx, nx),
        R_task=info.get_matrix(t, "R", 6 * nc, 6 * nc),
        friction_coefficient=info.get_scalar(
            t, "frictionConeSoftConstraint.frictionCoefficient", 0.5
        ),
        cone_mode=(
            "hard"
            if info.get_bool(
                t, "bipedal_robot_interface.useAnalyticalGradientsConstraints", False
            )
            else "soft"
        ),
        wbc=wbc,
        com_height=info.get_scalar(r, "comHeight", 0.9),
        default_joint_state=info.get_matrix(r, "defaultJointState", nj),
        default_upper_joint_state=(
            info.get_matrix(r, "defaultUpperJointState", len(upper_names)) if upper_names else None
        ),
        target_displacement_velocity=info.get_scalar(r, "targetDisplacementVelocity", 0.5),
        target_rotation_velocity=info.get_scalar(r, "targetRotationVelocity", 0.3),
        extra_frames=extra_frames,
        capture=capture,
        matmul_precision=info.get_string(t, "matmulPrecision", "") or None,
        sim_joint_armature=info.get_scalar(t, "simulation.jointArmature", 0.0),
    )
    # initial mode schedule + default gait template
    init_modes = [
        MODE_BY_NAME[m] for m in info.get_string_list(r, "initialModeSchedule.modeSequence")
    ]
    init_events = info.get_scalar_list(r, "initialModeSchedule.eventTimes")
    cfg.initial_mode_schedule = ModeSchedule(init_events, init_modes)
    cfg.default_gait = _mode_sequence_template(r, "defaultModeSequenceTemplate")
    # note: defaultModeSequenceTemplate uses key 'switchingTimes', initial uses 'eventTimes'

    if gait_file and os.path.exists(gait_file):
        g = info.load_info(gait_file)
        for name in info.get_string_list(g, "list"):
            cfg.gait_library[name] = _mode_sequence_template(g, name)
    # authored supplements on top of the reference's gait library (same
    # overlay idea as overrides.info: reference files load unchanged, local
    # tuning lives in configs/<robot>/)
    if extra_gait_file and os.path.exists(extra_gait_file):
        g = info.load_info(extra_gait_file)
        for name in info.get_string_list(g, "list"):
            cfg.gait_library[name] = _mode_sequence_template(g, name)
            print(f"[config] extra gait ({os.path.basename(extra_gait_file)}): {name}")
    return cfg


def build_input_cost_weight(model, inf, R_task: np.ndarray, initial_state: np.ndarray) -> np.ndarray:
    """Map the task-space R onto inputs: forces keep their block, the
    joint-velocity block becomes J^T R_foot J with J the foot translational
    Jacobians (joint columns) at the nominal configuration
    (BipedalRobotInterface::initializeInputCostWeight, cpp:239-271).
    Computed in float64 on the CPU from the model's parameters."""
    import torch

    from ..model.kinematics import forward_kinematics, frame_position, stacked_point_jacobians

    model = model.to(device="cpu", dtype=torch.float64)
    nc = inf.num_contacts
    total = 3 * nc
    q = torch.as_tensor(np.asarray(initial_state[6:], dtype=np.float64))
    kin = forward_kinematics(model, q)
    ps = torch.stack([frame_position(model, kin, fid) for fid in inf.contact_frame_ids])
    anc = model.ancestor_mask()[[model.frame_body[fid] for fid in inf.contact_frame_ids]]
    J = stacked_point_jacobians(model, kin, ps, anc)  # (nc, 6, nv)
    J_feet = J[:, :3, 6:].reshape(total, -1).numpy()  # (3nc, nj)
    R = np.zeros((inf.input_dim, inf.input_dim))
    R[:total, :total] = R_task[:total, :total]
    R[total:, total:] = J_feet.T @ R_task[total:, total:] @ J_feet
    return R

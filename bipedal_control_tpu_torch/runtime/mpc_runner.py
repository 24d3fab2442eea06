"""MPC runner: warm-started replanning loop around the SQP
(runtime/mpc_runner.py counterpart).

Host-side orchestration of the reference's MPC thread + MPC_MRT handoff: it
owns the reference manager, the previous solution (warm start), and the
solve's kernel front ends.  The JAX runner fuses each replan into one
compiled dispatch; here a replan is a short sequence of batched tensor
calls over the node axis (capture offset, ``build_refs``, cold or warm
start, ``sqp_solve`` at B = 1), and the linearizer and merit evaluator are
built once per runner from the interface's circuit tables, so nothing is
rebuilt or uploaded per replan.

On the card, with the kernels' settings (linearize, riccati and merit
"pallas"), each kind of replan (cold and warm start) runs op by op at its
first use, is then captured in a CUDA graph, and is replayed after that:
~20 launches a replan instead of ~340.  The iLQR replan (``solver="ilqr"``)
replays three kinds of graph on the card, whatever the settings' backends
(it runs the plain structured linearization and Riccati sweep, as the
reference's does): the front end with iteration 0 (one per cold and warm
start), one later iteration (replayed ``ddp_iterations - 1`` times), and
the solution's evaluation.  Every torch call releases the GIL and takes it back, so
an op-by-op replan on a worker thread waits for the GIL once per operation
while the 400 Hz control tick holds it (runtime/async_mpc.py); the graph is
what lets the worker keep its 50 Hz beside the tick.
"""
from __future__ import annotations

import torch

from ..gait.mode_schedule import GaitTable
from ..gait.swing import SwingTable
from ..interface import RobotInterface
from ..ocp.problem import NodeRefs
from ..ops.linearize_kernel import make_node_linearizer
from ..ops.merit_kernel import make_merit_sums
from ..reference.manager import ReferenceManager
from ..reference.target import TargetTable
from ..solver.ddp import DdpSettings, IlqrState, ilqr_finish, ilqr_init, ilqr_iteration, ilqr_solve
from ..solver.sqp import SqpSolution, build_refs, initial_trajectory, sqp_solve, warm_start_trajectories
from ..utils.cuda_graph import GraphedCall
from ..utils.precision import set_full_f32_matmul
from ..utils.timing import RepeatedTimer


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


class MpcRunner:
    """`solver` selects the replan backend: "sqp" (the SqpMpc analogue) or
    "ilqr" (GaussNewtonDDP_MPC, BipedalRobotDdpMpcNode.cpp:70-72: AL-iLQR
    single shooting, solver/ddp.py, whose iteration 0 linearizes around the
    warm or cold start's states).  ``ddp_iterations`` overrides task.info's
    ddp.maxNumIterations and ``ddp_penalty`` its initial constraint penalty
    (default max(constraintPenaltyInitialValue, 100): the task's 20
    under-penalizes the swing rows in a trot replan chain).  The AL state is
    not carried across replans.  The backends of the SQP are the
    interface's settings: "pallas" means the CUDA kernels for tensors on
    the card and their plain versions on the CPU."""

    def __init__(
        self,
        iface: RobotInterface,
        reference_manager: ReferenceManager | None = None,
        solver: str = "sqp",
        ddp_iterations: int | None = None,
        ddp_penalty: float | None = None,
    ):
        if solver not in ("sqp", "ilqr"):
            raise ValueError(f"unknown solver {solver!r} (expected 'sqp' or 'ilqr')")
        set_full_f32_matmul()
        self.iface = iface
        self.rm = reference_manager or iface.make_reference_manager()
        self.last_solution: SqpSolution | None = None
        self.last_frozen = None
        self.timer = RepeatedTimer("mpc", device=iface.device)
        self.solver = solver
        model, info, settings = iface.model, iface.info, iface.settings
        self.ddp = None
        if solver == "ilqr":
            c = iface.task.ddp
            self.ddp = DdpSettings(
                iterations=int(ddp_iterations if ddp_iterations is not None else c.max_iterations),
                constraint_penalty=float(ddp_penalty if ddp_penalty is not None else max(c.constraint_penalty, 100.0)),
                penalty_increase_rate=float(c.penalty_increase_rate),
                strategy=c.strategy,
            )
        # the kernels' front ends, built once from the interface's circuit
        # tables (the plain versions for CPU tensors)
        sqp = solver == "sqp"
        self._linearize = (
            make_node_linearizer(model, info, settings, iface.Q, iface.R, static=iface.circuit)
            if sqp and settings.linearize == "pallas" else None
        )
        self._merit = (
            make_merit_sums(model, info, settings, static=iface.circuit)
            if sqp and settings.merit == "pallas" and len(settings.linesearch_alphas) else None
        )
        self._capture_dq, self._decay, self._wshift = make_capture_hook(getattr(iface.task, "capture", None), info.nj)
        self._num_nodes = settings.num_intervals + 1
        kernels = (settings.linearize, settings.riccati, settings.merit) == ("pallas",) * 3
        # replan kind -> GraphedCall, made at first use; None: every replan runs op by op
        self._graphs = {} if iface.device.type == "cuda" and (kernels or not sqp) else None

    @property
    def graphed(self) -> bool:
        """Whether replans replay CUDA graphs (the card, the kernels' settings)."""
        return self._graphs is not None

    def reset(self):
        self.last_solution = None
        self.last_frozen = None

    # command-channel sink: same surface as the JAX runner
    def set_gait(self, template, start_time: float) -> None:
        self.rm.set_gait(template, start_time)

    def set_target(self, target) -> None:
        self.rm.set_target(target)

    def advance(self, t: float, x_measured) -> SqpSolution:
        """One replan (MPC_MRT_Interface::advanceMpc equivalent)."""
        return self.advance_frozen(t, x_measured, self.rm.freeze(t))

    def advance_frozen(self, t: float, x_measured, frozen) -> SqpSolution:
        """Solve against an already-frozen reference set: capture offset,
        references, cold or warm start, then the B = 1 solve.  Returns the
        batched solution (leading axis 1)."""
        iface = self.iface
        self.last_frozen = frozen
        with self.timer:
            x = torch.as_tensor(x_measured, dtype=iface.dtype, device=iface.device).reshape(-1)
            prev = self.last_solution
            warm = () if prev is None else (prev.t_nodes, prev.x_traj, prev.u_traj)
            inputs = [x, *frozen.gait, *frozen.swing, *frozen.target, frozen.t_nodes, *warm]
            kind = "warm" if warm else "cold"
            if self._graphs is None:
                sol = self._replan(*inputs)
            elif self.solver == "ilqr":
                sol = self._ilqr_graphed(kind, inputs)
            else:
                sol = self._graphs.setdefault(kind, GraphedCall(self._replan))(inputs)
        self.last_solution = sol
        return sol

    def _front(self, x, *tables):
        """A replan's references and start: (refs, t_nodes, xs, us) from x,
        the frozen gait, swing and target tables' fields, the node grid, and
        for a warm start the previous solution's t_nodes, x_traj, u_traj."""
        iface = self.iface
        ng, ns, nt = len(GaitTable._fields), len(SwingTable._fields), len(TargetTable._fields)
        gait, swing = GaitTable(*tables[:ng]), SwingTable(*tables[ng : ng + ns])
        target, t_nodes = TargetTable(*tables[ng + ns : ng + ns + nt]), tables[ng + ns + nt]
        warm = tables[ng + ns + nt + 1 :]
        dq = self._capture_dq(gait, target, t_nodes, x)
        refs = build_refs(iface.info, gait, swing, target, t_nodes, dq, self._decay, self._wshift)
        if warm:
            xs, us = warm_start_trajectories(*warm, t_nodes[None])
        else:
            xs, us = initial_trajectory(iface.info, refs, x[None], self._num_nodes)
        return refs, t_nodes[None], xs, us

    def _replan(self, x, *tables) -> SqpSolution:
        """One replan as a function of tensors only (what a CUDA graph
        captures for the SQP); see :meth:`_front` for the arguments."""
        iface = self.iface
        refs, t_nodes, xs, us = self._front(x, *tables)
        if self.solver == "ilqr":
            # xs seeds iteration 0's linearization only; the accepted states
            # come from nonlinear rollouts
            return ilqr_solve(iface.model, iface.info, iface.settings, self.ddp, iface.Q, iface.R, refs, t_nodes,
                              x[None], us, x_warm=xs)
        return sqp_solve(iface.model, iface.info, iface.settings, iface.Q, iface.R, refs, t_nodes, x[None],
                         xs, us, merit_sums=self._merit, linearize=self._linearize)

    # ---- the iLQR replan in CUDA graphs: (refs, t_nodes, state) flow between them as flat tuples
    def _ilqr_args(self):
        iface = self.iface
        return iface.model, iface.info, iface.settings, self.ddp, iface.Q, iface.R

    def _ilqr_begin(self, x, *tables):
        refs, t_nodes, xs, us = self._front(x, *tables)
        state = ilqr_init(*self._ilqr_args(), refs, x[None], us, x_warm=xs)
        if self.ddp.iterations:
            state, _ = ilqr_iteration(*self._ilqr_args(), refs, x[None], state, first=True)
        return (*refs, t_nodes, *state)

    def _ilqr_step(self, x, *flat):
        nr = len(NodeRefs._fields)
        state, _ = ilqr_iteration(*self._ilqr_args(), NodeRefs(*flat[:nr]), x[None], IlqrState(*flat[nr:]),
                                  first=False)
        return tuple(state)

    def _ilqr_end(self, *flat):
        nr = len(NodeRefs._fields)
        model, info, settings, _, Q, R = self._ilqr_args()
        return ilqr_finish(model, info, settings, Q, R, NodeRefs(*flat[:nr]), flat[nr], IlqrState(*flat[nr + 1 :]))

    def _ilqr_graphed(self, kind: str, inputs) -> SqpSolution:
        """The iLQR replan from graph replays: the front end with iteration
        0, the later iterations, the evaluation of the result."""
        graph = lambda name, fn: self._graphs.setdefault(name, GraphedCall(fn))
        nr = len(NodeRefs._fields)
        carry = graph(kind, self._ilqr_begin)(inputs)
        refs, t_nodes, state = carry[:nr], carry[nr], carry[nr + 1 :]
        for _ in range(1, self.ddp.iterations):
            state = graph("iterate", self._ilqr_step)([inputs[0], *refs, *state])
        return graph("finish", self._ilqr_end)([*refs, t_nodes, *state])

"""Observability: solver constraint observers + tracking-error debug metrics
(runtime/observability.py counterpart).

Replaces the reference's observability stack (SURVEY.md §5.5):
- per-constraint SolverObserver terms the MPC nodes publish for multiplot
  (BipedalRobotSqpMpcNode.cpp:75-87: friction-cone and zero-velocity
  violations along the optimized trajectory);
- the DebugPublisher desired-vs-measured comparisons and TrackingError
  message (bipedal_controllers/src/debug/DebugPublisher.cpp:38-180,
  msg/TrackingError.msg).

Each constraint family is one batched computation over the node axis (the
JAX package vmaps a per-node function).  The functions take one scenario's
solution (index a batched SqpSolution, as runtime/mrt.py does) and return
numpy records; stream them to whatever sink the deployment uses.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..model.centroidal import CentroidalModelInfo, generalized_from_rbd, get_generalized_coordinates
from ..model.kinematics import forward_kinematics, frame_position
from ..ocp.problem import NodeRefs, OcpSettings, equality_residual, friction_cone_values
from ..solver.sqp import SqpSolution


class ConstraintObservation(NamedTuple):
    """Per-node constraint terms along an optimized trajectory."""

    t: np.ndarray  # (N,)
    friction_cone: np.ndarray  # (N, nc) cone margin h_i (>=0 feasible); nan when swing
    zero_velocity: np.ndarray  # (N, nc) stance-foot speed residual norm
    normal_velocity: np.ndarray  # (N, nc) swing z-velocity residual; nan when stance


def observe_constraints(
    model, info: CentroidalModelInfo, settings: OcpSettings, sol: SqpSolution, refs: NodeRefs
) -> ConstraintObservation:
    """SolverObserver analogue: the constraint families at every node at once
    (sol fields (N+1, nx) / (N, nu), refs fields (N, ...))."""
    host = lambda a: a.detach().cpu().numpy()
    xs, us = sol.x_traj[:-1], sol.u_traj
    cones = friction_cone_values(settings, us, info)
    e = equality_residual(model, info, settings, xs, us, refs)
    zv = torch.linalg.norm(e[:, :12].reshape(-1, 4, 3), dim=-1)
    nv = e[:, 12:]
    flags = host(refs.contact_flags)
    return ConstraintObservation(
        t=host(refs.t),
        friction_cone=np.where(flags > 0.5, host(cones), np.nan),
        zero_velocity=np.where(flags > 0.5, host(zv), np.nan),
        normal_velocity=np.where(flags < 0.5, host(nv), np.nan),
    )


class TrackingError(NamedTuple):
    """Desired-vs-measured snapshot (TrackingError.msg analogue)."""

    base_position_error: np.ndarray  # (3,)
    base_orientation_error: np.ndarray  # (3,) euler-zyx difference
    base_velocity_error: np.ndarray  # (3,)
    foot_position_error: np.ndarray  # (nc, 3)
    joint_position_error: np.ndarray  # (nj,)


def tracking_error(model, info: CentroidalModelInfo, x_desired, rbd_measured) -> TrackingError:
    """DebugPublisher analogue: dual FK evaluation desired vs measured, both
    sides in one batched pass."""
    as_t = lambda a: torch.as_tensor(a, dtype=model.dtype, device=model.body_mass.device)
    x_d, rbd = as_t(x_desired), as_t(rbd_measured)
    q_m, v_m = generalized_from_rbd(info, rbd)
    q = torch.stack([get_generalized_coordinates(x_d), q_m])  # (2, nq): desired, measured
    kin = forward_kinematics(model, q)
    feet = torch.stack([frame_position(model, kin, f) for f in info.contact_frame_ids], dim=-2)
    err = (q[0] - q[1]).detach().cpu().numpy()
    return TrackingError(
        base_position_error=err[0:3],
        base_orientation_error=err[3:6],
        base_velocity_error=(x_d[0:3] - v_m[0:3]).detach().cpu().numpy(),
        foot_position_error=(feet[0] - feet[1]).detach().cpu().numpy(),
        joint_position_error=err[6:],
    )


def solve_report(sol: SqpSolution) -> dict:
    """One-line machine-readable solve summary (printSolverStatistics analog)."""
    return {
        "cost": float(sol.cost),
        "defect_l1": float(sol.defect_norm),
        "eq_l1": float(sol.eq_norm),
        "step_size": float(sol.step_size),
        "horizon_nodes": int(sol.x_traj.shape[0]),
    }

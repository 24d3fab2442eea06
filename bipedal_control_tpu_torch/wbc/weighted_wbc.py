"""Weighted whole-body QP (wbc/weighted_wbc.py counterpart; WeightedWbc).

Stacks the hard constraints (EoM, torque limits, friction / zero force,
no contact motion) and the weighted task rows (swing leg * w_swing, base PD
* w_base, contact force * w_force), forms H = A^T A and g = -A^T b as
WeightedWbc.cpp:48-51 does, and hands the QP to the ADMM of wbc/qp.py,
whose KKT inverse is K5 on the card.

Every input takes any number of leading batch dimensions: :func:`wbc_update`
on a batch is :func:`wbc_update_batch`.  Nothing reads a value back to the
host, so the controller replays a tick's WBC from a CUDA graph
(runtime/controller.py).  The reference's "reuse the last solution on
failure" lives in the controller, which owns the state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..model.centroidal import CentroidalModelInfo
from ..utils.device import constant
from .qp import QpSolution, solve_qp
from .tasks import (
    NUM_CONTACTS,
    WbcKinematics,
    WbcTaskConfig,
    base_accel_pd_task,
    compute_wbc_kinematics,
    concat_tasks,
    contact_force_task,
    floating_base_eom_task,
    friction_cone_task,
    no_contact_motion_task,
    num_decision_vars,
    scale_task,
    swing_leg_task,
    torque_limits_task,
)

_BIG = 1e20


class WbcResult(NamedTuple):
    decision: torch.Tensor  # (..., ndec) [vdot; F; tau]
    torque: torch.Tensor  # (..., nj)
    qp: QpSolution


def wbc_qp(model, info: CentroidalModelInfo, cfg: WbcTaskConfig, x_desired, u_desired, rbd_measured, contact_flags):
    """The WBC's QP (H, g, A, l, u) at these inputs, as :func:`wbc_update`
    hands it to the ADMM."""
    kin = compute_wbc_kinematics(model, info, x_desired, u_desired, rbd_measured)
    constraints = concat_tasks(
        [
            floating_base_eom_task(info, kin),
            torque_limits_task(info, cfg, kin.M),
            friction_cone_task(info, cfg, contact_flags),
            no_contact_motion_task(info, cfg, kin, contact_flags),
        ]
    )
    weighted = concat_tasks(
        [
            scale_task(swing_leg_task(info, cfg, kin, contact_flags), cfg.weight_swing_leg),
            scale_task(base_accel_pd_task(info, cfg, kin), cfg.weight_base_accel),
            scale_task(contact_force_task(info, kin), cfg.weight_contact_force),
        ]
    )
    aT = weighted.a.transpose(-1, -2)
    nv = info.generalized_dim
    reg = [cfg.accel_reg] * nv + [cfg.force_reg] * (3 * NUM_CONTACTS) + [cfg.torque_reg] * info.nj
    H = aT @ weighted.a + torch.diag(constant(reg, kin.M.dtype, kin.M.device))
    g = -(aT @ weighted.b[..., None])[..., 0]
    # rows: equalities (l = u = b) then inequalities (-inf, f]
    A = torch.cat([constraints.a, constraints.d], dim=-2)
    l = torch.cat([constraints.b, torch.full_like(constraints.f, -_BIG)], dim=-1)  # noqa: E741
    u = torch.cat([constraints.b, constraints.f], dim=-1)
    return H, g, A, l, u


def wbc_update(
    model,
    info: CentroidalModelInfo,
    cfg: WbcTaskConfig,
    x_desired,
    u_desired,
    rbd_measured,
    contact_flags,
    qp_iters: int = 120,
) -> WbcResult:
    qp = wbc_qp(model, info, cfg, x_desired, u_desired, rbd_measured, contact_flags)
    sol = solve_qp(*qp, iters=qp_iters)
    return WbcResult(decision=sol.x, torque=sol.x[..., -info.nj:], qp=sol)


def wbc_update_batch(model, info, cfg, x_des_b, u_des_b, rbd_b, flags_b, qp_iters: int = 120) -> WbcResult:
    """Scenario-batched WBC over the leading axis (the 400 Hz stage of large
    domain-randomized sweeps): :func:`wbc_update` takes the batch as it is,
    with one K5 launch for all of its KKT systems."""
    return wbc_update(model, info, cfg, x_des_b, u_des_b, rbd_b, flags_b, qp_iters=qp_iters)


__all__ = ["WbcResult", "WbcTaskConfig", "wbc_qp", "wbc_update", "wbc_update_batch", "num_decision_vars",
           "WbcKinematics"]

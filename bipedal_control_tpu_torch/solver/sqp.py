"""Multiple-shooting Gauss-Newton SQP over an explicit scenario batch
(solver/sqp.py counterpart; the JAX package vmaps a single-scenario solve).

One iteration: structured linearization of every (scenario, node) (the
linearize kernel for ``linearize="pallas"``), the equality-constrained
Riccati sweep, then the OCS2 filter line search over the step candidates,
all evaluated at once.  ``sqp_iterations=1`` is the real-time iteration.
The port implements cone "soft"; "hard" and "ipm" raise NotImplementedError.

Every tensor argument carries the scenario batch on its leading axis B; a
batch of one is the single-solve (latency) path.  The solve runs where its
tensors lie.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..model.centroidal import CentroidalModelInfo
from ..model.robot_model import RobotModel
from ..ocp.linearize import linearize_node_structured, node_eval
from ..ocp.problem import NodeRefs, OcpSettings, make_node_refs, node_cost, weight_compensating_input
from .riccati import solve_lqr, solve_lqr_pallas

# Filter-linesearch bands on the squared constraint violation (task.info
# sqp.g_max 1e-2 / g_min 1e-6).
_G_MAX = 1e-2
_G_MIN = 1e-6


class SqpSolution(NamedTuple):
    """PrimalSolution equivalent, batched over B."""

    t_nodes: torch.Tensor  # (B, N+1)
    x_traj: torch.Tensor  # (B, N+1, nx)
    u_traj: torch.Tensor  # (B, N, nu)
    K: torch.Tensor  # (B, N, nu, nx) feedback gains
    cost: torch.Tensor  # (B,) achieved merit cost term
    defect_norm: torch.Tensor  # (B,) l1 dynamics defect
    eq_norm: torch.Tensor  # (B,) l1 equality residual
    step_size: torch.Tensor  # (B,) accepted line-search step


def eq_mask_from_flags(contact_flags):
    """(..., 4) flags -> (..., 16) active-row mask: the 12 velocity/force rows
    are always active; the 4 normal-velocity rows only during swing."""
    ones = torch.ones(contact_flags.shape[:-1] + (12,), dtype=contact_flags.dtype, device=contact_flags.device)
    return torch.cat([ones, 1.0 - contact_flags], dim=-1)


def _performance(model, info, settings, Q, R, xs, us, refs: NodeRefs):
    """(cost, squared-violation ISE, l1 defect, l1 eq) summed over the node
    axis, for any leading dims that broadcast against refs'."""
    c, defect, e = node_eval(model, info, settings, Q, R, xs[..., :-1, :], us, xs[..., 1:, :], refs)
    return (
        c.sum(-1),
        (defect**2).sum((-1, -2)) + (e**2).sum((-1, -2)),
        defect.abs().sum((-1, -2)),
        e.abs().sum((-1, -2)),
    )


def _candidate_costs(model, info, settings, Q, R, xs_c, us_c, refs: NodeRefs):
    """dt-scaled tracking + cone-barrier cost per step candidate: the FK-free
    part of node_eval over (..., N, .) candidates whose refs broadcast."""
    return (refs.dt * node_cost(model, info, settings, Q, R, xs_c, us_c, refs)).sum(-1)


def _filter_accept(cost_base, viol_base, cost_step, viol_step):
    """OCS2 FilterLinesearch acceptance: infeasible iterates must reduce
    violation; near-feasible steps must reduce cost; in between either; and
    a step from a feasible base may never leave the g_max band."""
    infeasible = viol_base > _G_MAX
    blowup = viol_step > _G_MAX
    both_feasible = (viol_step < _G_MIN) & (viol_base < _G_MAX)
    reduce_viol = viol_step < (1.0 - 1e-3) * viol_base
    reduce_cost = cost_step < cost_base - 1e-6 * cost_base.abs()
    return torch.where(
        infeasible,
        reduce_viol,
        ~blowup & torch.where(both_feasible, reduce_cost, reduce_cost | reduce_viol),
    )


def _check_settings(info: CentroidalModelInfo, settings: OcpSettings) -> None:
    if settings.cone != "soft":
        raise NotImplementedError(f"cone={settings.cone!r}: the port implements the soft cone only")
    if settings.linearize not in ("structured", "pallas"):
        raise NotImplementedError(f"linearize={settings.linearize!r}: the port implements 'structured' and 'pallas'")
    if settings.riccati not in ("sequential", "pallas"):
        raise NotImplementedError(f"riccati={settings.riccati!r}: the port implements 'sequential' and 'pallas'")
    if settings.merit not in ("xla", "pallas"):
        raise NotImplementedError(f"merit={settings.merit!r}")
    if info.model_type != 0:
        raise NotImplementedError("the port implements FullCentroidalDynamics (model_type 0) only")


@functools.lru_cache(maxsize=None)
def _alphas_tensor(alphas: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The line-search candidates as a tensor on the solve's device, copied
    there once per (alphas, dtype, device) and never written: a CUDA-graph
    capture of the solve (runtime/mpc_runner.py) cannot copy from the host,
    and the batched solves skip one copy per iteration."""
    return torch.tensor(alphas, dtype=dtype, device=device)


def sqp_solve(
    model: RobotModel,
    info: CentroidalModelInfo,
    settings: OcpSettings,
    Q,
    R,
    refs: NodeRefs,  # fields (B, N, ...)
    t_nodes,  # (B, N+1)
    x_init,  # (B, nx) measured initial states
    x_warm,  # (B, N+1, nx) warm-start state trajectories
    u_warm,  # (B, N, nu)
    merit_sums=None,
    linearize=None,
) -> SqpSolution:
    """Run ``settings.sqp_iterations`` Gauss-Newton iterations per scenario.

    merit_sums: the evaluator of ops/merit_kernel.make_merit_sums for
    ``merit="pallas"``; linearize: the linearizer of
    ops/linearize_kernel.make_node_linearizer for ``linearize="pallas"``;
    each built from the model when not given.  The warm-start tensors are
    not modified."""
    _check_settings(info, settings)
    Bb, nx = x_init.shape
    xs = x_warm.clone()
    xs[:, 0] = x_init  # the initial state is a hard parameter: pin node 0
    us = u_warm
    dtype, device = x_init.dtype, x_init.device

    lqr = solve_lqr_pallas if settings.riccati == "pallas" else solve_lqr
    if settings.merit == "pallas" and len(settings.linesearch_alphas) and merit_sums is None:
        from ..ops.merit_kernel import make_merit_sums

        merit_sums = make_merit_sums(model, info, settings)
    if linearize is None:
        if settings.linearize == "pallas":
            from ..ops.linearize_kernel import make_node_linearizer

            linearize = make_node_linearizer(model, info, settings, Q, R)
        else:
            linearize = lambda x, u, xn, r: linearize_node_structured(model, info, settings, Q, R, x, u, xn, r)
    masks = eq_mask_from_flags(refs.contact_flags)
    dx0 = torch.zeros(Bb, nx, dtype=dtype, device=device)
    step_size = torch.ones(Bb, dtype=dtype, device=device)
    alphas = _alphas_tensor(tuple(settings.linesearch_alphas), dtype, device)
    gains = cost = defect = eq = None
    for _ in range(settings.sqp_iterations):
        nodes = linearize(xs[:, :-1], us, xs[:, 1:], refs)
        sol = lqr(nodes, masks, dx0)
        gains = sol.K
        e_masked = masks * nodes.e

        if len(settings.linesearch_alphas) == 0:
            # pure RTI: full Newton step, diagnostics of the pre-step point
            xs = xs + sol.dx
            us = us + sol.du
            step_size = torch.ones(Bb, dtype=dtype, device=device)
            cost = nodes.cost.sum(-1)
            defect = nodes.c.abs().sum((-1, -2))
            eq = e_masked.abs().sum((-1, -2))
            continue

        xs_c = xs[:, None] + alphas[None, :, None, None] * sol.dx[:, None]  # (B, A, N+1, nx)
        us_c = us[:, None] + alphas[None, :, None, None] * sol.du[:, None]
        refs_a = NodeRefs(*(f[:, None] for f in refs))  # broadcast over candidates
        if settings.merit == "pallas":
            n_a = alphas.shape[0]
            bc = lambda a: a[:, None].expand((Bb, n_a) + a.shape[1:])
            sums = merit_sums(
                xs_c[:, :, :-1], us_c, xs_c[:, :, 1:], bc(refs.contact_flags), bc(refs.swing_vref),
                bc(refs.swing_pref), bc(refs.dt),
            )  # (B, A, N, 4): [|defect|, defect^2, |eq|, eq^2] per node
            d1_a = sums[..., 0].sum(-1)
            viols_a = (sums[..., 1] + sums[..., 3]).sum(-1)
            e1_a = sums[..., 2].sum(-1)
            costs_a = _candidate_costs(model, info, settings, Q, R, xs_c[:, :, :-1], us_c, refs_a)
        else:
            costs_a, viols_a, d1_a, e1_a = _performance(model, info, settings, Q, R, xs_c, us_c, refs_a)
        # alpha = 0 baseline from the node data the linearization holds
        cost0 = nodes.cost.sum(-1)
        viol0 = (nodes.c**2).sum((-1, -2)) + (e_masked**2).sum((-1, -2))
        d1_0 = nodes.c.abs().sum((-1, -2))
        e1_0 = e_masked.abs().sum((-1, -2))
        accepted = _filter_accept(cost0[:, None], viol0[:, None], costs_a, viols_a)  # (B, A)
        # largest accepted alpha (alphas sorted descending); fall back to 0
        idx = torch.argmax(accepted.to(torch.int32), dim=1)
        any_ok = accepted.any(dim=1)
        pick = lambda a: a.gather(1, idx[:, None])[:, 0]
        step_size = torch.where(any_ok, alphas[idx], torch.zeros_like(cost0))
        xs = xs + step_size[:, None, None] * sol.dx
        us = us + step_size[:, None, None] * sol.du
        cost = torch.where(any_ok, pick(costs_a), cost0)
        defect = torch.where(any_ok, pick(d1_a), d1_0)
        eq = torch.where(any_ok, pick(e1_a), e1_0)
    return SqpSolution(
        t_nodes=t_nodes, x_traj=xs, u_traj=us, K=gains, cost=cost, defect_norm=defect, eq_norm=eq,
        step_size=step_size,
    )


def initial_trajectory(info: CentroidalModelInfo, refs: NodeRefs, x_init, num_nodes: int):
    """Cold start (BipedalRobotInitializer): state held at x_init, input =
    weight-compensating forces for each node's contact mode.
    x_init (..., nx) -> xs (..., num_nodes, nx), us (..., N, nu)."""
    xs = x_init.unsqueeze(-2).expand(x_init.shape[:-1] + (num_nodes, x_init.shape[-1])).clone()
    us = weight_compensating_input(info, refs.contact_flags, info.input_dim)
    return xs, us


def build_refs(info: CentroidalModelInfo, gait_table, swing_table, target_table, t_nodes,
               dq_swing=None, dq_decay: float | None = None,
               weight_shift: float | None = None) -> NodeRefs:
    """NodeRefs of every interval of the node grid t_nodes (N+1,), with the
    batch axis sqp_solve takes: fields (1, N, ...) for one target table,
    (B, N, ...) for a batched one (B tables, ``TargetTable`` with a leading
    scenario axis; the gait, swing tables and the grid are shared).  One
    batched computation over the nodes and scenarios (the JAX package vmaps
    over the nodes, and over the scenarios in its batched closed loop).

    dq_swing: optional (2, nj) or (B, 2, nj) joint-reference offsets (row 0 =
    left leg, row 1 = right leg) added to x_nom's joint block at every node
    where that leg is in swing (the capture-stepping hook,
    config.loader.CaptureConfig).  dq_decay: optional time constant [s];
    the offset decays exp(-(t-t0)/tau) along the horizon.  weight_shift:
    optional amplitude [m] of a phase-locked base-y reference offset toward
    the single-support stance foot, rotated to world by each node's yaw
    reference."""
    t = t_nodes[:-1]
    r = make_node_refs(info, gait_table, swing_table, target_table, t, t_nodes[1:] - t)
    f = r.contact_flags  # (N, 4) [l_toe, l_heel, r_toe, r_heel]
    left, right = torch.maximum(f[:, 0], f[:, 1]), torch.maximum(f[:, 2], f[:, 3])
    x_nom = r.x_nom  # (N, nx) or (B, N, nx)
    if dq_swing is not None:
        dq = (1.0 - left)[:, None] * dq_swing[..., 0:1, :] + (1.0 - right)[:, None] * dq_swing[..., 1:2, :]
        if dq_decay is not None:
            dq = torch.exp(-torch.clamp(t - t_nodes[0], min=0.0) / dq_decay)[:, None] * dq
        x_nom = x_nom.expand(torch.broadcast_shapes(x_nom.shape[:-1], dq.shape[:-1]) + x_nom.shape[-1:])
        x_nom = torch.cat([x_nom[..., :12], x_nom[..., 12:] + dq], dim=-1)
    if weight_shift is not None:
        # +1 left single support, -1 right, 0 double/flight; body +y is
        # toward the left foot, rotated to world by the node's yaw ref
        dy = weight_shift * (left - right)
        yaw = x_nom[..., 9]
        shift = torch.stack([-torch.sin(yaw) * dy, torch.cos(yaw) * dy], dim=-1)
        x_nom = torch.cat([x_nom[..., :6], x_nom[..., 6:8] + shift, x_nom[..., 8:]], dim=-1)
    r = r._replace(x_nom=x_nom)
    if x_nom.dim() == 2:
        return NodeRefs(*(a[None] for a in r))
    lanes = x_nom.shape[0]
    return NodeRefs(*(a if a is x_nom else a.expand((lanes,) + a.shape) for a in r))


def _interp_rows(times, rows, t):
    """rows (..., T, w) on their grid times (..., T), linearly interpolated
    at t (..., S) with the end rows held: (..., S, w)."""
    idx = torch.clamp(torch.searchsorted(times, t.contiguous(), right=True), 1, rows.shape[-2] - 1)
    t0, t1 = torch.gather(times, -1, idx - 1), torch.gather(times, -1, idx)
    alpha = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)[..., None]
    pick = lambda i: torch.gather(rows, -2, i[..., None].expand(i.shape + rows.shape[-1:]))
    return pick(idx - 1) * (1 - alpha) + pick(idx) * alpha


def warm_start_trajectories(prev_t_nodes, prev_xs, prev_us, t_nodes):
    """Shift (x, u) trajectories from their own node grid onto a new one by
    linear interpolation, over any leading batch dims that match:
    prev_t_nodes (..., N+1), prev_xs (..., N+1, nx), prev_us (..., N, nu),
    t_nodes (..., N+1) -> xs (..., N+1, nx), us (..., N, nu)."""
    xs = _interp_rows(prev_t_nodes, prev_xs, t_nodes)
    us = _interp_rows(prev_t_nodes[..., :-1].contiguous(), prev_us, t_nodes[..., :-1])
    return xs, us


def warm_start_from_solution(prev: SqpSolution, t_nodes):
    """Shift the previous solution onto a new time grid (MPC warm start;
    mpc.coldStart=false)."""
    return warm_start_trajectories(prev.t_nodes, prev.x_traj, prev.u_traj, t_nodes)

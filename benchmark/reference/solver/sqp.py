"""Multiple-shooting Gauss-Newton SQP over an explicit scenario batch: the
benchmark's frozen plain copy of the port's solver/sqp.py.

One iteration: the structured linearization of every (scenario, node), the
plain equality-constrained Riccati sweep, then the OCS2 filter line search
over the step candidates, evaluated by ``node_eval``.  No kernel runs here,
whatever the settings' backend fields say.  ``sqp_iterations=1`` is the
real-time iteration.

Friction cones: "soft" (the relaxed barrier), "hard" (its mu and delta
shrink over the unrolled iterations) and "ipm" (primal-dual slack and dual
iterates).  Every tensor argument carries the scenario batch on its leading
axis B.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from ..model.centroidal import CentroidalModelInfo
from ..model.robot_model import RobotModel
from ..ocp.linearize import linearize_node_structured, node_eval
from ..ocp.problem import (
    NodeRefs,
    OcpSettings,
    friction_cone_grads_u,
    friction_cone_values,
    make_node_refs,
    weight_compensating_input,
)
from .riccati import _regs, solve_lqr

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
    # cone="ipm" (None otherwise): friction-cone slack and dual iterates at
    # the returned primal point
    cone_slack: torch.Tensor | None = None  # (B, N, nc)
    cone_dual: torch.Tensor | None = None  # (B, N, nc)


def scenario(sol: SqpSolution, b: int) -> SqpSolution:
    """Scenario b of a batched solution, its fields without the batch axis
    (the cone fields stay None where the solve has none)."""
    return SqpSolution(*(None if f is None else f[b] for f in sol))


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
    if settings.cone not in ("soft", "hard", "ipm"):
        raise NotImplementedError(f"cone={settings.cone!r}")


def iteration_settings(settings: OcpSettings, it: int) -> OcpSettings:
    """The settings of unrolled SQP iteration ``it``.  cone="hard": an
    interior-point continuation, the barrier's mu and relaxed switch point
    delta shrink geometrically per iteration, floored at cone_mu_final and
    cone_delta_final, so late iterations solve an almost-true log barrier.
    cone="ipm": the cone enters through the primal-dual condensed terms, so
    the soft barrier is off (barrier_mu=0 zeroes every relaxed-barrier
    term)."""
    if settings.cone == "ipm":
        return dataclasses.replace(settings, barrier_mu=0.0)
    if settings.cone != "hard":
        return settings
    decay = settings.cone_mu_decay**it
    return dataclasses.replace(
        settings,
        barrier_mu=max(settings.barrier_mu * decay, settings.cone_mu_final),
        barrier_delta=max(settings.barrier_delta * decay, settings.cone_delta_final),
    )


def _lqr_backend(settings: OcpSettings, reg_dtype):
    """The plain sequential Riccati sweep, whatever ``settings.riccati`` says,
    with the KKT regularisation of ``reg_dtype`` (the configuration's
    precision, which defines the problem the program solves)."""
    regs = None if reg_dtype is None else _regs(reg_dtype)
    return lambda nodes, masks, dx0: solve_lqr(nodes, masks, dx0, regs)


@functools.lru_cache(maxsize=None)
def _alphas_tensor(alphas: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The line-search candidates as a tensor on the solve's device, copied
    there once per (alphas, dtype, device) and never written: a CUDA-graph
    capture of the solve (runtime/mpc_runner.py) cannot copy from the host,
    and the batched solves skip one copy per iteration."""
    return torch.tensor(alphas, dtype=dtype, device=device)


class _ConeIpm:
    """cone="ipm": the primal-dual slack/dual state of every (scenario,
    node, stance cone) (the OCS2 ipm role).  Central path s * lam -> mu,
    with mu marching ipm_mu_init -> ipm_mu_target across the unrolled
    iterations.  Swing cones carry benign (1, mu) iterates and zero
    condensed weight, so every shape is static."""

    def __init__(self, settings: OcpSettings, info, refs: NodeRefs, us, cone_warm):
        self.settings, self.info = settings, info
        self.flags = refs.contact_flags  # (B, N, nc)
        self.act = self.flags > 0.5
        self.w = refs.dt[..., None] * self.flags
        self.mu = settings.ipm_mu_init
        if cone_warm is not None:
            self.s, self.lam = cone_warm
        else:
            g = friction_cone_values(settings, us, info)
            self.s = torch.where(self.act, torch.clamp(g, min=1e-2), torch.ones_like(g))
            self.lam = torch.where(self.act, self.mu / self.s, torch.full_like(g, self.mu))

    def condense(self, nodes, us):
        """Add the condensed Newton terms to the stage quadratics (dt-scaled
        like every other stage cost term):
            Quu += sum_j w_j (lam_j/s_j) G_j G_j^T
            qu  -= sum_j w_j (mu/s_j - (lam_j/s_j)(g_j - s_j)) G_j"""
        self.g = friction_cone_values(self.settings, us, self.info)  # (B, N, nc)
        self.G = friction_cone_grads_u(self.settings, us, self.info)  # (B, N, nc, nu)
        self.sig = self.lam / self.s
        wG = (self.w * self.sig)[..., None] * self.G
        Quu_pd = wG.transpose(-1, -2) @ self.G
        qu_pd = -((self.w * (self.mu / self.s - self.sig * (self.g - self.s)))[..., None] * self.G).sum(-2)
        return nodes._replace(Quu=nodes.Quu + Quu_pd, qu=nodes.qu + qu_pd)

    def directions(self, du, alphas):
        """Slack and dual Newton directions recovered from du; returns the
        candidates capped per lane by the fraction-to-boundary rule (B, A)."""
        self.ds = (self.G @ du[..., None])[..., 0] + (self.g - self.s)
        self.dlam = (self.mu - self.s * self.lam) / self.s - self.sig * self.ds
        frac = self.settings.ipm_fraction_to_boundary

        def max_step(v, dv):
            r = torch.where(self.act & (dv < 0), -frac * v / torch.clamp(dv, max=-1e-12),
                            torch.full_like(v, float("inf")))
            return torch.clamp(r.amin((-1, -2)), max=1.0)

        self.a_s_max = max_step(self.s, self.ds)  # (B,)
        self.a_lam_max = max_step(self.lam, self.dlam)
        return torch.minimum(alphas[None, :], self.a_s_max[:, None])

    def violation(self, us_c, alphas_b):
        """Primal cone residual ||g(u_a) - s_a||^2 on the active cones per
        candidate (B, A): the IPM term of the filter's violation channel
        (without it a feasibility-restoring step from a cost-converged warm
        start is rejected as a cost increase)."""
        g_a = friction_cone_values(self.settings, us_c, self.info)  # (B, A, N, nc)
        s_a = self.s[:, None] + alphas_b[..., None, None] * self.ds[:, None]
        return (self.flags[:, None] * (g_a - s_a) ** 2).sum((-1, -2))

    def base_violation(self):
        return (self.flags * (self.g - self.s) ** 2).sum((-1, -2))

    def step(self, step_size, any_ok):
        """Accept the primal step: slack along it, duals by their own
        fraction-to-boundary step unless tied to the primal one; then mu
        along its schedule."""
        st = self.settings
        a_dual = step_size if st.ipm_dual_step_from_primal else torch.where(
            any_ok, self.a_lam_max, torch.zeros_like(self.a_lam_max))
        self.s = torch.clamp(self.s + step_size[:, None, None] * self.ds, min=1e-10)
        self.lam = torch.clamp(self.lam + a_dual[:, None, None] * self.dlam, min=1e-10)
        self.mu = max(st.ipm_mu_target, self.mu * st.ipm_mu_decay)


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
    cone_warm=None,  # cone="ipm": optional (s, lam) warm start, (B, N, nc) each
    reg_dtype=None,  # the dtype whose KKT regularisation to use (None: the tensors')
) -> SqpSolution:
    """Run ``settings.sqp_iterations`` Gauss-Newton iterations per scenario.

    The warm-start tensors are not
    modified."""
    _check_settings(info, settings)
    Bb, nx = x_init.shape
    xs = x_warm.clone()
    xs[:, 0] = x_init  # the initial state is a hard parameter: pin node 0
    us = u_warm
    dtype, device = x_init.dtype, x_init.device
    n_alphas = len(settings.linesearch_alphas)
    if settings.cone == "ipm" and n_alphas == 0:
        raise NotImplementedError(
            "cone='ipm' needs linesearch candidates for its fraction-to-boundary cap; "
            "use a non-empty linesearch_alphas"
        )

    lqr = _lqr_backend(settings, reg_dtype)
    linearize = lambda x, u, xn, r, s: linearize_node_structured(model, info, s, Q, R, x, u, xn, r)
    masks = eq_mask_from_flags(refs.contact_flags)
    dx0 = torch.zeros(Bb, nx, dtype=dtype, device=device)
    step_size = torch.ones(Bb, dtype=dtype, device=device)
    alphas = _alphas_tensor(tuple(settings.linesearch_alphas), dtype, device)
    ipm = _ConeIpm(settings, info, refs, us, cone_warm) if settings.cone == "ipm" else None
    gains = cost = defect = eq = None
    for it in range(settings.sqp_iterations):
        settings_it = iteration_settings(settings, it)
        nodes = linearize(xs[:, :-1], us, xs[:, 1:], refs, settings_it)
        if ipm is not None:
            nodes = ipm.condense(nodes, us)
        sol = lqr(nodes, masks, dx0)
        gains = sol.K
        e_masked = masks * nodes.e

        if n_alphas == 0:
            # pure RTI: full Newton step, diagnostics of the pre-step point
            xs = xs + sol.dx
            us = us + sol.du
            step_size = torch.ones(Bb, dtype=dtype, device=device)
            cost = nodes.cost.sum(-1)
            defect = nodes.c.abs().sum((-1, -2))
            eq = e_masked.abs().sum((-1, -2))
            continue

        # (B, A) candidates: the same for every lane unless the ipm caps them
        alphas_b = ipm.directions(sol.du, alphas) if ipm is not None else alphas[None, :].expand(Bb, n_alphas)
        xs_c = xs[:, None] + alphas_b[..., None, None] * sol.dx[:, None]  # (B, A, N+1, nx)
        us_c = us[:, None] + alphas_b[..., None, None] * sol.du[:, None]
        refs_a = NodeRefs(*(f[:, None] for f in refs))  # broadcast over candidates
        costs_a, viols_a, d1_a, e1_a = _performance(model, info, settings_it, Q, R, xs_c, us_c, refs_a)
        # alpha = 0 baseline from the node data the linearization holds
        cost0 = nodes.cost.sum(-1)
        viol0 = (nodes.c**2).sum((-1, -2)) + (e_masked**2).sum((-1, -2))
        if ipm is not None:
            viols_a = viols_a + ipm.violation(us_c, alphas_b)
            viol0 = viol0 + ipm.base_violation()
        d1_0 = nodes.c.abs().sum((-1, -2))
        e1_0 = e_masked.abs().sum((-1, -2))
        accepted = _filter_accept(cost0[:, None], viol0[:, None], costs_a, viols_a)  # (B, A)
        # largest accepted alpha (alphas sorted descending); fall back to 0
        idx = torch.argmax(accepted.to(torch.int32), dim=1)
        any_ok = accepted.any(dim=1)
        pick = lambda a: a.gather(1, idx[:, None])[:, 0]
        step_size = torch.where(any_ok, pick(alphas_b), torch.zeros_like(cost0))
        xs = xs + step_size[:, None, None] * sol.dx
        us = us + step_size[:, None, None] * sol.du
        cost = torch.where(any_ok, pick(costs_a), cost0)
        defect = torch.where(any_ok, pick(d1_a), d1_0)
        eq = torch.where(any_ok, pick(e1_a), e1_0)
        if ipm is not None:
            ipm.step(step_size, any_ok)
    # feedback gains from the last QP (OCS2 publishes the gains of the QP it just solved)
    return SqpSolution(
        t_nodes=t_nodes, x_traj=xs, u_traj=us, K=gains, cost=cost, defect_norm=defect, eq_norm=eq,
        step_size=step_size, cone_slack=None if ipm is None else ipm.s, cone_dual=None if ipm is None else ipm.lam,
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

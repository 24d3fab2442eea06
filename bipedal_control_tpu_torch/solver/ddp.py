"""iLQR / Gauss-Newton DDP solver path (solver/ddp.py counterpart), batched
over a leading scenario axis B.

The reference offers GaussNewtonDDP_MPC (algorithm ILQR) beside the SQP node
(BipedalRobotDdpMpcNode.cpp:59-100; the ddp block of task.info).  This path
shares the structured linearization with the SQP:

- single shooting: the forward pass is a nonlinear rollout under the
  time-varying affine feedback policy, so dynamics defects vanish by
  construction; all line-search candidates roll out in one batch;
- the state-input equality constraints enter the backward pass through the
  same constrained stage KKT the SQP's Riccati sweep uses (the analogue of
  OCS2 DDP's projection), from iteration 1 on; iteration 0 folds them into
  the cost as an augmented-Lagrangian penalty, since its initial trajectory
  carries defects the constrained KKT would answer with feedforwards large
  enough to blow up the first rollout;
- an augmented-Lagrangian merit (multipliers lam, penalty rho) accepts or
  rejects rollouts; line search over step sizes, or Levenberg-Marquardt (full
  steps, an adaptive Quu shift).

The backward pass is the plain sweep of solver/riccati.py::solve_lqr, as the
reference uses its XLA solve_lqr there (not its Riccati kernel).  Every
per-lane decision (improved, done, rho, lam, the LM shift) is a tensor
select, so an iteration reads nothing back to the host and a CUDA graph can
capture it (runtime/mpc_runner.py replays one graph per iteration kind).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..model.centroidal import CentroidalModelInfo
from ..model.robot_model import RobotModel
from ..ocp.linearize import linearize_node_structured, node_eval
from ..ocp.problem import NodeRefs, OcpSettings, discrete_dynamics
from .riccati import solve_lqr
from .sqp import SqpSolution, _alphas_tensor, eq_mask_from_flags


@dataclasses.dataclass(frozen=True)
class DdpSettings:
    iterations: int = 10  # ddp.maxNumIterations (per replan; RTI uses 1)
    constraint_penalty: float = 20.0  # ddp.constraintPenaltyInitialValue
    penalty_increase_rate: float = 2.0  # ddp.constraintPenaltyIncreaseRate
    # lineSearch minStepLength 1e-2 / maxStepLength 1.0
    alphas: tuple = (1.0, 0.3, 0.1, 0.03, 0.01)
    # Levenberg-Marquardt Quu shift (hessianCorrectionStrategy DIAGONAL_SHIFT);
    # kept small: 1.0 over-damps against the task-scaled R
    hessian_shift: float = 0.01
    # augmented Lagrangian: multiplier updates on accepted iterates; rho
    # escalates only when an update fails to cut ||e||^2 by this factor
    multiplier_updates: bool = True
    violation_decrease_factor: float = 0.25
    max_penalty: float = 1e6
    # equality constraints in the backward pass: True = constrained stage KKT
    # (from iteration 1), False = penalty-folded quadratics in every iteration
    constrained_backward: bool = True
    # ddp.strategy: "line_search" (the alphas ladder) or
    # "levenberg_marquardt" (full steps; the Quu shift shrinks toward
    # hessian_shift on an accepted rollout and grows on a rejected one)
    strategy: str = "line_search"
    lm_shrink: float = 0.5
    lm_grow: float = 4.0
    lm_shift_max: float = 1e3
    # ddp.minRelCost: once an accepted iterate improves the AL merit by less
    # than this relative amount, the lane's later iterations freeze (0: never)
    min_rel_cost: float = 0.0


class IlqrState(NamedTuple):
    """What one iteration hands the next, per lane."""

    xs: torch.Tensor  # (B, N+1, nx)
    us: torch.Tensor  # (B, N, nu)
    K: torch.Tensor  # (B, N, nu, nx) the last backward pass's gains
    rho: torch.Tensor  # (B,) AL penalty
    lam: torch.Tensor  # (B, N, ne) AL multipliers (masked rows stay 0)
    viol_prev: torch.Tensor  # (B,) ||e||^2 after the previous iteration
    shift: torch.Tensor  # (B,) the LM Quu shift
    done: torch.Tensor  # (B,) bool: min_rel_cost reached


def _penalized_nodes(nodes, masks, rho, lam):
    """Fold the masked equality constraints into the cost quadratics
    (augmented-Lagrangian linear term C^T / D^T (lam + rho e)); rho (B,)."""
    D = masks[..., None] * nodes.D
    C = masks[..., None] * nodes.C
    e = masks * nodes.e
    r = rho[:, None, None]
    g = lam + r * e
    bt = lambda M: M.transpose(-1, -2)
    r = r[..., None]
    return nodes._replace(
        Qxx=nodes.Qxx + r * bt(C) @ C,
        Quu=nodes.Quu + r * bt(D) @ D,
        Qux=nodes.Qux + r * bt(D) @ C,
        qx=nodes.qx + (bt(C) @ g[..., None])[..., 0],
        qu=nodes.qu + (bt(D) @ g[..., None])[..., 0],
        C=torch.zeros_like(nodes.C),
        D=torch.zeros_like(nodes.D),
        e=torch.zeros_like(nodes.e),
    )


def _rollout(model, info, settings, refs: NodeRefs, x_init, x_bar, u_bar, K, k_ff, alphas):
    """Closed-loop nonlinear rollouts u = u_bar - alpha k - K (x - x_bar) of
    every candidate at once: alphas (A,) -> xs (B, A, N+1, nx), us (B, A, N, nu)."""
    x = x_init[:, None].expand(x_init.shape[:1] + (alphas.shape[0],) + x_init.shape[1:])
    a = alphas[:, None]
    xs, us = [x], []
    for t in range(u_bar.shape[1]):
        dxb = x - x_bar[:, None, t]
        u = u_bar[:, None, t] - a * k_ff[:, None, t] - (K[:, None, t] @ dxb[..., None])[..., 0]
        x = discrete_dynamics(model, info, settings, x, u, refs.dt[:, t, None])
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=2), torch.stack(us, dim=2)


def _eval(model, info, settings, Q, R, refs, xs, us):
    """node_eval over the horizon: (cost, defect, masked eq) per node, for
    trajectories with any leading dims that broadcast against refs'."""
    return node_eval(model, info, settings, Q, R, xs[..., :-1, :], us, xs[..., 1:, :], refs)


def _al_merit(model, info, settings, Q, R, refs, xs, us, rho, lam):
    """Augmented-Lagrangian merit sum c + lam.e + rho/2 ||e||^2 per lane."""
    c, _, e = _eval(model, info, settings, Q, R, refs, xs, us)
    return c.sum(-1) + (lam * e).sum((-1, -2)) + 0.5 * rho * (e**2).sum((-1, -2))


def ilqr_init(model, info, settings, ddp: DdpSettings, Q, R, refs: NodeRefs, x_init, u_warm,
              x_warm=None, al_state=None) -> IlqrState:
    """The state before iteration 0: the warm states (else x_init held over
    the horizon, the Initializer's), zero gains, fresh multipliers (or
    ``al_state=(lam, rho)`` re-masked)."""
    Bb, N, nu = u_warm.shape
    nx = x_init.shape[-1]
    dtype, device = x_init.dtype, x_init.device
    masks = eq_mask_from_flags(refs.contact_flags)
    xs = x_init[:, None].expand(Bb, N + 1, nx).clone() if x_warm is None else x_warm
    if al_state is None:
        rho = torch.full((Bb,), float(ddp.constraint_penalty), dtype=dtype, device=device)
        lam = torch.zeros_like(masks)
    else:
        lam, rho = al_state
        lam = lam * masks  # re-mask: the contact schedule may have shifted
    _, _, e_prev = _eval(model, info, settings, Q, R, refs, xs, u_warm)
    return IlqrState(
        xs=xs, us=u_warm, K=torch.zeros(Bb, N, nu, nx, dtype=dtype, device=device), rho=rho, lam=lam,
        viol_prev=(e_prev**2).sum((-1, -2)), shift=torch.full((Bb,), float(ddp.hessian_shift), dtype=dtype,
                                                              device=device),
        done=torch.zeros(Bb, dtype=torch.bool, device=device),
    )


def ilqr_iteration(model, info, settings, ddp: DdpSettings, Q, R, refs: NodeRefs, x_init, state: IlqrState,
                   first: bool, history: bool = False):
    """One AL-iLQR iteration (iteration 0 when ``first``): linearize, the
    backward pass, the candidates' rollouts, acceptance, the AL update.
    Returns (state, history row (B, 6) or None)."""
    xs, us, _, rho, lam, viol_prev, shift, done = state
    nu = us.shape[-1]
    masks = eq_mask_from_flags(refs.contact_flags)
    lm = ddp.strategy == "levenberg_marquardt"
    eye = torch.eye(nu, dtype=xs.dtype, device=xs.device)
    it_shift = (shift if lm else torch.full_like(shift, ddp.hessian_shift))[:, None, None, None]
    nodes = linearize_node_structured(model, info, settings, Q, R, xs[:, :-1], us, xs[:, 1:], refs)
    if ddp.constrained_backward and not first:
        # projected equality handling on a genuine rollout iterate
        bnodes, bmasks = nodes._replace(Quu=nodes.Quu + it_shift * eye), masks
    else:
        # iteration 0: the soft AL backward only has to give stabilizing feedback
        bnodes = _penalized_nodes(nodes, masks, rho, lam)
        bnodes, bmasks = bnodes._replace(Quu=bnodes.Quu + it_shift * eye), torch.zeros_like(masks)
    sol = solve_lqr(bnodes, bmasks, torch.zeros_like(x_init))

    # LM takes full steps only; its damping adapts instead of the step size
    alphas = _alphas_tensor((1.0,) if lm else tuple(ddp.alphas), xs.dtype, xs.device)
    xs_a, us_a = _rollout(model, info, settings, refs, x_init, xs, us, sol.K, sol.k, alphas)
    refs_a = NodeRefs(*(f[:, None] for f in refs))
    merits = _al_merit(model, info, settings, Q, R, refs_a, xs_a, us_a, rho[:, None], lam[:, None])  # (B, A)
    best = torch.argmin(merits, dim=1)
    merit_best = merits.gather(1, best[:, None])[:, 0]
    merit_base = _al_merit(model, info, settings, Q, R, refs, xs, us, rho, lam)
    # iteration 0 always steps onto a real rollout: the initial trajectory
    # carries defects the single-shooting merit cannot see
    improved = torch.ones_like(done) if first else merit_best < merit_base
    improved = improved & ~done
    pick = lambda a: a.gather(1, best.view((-1, 1) + (1,) * (a.dim() - 2)).expand(
        (a.shape[0], 1) + a.shape[2:]))[:, 0]
    sel = improved.view(-1, 1, 1)
    xs = torch.where(sel, pick(xs_a), xs)
    us = torch.where(sel, pick(us_a), us)
    if lm:
        shift = torch.where(improved, torch.clamp(shift * ddp.lm_shrink, min=ddp.hessian_shift),
                            torch.clamp(shift * ddp.lm_grow, max=ddp.lm_shift_max))
    if ddp.min_rel_cost > 0.0 and not first:
        rel = (merit_base - merit_best) / torch.clamp(merit_base.abs(), min=1.0)
        done = done | (improved & (rel < ddp.min_rel_cost))

    # first-order multiplier update on the accepted iterate; rho escalates
    # only when the violation did not drop enough (Bertsekas' AL schedule)
    c_now, _, e_now = _eval(model, info, settings, Q, R, refs, xs, us)
    viol = (e_now**2).sum((-1, -2))
    if ddp.multiplier_updates and not first:
        lam = lam + torch.where(improved, rho, torch.zeros_like(rho))[:, None, None] * masks * e_now
    rho = torch.where(viol > ddp.violation_decrease_factor * viol_prev,
                      torch.clamp(rho * ddp.penalty_increase_rate, max=ddp.max_penalty), rho)
    row = None
    if history:
        row = torch.stack([improved.to(xs.dtype), merit_best, viol, c_now.sum(-1), alphas[best], xs[:, -1, 8]],
                          dim=-1).float()
    return IlqrState(xs=xs, us=us, K=sol.K, rho=rho, lam=lam, viol_prev=viol, shift=shift, done=done), row


def ilqr_finish(model, info, settings, Q, R, refs: NodeRefs, t_nodes, state: IlqrState) -> SqpSolution:
    """The solution of the last iterate, with its cost, l1 defect and l1
    equality residual."""
    cost, defects, eqs = _eval(model, info, settings, Q, R, refs, state.xs, state.us)
    return SqpSolution(
        t_nodes=t_nodes, x_traj=state.xs, u_traj=state.us, K=state.K, cost=cost.sum(-1),
        defect_norm=defects.abs().sum((-1, -2)), eq_norm=eqs.abs().sum((-1, -2)),
        step_size=torch.ones_like(state.rho),
    )


def ilqr_solve(
    model: RobotModel,
    info: CentroidalModelInfo,
    settings: OcpSettings,
    ddp: DdpSettings,
    Q,
    R,
    refs: NodeRefs,  # fields (B, N, ...)
    t_nodes,  # (B, N+1)
    x_init,  # (B, nx)
    u_warm,  # (B, N, nu)
    x_warm=None,  # (B, N+1, nx)
    al_state=None,
    return_al_state: bool = False,
    return_history: bool = False,
):
    """AL-iLQR solve of every lane.  ``al_state=(lam, rho)`` warm-starts
    the augmented Lagrangian (with ``return_al_state`` the result is
    (SqpSolution, (lam, rho))), for continuing a refinement at a fixed
    iterate; MpcRunner does not chain it across replans (the per-iterate
    multiplier updates over-accumulate when carried).  ``return_history``
    appends a (B, iterations, 6) float32 tensor: improved, best merit,
    ||e||^2, cost, the accepted alpha and the last node's base z."""
    state = ilqr_init(model, info, settings, ddp, Q, R, refs, x_init, u_warm, x_warm, al_state)
    rows = []
    for it in range(ddp.iterations):
        state, row = ilqr_iteration(model, info, settings, ddp, Q, R, refs, x_init, state, it == 0,
                                    return_history)
        rows.append(row)
    sol = ilqr_finish(model, info, settings, Q, R, refs, t_nodes, state)
    extras = []
    if return_al_state:
        extras.append((state.lam, state.rho))
    if return_history:
        extras.append(torch.stack(rows, dim=1))
    return (sol, *extras) if extras else sol

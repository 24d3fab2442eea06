"""Policy evaluation (MRT): interpolation + optional feedback policy
(runtime/mrt.py counterpart).

Linear interpolation of the optimized state and input trajectories at the
query time, plus the Riccati feedback term u = u*(t) + K(t) (x - x*(t))
when useFeedbackPolicy is on (task.info sqp:80).  A pure function of one
scenario's solution (unbatched fields: t_nodes (N+1,), x_traj (N+1, nx),
u_traj (N, nu), K (N, nu, nx)); index the batched SqpSolution to get one.
:func:`evaluate_policy_batch` evaluates every scenario of a batched
solution at once (the JAX package vmaps the one-scenario function), and
the one-scenario function is its batch of one.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch

from ..solver.sqp import SqpSolution


class PolicyEval(NamedTuple):
    x_star: torch.Tensor
    u_star: torch.Tensor  # feedforward (interpolated)
    u_fb: torch.Tensor  # with feedback term applied


def evaluate_policy(sol: SqpSolution, t, x_measured, use_feedback: bool = True) -> PolicyEval:
    """The policy of one scenario's solution at time t (a float or a
    one-element tensor): :func:`evaluate_policy_batch` of a batch of one."""
    one = SimpleNamespace(t_nodes=sol.t_nodes[None], x_traj=sol.x_traj[None], u_traj=sol.u_traj[None], K=sol.K[None])
    return PolicyEval(*(f[0] for f in evaluate_policy_batch(one, t, x_measured[None], use_feedback)))


def evaluate_policy_batch(sol: SqpSolution, t, x_measured, use_feedback: bool = True) -> PolicyEval:
    """The policy of every scenario of a batched solution (t_nodes (B, N+1),
    x_traj (B, N+1, nx), u_traj (B, N, nu), K (B, N, nu, nx)) at one time t
    (a float or a one-element tensor) and the measured states x_measured
    (B, nx): fields (B, ...).  Each scenario's index is found and taken on
    the device (searchsorted, gathers): indexing with a 0-dim tensor would
    read it to the host, a synchronisation of the card per index."""
    times = sol.t_nodes
    B, n1 = times.shape
    if not torch.is_tensor(t):  # a fill on the device, not a host-to-device copy
        t = torch.full((), float(t), dtype=times.dtype, device=times.device)
    t = t.reshape(1, 1).expand(B, 1).contiguous()
    idx = torch.clamp(torch.searchsorted(times.contiguous(), t, right=True), 1, n1 - 1)  # (B, 1)
    t0, t1 = torch.gather(times, 1, idx - 1), torch.gather(times, 1, idx)
    alpha = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)  # (B, 1)

    def take(a, i):  # a[b, i[b]] for every scenario b: (B, ...)
        return torch.gather(a, 1, i.reshape((B, 1) + (1,) * (a.dim() - 2)).expand((B, 1) + a.shape[2:]))[:, 0]

    x_star = take(sol.x_traj, idx - 1) * (1 - alpha) + take(sol.x_traj, idx) * alpha
    iu = torch.clamp(idx - 1, 0, sol.u_traj.shape[1] - 1)
    iu1 = torch.clamp(idx, 0, sol.u_traj.shape[1] - 1)
    u_star = take(sol.u_traj, iu) * (1 - alpha) + take(sol.u_traj, iu1) * alpha
    if use_feedback:
        u_fb = u_star - (take(sol.K, iu) @ (x_measured - x_star)[..., None])[..., 0]
    else:
        u_fb = u_star
    return PolicyEval(x_star=x_star, u_star=u_star, u_fb=u_fb)

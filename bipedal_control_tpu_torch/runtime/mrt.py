"""Policy evaluation (MRT): interpolation + optional feedback policy
(runtime/mrt.py counterpart).

Linear interpolation of the optimized state and input trajectories at the
query time, plus the Riccati feedback term u = u*(t) + K(t) (x - x*(t))
when useFeedbackPolicy is on (task.info sqp:80).  A pure function of one
scenario's solution (unbatched fields: t_nodes (N+1,), x_traj (N+1, nx),
u_traj (N, nu), K (N, nu, nx)); index the batched SqpSolution to get one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..solver.sqp import SqpSolution


class PolicyEval(NamedTuple):
    x_star: torch.Tensor
    u_star: torch.Tensor  # feedforward (interpolated)
    u_fb: torch.Tensor  # with feedback term applied


def evaluate_policy(sol: SqpSolution, t, x_measured, use_feedback: bool = True) -> PolicyEval:
    """The policy at time t (a float or a 0-dim tensor).  Every index stays a
    one-element tensor: indexing with a 0-dim tensor reads it to the host
    (a synchronisation of the card per index)."""
    times = sol.t_nodes
    if not torch.is_tensor(t):  # a fill on the device, not a host-to-device copy
        t = torch.full((), float(t), dtype=times.dtype, device=times.device)
    t = t.reshape(1)
    idx = torch.clamp(torch.searchsorted(times, t, right=True), 1, times.shape[0] - 1)
    t0, t1 = times[idx - 1], times[idx]
    alpha = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)[:, None]
    x_star = (sol.x_traj[idx - 1] * (1 - alpha) + sol.x_traj[idx] * alpha)[0]
    iu = torch.clamp(idx - 1, 0, sol.u_traj.shape[0] - 1)
    iu1 = torch.clamp(idx, 0, sol.u_traj.shape[0] - 1)
    u_star = (sol.u_traj[iu] * (1 - alpha) + sol.u_traj[iu1] * alpha)[0]
    if use_feedback:
        u_fb = u_star - sol.K[iu][0] @ (x_measured - x_star)
    else:
        u_fb = u_star
    return PolicyEval(x_star=x_star, u_star=u_star, u_fb=u_fb)

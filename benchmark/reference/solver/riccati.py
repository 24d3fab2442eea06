"""Equality-constrained Riccati sweep (solver/riccati.py counterpart).

Each backward stage solves the KKT system

    [ H_uu  D^T ] [du]   [-(H_ux dx + h_u)]
    [ D    -Reg ] [la] = [-(C dx + e)     ]

with Reg = diag(eps on active rows, 1 on masked rows), so masked rows (C, D,
e identically zero) drop out and shapes stay static across contact modes.

:func:`solve_lqr` is the plain PyTorch version, batched over a leading
scenario axis with Python loops over the stages; it is also the plain
sweep that the benchmark's reference runs (no kernel).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ocp.problem import LinearizedNode
from ..ops.linalg import solve_saddle_kkt


def _regs(dtype):
    """Dtype-aware (dual_eps, huu_reg): 100 eps, at least 1e-9."""
    eps = float(torch.finfo(dtype).eps)
    return max(1e-9, 100.0 * eps), max(1e-9, 100.0 * eps)


class RiccatiSolution(NamedTuple):
    dx: torch.Tensor  # (B, N+1, nx)
    du: torch.Tensor  # (B, N, nu)
    K: torch.Tensor  # (B, N, nu, nx) feedback gains (du = -K dx - k)
    k: torch.Tensor  # (B, N, nu)
    expected_decrease: torch.Tensor  # (B,) first-order predicted decrease


def _stage_kkt(node: LinearizedNode, eq_mask, S_next, s_next, regs=None):
    """One backward stage over the batch; returns (S, s, K, k).
    regs: (dual_eps, huu_reg), by default :func:`_regs` of the dtype."""
    A, B, c = node.A, node.B, node.c
    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
    Sc = (S_next @ c[..., None])[..., 0] + s_next
    SA = S_next @ A
    H_xx = node.Qxx + At @ SA
    H_uu = node.Quu + Bt @ (S_next @ B)
    H_ux = node.Qux + Bt @ SA
    h_x = node.qx + (At @ Sc[..., None])[..., 0]
    h_u = node.qu + (Bt @ Sc[..., None])[..., 0]

    nu = H_uu.shape[-1]
    dual_eps, huu_reg = regs if regs is not None else _regs(A.dtype)
    reg = eq_mask * dual_eps + (1.0 - eq_mask) * 1.0
    rhs_top = torch.cat([H_ux, h_u[..., None]], dim=-1)
    rhs_bot = torch.cat([node.C, node.e[..., None]], dim=-1)
    eye = torch.eye(nu, dtype=A.dtype, device=A.device)
    sol = solve_saddle_kkt(H_uu + huu_reg * eye, node.D, reg, rhs_top, rhs_bot)
    K = sol[..., :nu, :-1]
    k = sol[..., :nu, -1]

    Kt = K.transpose(-1, -2)
    S = H_xx + Kt @ H_uu @ K - Kt @ H_ux - H_ux.transpose(-1, -2) @ K
    s = (
        h_x
        + (Kt @ (H_uu @ k[..., None]))[..., 0]
        - (Kt @ h_u[..., None])[..., 0]
        - (H_ux.transpose(-1, -2) @ k[..., None])[..., 0]
    )
    S = 0.5 * (S + S.transpose(-1, -2))
    return S, s, K, k


def riccati_plain(nodes: LinearizedNode, eq_masks, dx0, regs=None):
    """Backward sweep + forward rollout: (K, k, dx_all, du).

    nodes: LinearizedNode with leading axes (B, N); eq_masks (B, N, ne);
    dx0 (B, nx); regs as in :func:`_stage_kkt`."""
    Bb, N, nx = nodes.A.shape[:3]
    S = torch.zeros(Bb, nx, nx, dtype=nodes.A.dtype, device=nodes.A.device)
    s = torch.zeros(Bb, nx, dtype=nodes.A.dtype, device=nodes.A.device)
    Ks, ks = [None] * N, [None] * N
    for t in range(N - 1, -1, -1):
        node = LinearizedNode(*(f[:, t] for f in nodes))
        S, s, Ks[t], ks[t] = _stage_kkt(node, eq_masks[:, t], S, s, regs)
    dx = dx0
    dxs, dus = [], []
    for t in range(N):
        du = -(Ks[t] @ dx[..., None])[..., 0] - ks[t]
        dxs.append(dx)
        dus.append(du)
        dx = (nodes.A[:, t] @ dx[..., None])[..., 0] + (nodes.B[:, t] @ du[..., None])[..., 0] + nodes.c[:, t]
    dxs.append(dx)
    return torch.stack(Ks, 1), torch.stack(ks, 1), torch.stack(dxs, 1), torch.stack(dus, 1)


def _solution(nodes, K, k, dx_all, dus) -> RiccatiSolution:
    pred = (nodes.qx * dx_all[:, :-1]).sum((1, 2)) + (nodes.qu * dus).sum((1, 2))
    return RiccatiSolution(dx=dx_all, du=dus, K=K, k=k, expected_decrease=pred)


def solve_lqr(nodes: LinearizedNode, eq_masks, dx0, regs=None) -> RiccatiSolution:
    """Plain backward Riccati + forward rollout over a scenario batch;
    ``regs`` as in :func:`_stage_kkt`."""
    return _solution(nodes, *riccati_plain(nodes, eq_masks, dx0, regs))

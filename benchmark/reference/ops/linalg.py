"""Small dense linear algebra without pivoting (ops/linalg.py counterpart).

- :func:`gauss_jordan_solve`: pivot-free Gauss-Jordan as rank-1 updates over
  the augmented matrix.  Safe for the stage KKT, which is quasi-definite
  (positive (1,1) block, negative-definite regularized Schur complement), so
  pivots never vanish.
- :func:`inv3`, :func:`inv6_block`: closed-form inverses for the
  centroidal-momentum base block.
- :func:`solve_saddle_kkt`: [[H, D^T], [D, -diag(reg)]] solve.
"""
from __future__ import annotations

import torch

from .contract import mm


def gauss_jordan_solve(A, B):
    """Solve A X = B for quasi-definite A without pivoting.

    A: (..., n, n); B: (..., n, k) -> X: (..., n, k).
    """
    n = A.shape[-1]
    aug = torch.cat([A, B], dim=-1)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    for i in range(n):
        pivot_row = aug[..., i, :]
        norm_row = pivot_row / pivot_row[..., i : i + 1]
        col = aug[..., :, i]
        # one fused rank-1 update that also lands the pivot row on norm_row
        aug = aug - (col - eye[i]).unsqueeze(-1) * norm_row.unsqueeze(-2)
    return aug[..., :, n:]


def inv3(A):
    """Closed-form 3x3 inverse via the adjugate; A: (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def inv6_block(A):
    """6x6 inverse by 3x3 block-Schur elimination; A: (..., 6, 6).

    The (1,1) block of the CMM base block is m*I and its Schur complement is
    the locked angular inertia through the Euler-rate map, invertible away
    from gimbal lock."""
    A11 = A[..., :3, :3]
    A12 = A[..., :3, 3:]
    A21 = A[..., 3:, :3]
    A22 = A[..., 3:, 3:]
    A11i = inv3(A11)
    A11i_A12 = mm(A11i, A12)
    S = A22 - mm(A21, A11i_A12)
    Si = inv3(S)
    A21_A11i = mm(A21, A11i)
    top_right = -mm(A11i_A12, Si)
    bottom_left = -mm(Si, A21_A11i)
    top_left = A11i - mm(top_right, A21_A11i)
    top = torch.cat([top_left, top_right], dim=-1)
    bottom = torch.cat([bottom_left, Si], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def solve_saddle_kkt(H, D, reg, rhs_top, rhs_bot):
    """Solve [[H, D^T], [D, -diag(reg)]] [x; y] = [rhs_top; rhs_bot].

    H (..., n, n), D (..., m, n), reg (..., m), rhs_top (..., n, k),
    rhs_bot (..., m, k).
    """
    kkt = torch.cat(
        [
            torch.cat([H, D.transpose(-1, -2)], dim=-1),
            torch.cat([D, -torch.diag_embed(reg)], dim=-1),
        ],
        dim=-2,
    )
    rhs = torch.cat([rhs_top, rhs_bot], dim=-2)
    return gauss_jordan_solve(kkt, rhs)

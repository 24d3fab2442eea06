"""Batched dense QP solver, OSQP-style ADMM: the qpOASES replacement
(wbc/qp.py counterpart).

Solves   min 0.5 x^T H x + g^T x   s.t.  l <= A x <= u
(equalities encoded as l == u, like the reference's qpOASES call in
WeightedWbc.cpp:29-64).  A fixed iteration count and one KKT inverse per
solve, reused across the iterations: the inverse is K5
(ops/gj_kernel.py::gauss_jordan_solve_pallas; its plain version for CPU
tensors), and the iterations are matrix-vector products and elementwise
ops.  Masked rows (0 <= 0 <= 0) are exactly feasible, which is how the
contact-mode-dependent constraint counts keep static shapes.

Per-row penalty: rows detected as equalities get a stiffer rho (OSQP's
heuristic), which makes the EoM rows behave like qpOASES's
``enableEqualities`` option.

Every argument takes any number of leading batch dimensions (the same on
all of them), and the whole batch's KKT systems go to K5 in one launch.
Nothing reads a value back to the host, so a solve can run inside a CUDA
graph.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.contract import mv
from ..ops.gj_kernel import gauss_jordan_solve_pallas


class QpSolution(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor  # dual for the row constraints
    primal_residual: torch.Tensor  # (...) inf-norm of A x - clip(Ax)
    dual_residual: torch.Tensor  # (...) inf-norm of H x + g + A^T y
    solved: torch.Tensor  # (...) bool: residuals under tolerance


def kkt_matrix(H, A, l, u, rho: float = 0.1, sigma: float = 1e-6, eq_rho_scale: float = 1e3):  # noqa: E741
    """(rho_vec (..., m), the quasi-definite ADMM KKT (..., n + m, n + m))
    [[H + sigma I, A^T], [A, -diag(1 / rho_vec)]]."""
    n = H.shape[-1]
    is_eq = (u - l) < 1e-9
    rho_vec = torch.where(is_eq, torch.full_like(l, rho * eq_rho_scale), torch.full_like(l, rho))
    eye_n = torch.eye(n, dtype=H.dtype, device=H.device)
    kkt = torch.cat(
        [
            torch.cat([H + sigma * eye_n, A.transpose(-1, -2)], dim=-1),
            torch.cat([A, -torch.diag_embed(1.0 / rho_vec)], dim=-1),
        ],
        dim=-2,
    )
    return rho_vec, kkt


def solve_qp(
    H,
    g,
    A,
    l,  # noqa: E741
    u,
    iters: int = 120,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eq_rho_scale: float = 1e3,
    tol: float = 1e-3,
) -> QpSolution:
    """H (..., n, n), g (..., n), A (..., m, n), l and u (..., m)."""
    n = H.shape[-1]
    rho_vec, kkt = kkt_matrix(H, A, l, u, rho, sigma, eq_rho_scale)
    # factorize once: the quasi-definite KKT's pivot-free inverse (K5);
    # the iterations are then matrix-vector products
    kkt_inv = gauss_jordan_solve_pallas(kkt, torch.eye(kkt.shape[-1], dtype=H.dtype, device=H.device).expand(kkt.shape))

    x = torch.zeros_like(g)
    z = torch.clamp(torch.zeros_like(l), l, u)
    y = torch.zeros_like(l)
    for _ in range(iters):
        y_rho = y / rho_vec
        sol = mv(kkt_inv, torch.cat([sigma * x - g, z - y_rho], dim=-1))
        x_t, nu = sol[..., :n], sol[..., n:]
        z_t = z + (nu - y) / rho_vec
        x_new = alpha * x_t + (1 - alpha) * x
        z_mix = alpha * z_t + (1 - alpha) * z
        z_new = torch.clamp(z_mix + y_rho, l, u)
        y = y + rho_vec * (z_mix - z_new)
        x, z = x_new, z_new

    ax = mv(A, x)
    primal = (ax - torch.clamp(ax, l, u)).abs().amax(-1)
    dual = (mv(H, x) + g + mv(A.transpose(-1, -2), y)).abs().amax(-1)
    # acceptance mirrors qpOASES' role in WeightedWbc: reject only genuine
    # failures (divergence / NaN), not finite-iteration ADMM residuals --
    # rejecting healthy solves would freeze the controller on a stale torque.
    finite = torch.isfinite(x).all(-1) & torch.isfinite(dual)
    return QpSolution(x=x, y=y, primal_residual=primal, dual_residual=dual, solved=(primal < tol) & finite)


def solve_qp_batch(H, g, A, l, u, **kw):  # noqa: E741
    """A leading batch axis on every argument (:func:`solve_qp` takes it as
    it is): one K5 launch for the batch."""
    return solve_qp(H, g, A, l, u, **kw)

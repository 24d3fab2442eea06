"""Parallel-in-time Riccati by associative scans over the node axis
(solver/parallel_riccati.py counterpart), batched over a leading scenario
axis B.

Each stage is a conditional value function

    f(x, z) = 1/2 (z - A x - b)^T C^{-1} (z - A x - b) + 1/2 x^T J x - eta^T x

held as the quintuple (A, b, C, eta, J) (Sarkka & Garcia-Fernandez,
temporal parallelization of LQT); composing two spans, min_y f1(x, y) +
f2(y, z), is associative and needs only (I + C1 J2)^{-1}.  Stage equality
constraints are folded in by a quadratic penalty rho before the elements are
built, so shapes stay static; the gains are then recovered with the exact
stage KKT of solver/riccati.py against the scanned value functions, and the
rollout is a second scan over affine maps.

:func:`solve_lqr_parallel` composes dense elements and raises on float32, as
the reference's does (the chain of (I + C J)^{-1} products loses the
solution in single precision).  :func:`solve_lqr_parallel_sqrt` keeps
C = U U^T and J = Z Z^T in factor form: with W = U1^T Z2,

    (I + C1 J2)^{-1} X = X - U1 (I + W W^T)^{-1} W (Z2^T X)

and every inverse is two triangular solves against the QR factor of
[W^T; I] (or [W; I]), so no Gram matrix is formed; one more QR per combine
re-triangularizes the factor stacks.

PyTorch has no associative scan; :func:`associative_scan` is the
reference's (``jax.lax.associative_scan``) recursion on plain tensors:
⌈log2 N⌉ levels of pairwise combines, in the same association order, so the
two packages round alike.  The value functions scan the reversed node axis,
the rollout the forward one.  Every solve here is a ``*_ex`` form without
its error check, which would read a value back to the host; QR and eigh
have none, so these backends are not run inside a CUDA graph.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ocp.problem import LinearizedNode
from .riccati import RiccatiSolution, _stage_kkt

_mT = lambda M: M.transpose(-1, -2)


def _solve(A, B):
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def _interleave(a, b, dim: int):
    """[a0, b0, a1, b1, ...] along dim; a has as many elements as b or one
    more."""
    n = a.shape[dim] + b.shape[dim]
    if a.shape[dim] > b.shape[dim]:
        pad = torch.zeros_like(a.narrow(dim, 0, 1))
        b = torch.cat([b, pad], dim=dim)
    out = torch.stack([a, b], dim=dim + 1).flatten(dim, dim + 1)
    return out.narrow(dim, 0, n)


def associative_scan(fn, elems, dim: int = 1):
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` with
    the associative fn(earlier, later): ``jax.lax.associative_scan``'s
    recursion (pairwise reduce, scan of the odd elements, fill-in of the
    even ones)."""
    cls = type(elems)
    make = (lambda fields: cls(*fields)) if hasattr(elems, "_fields") else tuple
    sl = lambda e, start, stop=None, step=1: make(
        [t[(slice(None),) * dim + (slice(start, stop, step),)] for t in e])

    def scan(e):
        n = e[0].shape[dim]
        if n < 2:
            return e
        reduced = fn(sl(e, 0, -1, 2), sl(e, 1, None, 2))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(sl(odd, 0, -1), sl(e, 2, None, 2))
        else:
            even = fn(odd, sl(e, 2, None, 2))
        even = make([torch.cat([t.narrow(dim, 0, 1), r], dim=dim) for t, r in zip(e, even)])
        return make([_interleave(a, b, dim) for a, b in zip(even, odd)])

    return scan(elems)


def _flip(e, dim: int = 1):
    return type(e)(*(t.flip(dim) for t in e))


class _Element(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _combine(e1: _Element, e2: _Element) -> _Element:
    """f1 spans [i, j], f2 spans [j, k] -> the combined span [i, k]."""
    nx = e1.A.shape[-1]
    I = torch.eye(nx, dtype=e1.A.dtype, device=e1.A.device)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    mTv = lambda M, v: (_mT(M) @ v[..., None])[..., 0]
    G1 = I + e1.C @ e2.J
    G2 = I + e2.J @ e1.C
    M = _solve(G1, e1.A)
    N = _solve(G2, e2.J)
    A = e2.A @ M
    b = mv(e2.A, _solve(G1, (e1.b + mv(e1.C, e2.eta))[..., None])[..., 0]) + e2.b
    C = e2.A @ _solve(G1, e1.C) @ _mT(e2.A) + e2.C
    eta = mTv(e1.A, _solve(G2, (e2.eta - mv(e2.J, e1.b))[..., None])[..., 0]) + e1.eta
    J = _mT(e1.A) @ N @ e1.A + e1.J
    return _Element(A=A, b=b, C=0.5 * (C + _mT(C)), eta=eta, J=0.5 * (J + _mT(J)))


def _penalized(nodes: LinearizedNode, eq_masks, penalty: float):
    """(R, P, r, Q, q): the stage quadratics with the masked equality rows
    folded in as a quadratic penalty."""
    D = eq_masks[..., None] * nodes.D
    C = eq_masks[..., None] * nodes.C
    e = (eq_masks * nodes.e)[..., None]
    Dt, Ct = penalty * _mT(D), penalty * _mT(C)
    R = nodes.Quu + Dt @ D
    P = nodes.Qux + Dt @ C
    r = nodes.qu + (Dt @ e)[..., 0]
    Q = nodes.Qxx + Ct @ C
    q = nodes.qx + (Ct @ e)[..., 0]
    return R, P, r, Q, q


def _stage_elements(nodes: LinearizedNode, eq_masks, penalty: float) -> _Element:
    """Per-stage elements with the constraints folded in as a penalty."""
    R, P, r, Q, q = _penalized(nodes, eq_masks, penalty)
    Rinv = torch.linalg.inv_ex(R, check_errors=False)[0]
    B = nodes.B
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    return _Element(
        A=nodes.A - B @ Rinv @ P,
        b=nodes.c - mv(B @ Rinv, r),
        C=B @ Rinv @ _mT(B),
        eta=-(q - mv(_mT(P) @ Rinv, r)),
        J=Q - _mT(P) @ Rinv @ P,
    )


def _value_tail(J_all, s_all):
    """(S, s) at nodes 1..N from the scanned value at nodes 0..N-1 (V_N = 0)."""
    zeros = lambda a: torch.zeros_like(a.narrow(1, 0, 1))
    return torch.cat([J_all[:, 1:], zeros(J_all)], dim=1), torch.cat([s_all[:, 1:], zeros(s_all)], dim=1)


def value_functions_parallel(nodes: LinearizedNode, eq_masks, penalty: float = 1e6):
    """(S, s) at nodes 1..N, (B, N, nx, nx) / (B, N, nx), by the associative
    scan over the reversed node axis: entry k is the value at node k+1."""
    elems = _stage_elements(nodes, eq_masks, penalty)
    # reversed time: the arguments arrive later-first
    scanned = _flip(associative_scan(lambda e_l, e_e: _combine(e_e, e_l), _flip(elems)))
    return _value_tail(scanned.J, -scanned.eta)


class _SqrtElement(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    U: torch.Tensor  # C = U U^T
    eta: torch.Tensor
    Z: torch.Tensor  # J = Z Z^T


def _qr_r(M):
    return torch.linalg.qr(M, mode="r")[1]


def _tria(M):
    """Lower-triangular T with T T^T = M M^T, for M (..., n, m), m >= n."""
    return _mT(_qr_r(_mT(M)))


def _solve_upper_t(R, X):
    """R^T Y = X for upper-triangular R."""
    return torch.linalg.solve_triangular(_mT(R), X, upper=False)


def _combine_sqrt(e1: _SqrtElement, e2: _SqrtElement) -> _SqrtElement:
    """:func:`_combine` in square-root form: every (I + C J)^{-1} is applied
    through the QR factors of I + W W^T and I + W^T W (W = U1^T Z2)."""
    nx = e1.A.shape[-1]
    I = torch.eye(nx, dtype=e1.A.dtype, device=e1.A.device).expand(e1.A.shape)
    W = _mT(e1.U) @ e2.Z
    # R_C^T R_C = I + W W^T ; R_J^T R_J = I + W^T W  (QR of tall stacks)
    R_C = _qr_r(torch.cat([_mT(W), I], dim=-2))
    R_J = _qr_r(torch.cat([W, I], dim=-2))

    def solve_RtR(R, X):  # (R^T R)^{-1} X by two triangular solves
        return torch.linalg.solve_triangular(R, _solve_upper_t(R, X), upper=True)

    g1inv = lambda X: X - e1.U @ solve_RtR(R_C, W @ (_mT(e2.Z) @ X))
    g2inv = lambda X: X - e2.Z @ solve_RtR(R_J, _mT(W) @ (_mT(e1.U) @ X))

    A = e2.A @ g1inv(e1.A)
    rhs_b = (e1.b + (e1.U @ (_mT(e1.U) @ e2.eta[..., None]))[..., 0])[..., None]
    b = (e2.A @ g1inv(rhs_b))[..., 0] + e2.b
    rhs_eta = (e2.eta - (e2.Z @ (_mT(e2.Z) @ e1.b[..., None]))[..., 0])[..., None]
    eta = (_mT(e1.A) @ g2inv(rhs_eta))[..., 0] + e1.eta

    # C = (A2 U1 R_C^{-1}) (.)^T + C2 ;  J = (A1^T Z2 R_J^{-1}) (.)^T + J1
    Y_C = _mT(_solve_upper_t(R_C, _mT(e2.A @ e1.U)))
    Y_J = _mT(_solve_upper_t(R_J, _mT(_mT(e1.A) @ e2.Z)))
    U = _tria(torch.cat([Y_C, e2.U], dim=-1))
    Z = _tria(torch.cat([Y_J, e1.Z], dim=-1))
    return _SqrtElement(A=A, b=b, U=U, eta=eta, Z=Z)


def _psd_sqrt(M, eps: float):
    """Z with Z Z^T = PSD(M), by eigh with the eigenvalues clipped at eps.
    A matrix with a non-finite entry (a Cholesky factor that failed
    upstream, as float32 can on the cold start's stage data) gets a
    non-finite factor, as the reference's eigh gives it, where torch's
    eigh on the card would raise that it did not converge."""
    S = 0.5 * (M + _mT(M))
    bad = ~torch.isfinite(S).all(-1).all(-1)[..., None, None]
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    lam, V = torch.linalg.eigh(torch.where(bad, eye, S))
    Z = V * torch.sqrt(torch.clamp(lam, min=eps))[..., None, :]
    return torch.where(bad, torch.full_like(Z, float("nan")), Z)


def _stage_elements_sqrt(nodes: LinearizedNode, eq_masks, penalty: float) -> _SqrtElement:
    """Per-stage square-root elements: U from the Cholesky factor of R (PD),
    Z from the PSD square root of the Schur complement Q - P^T R^{-1} P."""
    R, P, r, Q, q = _penalized(nodes, eq_masks, penalty)
    L, info = torch.linalg.cholesky_ex(R, check_errors=False)
    # a factorization that failed is NaN, as the reference's Cholesky returns it
    L = torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)
    Linv_P = torch.linalg.solve_triangular(L, P, upper=False)
    Linv_r = torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]
    Linv_Bt = torch.linalg.solve_triangular(L, _mT(nodes.B), upper=False)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    nx, nu = nodes.A.shape[-1], nodes.B.shape[-1]
    # C = B R^{-1} B^T = (B L^{-T})(.)^T, brought to exactly nx columns
    if nu >= nx:
        U = _tria(_mT(Linv_Bt))
    else:
        U = torch.cat([_mT(Linv_Bt), torch.zeros(nodes.A.shape[:-1] + (nx - nu,), dtype=R.dtype, device=R.device)],
                      dim=-1)
    return _SqrtElement(
        A=nodes.A - _mT(Linv_Bt) @ Linv_P,
        b=nodes.c - mv(_mT(Linv_Bt), Linv_r),
        U=U,
        eta=-(q - mv(_mT(Linv_P), Linv_r)),
        Z=_psd_sqrt(Q - _mT(Linv_P) @ Linv_P, 0.0),
    )


def value_functions_parallel_sqrt(nodes: LinearizedNode, eq_masks, penalty: float = 1e4):
    """(S, s) at nodes 1..N by the square-root scan (any float dtype)."""
    elems = _stage_elements_sqrt(nodes, eq_masks, penalty)
    scanned = _flip(associative_scan(lambda e_l, e_e: _combine_sqrt(e_e, e_l), _flip(elems)))
    return _value_tail(scanned.Z @ _mT(scanned.Z), -scanned.eta)


def _gains_and_rollout(nodes: LinearizedNode, eq_masks, S_next, s_next, dx0) -> RiccatiSolution:
    """Exact stage-KKT gains against the scanned value functions, then the
    rollout dx_{k+1} = (A - B K) dx_k + (c - B k) as a forward scan over
    affine maps."""
    _, _, Ks, ks = _stage_kkt(nodes, eq_masks, S_next, s_next)
    F = nodes.A - nodes.B @ Ks
    f = nodes.c - (nodes.B @ ks[..., None])[..., 0]

    def aff_comb(m1, m2):  # m1 earlier: x -> F1 x + f1; m2 later
        F1, f1 = m1
        F2, f2 = m2
        return F2 @ F1, (F2 @ f1[..., None])[..., 0] + f2

    Fp, fp = associative_scan(aff_comb, (F, f))
    dx_tail = (Fp @ dx0[:, None, :, None])[..., 0] + fp
    dx_all = torch.cat([dx0[:, None], dx_tail], dim=1)
    dus = -(Ks @ dx_all[:, :-1, :, None])[..., 0] - ks
    pred = (nodes.qx * dx_all[:, :-1]).sum((1, 2)) + (nodes.qu * dus).sum((1, 2))
    return RiccatiSolution(dx=dx_all, du=dus, K=Ks, k=ks, expected_decrease=pred)


def solve_lqr_parallel_sqrt(nodes: LinearizedNode, eq_masks, dx0, penalty: float = 1e4) -> RiccatiSolution:
    """float32-capable parallel-in-time constrained LQR: square-root value
    scan, exact stage-KKT gains, scanned rollout.  nodes (B, N, ...)."""
    S_next, s_next = value_functions_parallel_sqrt(nodes, eq_masks, penalty)
    return _gains_and_rollout(nodes, eq_masks, S_next, s_next, dx0)


def solve_lqr_parallel(nodes: LinearizedNode, eq_masks, dx0, penalty: float = 1e6) -> RiccatiSolution:
    """Parallel-in-time constrained LQR with dense elements; float64 only."""
    if nodes.A.dtype != torch.float64:
        raise NotImplementedError(
            "parallel Riccati requires float64 (f32 composition is unstable; "
            "use the sequential backend, which meets the latency budget)"
        )
    S_next, s_next = value_functions_parallel(nodes, eq_masks, penalty)
    return _gains_and_rollout(nodes, eq_masks, S_next, s_next, dx0)

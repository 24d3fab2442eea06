"""Small batched contractions (ops/contract.py counterpart).

The JAX package spells these as broadcast-multiply-reduce to keep tiny-dim
contractions off the TPU's matrix unit.  On a GPU a batched ``matmul`` is the
plain form, so these are thin wrappers that keep the reference's names.
"""
from __future__ import annotations


def mv(M, v):
    """(..., m, k) x (..., k) -> (..., m)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def mm(A, B):
    """(..., m, k) @ (..., k, n) -> (..., m, n)."""
    return A @ B


def quad(v, M, w):
    """v^T M w with batching: (..., m), (..., m, k), (..., k) -> (...,)."""
    return (v * mv(M, w)).sum(-1)

"""ctypes binding of the native ADMM iteration loop (wbc/native_qp.py
counterpart; native/host_qp.cc, read where it stands).

The C++ holds the inner fixed-point loop of the host WBC QP; problem
assembly and the SPD factorization stay in numpy (they are one-shot per
tick, the loop is not).  The library builds at its first use into
build/host_native/ (utils/native_build.py); a failed build or load raises.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..utils.native_build import load_native

_D = ctypes.POINTER(ctypes.c_double)


def load_library() -> ctypes.CDLL:
    """The ADMM CDLL, built on first use; raises if it cannot be."""
    lib = load_native("host_qp")
    lib.admm_iterate.argtypes = [_D] * 8 + [
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ] + [_D] * 4
    lib.admm_iterate.restype = None
    return lib


def admm_iterate_native(
    P_inv, A, rho_AT, g, l, u, rho_vec, inv_rho, sigma, alpha, iters, x, z, y  # noqa: E741
) -> None:
    """Run ``iters`` ADMM iterations natively, updating x, z, y in place."""
    lib = load_library()
    n, m = A.shape[1], A.shape[0]
    scratch = np.empty(2 * n + 2 * m, dtype=np.float64)
    as_ptr = lambda a: a.ctypes.data_as(_D)
    lib.admm_iterate(
        as_ptr(P_inv), as_ptr(A), as_ptr(rho_AT), as_ptr(g), as_ptr(l), as_ptr(u),
        as_ptr(rho_vec), as_ptr(inv_rho),
        ctypes.c_double(sigma), ctypes.c_double(alpha),
        ctypes.c_int(n), ctypes.c_int(m), ctypes.c_int(iters),
        as_ptr(x), as_ptr(z), as_ptr(y), as_ptr(scratch),
    )

"""K5: the batched pivot-free Gauss-Jordan solve as a hand-written CUDA
kernel (``csrc/gauss_jordan.cu``).

Replaces the TPU kernel ``_gj_kernel`` of ``bipedal_control_tpu/ops/pallas_gj.py``
(its ``pallas_call`` in ``gauss_jordan_solve_pallas``).  Its caller is the
device WBC's QP (``wbc/qp.py::solve_qp``), which inverts its quasi-definite
KKT here once per solve, for a whole batch of QPs in one launch.  The
plain PyTorch version is ``ops/linalg.py::gauss_jordan_solve``;
:func:`gauss_jordan_solve_pallas` runs it for CPU tensors only, and for CUDA
tensors launches the kernel or raises.  The kernel eliminates each
system once, in registers, in panels of 8 pivots: a system of n <= 40
rows and n + k <= 64 columns takes one warp (float32) or two (float64);
one of n <= 128 rows a CTA of 8 warps per 64 columns, one of n <= 192 a
CTA of 12: a thread-block cluster of such CTAs when it is wider (n + k <=
512; :func:`limits`).  The TPU kernel's padding of each system to (8, 128)
tiles has no counterpart.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import build_library, check_launch, check_tensor
from .linalg import gauss_jordan_solve


def build():
    built = build_library("gauss_jordan", "gauss_jordan.cu", {})
    for fn in (built.lib.gauss_jordan_f32, built.lib.gauss_jordan_f64):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    built.lib.gauss_jordan_config.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    built.lib.gauss_jordan_config.restype = ctypes.c_int
    built.lib.gauss_jordan_limits.argtypes = [ctypes.c_void_p]
    built.lib.gauss_jordan_limits.restype = None
    return built


def limits() -> tuple[int, int]:
    """The largest n and n + k the kernel takes, as its library states them."""
    out = (ctypes.c_longlong * 2)()
    build().lib.gauss_jordan_limits(out)
    return int(out[0]), int(out[1])


CONFIG_KEYS = ("kind", "ctas_per_system", "systems_per_cta", "threads_per_cta", "ctas", "shared_bytes_per_cta",
               "ctas_per_sm", "max_active_clusters", "registers", "local_bytes", "panels", "tile_rows",
               "tile_columns")
KINDS = ("S40", "L64", "T64")


def launch_config(batch, n, k, dtype):
    """The kernel's launch for (batch, n, k) in this dtype on the current
    card: the CTA shape (``kind``), CTAs per system (the cluster size),
    systems per CTA, the grid, shared bytes, resident CTAs per SM and warps
    per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), co-resident
    clusters, registers and local (spill) bytes per thread."""
    out = (ctypes.c_longlong * len(CONFIG_KEYS))()
    status = build().lib.gauss_jordan_config(torch.tensor([], dtype=dtype).element_size(), batch, n, k, out)
    check_launch(status, "Gauss-Jordan kernel's configuration query")
    cfg = dict(zip(CONFIG_KEYS, (int(v) for v in out)))
    cfg["kind"] = KINDS[cfg["kind"]]
    cfg["warps_per_sm"] = cfg["ctas_per_sm"] * cfg["threads_per_cta"] // 32
    return cfg


def gauss_jordan_solve_pallas(A, B):
    """Solve A X = B for quasi-definite A without pivoting.
    A: (..., n, n); B: (..., n, k) -> X: (..., n, k); on the card every
    system of the leading dimensions goes into one launch."""
    if A.device.type == "cpu":
        return gauss_jordan_solve(A, B)
    lead = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    n, k = A.shape[-1], B.shape[-1]
    flat = lambda t, w: t.expand(lead + (n, w)).reshape(-1, n, w).contiguous()
    return gauss_jordan_solve_cuda(flat(A, n), flat(B, k)).reshape(lead + (n, k))


def gauss_jordan_solve_cuda(A, B):
    """Launch the kernel on CUDA tensors; raises on anything it does not take."""
    dev, dtype = A.device, A.dtype
    if dev.type != "cuda":
        raise ValueError(f"Gauss-Jordan kernel needs CUDA tensors, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"Gauss-Jordan kernel takes float32 or float64, got {dtype}")
    batch, n, _ = A.shape
    k = B.shape[-1]
    check_tensor(A, "A", dev, dtype, (batch, n, n))
    check_tensor(B, "B", dev, dtype, (batch, n, k))
    max_n, max_width = limits()
    if n > max_n or n + k > max_width:
        raise ValueError(f"Gauss-Jordan kernel takes n <= {max_n} and n + k <= {max_width}, got n={n}, k={k}")
    X = torch.empty(batch, n, k, dtype=dtype, device=dev)
    lib = build().lib
    fn = lib.gauss_jordan_f32 if dtype == torch.float32 else lib.gauss_jordan_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(A.data_ptr(), B.data_ptr(), X.data_ptr(), batch, n, k, stream)
    check_launch(status, "Gauss-Jordan kernel")
    # a launch recorded into a CUDA graph runs only at the graph's replays, which call no wrapper
    if not torch.cuda.is_current_stream_capturing():
        gauss_jordan_solve_pallas.launches += 1
    return X


gauss_jordan_solve_pallas.launches = 0


# The systems the kernel is checked and timed on, and its bars against the
# plain version (the gpu tests, tools/k5_compare.py).


def quasi_definite(rng, batch: int, n: int, m: int) -> np.ndarray:
    """(batch, n, n) quasi-definite systems [[H, D'], [D, -I/2]] with
    H = W W' + I (n - m rows) and D (m rows) normal, from a numpy Generator:
    the arrangement of the device WBC's and the stage KKT's blocks."""
    W = rng.normal(size=(batch, n - m, n - m))
    A = np.zeros((batch, n, n))
    A[:, : n - m, : n - m] = W @ np.swapaxes(W, 1, 2) + np.eye(n - m)
    D = rng.normal(size=(batch, m, n - m))
    A[:, n - m :, : n - m] = D
    A[:, : n - m, n - m :] = np.swapaxes(D, 1, 2)
    A[:, n - m :, n - m :] = -0.5 * np.eye(m)
    return A


def solution_error(A, B, X) -> tuple[float, float]:
    """X's error against the plain version's solution of A X = B and the bar
    it must stay within (NaN, above any bar, if X is not finite).  float64:
    max|X - ref| relative to max(1, max|ref|), bar 1e-10.  float32: the
    backward error max|A X - B| (in float64), bar 4 x the plain version's
    + 1e-6 (the device WBC's KKT keeps only a few float32 digits of its
    inverse)."""
    want = gauss_jordan_solve(A, B)
    if not bool(torch.isfinite(X).all()):
        return float("nan"), 0.0
    if X.dtype == torch.float64:
        return float((X - want).abs().max()) / max(1.0, float(want.abs().max())), 1e-10
    residual = lambda Y: float((A.double() @ Y.double() - B.double()).abs().max())
    return residual(X), 4.0 * residual(want) + 1e-6

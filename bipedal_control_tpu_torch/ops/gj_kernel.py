"""K5: the batched pivot-free Gauss-Jordan solve as a hand-written CUDA
kernel (``csrc/gauss_jordan.cu``).

Replaces the TPU kernel ``_gj_kernel`` of ``bipedal_control_tpu/ops/pallas_gj.py``
(its ``pallas_call`` in ``gauss_jordan_solve_pallas``).  Its caller is the
device WBC's QP (``wbc/qp.py::solve_qp``), which inverts its quasi-definite
KKT here once per solve, for a whole batch of QPs in one launch.  The
plain PyTorch version is ``ops/linalg.py::gauss_jordan_solve``;
:func:`gauss_jordan_solve_pallas` runs it for CPU tensors only, and for CUDA
tensors launches the kernel or raises.  The kernel runs one thread block
per (system, tile of 32 right-hand-side columns); the TPU kernel's padding
of each system to (8, 128) tiles has no counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import build_library, check_launch, check_tensor
from .linalg import gauss_jordan_solve


def build():
    built = build_library("gauss_jordan", "gauss_jordan.cu", {})
    for fn in (built.lib.gauss_jordan_f32, built.lib.gauss_jordan_f64):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    built.lib.gauss_jordan_col_tile.argtypes = [ctypes.c_int]
    built.lib.gauss_jordan_col_tile.restype = ctypes.c_int
    return built


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

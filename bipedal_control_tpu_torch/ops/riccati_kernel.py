"""K2+K3: the constrained Riccati backward sweep and forward rollout as one
hand-written CUDA kernel (``csrc/riccati.cu``), compiled for the stage shapes
(nx, nu, ne) it is called with.

Replaces the TPU kernels ``_backward_kernel`` and ``_forward_kernel`` of
``bipedal_control_tpu/ops/pallas_riccati.py`` (their ``pallas_call`` sites
in ``riccati_backward_pallas`` and ``riccati_solve_pallas``).  The plain
PyTorch version is ``solver/riccati.py::riccati_plain``; it runs for CPU
tensors only.  For CUDA tensors :func:`riccati_solve` launches the kernel or
raises.

The library holds two builds of the one kernel, which give the same bits: 256
threads per scenario (two scenarios per SM at G1's shapes in float32), the
shorter chain, and 128 threads per scenario (four per SM), more chains in
flight.  A launch of B scenarios takes the 128-thread build when B is more
than the 256-thread build holds resident on the card (its CTAs per SM times
the SM count) and the 128-thread build holds more CTAs per SM than the
256-thread one for this dtype and these shapes; otherwise the 256-thread
build.  The CTAs per SM come from the CUDA occupancy query, made once per
(shapes, dtype, device) (:func:`residency`); :func:`choose_threads` is the
rule.  The 128-thread build exists in float32 only: in float64 it would
hold no more CTAs per SM than the 256-thread one (its occupancy query answers
0).  ``riccati_solve.launches`` counts every launch and
``riccati_solve.wide_launches`` those of the 128-thread build.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import check_launch, check_tensor

_FIELDS = ("A", "B", "c", "C", "D", "e", "Qxx", "Quu", "Qux", "qx", "qu")
_KERNEL_ORDER = ("A", "B", "Qxx", "Quu", "Qux", "C", "D", "e", "mask", "c", "qx", "qu")  # riccati.cu's Piece
BUILDS = (256, 128)  # threads per scenario: the latency build, the wide build


def shape_defines(nx: int, nu: int, ne: int) -> dict[str, str]:
    """The compile-time stage shapes of ``csrc/riccati.cu``."""
    return {"RICCATI_NX": str(nx), "RICCATI_NU": str(nu), "RICCATI_NE": str(ne)}


def build(nx: int, nu: int, ne: int):
    """Build (or load from the cache) the kernel library for these stage
    shapes; other shapes are another library, built on first use."""
    built = cuda_build.build_library("riccati", "riccati.cu", shape_defines(nx, nu, ne))
    for fn in (built.lib.riccati_solve_f32, built.lib.riccati_solve_f64):
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_double] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return built


def choose_threads(batch: int, resident: dict[int, int], sm_count: int) -> int:
    """The build for a launch of ``batch`` scenarios, given each build's
    resident CTAs per SM (threads -> CTAs) and the device's SM count."""
    if batch > resident[256] * sm_count and resident[128] > resident[256]:
        return 128
    return 256


_residency: dict[tuple, tuple[dict[int, int], int]] = {}


def residency(nx: int, nu: int, ne: int, dtype, device) -> tuple[dict[int, int], int]:
    """({threads: resident CTAs per SM} of each build, the SM count) for these
    shapes, dtype and CUDA device; queried once, then cached."""
    device = torch.device(device)
    key = (nx, nu, ne, dtype, device.index)
    if key not in _residency:
        lib = build(nx, nu, ne).lib
        word = torch.empty((), dtype=dtype).element_size()
        with torch.cuda.device(device):
            resident = {th: cuda_build.resident_per_sm(lib, "riccati", word, th)[0] for th in BUILDS}
        _residency[key] = (resident, torch.cuda.get_device_properties(device).multi_processor_count)
    return _residency[key]


def riccati_solve(nodes, masks, dx0, dual_eps: float, huu_reg: float):
    """Backward sweep + forward rollout over a scenario batch.

    nodes: LinearizedNode with leading axes (B, N); masks (B, N, ne);
    dx0 (B, nx).  Returns (K (B,N,nu,nx), k (B,N,nu), dx (B,N+1,nx),
    du (B,N,nu))."""
    if nodes.A.device.type == "cpu":
        from ..solver.riccati import riccati_plain

        return riccati_plain(nodes, masks, dx0, (dual_eps, huu_reg))
    return riccati_solve_cuda(nodes, masks, dx0, dual_eps, huu_reg)


def riccati_solve_cuda(nodes, masks, dx0, dual_eps: float, huu_reg: float):
    """Launch the kernel on CUDA tensors in the build :func:`choose_threads`
    picks; raises on anything it does not take."""
    A = nodes.A
    if A.device.type != "cuda":
        raise ValueError(f"riccati kernel needs CUDA tensors, got {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"riccati kernel takes float32 or float64, got {A.dtype}")
    Bn, _, nx, _ = A.shape
    threads = choose_threads(Bn, *residency(nx, nodes.B.shape[-1], nodes.e.shape[-1], A.dtype, A.device))
    return _launch(nodes, masks, dx0, dual_eps, huu_reg, threads)


def _launch(nodes, masks, dx0, dual_eps: float, huu_reg: float, threads: int):
    """Launch the build of ``threads`` threads per scenario: 256, or 128 in
    float32 only (the library refuses a float64 launch of 128)."""
    A = nodes.A
    Bn, N, nx, _ = A.shape
    nu = nodes.B.shape[-1]
    ne = nodes.e.shape[-1]
    shapes = {
        "A": (Bn, N, nx, nx), "B": (Bn, N, nx, nu), "c": (Bn, N, nx), "C": (Bn, N, ne, nx),
        "D": (Bn, N, ne, nu), "e": (Bn, N, ne), "Qxx": (Bn, N, nx, nx), "Quu": (Bn, N, nu, nu),
        "Qux": (Bn, N, nu, nx), "qx": (Bn, N, nx), "qu": (Bn, N, nu),
    }
    ins = {f: getattr(nodes, f) for f in _FIELDS}
    for f, t in ins.items():
        check_tensor(t, f, A.device, A.dtype, shapes[f])
    check_tensor(masks, "masks", A.device, A.dtype, (Bn, N, ne))
    check_tensor(dx0, "dx0", A.device, A.dtype, (Bn, nx))
    ins["mask"] = masks
    for f, t in ins.items():
        if t.data_ptr() % 16:  # the kernel's bulk copies read each input from a 16-byte aligned base
            raise ValueError(f"{f}: data not 16-byte aligned")
    K = torch.empty(Bn, N, nu, nx, dtype=A.dtype, device=A.device)
    k = torch.empty(Bn, N, nu, dtype=A.dtype, device=A.device)
    dx = torch.empty(Bn, N + 1, nx, dtype=A.dtype, device=A.device)
    du = torch.empty(Bn, N, nu, dtype=A.dtype, device=A.device)
    lib = build(nx, nu, ne).lib
    fn = lib.riccati_solve_f32 if A.dtype == torch.float32 else lib.riccati_solve_f64
    ptrs = (ctypes.c_void_p * len(_KERNEL_ORDER))(*[ins[f].data_ptr() for f in _KERNEL_ORDER])
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        status = fn(ptrs, dx0.data_ptr(), K.data_ptr(), k.data_ptr(), dx.data_ptr(), du.data_ptr(), Bn, N,
                    float(dual_eps), float(huu_reg), threads, stream)
    check_launch(status, "riccati kernel")
    # a launch recorded into a CUDA graph runs only at the graph's replays, which call no wrapper
    if not torch.cuda.is_current_stream_capturing():
        riccati_solve.launches += 1
        riccati_solve.wide_launches += threads == 128
    return K, k, dx, du


riccati_solve.launches = 0
riccati_solve.wide_launches = 0

"""K4: the line-search merit sums as a hand-written CUDA kernel
(``csrc/merit.cu`` on the circuit of ``csrc/centroidal_circuit.cuh``).

Replaces the TPU kernel ``_merit_kernel`` of
``bipedal_control_tpu/ops/pallas_merit.py`` (its ``pallas_call`` in
``_merit_sums_flat_static``, reached through ``make_merit_sums``).  Per
instance it returns [sum|defect|, sum defect^2, sum|eq|, sum eq^2].

The plain PyTorch version, :func:`merit_sums_plain`, computes the same sums
from ``ocp/linearize.py::node_defect_eq`` and runs for CPU tensors only.  For
CUDA tensors :func:`make_merit_sums`' evaluator launches the kernel or raises.
The kernel is compiled per robot topology (joint count, parents, joint
types, contact bodies, FK's level schedule and the group width); the
numeric constants ride in a parameter tensor.  Each instance is one
warp-synchronous group of lanes on the circuit the linearization kernel
uses (16 lanes for H1: two flow passes, J v and the four sums reduced by
shuffles), so 17,152 instances fill the card with ~274k threads.
"""
from __future__ import annotations

import ctypes

import torch

from ..ocp.problem import NUM_CONTACTS, NodeRefs
from .cuda_build import build_library, check_launch, check_tensor
from .static_model import circuit_static


def build(defines: dict[str, str]):
    built = build_library("merit", "merit.cu", defines)
    lib = built.lib
    lib.merit_param_size.restype = ctypes.c_int
    lib.merit_state_dim.restype = ctypes.c_int
    for fn in (lib.merit_sums_f32, lib.merit_sums_f64):
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def merit_sums_plain(model, info, settings, xs, us, xns, flags, vref, pref, dt):
    """Plain PyTorch merit sums over any leading dims: (..., 4)."""
    from ..ocp.linearize import node_defect_eq

    refs = NodeRefs(t=None, dt=dt, contact_flags=flags, swing_vref=vref, swing_pref=pref, x_nom=None, u_nom=None)
    defect, eq = node_defect_eq(model, info, settings, xs, us, xns, refs)
    return torch.stack(
        [defect.abs().sum(-1), (defect * defect).sum(-1), eq.abs().sum(-1), (eq * eq).sum(-1)], dim=-1
    )


def merit_sums_cuda(params, defines, gain: float, integrator: str, xs, us, xns, flags, vref, pref, dt):
    """Launch the kernel over a flat instance axis M on CUDA tensors:
    xs/xns (M, nx), us (M, nu), flags/vref/pref (M, 4), dt (M,) -> (M, 4)."""
    dev, dtype = xs.device, xs.dtype
    if dev.type != "cuda":
        raise ValueError(f"merit kernel needs CUDA tensors, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"merit kernel takes float32 or float64, got {dtype}")
    M, nx = xs.shape
    nu = us.shape[-1]
    lib = build(defines).lib
    if lib.merit_state_dim() != nx:
        raise ValueError(f"merit kernel compiled for nx={lib.merit_state_dim()}, got {nx}")
    check_tensor(params, "params", dev, dtype, (lib.merit_param_size(),))
    for name, t, shape in (
        ("xs", xs, (M, nx)), ("us", us, (M, nu)), ("xns", xns, (M, nx)), ("flags", flags, (M, NUM_CONTACTS)),
        ("vref", vref, (M, NUM_CONTACTS)), ("pref", pref, (M, NUM_CONTACTS)), ("dt", dt, (M,)),
    ):
        check_tensor(t, name, dev, dtype, shape)
    out = torch.empty(M, 4, dtype=dtype, device=dev)
    fn = lib.merit_sums_f32 if dtype == torch.float32 else lib.merit_sums_f64
    tensors = (params, xs, us, xns, flags, vref, pref, dt, out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*[t.data_ptr() for t in tensors], M, float(gain), int(integrator == "rk2"), stream)
    check_launch(status, "merit kernel")
    # a launch recorded into a CUDA graph runs only at the graph's replays, which call no wrapper
    if not torch.cuda.is_current_stream_capturing():
        merit_sums_cuda.launches += 1
    return out


merit_sums_cuda.launches = 0


def refusal(info, settings) -> str | None:
    """Why the kernel does not implement this configuration, as the TPU
    kernel does not (model_type != 0, integrators other than euler/rk2), or
    None where it does."""
    if info.model_type != 0:
        return "merit kernel supports FullCentroidalDynamics only"
    if settings.integrator not in ("euler", "rk2"):
        return f"merit kernel integrator {settings.integrator}"
    return None


def make_merit_sums(model, info, settings, static=None):
    """Merit evaluator f(xs, us, xns, flags, vref, pref, dt) -> (..., 4) over
    any leading dims: the kernel for CUDA tensors, the plain version for CPU
    tensors.  Raises for what the kernel does not implement (``refusal``).

    static: (kernel_defines, kernel_params tensor) of ops/static_model.py,
    prepared once by the caller; extracted from the model when not given."""
    reason = refusal(info, settings)
    if reason is not None:
        raise NotImplementedError(reason)
    defines, params = static if static is not None else circuit_static(model, info)
    gain = float(settings.position_error_gain)

    def merit(xs, us, xns, flags, vref, pref, dt):
        if xs.device.type == "cpu":
            return merit_sums_plain(model, info, settings, xs, us, xns, flags, vref, pref, dt)
        lead = xs.shape[:-1]
        flat = lambda a, w: a.reshape(-1, w).contiguous()
        out = merit_sums_cuda(
            params.to(device=xs.device, dtype=xs.dtype), defines, gain, settings.integrator,
            flat(xs, xs.shape[-1]), flat(us, us.shape[-1]), flat(xns, xns.shape[-1]),
            flat(flags, NUM_CONTACTS), flat(vref, NUM_CONTACTS), flat(pref, NUM_CONTACTS),
            dt.reshape(-1).contiguous(),
        )
        return out.reshape(lead + (4,))

    return merit

"""K1: the whole-node linearization as a hand-written CUDA kernel
(``csrc/linearize.cu`` on the circuit of ``csrc/centroidal_circuit.cuh``).

Replaces the TPU kernels ``_lin_kernel`` and ``_lin_kernel_fields`` of
``bipedal_control_tpu/ops/pallas_linearize_kernel.py`` (their ``pallas_call``
sites in ``linearize_flat_static``, reached through ``make_node_linearizer``,
and ``linearize_lanes_batched``, reached through ``solver/lanes_rti.py``).
Per (scenario, node) instance the kernel computes the FK-dependent node data
A, B, c, C, D, e of the same-point RK2 (or euler) structured linearization,
batch-leading and contiguous, in the layout ``riccati_kernel`` reads.

Each instance is one warp-synchronous group of lanes (16 for H1, two
instances per warp; ``static_model.group_width``), lane l owning coordinate
column l; FK runs by tree level (``static_model.level_schedule``), and the
outputs are written from the lanes' registers.  The kernel is bound by the
latency of each instance's chain rather than by its 6.8 KB of float32
stores; the source's note gives its register, shared-memory and occupancy
arithmetic, and ``cuda_build.resident_per_sm`` what the card fits.

The plain PyTorch version is ``ocp/linearize.py::linearize_node_structured``;
:func:`make_node_linearizer`'s linearizer runs it for CPU tensors only.  For
CUDA tensors it launches the kernel or raises, and adds the FK-free cost
quadratics in plain torch (``ocp/linearize.py::cost_quadratics``).
"""
from __future__ import annotations

import ctypes

import torch

from ..ocp.linearize import cost_quadratics, linearize_node_structured
from ..ocp.problem import NUM_CONTACTS, LinearizedNode
from .cuda_build import build_library, check_launch, check_tensor
from .static_model import circuit_static

NUM_EQ = 4 * NUM_CONTACTS


def build(defines: dict[str, str]):
    built = build_library("linearize", "linearize.cu", defines)
    lib = built.lib
    for fn in (lib.linearize_param_size, lib.linearize_state_dim, lib.linearize_input_dim):
        fn.restype = ctypes.c_int
    for fn in (lib.linearize_f32, lib.linearize_f64):
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def linearize_cuda(params, defines, gain: float, integrator: str, xs, us, xns, flags, vref, pref, dt):
    """Launch the kernel over a flat instance axis M on CUDA tensors:
    xs/xns (M, nx), us (M, nu), flags/vref/pref (M, 4), dt (M,) ->
    A (M,nx,nx), B (M,nx,nu), c (M,nx), C (M,16,nx), D (M,16,nu), e (M,16)."""
    dev, dtype = xs.device, xs.dtype
    if dev.type != "cuda":
        raise ValueError(f"linearize kernel needs CUDA tensors, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"linearize kernel takes float32 or float64, got {dtype}")
    if integrator not in ("euler", "rk2"):
        raise NotImplementedError(f"linearize kernel integrator {integrator}")
    M, nx = xs.shape
    nu = us.shape[-1]
    lib = build(defines).lib
    if (lib.linearize_state_dim(), lib.linearize_input_dim()) != (nx, nu):
        raise ValueError(f"linearize kernel compiled for nx={lib.linearize_state_dim()}, "
                         f"nu={lib.linearize_input_dim()}; got {nx}, {nu}")
    check_tensor(params, "params", dev, dtype, (lib.linearize_param_size(),))
    for name, t, shape in (
        ("xs", xs, (M, nx)), ("us", us, (M, nu)), ("xns", xns, (M, nx)), ("flags", flags, (M, NUM_CONTACTS)),
        ("vref", vref, (M, NUM_CONTACTS)), ("pref", pref, (M, NUM_CONTACTS)), ("dt", dt, (M,)),
    ):
        check_tensor(t, name, dev, dtype, shape)
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=dev)
    outs = (new(M, nx, nx), new(M, nx, nu), new(M, nx), new(M, NUM_EQ, nx), new(M, NUM_EQ, nu), new(M, NUM_EQ))
    fn = lib.linearize_f32 if dtype == torch.float32 else lib.linearize_f64
    tensors = (params, xs, us, xns, flags, vref, pref, dt) + outs
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*[t.data_ptr() for t in tensors], M, float(gain), int(integrator == "rk2"), stream)
    check_launch(status, "linearize kernel")
    # a launch recorded into a CUDA graph runs only at the graph's replays, which call no wrapper
    if not torch.cuda.is_current_stream_capturing():
        linearize_cuda.launches += 1
    return outs


linearize_cuda.launches = 0


def refusal(info, settings) -> str | None:
    """Why the kernel does not implement this configuration, as the TPU
    kernel does not (model_type != 0, the exact RK2 sensitivity, integrators
    other than euler/rk2), or None where it does."""
    if info.model_type != 0:
        return "linearize kernel supports FullCentroidalDynamics only"
    if settings.exact_rk2_sensitivity and settings.integrator == "rk2":
        return "linearize kernel implements same-point RK2 only"
    if settings.integrator not in ("euler", "rk2"):
        return f"linearize kernel integrator {settings.integrator}"
    return None


def make_node_linearizer(model, info, settings, Q, R, static=None):
    """Linearizer f(xs, us, xns, refs, settings_it=None) -> LinearizedNode
    over any leading (scenario, node) dims: the kernel plus the cost
    quadratics for CUDA tensors, the plain ``linearize_node_structured`` for
    CPU tensors.  settings_it, when given, are the settings of the SQP
    iteration (its barrier mu and delta: solver/sqp.py::iteration_settings),
    which the cost quadratics and the plain version use; the kernel's own
    inputs (the position-error gain and the integrator) are the same in
    every iteration and are taken from ``settings``.  Raises
    for what the kernel does not implement, as the TPU kernel does:
    model_type != 0, the exact RK2 sensitivity, and integrators other than
    euler/rk2.

    static: (kernel_defines, kernel_params tensor) of ops/static_model.py,
    prepared once by the caller; extracted from the model when not given."""
    reason = refusal(info, settings)
    if reason is not None:
        raise NotImplementedError(reason)
    defines, params = static if static is not None else circuit_static(model, info)
    gain = float(settings.position_error_gain)

    def linearize(xs, us, xns, refs, settings_it=None) -> LinearizedNode:
        s = settings if settings_it is None else settings_it
        if xs.device.type == "cpu":
            return linearize_node_structured(model, info, s, Q, R, xs, us, xns, refs)
        lead = xs.shape[:-1]
        flat = lambda a, w: a.reshape(-1, w).contiguous()
        outs = linearize_cuda(
            params.to(device=xs.device, dtype=xs.dtype), defines, gain, settings.integrator,
            flat(xs, xs.shape[-1]), flat(us, us.shape[-1]), flat(xns, xns.shape[-1]),
            flat(refs.contact_flags, NUM_CONTACTS), flat(refs.swing_vref, NUM_CONTACTS),
            flat(refs.swing_pref, NUM_CONTACTS), refs.dt.reshape(-1).contiguous(),
        )
        A, B, c, C, D, e = (t.reshape(lead + t.shape[1:]) for t in outs)
        return LinearizedNode(A, B, c, C, D, e, *cost_quadratics(info, s, Q, R, xs, us, refs))

    return linearize

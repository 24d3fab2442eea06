"""Replay a function of tensors from a CUDA graph (the port's counterpart
of ``jax.jit`` on the card's hot paths: MPC replans, the device WBC's tick,
the Kalman filter's step).

An op-by-op call of such a function is hundreds to thousands of small
launches, each taking the GIL back from whatever else runs (the 400 Hz
tick, the MPC worker); a graph replay is one launch.
"""
from __future__ import annotations

import gc

import numpy as np
import torch


class GraphedCall:
    """``fn(*inputs)`` (tensors on one CUDA device in, a tensor or a tuple
    or named tuple of tensors out, whose fields may be None) replayed from
    a CUDA graph.  The first call runs fn op
    by op on a side stream (it loads the kernels' libraries and settles the
    allocator) and returns its result, then captures the graph; a later call
    copies its input tensors into the graph's static buffers, replays the
    graph, and returns copies of the outputs (the next replay overwrites the
    graph's own).  A capture that fails raises: nothing falls back to op by
    op.

    The kernels' wrappers count the first call's launches only: a replay
    runs the captured kernels without calling a wrapper, so what a replay
    ran on the card is read from a profiler trace (chip_smoke.py)."""

    def __init__(self, fn):
        self._fn = fn
        self._graph = None

    def __call__(self, inputs):
        if self._graph is None:
            return self._run_and_capture(inputs)
        for static, t in zip(self._static, inputs):
            static.copy_(t)
        self._graph.replay()
        out = self._out
        if isinstance(out, torch.Tensor):
            return out.clone()
        fields = [None if o is None else o.clone() for o in out]
        return type(out)(*fields) if hasattr(out, "_fields") else tuple(fields)

    def _run_and_capture(self, inputs):
        dev = inputs[0].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = self._fn(*inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._static = [t.clone() for t in inputs]
        graph = torch.cuda.CUDAGraph()
        # no automatic garbage collection while capturing: a collection that frees another
        # graph (say, of a runner gone out of scope) resets it, which a capture forbids and
        # which invalidates this capture (torch.cuda.graph collects once before it begins)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._out = self._fn(*self._static)
        finally:
            if collecting:
                gc.enable()
        self._graph = graph
        return out


class HostCall:
    """``fn(packed)`` of one flat tensor, called from the host with numpy
    arrays: the arrays are packed into one float64 vector, cross to
    ``device`` as ``dtype``, and fn's tensor comes back as float64 numpy.
    On the CPU fn runs as plain tensor code; on the card the arrays go
    through one pinned buffer (a copy without a synchronisation) into a
    :class:`GraphedCall` of fn, and the copy back is the one
    synchronisation of a call."""

    def __init__(self, fn, width: int, dtype, device):
        self._fn, self.dtype, self.device = fn, dtype, torch.device(device)
        cuda = self.device.type == "cuda"
        self._pinned = torch.empty(width, dtype=dtype, pin_memory=True) if cuda else None
        self._graph = GraphedCall(fn) if cuda else None

    @property
    def graphed(self) -> bool:
        return self._graph is not None

    def __call__(self, *arrays) -> np.ndarray:
        packed = np.concatenate([np.asarray(a, dtype=np.float64).reshape(-1) for a in arrays])
        if self._graph is None:
            out = self._fn(torch.as_tensor(packed, dtype=self.dtype, device=self.device))
        else:
            self._pinned.numpy()[:] = packed
            out = self._graph([self._pinned.to(self.device, non_blocking=True)])
        return out.to(device="cpu", dtype=torch.float64).numpy()

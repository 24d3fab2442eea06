"""ctypes bindings of the native real-time runtime (runtime/native_rt.py
counterpart; native/rt_runtime.cc, read where it stands).

Provides:
- :class:`PolicySlot` — lock-free seqlock double buffer for the MPC -> control
  loop policy handoff (realtime_tools::RealtimeBuffer equivalent);
- :class:`RtLoop` — periodic loop with best-effort SCHED_FIFO and
  cycle-overrun accounting (BipedalHWLoop equivalent).

The library builds at its first use into build/host_native/
(utils/native_build.py); a failed build or load raises.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..utils.native_build import load_native


def load_library(hold_gil: bool = False) -> ctypes.CDLL:
    """The runtime library, built on first use; raises if it cannot be.
    ``hold_gil``: its calls keep the GIL (the policy slot's copies, which
    the control tick makes); the loop's start and stop must release it,
    because stop joins a thread whose callback takes the GIL."""
    lib = load_native("rt_runtime", ("-O2", "-pthread"), hold_gil=hold_gil)
    lib.policy_slot_create.restype = ctypes.c_void_p
    lib.policy_slot_create.argtypes = [ctypes.c_size_t]
    lib.policy_slot_destroy.argtypes = [ctypes.c_void_p]
    lib.policy_slot_write.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_size_t,
    ]
    lib.policy_slot_read.restype = ctypes.c_uint64
    lib.policy_slot_read.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_size_t,
    ]
    lib.rt_loop_start.restype = ctypes.c_void_p
    lib.rt_loop_start.argtypes = [
        ctypes.c_double,
        ctypes.c_int,
        ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p),
        ctypes.c_void_p,
    ]
    lib.rt_loop_stop.argtypes = [ctypes.c_void_p]
    lib.rt_loop_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.rt_loop_destroy.argtypes = [ctypes.c_void_p]
    return lib


class PolicySlot:
    """Single-writer multi-reader snapshot buffer for flat float64 blobs."""

    def __init__(self, n_doubles: int):
        self._lib = load_library(hold_gil=True)
        self._n = n_doubles
        self._h = self._lib.policy_slot_create(n_doubles)

    def write(self, arr: np.ndarray) -> None:
        flat = np.ascontiguousarray(arr, dtype=np.float64).reshape(-1)
        self._lib.policy_slot_write(
            self._h, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), flat.size
        )

    def read(self) -> tuple[int, np.ndarray]:
        """(sequence, snapshot); sequence == 0 means nothing published yet."""
        out = np.empty(self._n, dtype=np.float64)
        seq = self._lib.policy_slot_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), out.size
        )
        return int(seq), out

    def close(self) -> None:
        if self._h:
            self._lib.policy_slot_destroy(self._h)
            self._h = None


_CB_TYPE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)


class RtLoop:
    """Native periodic loop calling a Python callback (returns True to stop).

    A callback exception stops the loop and is recorded on ``exception`` so
    the owner can distinguish a crash from a deliberate stop (and react,
    e.g. write a damping command) instead of the loop dying silently.
    """

    def __init__(self, frequency_hz: float, callback, priority: int = 0):
        self._lib = load_library()
        self.exception: BaseException | None = None

        def _tramp(_):
            try:
                return 1 if callback() else 0
            except BaseException as e:  # noqa: BLE001 — crash must stop the loop
                self.exception = e
                return 1

        self._cb = _CB_TYPE(_tramp)  # keep a reference alive
        self._h = self._lib.rt_loop_start(frequency_hz, priority, self._cb, None)

    @property
    def failed(self) -> bool:
        return self.exception is not None

    def stop(self) -> None:
        if self._h:
            self._lib.rt_loop_stop(self._h)

    def stats(self) -> dict:
        out = (ctypes.c_int64 * 4)()
        self._lib.rt_loop_stats(self._h, out)
        return {
            "cycles": out[0],
            "overruns": out[1],
            "max_cycle_ns": out[2],
            "last_cycle_ns": out[3],
        }

    def close(self) -> None:
        if self._h:
            self._lib.rt_loop_destroy(self._h)
            self._h = None

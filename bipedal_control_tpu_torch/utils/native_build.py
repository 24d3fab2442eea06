"""Build the host-side C++ of ``native/`` with g++ and load it with ctypes.

The controller's tick runs small C++ libraries on the CPU: the host model
and the real-time runtime, whose sources stay where the JAX package reads
them (``native/*.cc``), and the port's own host WBC
(``bipedal_control_tpu_torch/native/host_wbc.cc``).  This module compiles
them into ``build/host_native/`` at the repository root, one directory per
source named by a hash of the source and the flags:

    g++ <flags> -shared -fPIC -std=c++17 -o lib<stem>.so <dir>/<stem>.cc

A library builds at its first use, never at import.  ``hold_gil=True``
loads it as a ``ctypes.PyDLL``, whose calls keep the GIL: the control
tick's short calls take that form, because a call that releases the GIL
must take it back afterwards, and while another Python thread (the MPC
worker) runs, each taking-back waits up to the interpreter's switch
interval.  The tick's one long call, the host WBC's QP, releases it, so
that the worker's host code runs meanwhile.  The compiler writes a
temporary file that is renamed into place, so two processes may build the
same library at once.  A failed build or load raises: there is no fallback
here, and the numpy twins run only where the caller asks for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
PORT_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_native"
CXX = "g++"

_loaded: dict[tuple, ctypes.CDLL] = {}
_lock = threading.Lock()


def load_native(stem: str, flags: tuple[str, ...] = ("-O3",), hold_gil: bool = False) -> ctypes.CDLL:
    """native/<stem>.cc (else the port's native/<stem>.cc) built with
    ``flags`` and loaded (cached per process): as a ``ctypes.PyDLL``, whose
    calls keep the GIL, when ``hold_gil``, else as a ``ctypes.CDLL``."""
    request = (stem, flags, str(BUILD_DIR), CXX, hold_gil)
    with _lock:
        if request not in _loaded:
            _loaded[request] = (ctypes.PyDLL if hold_gil else ctypes.CDLL)(str(_build(stem, flags)))
        return _loaded[request]


def _build(stem: str, flags: tuple[str, ...]) -> Path:
    src = NATIVE_DIR / f"{stem}.cc"
    if not src.exists():
        src = PORT_NATIVE_DIR / f"{stem}.cc"
    cmd_flags = (*flags, "-shared", "-fPIC", "-std=c++17")
    h = hashlib.sha256(src.read_bytes())
    h.update(repr(cmd_flags).encode())
    out_dir = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{stem}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    cmd = [CXX, *cmd_flags, str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler for {src.name}: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"C++ build failed for {src.name}:\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib

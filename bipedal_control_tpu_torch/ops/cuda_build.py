"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source in ``csrc/`` exposes a plain C interface (device pointers
and the CUDA stream as ``void*``; every entry returns ``cudaGetLastError()``),
so it compiles in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -I csrc -o lib<name>.so <name>_unit.cu

where ``<name>_unit.cu`` is generated beside the library: the compile-time
defines (robot topology) followed by ``#include "<name>.cu"``.

Libraries are cached under ``build/torch_kernels/`` at the repository root,
keyed by a hash of the sources, the compile-time defines and the flags, so
the first call in a fresh checkout builds everything and later calls load;
:func:`build_libraries` starts one nvcc per library at once.  A lock file
beside each library (``flock``, released when its process ends) makes
processes that start together build it once.  The
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    ptxas_report: str
    build_seconds: float  # 0.0 when loaded from the cache


_loaded: dict[tuple, BuiltLibrary] = {}  # (name, source, defines) -> library: launches skip the hashing


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build_libraries(requests) -> list[BuiltLibrary]:
    """Build several (name, source, defines) libraries at once, one nvcc
    process each, all started together."""
    with ThreadPoolExecutor(max_workers=max(1, len(requests))) as pool:
        return list(pool.map(lambda r: build_library(*r), requests))


def build_library(name: str, source: str, defines: dict[str, str]) -> BuiltLibrary:
    """Compile csrc/<source> (or a source at an absolute path) under the
    given #defines and load it; the cache key hashes every csrc file, the
    source, the defines and the flags."""
    request = (name, source, tuple(sorted(defines.items())))
    if request in _loaded:
        return _loaded[request]
    srcs = sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update((CSRC / source).read_bytes())
    # the defines go into a generated translation unit: nvcc would split a
    # comma-separated -D value (PARENT_LIST=0,1,2) into several options
    unit = "".join(f"#define {k} {v}\n" for k, v in sorted(defines.items())) + f'#include "{source}"\n'
    h.update(repr((unit, ARCH_FLAGS, NVCC_FLAGS)).encode())
    key = f"{name}-{h.hexdigest()[:16]}"
    out_dir = BUILD_DIR / key
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "ptxas.txt"
    seconds = 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    # processes that start together (the ranks of a world) build a library
    # once: the first holds the lock while it builds, the others then load
    with open(out_dir / "build.flock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            unit_path = out_dir / f"{name}_unit.cu"
            unit_path.write_text(unit)
            cmd = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(unit_path)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source}:\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)
    built = BuiltLibrary(
        lib=ctypes.CDLL(str(lib_path)),
        ptxas_report=log_path.read_text() if log_path.exists() else "",
        build_seconds=seconds,
    )
    _loaded[request] = built
    return built


def resident_per_sm(lib, name: str, dtype_bytes: int, *shape: int) -> tuple[int, int]:
    """(blocks, warps) of a library's kernel resident on one SM, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor through the library's
    ``<name>_blocks_per_sm(dtype_bytes, *shape)`` and
    ``<name>_block_threads(*shape)``."""
    blocks = getattr(lib, f"{name}_blocks_per_sm")(dtype_bytes, *shape)
    if blocks < 0:
        raise RuntimeError(f"{name}: CUDA error {-blocks} in the occupancy query")
    threads = getattr(lib, f"{name}_block_threads")(*shape)
    return blocks, blocks * ((threads + 31) // 32)


def check_launch(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def check_tensor(t, name: str, device, dtype, shape) -> None:
    """Raise unless t is a contiguous tensor of this device, dtype and shape."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")

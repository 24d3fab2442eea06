"""Time K5 (the batched Gauss-Jordan solve) against an earlier build of it on one GPU.

    git show <commit>:bipedal_control_tpu_torch/csrc/gauss_jordan.cu > build/k5_parent.cu
    python3 tools/k5_compare.py --parent build/k5_parent.cu [--rounds N]

Builds the port's kernel (csrc/gauss_jordan.cu) and the --parent source, a
file with the same C entries (gauss_jordan_f32/f64), through
ops/cuda_build.py, both nvcc processes at once.  Each is checked against the
plain version on the systems it is timed on (gj_kernel.solution_error's
bars), then timed in turns, port then parent, for --rounds rounds (default
2) beside torch.linalg.solve of the same systems, at:
  - the device WBC's KKT shape, 128 x 128 against eye(128): B = 1 (device
    time from a CUDA graph of 50 launches) and B = 256 (CUDA events over
    20), float32 and float64;
  - the stage KKT, (38 x 38 | 23) x 17,152 systems (CUDA events over 20).
The systems are gj_kernel.quasi_definite's, from a fixed seed; the times
depend on the shapes only.  torch.linalg.solve checks its result on the
host, so it is not captured: CUDA events over 10 calls.  The timers are
chip_smoke.py's.  Prints the card's name and power limit first and a JSON
line of every time last; exits non-zero if a build does not compile or
disagrees, or without a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bipedal_control_tpu_torch.ops import gj_kernel  # noqa: E402
from bipedal_control_tpu_torch.ops.cuda_build import build_libraries  # noqa: E402
from chip_smoke import cuda_time_ms, graph_time_ms  # noqa: E402

SHAPES = [("wbc_kkt", 1, 128, 86, 128), ("wbc_kkt", 256, 128, 86, 128), ("stage_kkt", 17152, 38, 16, 23)]


def solver(lib):
    """A (batch, n, n), B (batch, n, k) -> X through one library's entries."""
    for fn in (lib.gauss_jordan_f32, lib.gauss_jordan_f64):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def solve(A, B):
        X = torch.empty(A.shape[0], A.shape[1], B.shape[2], dtype=A.dtype, device=A.device)
        fn = lib.gauss_jordan_f32 if A.dtype == torch.float32 else lib.gauss_jordan_f64
        status = fn(A.data_ptr(), B.data_ptr(), X.data_ptr(), A.shape[0], A.shape[1], B.shape[2],
                    torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"CUDA error {status} at launch")
        return X

    return solve


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True, help="path of an earlier gauss_jordan.cu")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tools/k5_compare.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    port, parent = build_libraries([("gauss_jordan", "gauss_jordan.cu", {}),
                                    ("gauss_jordan_parent", os.path.abspath(args.parent), {})])
    solvers = {"port": solver(port.lib), "parent": solver(parent.lib), "torch.linalg.solve": torch.linalg.solve}
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    times, failures = {}, []
    for tag, batch, n, m, k in SHAPES:
        for dtype in (torch.float32, torch.float64):
            A = torch.as_tensor(gj_kernel.quasi_definite(rng, batch, n, m), dtype=dtype, device=device)
            B = (torch.eye(n, dtype=dtype, device=device).expand(batch, n, n).contiguous() if k == n
                 else torch.as_tensor(rng.normal(size=(batch, n, k)), dtype=dtype, device=device))
            key = f"{tag} B={batch} {str(dtype)[6:]}"
            for name in ("port", "parent"):
                err, bar = gj_kernel.solution_error(A, B, solvers[name](A, B))
                if not err <= bar:
                    failures.append(f"{name} {key}: {err:.3e} (bar {bar:.3e})")
            times[key] = {name: [] for name in solvers}
            for _ in range(args.rounds):
                for name, solve in solvers.items():
                    if name == "torch.linalg.solve":
                        ms = cuda_time_ms(lambda: solve(A, B), 10)
                    elif batch == 1:
                        ms = graph_time_ms(lambda: solve(A, B), 50)
                    else:
                        ms = cuda_time_ms(lambda: solve(A, B), 20)
                    times[key][name].append(ms)
            print(f"{key}: " + "; ".join(f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
                                          for name, ts in times[key].items()) + " ms")
    for f in failures:
        print("DISAGREES:", f)
    print(json.dumps({"device": smi, "ms": times, "disagree": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase 12(b)'s RtLoop on two trees of the port, in turns, on one GPU.

    python3 tools/rt_loop_turns.py TREE_A TREE_B

A tree is a checkout of this repo (a commit unpacked by ``git archive`` into
a directory that .gitignore lists, such as build/).  The runs go A, B, B, A,
each in a process of its own that imports that tree's chip_smoke.py and
package, and each drives twice what phase 12(b) drives: a trotting
asynchronous controller on G1 in float32 on the replay plant, run for 1.0 s
by RtControllerRunner at 400 Hz beside its MPC worker.  Each drive prints
one JSON line: the loop's cycles and overruns, the commands written, the
replans published, and percentiles in ms of each part of the cycles (the
start, where the tree's runner records it: the wait before the callback;
read, update, write; cycle = read + update + write) and of the policy's
staleness.  Hosts differ by up to 3x: compare trees only within one call.
Exits non-zero if a run fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


DRIVES = 2  # per process


def drive(tree: str) -> None:
    """The tree's RtLoop, DRIVES times, one JSON line each."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from bipedal_control_tpu_torch.runtime.rt_runner import RtControllerRunner

    cs.set_full_f32_matmul()
    g1, _ = cs.load_g1(torch.device("cuda", 0))
    iface32 = g1.to(dtype=torch.float32)
    for _ in range(DRIVES):
        ctrl = cs.trotting_controller(iface32, mpc_async=True)
        plant = cs.Replay(iface32)
        ctrl.starting(0.0, plant.rbd)
        written = []
        runner = RtControllerRunner(ctrl, read=lambda: plant.measure(ctrl), write=written.append,
                                    frequency_hz=400.0, priority=0)
        try:
            runner.start()
            time.sleep(1.0)
            stats = runner.stats()
        finally:
            runner.stop()
            ctrl.stop()
        if runner.failed or not ctrl.safe:
            raise RuntimeError(f"{tree}: the loop failed or went unsafe")
        cycle = np.asarray(runner.cycle_seconds)
        names = ("start", "read", "update", "write")[4 - cycle.shape[1]:]
        parts = {n: cs.percentiles(cycle[:, i]) for i, n in enumerate(names)}
        parts["cycle"] = cs.percentiles(cycle[:, -3:].sum(axis=1))
        stale = ctrl.report()["policy_staleness_s"]
        print(json.dumps({
            "tree": tree, "cycles": stats["cycles"], "overruns": stats["overruns"], "written": len(written),
            "replans": ctrl.async_mpc.solve_count,
            "parts_ms": {k: {q: round(v[q], 4) for q in ("p50_ms", "p99_ms", "max_ms")} for k, v in parts.items()},
            "staleness_ms": {q: round(v * 1e3, 3) for q, v in stale.items()},
        }), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        drive(args[1])
        return 0
    a, b = args
    failed = 0
    for tree in (a, b, b, a):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                           capture_output=True, text=True, timeout=600)
        print("\n".join(ln for ln in p.stdout.splitlines() if ln.startswith("{")), flush=True)
        if p.returncode:
            failed += 1
            print(f"[rt_loop_turns] {tree}: exit {p.returncode}\n{p.stderr[-2000:]}", file=sys.stderr, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

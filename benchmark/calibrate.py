"""Read a cell's check on many seeds: the program's readings, the
control's (the reference in the program's place, one precision lower) and
those of planted faults, from which the check's limits are set.  Not run by
the benchmark's own runs.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control tf32]
        [--faults unchanged,half,altered --fault-seeds 4,5,6] [--seconds 2] [--out path.jsonl]

Each seed sets the cell up, runs a window of ``--seconds`` and checks it;
with ``--control`` the same run is checked a second time with the control
in the program's place.  Each line printed is one reading as JSON.
"""
import argparse
import gc
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(cell, seconds, fault=None, control=None):
    import torch

    from benchmark import core
    from benchmark.faults import FAULTS

    drv = core.driver_for(cell)(cell, fault=FAULTS[fault] if fault else None)
    t0 = time.perf_counter()
    drv.setup()
    setup = time.perf_counter() - t0
    drv.window(seconds)
    drv.release()
    gc.collect()
    torch.cuda.empty_cache()
    out = []
    for mode in [None] + ([control] if control else []):
        t0 = time.perf_counter()
        numbers = drv.check(control=mode)
        out.append({"workload": cell.name, "seed": cell.seed, "mode": fault and f"fault:{fault}" or mode or "program",
                    "numbers": {n: v for n, v, _ in numbers}, "setup_s": setup, "check_s": time.perf_counter() - t0})
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default=None)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, _ROOT)
    import torch

    from benchmark import core

    if not torch.cuda.is_available():
        raise SystemExit("calibrate reads the check on the card")
    manifest = core.load_manifest()
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), f) for f in args.faults.split(",") if f for s in args.fault_seeds.split(",") if s]
    for seed, fault in runs:
        cell = core.find_cell(manifest, args.workload, seed, False)
        cell.device = torch.device("cuda", 0)
        for r in reading(cell, args.seconds, fault, None if fault else args.control):
            line = json.dumps(r)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")


if __name__ == "__main__":
    main()

"""Run one cell of the PyTorch/CUDA port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's entries are in BENCHMARK.json, its
traffic in benchmark/workloads/<cell>.json and its configuration in the
file BENCHMARK.json names.  The run sets the cell up from the seed (counted
as ``setup_s``, from this process's start), measures for ``--seconds``,
then checks what the window produced against the plain reference of
benchmark/reference.  With ``--trace 0`` the result carries the cell's
end-to-end metrics; with ``--trace 1`` a short profiled segment follows the
window, and the result carries the per-layer metrics, the device's busy
time and a breakdown.  The numbers compared, each with its limit, are the
last lines of standard error and the last key of the result, which is the
last line of standard output.

Exits non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for) and when a module of JAX or of the JAX package is loaded.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, and
    one host thread for the CPU's math libraries: the run is one process on
    a host that other work shares, where idle pool threads that spin only
    take cores from the thread that feeds the card."""
    cache = os.path.join(_ROOT, "build", "bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def run_cell(cell, seconds: float, driver=None) -> dict:
    """Set up, window, optional traced segment, the check: the result's
    fields.  ``driver`` is a Driver already made (the tests plant faults in
    one)."""
    import torch

    from benchmark import core

    manifest = core.load_manifest()
    drv = driver or core.driver_for(cell)(cell)
    drv.setup()
    setup_s = time.perf_counter() - _T0
    res = drv.window(seconds)
    metrics, breakdown = {}, None
    cuda = torch.device(cell.device).type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(cell.workload["chips"])}
    if not cell.trace:
        for m in core.end_to_end_of(manifest, cell.name):
            value = setup_s if m["name"] == "setup_s" else res[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof, wall, counts = drv.trace_segment(lambda: profile(activities=acts))
        reading = core.read_trace(prof, wall)
        del prof
        ctx = {"trace": reading, "counts": counts, "samples": drv.samples, "shapes": drv.shapes(),
               "window": res, "cell": cell.name}
        for m in core.per_layer_of(manifest, cell.name):
            value = core.read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=reading.busy_s, window_s=reading.window_s)
        breakdown = reading.breakdown()
    device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if cuda else 0
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the traffic file's limits name the numbers compared; the others the
    # check works out are not judged (benchmark/calibrate.py prints them)
    compared = [(name, value, limit) for name, value, limit in drv.check() if limit is not None]
    correct = bool(compared) and all(math.isfinite(value) and value <= limit for _, value, limit in compared)
    return {"correct": correct, "attempted": drv.attempted, "failed": drv.failed, "metrics": metrics,
            "device": device, "compared": compared, "breakdown": breakdown}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, _ROOT)
    import torch

    torch.set_num_threads(1)

    from benchmark import core

    cell = core.find_cell(core.load_manifest(), args.workload, args.seed, bool(args.trace))
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}: no result", file=sys.stderr)
        return 3
    cell.device = torch.device("cuda", 0)
    print(f"benchmark: {cell.name} seed {args.seed}, {args.seconds} s, trace {args.trace}; card: "
          f"{core.card_power_limit() or torch.cuda.get_device_name(0)}", file=sys.stderr, flush=True)
    out = run_cell(cell, args.seconds)
    loaded = core.forbidden_modules()
    if loaded:
        print(f"benchmark: forbidden modules loaded in this process: {loaded}: no result", file=sys.stderr)
        return 4
    lines = [f"compared {name}: {value!r} (limit {limit!r})" for name, value, limit in out["compared"]]
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(core.result_line(out["correct"], out["attempted"], out["failed"], out["metrics"], out["device"],
                           out["compared"], out["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

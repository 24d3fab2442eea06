"""What every cell shares: the manifest and the files found by name, the
device's description, the reading of a profiler trace, the per-layer
metrics' readers, the import check and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its traffic file
is ``benchmark/workloads/<cell>.json``; its ``kind`` names the driver
(``benchmark/drivers/<kind>.py``) that sets the cell up, runs its window and
checks what the window produced.  Its configuration's file is the one that
``BENCHMARK.json`` names.  A per-layer metric ``<name>`` is read by
``benchmark/metrics/<name>.py``'s ``read(ctx)``, which returns a number or
None when the trace holds nothing for it.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# top-level module names that may not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "bipedal_control_tpu")

# the port's hand-written kernels, as the profiler's kernel events name them
KERNELS = {"K1": "linearize_kernel", "K23": "riccati_kernel", "K4": "merit_kernel", "K5": "gj_kernel"}


@dataclasses.dataclass
class Cell:
    """One run's cell: its entries, its files' contents and the arguments."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    trace: bool
    device: object = None

    def path(self, rel: str) -> str:
        """A path of the configuration (relative to the checkout's root)."""
        return str(ROOT / rel)


def sync(device) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def find_cell(manifest: dict, name: str, seed: int, trace: bool) -> Cell:
    """The cell ``name`` with its configuration and traffic files read."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    workload = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(ROOT / configs[workload["config"]]["file"]) as fh:
        config = json.load(fh)
    with open(BENCH / "workloads" / f"{name}.json") as fh:
        traffic = json.load(fh)
    return Cell(name=name, workload=workload, config=config, traffic=traffic, seed=seed, trace=trace)


def driver_for(cell: Cell):
    """The driver class of the cell's traffic kind."""
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}").Driver


def end_to_end_of(manifest: dict, cell: str) -> list[dict]:
    return [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_of(manifest: dict, cell: str) -> list[dict]:
    """The per-layer metrics a traced run of ``cell`` reports: those that
    list it."""
    return [m for m in manifest["per_layer"] if cell in m["workloads"]]


def read_metric(name: str, ctx: dict):
    """``benchmark/metrics/<name>.py``'s reading of ``ctx``, or None."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them ('' if it
    cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


# ------------------------------------------------------------------ the trace
@dataclasses.dataclass
class TraceReading:
    """What a profiled window shows: the device's activities (name, start
    and end in us), the busy time (the union of their intervals), the
    window's wall length, and the host's activity over each idle gap."""

    device_ops: list
    busy_s: float
    window_s: float
    idle_by_host: dict

    def seconds_of(self, kernel: str) -> float:
        """Device seconds of the activities whose name holds ``kernel`` as a
        word."""
        import re

        pat = re.compile(rf"\b{kernel}\b")
        return sum(e - s for n, s, e in self.device_ops if pat.search(n)) / 1e6

    def count_of(self, kernel: str) -> int:
        import re

        pat = re.compile(rf"\b{kernel}\b")
        return sum(1 for n, _, _ in self.device_ops if pat.search(n))

    def breakdown(self) -> dict:
        by_name: dict = {}
        for n, s, e in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], v] for n, v in top], "idle_gaps": [[n[:120], v] for n, v in gaps]}


def idle_percent(trace: TraceReading):
    """1 - (union of the device's activity intervals) / (the traced
    segment's wall time), in %; None where the device ran nothing."""
    if not trace.device_ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def topology(cell):
    """The robot's tree as the roofline counters read it, from the
    reference's own model of the configuration's URDF."""
    import torch

    from .reference.frontend import make_problem
    from .roofline import Topology

    files = {k: cell.path(v) for k, v in cell.config["files"].items()}
    return Topology.of(make_problem(files, cell.config["solver"], "cpu", torch.float64).model)


def _union(spans):
    """(busy us, merged intervals) of sorted (start, end) spans."""
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def read_trace(prof, window_s: float) -> TraceReading:
    """Reduce a finished ``torch.profiler.profile`` (CPU and CUDA
    activities) to a :class:`TraceReading`.  Each idle gap of the device
    inside its first and last activity is put down to what the host was in
    at the gap's start: the outermost ``bench.`` span and the innermost
    host operation around that instant."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev, host = [], []
    for e in events:
        if getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
            if e.device_type == DeviceType.CUDA:
                continue  # a span's mirror on the device timeline, not device work
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, float(e.time_range.start), float(e.time_range.end)))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, float(e.time_range.start), float(e.time_range.end)))
    dev.sort(key=lambda t: t[1])
    busy_us, merged = _union([(s, e) for _, s, e in dev])
    host.sort(key=lambda t: t[1])
    bench = [h for h in host if h[0].startswith("bench.")]
    ops = [h for h in host if not h[0].startswith("bench.")]
    starts = [s for _, s, _ in ops]
    gaps = sorted(((b - a, a) for (_, a), (b, _) in zip(merged[:-1], merged[1:])), reverse=True)
    idle: dict = {}
    for k, (length, a) in enumerate(gaps):
        label = _host_label(bench, ops, starts, a) if k < 2000 else "a shorter gap (not labelled)"
        idle[label] = idle.get(label, 0.0) + length / 1e6
    return TraceReading(device_ops=dev, busy_s=busy_us / 1e6, window_s=window_s, idle_by_host=idle)


def _host_label(bench, ops, starts, t: float) -> str:
    """'<outermost bench span> / <innermost host operation>' at time t."""
    import bisect

    outer = next((n for n, s, e in bench if s <= t <= e), "outside a bench span")
    inner, inner_len = "Python, no torch call", float("inf")
    i = bisect.bisect_right(starts, t)
    for name, s, e in ops[max(0, i - 400):i]:
        if e >= t and e - s < inner_len:
            inner, inner_len = name, e - s
    return f"{outer} / {inner}"


# ------------------------------------------------------------------ the result
def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, compared: list,
                breakdown: dict | None) -> str:
    """The run's last line: the result's keys, then ``compared`` (each number
    compared, with its limit) last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in compared}
    return json.dumps(out)

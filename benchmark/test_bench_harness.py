"""CPU tests of the benchmark's harness (``python -m pytest benchmark/``).

The manifest against the contract's characters and counts, each cell's
files found by name, the result line's keys, the frozen operation and byte
counters against hand counts, the reference against the port's plain path
in float64 at a tiny size, and the import rules."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from benchmark import core, roofline  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return core.load_manifest()


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_names_and_units(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in manifest["paths"])
    assert 1 <= len(manifest["command"]) <= 32 and all(_line(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    names = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        names.add(c["name"])
    assert len(names) == len(manifest["configs"])
    cells = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and _line(w["why"])
        cells.add(w["name"])
    assert len(cells) == len(manifest["workloads"])
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == len(cells)
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"]) and m["source"] in SOURCES
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(manifest):
    for w in manifest["workloads"]:
        e2e = {m["name"] for m in core.end_to_end_of(manifest, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = core.per_layer_of(manifest, w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)


def test_each_cell_finds_its_files_by_name(manifest):
    import importlib

    for w in manifest["workloads"]:
        cell = core.find_cell(manifest, w["name"], 1, False)
        assert (BENCH / "drivers" / f"{cell.traffic['kind']}.py").is_file()
        assert hasattr(importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}"), "Driver")
        for rel in cell.config["files"].values():
            assert rel.startswith("benchmark/") and (ROOT / rel).is_file()
        assert set(cell.traffic["check"]["limits"]), f"{w['name']}: no limits"
    for m in manifest["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


def test_result_line_keys_and_compared_last():
    line = core.result_line(True, 4, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                            {"platform": "gpu", "kind": "k", "count": 1, "memory_peak_bytes": 1},
                            [("step_worst", 1e-3, 1e-2)], {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "compared"]
    assert out["compared"] == {"step_worst": {"value": 1e-3, "limit": 1e-2}}


def test_frozen_counters_against_hand_counts():
    # Gauss-Jordan, n = 2, k = 1: pivot 0 touches columns 1, 2 (two
    # divisions, two multiply-adds in the other row); pivot 1 column 2.
    assert roofline.k5_ops(1, 2, 1) == 2 * 3 + 1 * 3
    assert roofline.k5_ops(3, 2, 1) == 3 * 9
    assert roofline.k5_bytes(1, 2, 1) == 4 * (4 + 2 * 2)
    # K2+K3 bytes at nx = nu = ne = 1, N = 1, B = 1: stage in 2+2+1+1+1+2+1+2
    # = 12 words, out 1+2 = 3, dx0 1, dx 2
    assert roofline.k23_bytes(1, 1, 1, 1, 1) == 4 * (12 + 3 + 1 + 2)
    # K1 bytes per node at nx = nu = 1, ne = 1: 2+1+13 inputs, A B c C D e 6
    assert roofline.k1_bytes(1, 1, 1, 1) == 4 * (16 + 6)
    # the K2+K3 operation count is linear in B and N
    assert roofline.k23_ops(4, 3, 24, 24, 16) == 12 * roofline.k23_ops(1, 1, 24, 24, 16)
    # a bound is the larger of the two times
    assert roofline.bound_ms(3.35e12, 0.0) == pytest.approx(1000.0)
    assert roofline.bound_ms(0.0, 67e12) == pytest.approx(1000.0)


def test_topology_of_the_reference_model(manifest):
    cell = core.find_cell(manifest, manifest["workloads"][0]["name"], 1, False)
    t = core.topology(cell)
    assert (t.nj, t.nb, t.nv, t.rev) == (12, 13, 18, 12)
    # each leg joint moves its own body and those below it: 6 + 5 + .. + 1 per leg
    assert t.moved == 6 * 13 + 2 * (6 + 5 + 4 + 3 + 2 + 1)


# ------------------------------------------------------------------ imports
def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for p in BENCH.rglob("*.py"):
        bad = set(_imports(p)) & set(core.FORBIDDEN)
        assert not bad, f"{p}: {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        assert "bipedal_control_tpu_torch" not in set(_imports(p)), p


def test_modules_loaded_by_a_run_and_by_the_reference():
    code = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "import benchmark.reference.solve, benchmark.reference.replan\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'bipedal_control_tpu_torch'], 'program'\n"
        "from benchmark import core\n"
        "m = core.load_manifest()\n"
        "cell = core.find_cell(m, 'g1_rti.b4096', 5, False)\n"
        "cell.traffic = dict(cell.traffic, batch=2, warmup_solves=0)\n"
        "cell.device = torch.device('cpu')\n"
        "d = core.driver_for(cell)(cell); d.setup(); d.window(0.01)\n"
        "print('FORBIDDEN', core.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build")}
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "g1_rti.b4096", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


# ------------------------------------------------------------------ the reference
def _cell(manifest, name, **traffic):
    cell = core.find_cell(manifest, name, 123456789012, False)
    cell.traffic = dict(cell.traffic, **traffic)
    cell.config = dict(cell.config, dtype="float64")
    cell.device = torch.device("cpu")
    return cell


def test_reference_solve_matches_the_port_plain_path_in_float64(manifest):
    """The batched cell's program side (the port on the CPU runs its
    kernels' plain versions) against the reference, float64, B = 3, at the
    reference's batched-parity bar (1e-5: the stage KKT amplifies last-bit
    differences ~1e10, tests/test_lanes_rti.py)."""
    cell = _cell(manifest, "g1_rti.b4096", batch=3, warmup_solves=3, check={"block": 3, "chain": 3, "limits": {}})
    drv = core.driver_for(cell)(cell)
    drv.setup()
    drv.window(0.01)
    drv.release()
    numbers = dict((n, v) for n, v, _ in drv.check())
    assert numbers["step_worst"] <= 1e-5 and numbers["cold_worst"] <= 1e-5 and numbers["chain_worst"] <= 1e-5


def test_reference_replan_matches_the_port_runner_in_float64(manifest):
    cell = _cell(manifest, "g1_rti.replan_b1", warmup_replans=1, check={"samples": 1, "limits": {}})
    drv = core.driver_for(cell)(cell)
    drv.setup()
    drv.replan()
    drv.attempted = drv.failed = 0
    drv.release()
    numbers = dict((n, v) for n, v, _ in drv.check())
    assert max(numbers.values()) <= 1e-5


def test_a_replan_on_a_gait_switch_is_held_to_either_side(manifest):
    """At t = 10 s (replan 100, 0.1 s apart here to keep the test short) a
    trot switch falls on the replan's time: float64 puts it
    2e-15 s later than float32 does, so the first node's mode differs
    between the program (float32) and the reference (float64) read at t
    alone; the check holds the replan to the reference from either side."""
    from benchmark.drivers.replan import step_error
    from benchmark.reference.replan import Replanner

    cell = core.find_cell(manifest, "g1_rti.replan_b1", 123456789012, False)
    cell.traffic = dict(cell.traffic, replan_dt=0.1, warmup_replans=1, check={"samples": 1, "limits": {}})
    cell.device = torch.device("cpu")
    drv = core.driver_for(cell)(cell)
    drv.setup()
    while drv.k < 100:
        drv.replan()
    drv.reservoir, drv.seen = [], 0
    drv.replan()
    rec = drv.last
    assert rec["t"] == 10.0
    p = drv.keep(rec["prev"])
    prev, out, x_obs = (p["t_nodes"], p["x_traj"], p["u_traj"]), drv.keep(rec["out"]), rec["x_obs"].double()
    drv.attempted = drv.failed = 0
    drv.release()
    numbers = dict((n, v) for n, v, _ in drv.check())
    assert numbers["step_median"] <= 1e-3
    files = {k: cell.path(v) for k, v in cell.config["files"].items()}
    ref = Replanner(files, cell.config["solver"], "trot", 0.1, "cpu", torch.float64, torch.float32)
    want, xs, us = ref.replan(10.0, x_obs, prev)
    at_t = step_error(out, {f: getattr(want, f).double() for f in ("x_traj", "u_traj", "step_size")},
                      {"x_traj": xs.double(), "u_traj": us.double()})
    assert at_t > 0.5

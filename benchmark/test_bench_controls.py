"""The check's own tests (``python -m pytest benchmark/``): on the CPU, a
run of each cell at a tiny size with a fault planted under its timed path
(a step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced) comes out not correct, and the same
run without one comes out correct; on the card (``gpu``), the control (the
reference in the program's place, in TF32) comes out not correct at a size
a test can hold.  Each drives the harness's run (``run.run_cell``) with the
cell's own limits; only the look for a card is skipped."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import core  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402
from benchmark.run import run_cell  # noqa: E402

TINY = {
    "g1_rti.b4096": {"batch": 4, "warmup_solves": 3, "trace_solves": 1, "enqueue_probes": 1},
    "g1_rti.replan_b1": {"warmup_replans": 1, "trace_replans": 1},
}
CHECK = {"g1_rti.b4096": {"block": 4, "chain": 3}, "g1_rti.replan_b1": {"samples": 1}}
FAULTS_OF = {"g1_rti.b4096": ("unchanged", "half", "altered", "nonfinite"),
             "g1_rti.replan_b1": ("unchanged", "altered", "nonfinite")}


def _cell(name: str, device, sizes: dict, check: dict):
    cell = core.find_cell(core.load_manifest(), name, 2718281828459, False)
    traffic = dict(cell.traffic, **sizes)
    traffic["check"] = dict(traffic["check"], **check)
    cell.traffic, cell.device = traffic, torch.device(device)
    return cell


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS_OF.items() for f in fs])
def test_a_planted_fault_makes_the_run_not_correct(name, fault):
    cell = _cell(name, "cpu", TINY[name], CHECK[name])
    out = run_cell(cell, 0.05, driver=core.driver_for(cell)(cell, fault=FAULTS[fault]))
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("name", list(TINY))
def test_the_same_run_without_a_fault_is_correct(name):
    cell = _cell(name, "cpu", TINY[name], CHECK[name])
    out = run_cell(cell, 0.05)
    assert out["correct"] is True, out["compared"]


CARD = {
    "g1_rti.b4096": ({"batch": 256}, {"block": 256, "chain": 256}),
    "g1_rti.replan_b1": ({"warmup_replans": 3}, {"samples": 3}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD))
@pytest.mark.parametrize("seed", [161803398874, 141421356237, 173205080756])
def test_the_control_is_not_correct_on_the_card(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = _cell(name, "cuda", *CARD[name])
    cell.seed = seed
    drv = core.driver_for(cell)(cell)
    drv.setup()
    drv.window(1.0)
    drv.release()
    compared = [(n, v, lim) for n, v, lim in drv.check(control="tf32") if lim is not None]
    assert any(value > limit for _, value, limit in compared), compared

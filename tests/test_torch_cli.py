"""PyTorch port vs JAX reference: the command line's plan, sim and gaits
(bipedal_control_tpu_torch/cli.py against bipedal_control_tpu/cli.py),
float64 on the CPU, and the port's bench-scaling.

Both packages' robot registries are pointed at the test files by patching
REGISTRY["g1"] (dataclasses.replace; no file of either package changes): the
interface is built from tests/data/g1_shaped_biped.urdf with configs/g1/*,
and sim runs the scene that test_torch_sim.py generates from
tests/data/g1_shaped_biped_feet.urdf (all 23 joints, armature 0.01).  The
port runs its production backends (the kernels' plain versions on the CPU),
the reference the task's (structured, sequential, xla).  Bars: gaits'
output identical; plan's saved trajectory at 1e-5 relative to
max(1, max|ref|), its times exactly; sim exits 0 with safe=True and prints
the reference's base position at its printed precision.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax._src import compilation_cache

mujoco = pytest.importorskip("mujoco")

from bipedal_control_tpu import cli as j_cli  # noqa: E402
from bipedal_control_tpu import robots as j_robots  # noqa: E402
from bipedal_control_tpu.sim.urdf_mjcf import build_mjcf_scene_from_urdf as j_build_scene  # noqa: E402
from bipedal_control_tpu_torch import cli  # noqa: E402
from bipedal_control_tpu_torch import robots  # noqa: E402

from test_torch_sim import G1_URDF, make_test_scene  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def registry(tmp_path_factory):
    """REGISTRY["g1"] of both packages on the test URDF and scene."""
    scene = make_test_scene(j_build_scene, tmp_path_factory.mktemp("home"))
    with pytest.MonkeyPatch.context() as mp:
        for reg in (j_robots.REGISTRY, robots.REGISTRY):
            mp.setitem(reg, "g1", dataclasses.replace(reg["g1"], urdf=G1_URDF, mjcf=scene))
        yield scene


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache(tmp_path_factory):
    """JAX's persistent compilation cache in a directory of the module's,
    for the module only: the reference's plan and sim build an MPC runner
    each, whose replans are the same programs, so sim's compile is a cache
    hit (on one CPU the module takes ~60 s, not ~72 s)."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    old = {n: getattr(jax.config, n) for n in names}
    jax.config.update(names[0], str(tmp_path_factory.mktemp("jax_cache")))
    jax.config.update(names[1], 0.0)
    compilation_cache.reset_cache()
    yield
    for n, v in old.items():
        jax.config.update(n, v)
    compilation_cache.reset_cache()


def _run(main, argv, **kw):
    """(exit code, stdout) of one command."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    return rc, out.getvalue()


def _port(argv):
    return _run(cli.main, argv, device="cpu", dtype=torch.float64)


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def test_gaits_prints_what_the_reference_prints():
    want, got = _run(j_cli.main, ["gaits", "--robot", "g1"]), _port(["gaits", "--robot", "g1"])
    assert got == want
    assert "trot: duration 0.60s, sequence LF-RF" in got[1]


def test_plan_matches_reference(tmp_path):
    """plan --robot g1 --duration 0.1 --out ...: the saved trajectories
    (0.1 s at 400 Hz, 5 replans, trot from 0.1 s) and the summary line."""
    paths = {pkg: str(tmp_path / f"{pkg}.npz") for pkg in ("jax", "port")}
    argv = lambda pkg: ["plan", "--robot", "g1", "--duration", "0.1", "--out", paths[pkg]]
    rc_j, out_j = _run(j_cli.main, argv("jax"))
    rc_t, out_t = _port(argv("port"))
    assert rc_j == rc_t == 0
    want, got = np.load(paths["jax"]), np.load(paths["port"])
    np.testing.assert_array_equal(got["times"], want["times"])
    assert got["states"].shape == want["states"].shape == (40, 24)
    for name in ("states", "inputs"):
        err = _rel(got[name], want[name])
        assert err <= 1e-5, f"{name}: {err:.3e}"
    summary = lambda out: [ln for ln in out.splitlines() if ln.startswith("ran ")]
    assert summary(out_t) == summary(out_j) and len(summary(out_t)) == 1
    assert '"count": 5' in out_t
    assert "backends: linearize pallas, riccati pallas, merit pallas" in out_t


def test_sim_matches_reference():
    """sim --robot g1 --duration 0.05 (stance, 25 ticks at 500 Hz): exit 0,
    safe=True, the reference's printed base position."""
    rc_j, out_j = _run(j_cli.main, ["sim", "--robot", "g1", "--duration", "0.05"])
    rc_t, out_t = _port(["sim", "--robot", "g1", "--duration", "0.05"])
    done = lambda out: [ln for ln in out.splitlines() if ln.startswith("sim done")]
    assert rc_t == rc_j == 0
    assert done(out_t) == done(out_j) and len(done(out_t)) == 1
    assert done(out_t)[0].endswith("safe=True")
    assert "report:" in out_t


def test_sim_async_kalman_view_runs_headless(monkeypatch):
    """The port's sim with --mpc-async (paced by wait_until_fresh),
    --estimator kalman and --view on a host without a display: the viewer
    is reported unavailable and the loop goes on, exit 0, safe=True, the
    worker's replans published."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, out = _port(["sim", "--robot", "g1", "--duration", "0.04", "--mpc-async", "--estimator", "kalman",
                         "--view"])
    assert rc == 0 and "viewer unavailable (no display" in err.getvalue()
    done = [ln for ln in out.splitlines() if ln.startswith("sim done")]
    assert len(done) == 1 and done[0].endswith("safe=True")
    assert '"mpc_solves":' in out


def test_cli_runs_on_the_card_unless_asked_for_the_cpu():
    """Without CUDA every command raises unless device="cpu"; bench is not
    a command of the port (it waits for the port's benchmark); python -m
    runs the parser."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["gaits", "--robot", "g1"])
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        cli.main(["bench"], device="cpu")
    proc = subprocess.run([sys.executable, "-m", "bipedal_control_tpu_torch.cli", "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "{plan,sim,gaits,bench-scaling}" in proc.stdout


def test_bench_scaling_prints_scaling_points():
    """bench-scaling --robot g1 --per-device-batch 2 --steps 1 on the CPU:
    exit 0, one JSON line per mesh size (a world of one it initialises and
    closes) with ScalingPoint's fields."""
    import torch.distributed as dist

    from bipedal_control_tpu_torch.parallel.scaling import ScalingPoint

    rc, out = _port(["bench-scaling", "--robot", "g1", "--per-device-batch", "2", "--steps", "1"])
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert rc == 0 and not dist.is_initialized()
    assert [list(r) for r in rows] == [[f.name for f in dataclasses.fields(ScalingPoint)]]
    assert (rows[0]["n_devices"], rows[0]["n_hosts"], rows[0]["batch"]) == (1, 1, 2)
    assert rows[0]["solves_per_s"] > 0 and np.isfinite(rows[0]["mean_defect"])
    assert "backends: linearize pallas, riccati pallas, merit pallas" in out


def test_sim_without_mujoco_raises_import_error(monkeypatch):
    """A missing mujoco is an ImportError naming the package, at the call."""
    monkeypatch.setitem(sys.modules, "mujoco", None)
    with pytest.raises(ImportError, match="mujoco"):
        cli.main(["sim", "--robot", "g1", "--duration", "0.01"], device="cpu")

"""The PyTorch port as a package: parameter conversion round trips, the
full-float32 matmul policy, import isolation from JAX, and no CPU fallback
behind a CUDA request."""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bipedal_control_tpu.ocp.problem import OcpSettings as JOcpSettings
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.ocp.problem import OcpSettings
from bipedal_control_tpu_torch.ops import gj_kernel, linearize_kernel
from bipedal_control_tpu_torch.parallel import batch_solver
from bipedal_control_tpu_torch.parallel.batch_solver import make_batched_solver

from test_lanes_rti import _batched_problem
from test_pallas_linearize_kernel import tiny_biped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(model, info):
    tm = convert.model_from_numpy(
        {f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)}, device="cpu"
    )
    return tm, convert.info_from_numpy(dataclasses.asdict(info))


def test_convert_round_trips():
    model, info = tiny_biped()
    tm, ti = _port(model, info)
    back = convert.model_to_numpy(tm)
    for f in dataclasses.fields(model):
        want = getattr(model, f.name)
        if f.name == "ancestor_joints":
            assert back[f.name] == want  # rebuilt from the parents, bytes-identical
        elif isinstance(want, (str, tuple)):
            assert back[f.name] == want, f.name
        else:
            np.testing.assert_array_equal(back[f.name], np.asarray(want), err_msg=f.name)
    assert dataclasses.asdict(ti) == dataclasses.asdict(info)
    js = JOcpSettings(position_error_gain=0.35, linesearch_alphas=(1.0,), riccati="pallas")
    assert dataclasses.asdict(convert.settings_from_numpy(dataclasses.asdict(js))) == dataclasses.asdict(js)
    assert [f.name for f in dataclasses.fields(OcpSettings)] == [f.name for f in dataclasses.fields(JOcpSettings)]
    refs = _batched_problem(model, info)[0]
    trefs = convert.refs_from_numpy({k: np.asarray(v) for k, v in refs._asdict().items()}, device="cpu")
    for k, v in refs._asdict().items():
        np.testing.assert_array_equal(getattr(trefs, k).numpy(), np.asarray(v))
    Q, R = convert.weights_from_numpy(np.eye(info.state_dim), 2 * np.eye(info.input_dim), device="cpu")
    assert Q.dtype == torch.float64 and float(R[0, 0]) == 2.0


def test_precision_policy_is_set_by_the_solver():
    model, info = tiny_biped()
    tm, ti = _port(model, info)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    make_batched_solver(tm, ti, OcpSettings(), np.eye(info.state_dim), np.eye(info.input_dim), device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bipedal_control_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'bipedal_control_tpu' or n.startswith('bipedal_control_tpu.'))\n"
        "print(len([n for n in sys.modules if n.startswith('bipedal_control_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) > 10  # every module was imported


def test_package_imports_without_mujoco_and_matplotlib():
    """Every module of the port imports where neither mujoco nor matplotlib
    can be imported (the card's machine has neither): the modules that use
    them import them at the call."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['mujoco'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import bipedal_control_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names), ' '.join(n for n in names if '.sim.' in n or 'visualizer' in n or n.endswith('.cli')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count, names = proc.stdout.split(maxsplit=1)
    assert int(count) > 10
    for module in ("cli", "runtime.visualizer", "sim.interactive", "sim.mujoco_backend", "sim.terrain",
                   "sim.urdf_mjcf"):
        assert f"bipedal_control_tpu_torch.{module}" in names.split(), module


def test_cuda_request_without_cuda_raises_and_does_not_compute():
    """Where CUDA is absent, asking for the CUDA path fails loudly; nothing
    quietly runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: this checks the behaviour without it")
    model, info = tiny_biped()
    tm, ti = _port(model, info)
    settings = OcpSettings(riccati="pallas", merit="pallas", linesearch_alphas=(1.0,))
    solver = make_batched_solver(tm, ti, settings, np.eye(info.state_dim), np.eye(info.input_dim), device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        solver.to("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        tm.to(device="cuda")


@pytest.mark.parametrize("linearize", ["structured", "pallas"])
def test_entry_points_default_to_the_card(monkeypatch, linearize):
    """Without CUDA, make_batched_solver asked for no device raises and
    builds nothing on the CPU (both its dispatch paths), and so do the
    model and parameter helpers."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: this checks the behaviour without it")
    model, info = tiny_biped()
    tm, ti = _port(model, info)
    built = []
    monkeypatch.setattr(batch_solver, "BatchedSolver", lambda *a, **kw: built.append(a))
    settings = OcpSettings(linearize=linearize, riccati="pallas", merit="pallas", linesearch_alphas=(1.0,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batched_solver(tm, ti, settings, np.eye(info.state_dim), np.eye(info.input_dim))
    assert built == []
    fields = {f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)}
    with pytest.raises(RuntimeError):
        convert.model_from_numpy(fields)
    with pytest.raises(RuntimeError):
        convert.weights_from_numpy(np.eye(2), np.eye(2))


@pytest.mark.parametrize("kernel", ["linearize", "gauss_jordan"])
def test_k1_k5_wrappers_refuse_cuda_less_calls(kernel):
    """The linearize (K1) and Gauss-Jordan (K5) kernels' CUDA entries raise
    on CPU tensors instead of computing there."""
    z = lambda *s: torch.zeros(*s, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "linearize":
            linearize_kernel.linearize_cuda(z(10), {}, 0.0, "rk2", z(2, 16), z(2, 16), z(2, 16), z(2, 4), z(2, 4),
                                            z(2, 4), z(2))
        else:
            gj_kernel.gauss_jordan_solve_cuda(z(2, 3, 3), z(2, 3, 1))


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a visible
    GPU, and alone in a directory without the rest of the repository."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

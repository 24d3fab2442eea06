"""PyTorch port vs JAX reference: the plain constrained Riccati sweep
(solver/riccati.py::solve_lqr, the plain version of the K2+K3 CUDA kernel)
on random masked LQR problems, float64, atol 1e-9 as the reference's own
kernel test (tests/test_pallas_riccati.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.solver.riccati import solve_lqr as j_solve_lqr
from bipedal_control_tpu_torch.ocp.problem import LinearizedNode
from bipedal_control_tpu_torch.solver.riccati import solve_lqr, solve_lqr_pallas

from test_riccati import _random_problem


def _batched(seed, B, **kw):
    nodes_l, masks_l = [], []
    for b in range(B):
        n, m = _random_problem(np.random.default_rng(seed + b), **kw)
        nodes_l.append(n)
        masks_l.append(m)
    stack = lambda *a: np.stack([np.asarray(x) for x in a])
    nodes = jax.tree.map(lambda *a: jnp.asarray(stack(*a)), *nodes_l)
    masks = jnp.asarray(stack(*masks_l))
    dx0 = np.random.default_rng(seed + 99).normal(size=(B, nodes.A.shape[-1])) * 0.1
    return nodes, masks, jnp.asarray(dx0)


def _to_port(nodes, masks, dx0):
    T = lambda a: torch.as_tensor(np.asarray(a))
    return LinearizedNode(*(T(f) for f in nodes)), T(masks), T(dx0)


@pytest.mark.parametrize("constrained", [True, False])
def test_solve_lqr_matches_reference(constrained):
    nodes, masks, dx0 = _batched(5, 3, N=6, nx=5, nu=4, ne=3, constrained=constrained)
    ref = jax.jit(jax.vmap(j_solve_lqr))(nodes, masks, dx0)
    got = solve_lqr(*_to_port(nodes, masks, dx0))
    for f in ("K", "k", "dx", "du"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), atol=1e-9, err_msg=f)
    np.testing.assert_allclose(
        got.expected_decrease.numpy(), np.asarray(ref.expected_decrease), rtol=1e-8, atol=1e-12
    )


def test_kernel_entry_on_cpu_is_the_plain_version():
    """riccati='pallas' on CPU tensors runs the plain version, bit-identical."""
    port = _to_port(*_batched(17, 2, N=4, nx=4, nu=3, ne=2, constrained=True))
    a, b = solve_lqr_pallas(*port), solve_lqr(*port)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_riccati_kernel_build_is_keyed_by_stage_shapes(monkeypatch):
    """riccati_kernel.build(nx, nu, ne) compiles the stage shapes in: it asks
    cuda_build for a library under defines that hold them, and two shape
    sets are two libraries (no nvcc needed: build_library is replaced)."""
    from types import SimpleNamespace

    from bipedal_control_tpu_torch.ops import cuda_build, riccati_kernel

    requests = []

    def fake_build_library(name, source, defines):
        requests.append((name, source, dict(defines)))
        lib = SimpleNamespace(riccati_solve_f32=SimpleNamespace(), riccati_solve_f64=SimpleNamespace())
        return SimpleNamespace(lib=lib, ptxas_report="", build_seconds=0.0)

    monkeypatch.setattr(cuda_build, "build_library", fake_build_library)
    a = riccati_kernel.build(22, 22, 16)
    b = riccati_kernel.build(7, 5, 3)
    assert [r[:2] for r in requests] == [("riccati", "riccati.cu")] * 2
    assert requests[0][2] == {"RICCATI_NX": "22", "RICCATI_NU": "22", "RICCATI_NE": "16"}
    assert requests[1][2] == {"RICCATI_NX": "7", "RICCATI_NU": "5", "RICCATI_NE": "3"}
    assert a is not b and a.lib.riccati_solve_f32.argtypes is not None


# (batch, resident CTAs per SM of the 256- and 128-thread builds, the build
# the wrapper takes) on a card of 132 SMs; G1's float32 builds hold 2 and 4
_CHOICE_CASES = {
    "b1": (1, {256: 2, 128: 4}, 256),
    "at_threshold": (264, {256: 2, 128: 4}, 256),
    "above_threshold": (265, {256: 2, 128: 4}, 128),
    "b4096": (4096, {256: 2, 128: 4}, 128),
    "wide_holds_no_more": (4096, {256: 2, 128: 2}, 256),
    "no_wide_build": (4096, {256: 2, 128: 0}, 256),  # float64: the library has no 128-thread build
}


@pytest.mark.parametrize("case", [*_CHOICE_CASES, "profiler_name"])
def test_riccati_build_choice(case):
    """The wrapper's choice between the kernel's two builds is a function of
    the batch, each build's residency and the SM count alone: the 128-thread
    build only above what the 256-thread build holds resident, and only if
    it holds more per SM.  Both builds keep the kernel's name, so the
    benchmark's profiler readers (benchmark/core.py's KERNELS pattern) find
    either."""
    from bipedal_control_tpu_torch.ops import riccati_kernel

    if case == "profiler_name":
        from benchmark.core import KERNELS, TraceReading

        names = [f"void (anonymous namespace)::riccati_kernel<float, {t}>((anonymous namespace)::StageInputs<float>, "
                 "float const*, float*, float*, float*, float*, int, float, float)" for t in riccati_kernel.BUILDS]
        trace = TraceReading(device_ops=[(n, 0.0, 2.0) for n in names], busy_s=4e-6, window_s=4e-6, idle_by_host={})
        assert trace.count_of(KERNELS["K23"]) == 2
        assert trace.seconds_of(KERNELS["K23"]) == pytest.approx(4e-6)
        return
    batch, resident, want = _CHOICE_CASES[case]
    assert riccati_kernel.choose_threads(batch, resident, 132) == want

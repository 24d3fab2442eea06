"""PyTorch port vs JAX reference: the pivot-free Gauss-Jordan solve
(ops/linalg.py::gauss_jordan_solve, the plain version of the K5 CUDA
kernel) against the reference's ops/linalg.py::gauss_jordan_solve on
quasi-definite systems, float64, 1e-10 (also at the device WBC's KKT
shape, 128 x 128 against eye(128), and a ragged n = 45, k = 70); and the
kernel's entry on CPU tensors is that plain version, bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.ops.linalg import gauss_jordan_solve as j_gauss_jordan_solve
from bipedal_control_tpu_torch.ops.gj_kernel import gauss_jordan_solve_pallas
from bipedal_control_tpu_torch.ops.linalg import gauss_jordan_solve

from test_pallas_gj import _quasi_definite


def _systems(seed, batch, n, m, k, rhs="normal"):
    rng = np.random.default_rng(seed)
    A = np.stack([_quasi_definite(rng, n, m) for _ in range(batch)])
    return A, (np.broadcast_to(np.eye(n), (batch, n, n)).copy() if rhs == "eye" else rng.normal(size=(batch, n, k)))


@pytest.mark.parametrize(
    "batch,n,m,k,rhs",
    [(5, 14, 4, 6, "normal"), (3, 38, 16, 23, "normal"), (1, 128, 86, 128, "eye"), (2, 45, 15, 70, "normal")],
    ids=["small", "stage_kkt", "wbc_kkt", "ragged"],
)
def test_gauss_jordan_solve_matches_reference(batch, n, m, k, rhs):
    A, B = _systems(3, batch, n, m, k, rhs)
    want = np.asarray(j_gauss_jordan_solve(jnp.asarray(A), jnp.asarray(B)))
    got = gauss_jordan_solve(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    assert float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want)))) < 1e-10


def test_kernel_entry_on_cpu_is_the_plain_version():
    A, B = (torch.as_tensor(a) for a in _systems(4, 4, 14, 4, 6))
    before = gauss_jordan_solve_pallas.launches
    assert torch.equal(gauss_jordan_solve_pallas(A, B), gauss_jordan_solve(A, B))
    assert gauss_jordan_solve_pallas.launches == before  # no kernel launch on the CPU

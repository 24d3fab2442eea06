"""PyTorch port vs JAX reference: the pivot-free Gauss-Jordan solve
(ops/linalg.py::gauss_jordan_solve, the plain version of the K5 CUDA
kernel) against the reference's ops/linalg.py::gauss_jordan_solve on
quasi-definite systems, float64, 1e-10; and the kernel's entry on CPU
tensors is that plain version, bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.ops.linalg import gauss_jordan_solve as j_gauss_jordan_solve
from bipedal_control_tpu_torch.ops.gj_kernel import gauss_jordan_solve_pallas
from bipedal_control_tpu_torch.ops.linalg import gauss_jordan_solve

from test_pallas_gj import _quasi_definite


def _systems(seed, batch, n, m, k):
    rng = np.random.default_rng(seed)
    return np.stack([_quasi_definite(rng, n, m) for _ in range(batch)]), rng.normal(size=(batch, n, k))


@pytest.mark.parametrize("batch,n,m,k", [(5, 14, 4, 6), (3, 38, 16, 23)], ids=["small", "stage_kkt"])
def test_gauss_jordan_solve_matches_reference(batch, n, m, k):
    A, B = _systems(3, batch, n, m, k)
    want = np.asarray(j_gauss_jordan_solve(jnp.asarray(A), jnp.asarray(B)))
    got = gauss_jordan_solve(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    assert float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want)))) < 1e-10


def test_kernel_entry_on_cpu_is_the_plain_version():
    A, B = (torch.as_tensor(a) for a in _systems(4, 4, 14, 4, 6))
    before = gauss_jordan_solve_pallas.launches
    assert torch.equal(gauss_jordan_solve_pallas(A, B), gauss_jordan_solve(A, B))
    assert gauss_jordan_solve_pallas.launches == before  # no kernel launch on the CPU

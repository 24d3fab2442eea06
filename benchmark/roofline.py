"""The yardstick of the kernels' roofline shares: the card's peaks and the
operations and bytes each kernel needs at a cell's shapes.

The operation counters are a frozen copy of ``chip_smoke.py``'s ``k1_ops``,
``k23_ops``, ``k5_ops`` and ``bound`` (each add, multiply,
divide and sin/cos is one operation, read off the loops of the CUDA
sources), taken here so that a change to the program cannot move them.
Bytes count each input read once and each output written once.  The robot's
tree enters through :class:`Topology`, which the reference's own model
gives (``benchmark/reference``), never the program's tables.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores

JOINT_REVOLUTE = 0


@dataclasses.dataclass(frozen=True)
class Topology:
    """What the counters read of a robot's tree: joints, bodies,
    coordinates, revolute joints, and the (body, coordinate) pairs where
    "coordinate l moves body b" (6 base coordinates move every body)."""

    nj: int
    nb: int
    nv: int
    rev: int
    moved: int

    @classmethod
    def of(cls, model) -> "Topology":
        """From a RobotModel of ``benchmark/reference/model/robot_model.py``."""
        anc = model.ancestor_mask()
        rev = sum(1 for t in model.joint_type if int(t) == JOINT_REVOLUTE)
        return cls(nj=model.nj, nb=model.nb, nv=model.nv, rev=rev, moved=6 * model.nb + int(anc.sum()))


def bound_ms(bytes_moved: float, ops: float, peak_ops: float = PEAK_F32_OPS_PER_S) -> float:
    """The least time the card could take, in ms: bytes over the memory rate
    or operations over the peak rate, whichever is larger."""
    return max(bytes_moved / PEAK_BYTES_PER_S, ops / peak_ops) * 1e3


def _fk_fields_ops(t: Topology) -> int:
    fk = 31 + 203 * t.rev + 84 * (t.nj - t.rev)
    fields = 36 + 27 * t.rev + 15 * (t.nj - t.rev)
    return fk + fields


def _flow_tail_ops(t: Topology, nc: int = 4) -> int:
    """inv6, v and the flow value from the CMM."""
    return 388 + 6 * (2 * t.nj + 2) + 72 + 18 * nc + 7


def k1_ops(t: Topology, M: int, rk2: bool, nx: int, nu: int, ne: int = 16, nc: int = 4) -> float:
    """linearize.cu: one group-parallel centroidal pass per stage (two for
    rk2), the derivative columns per lane, then the output elements."""
    nb, nv, nj = t.nb, t.nv, t.nj
    cmm = 6 * nv * nb + 46 * t.moved + 85 * nv
    one_pass = _fk_fields_ops(t) + 108 * nb + 18 * nc + cmm + _flow_tail_ops(t, nc)
    lane = 3 + 135 + 81 * nj + 159 * nb + 24 * nc + 72 + 66 + 12 * nc + 13 * 3 * nc
    deriv = nv * lane + 72 * nj
    out_A = 3 * (6 * 20 + nv * 16) + 6 * (6 * 23 + nv * 26)
    out_B = 12 + 3 * 12 * 3 + 3 * nj * 15 + 6 * 12 * 18 + 6 * nj * 17
    out_C = ne * (6 * 19 + nv)
    out_D = 12 + ne * nj * 14
    out_e = ne * (2 * nv + 5)
    per = (2 if rk2 else 1) * one_pass + deriv + out_A + out_B + out_C + out_D + out_e + 6 * nx
    return float(M * per)


def k1_bytes(M: int, nx: int, nu: int, ne: int = 16, word: int = 4) -> float:
    """K1 reads x, u, x_next and 13 reference words per node; writes A, B,
    c, C, D, e."""
    return float(word * M * ((2 * nx + nu + 13) + nx * nx + nx * nu + nx + ne * nx + ne * nu + ne))


def k23_ops(B: int, N: int, nx: int, nu: int, ne: int) -> float:
    """riccati.cu per stage: P = S [B | A | c] + s with S's symmetrisation,
    [H_uu | H_ux | h_u] = Q + B'P, the KKT's -Reg diagonal and H_uu's
    regularisation, the pivot-free elimination (per pivot pair: two
    multiply-adds per updated element, each column's two normalised row
    entries, each row's two factors, the pair's two reciprocals),
    G = H_uu [K|k] - [H_ux|h_u], [H_xx|h_x] = Q + A'P, U; then the rollout."""
    nkp = 2 * ((nu + ne + 1) // 2)
    w = nkp + nx + 1
    ldp, nxp = nu + nx + 1, nx + 1
    elim = sum(nkp * (w - p - 2) * 4 + (w - p - 2) * 4 + nkp * 4 + 4 for p in range(0, nkp, 2))
    stage = (2 * nx * nx + nx * ldp * 2 * nx + nx + nu * ldp * (2 * nx + 1) + 3 * ne + nu + elim
             + nu * nxp * (2 * nu + 1) + nx * nxp * (2 * nx + 1) + nx * nxp * 4 * nu)
    rollout = nu * (2 * nx + 1) + nx * (2 * nx + 2 * nu + 2)
    return float(B * N * (stage + rollout))


def k23_bytes(B: int, N: int, nx: int, nu: int, ne: int, word: int = 4) -> float:
    """K2+K3 reads each stage's quadratics, dynamics and constraints and
    the initial dx, writes K, k, du and dx."""
    stage_in = 2 * nx * nx + 2 * nx * nu + nu * nu + ne * nx + ne * nu + 2 * nx + nu + 2 * ne
    stage_out = nu * nx + 2 * nu
    return float(word * (B * N * (stage_in + stage_out) + B * nx + B * (N + 1) * nx))


def k5_ops(batch: int, n: int, k: int) -> float:
    """The pivot-free Gauss-Jordan solve A X = B: per pivot i, one division
    for each column right of it in the pivot row and one multiply-add (two
    operations) for each such column in the n - 1 other rows."""
    W = n + k
    return float(batch * sum((W - 1 - i) * (1 + 2 * (n - 1)) for i in range(n)))


def k5_bytes(batch: int, n: int, k: int, word: int = 4) -> float:
    """K5 reads A and B, writes X."""
    return float(word * batch * (n * n + 2 * n * k))

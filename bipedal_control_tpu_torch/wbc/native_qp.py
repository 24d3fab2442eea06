"""ctypes binding of the host WBC's C++ (the port's native/host_wbc.cc; the
JAX package's wbc/native_qp.py binds only the ADMM loop of native/host_qp.cc).

The C++ runs the whole tick's QP in one call: HostWbc._assemble's task rows,
the Schur complement's factorization and solve_qp_np's ADMM, on the
kinematics buffers of a NativeHostModel.  The library builds at its first
use into build/host_native/ (utils/native_build.py); a failed build or load
raises.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..utils.native_build import load_native

_D = ctypes.POINTER(ctypes.c_double)


def _check(name: str, a: np.ndarray, size: int, at_least: bool = False) -> None:
    """Raise unless a is a C-contiguous float64 array of size doubles (or
    more): the C++ reads it through a bare pointer."""
    if a.dtype != np.float64 or not a.flags.c_contiguous or (a.size < size if at_least else a.size != size):
        raise ValueError(f"{name}: {a.dtype} {a.shape} array (contiguous {a.flags.c_contiguous}); the host WBC "
                         f"reads {'at least ' if at_least else ''}{size} contiguous float64")


class NativeWbc:
    """The whole host WBC of one tick in one C++ call (the port's
    native/host_wbc.cc): HostWbc._assemble's task rows, the Schur
    complement's inverse, solve_qp_np's ADMM and its residuals, on the
    kinematics buffers of a NativeHostModel, with the GIL released: the
    tick's longest call, during which the MPC worker's host code can run
    (the tick's shorter native calls keep the GIL, utils/native_build.py).
    One instance per HostWbc (not thread-safe)."""

    # the order of the kinematics arrays in host_wbc.cc's Kin
    KIN_FIELDS = ("q_m", "v_m", "M", "nle", "Jc", "dJc", "p_contact_m", "v_contact_m", "base_J", "base_dJ",
                  "p_contact_d", "v_contact_d", "base_pose_d", "base_vel_d", "base_acc_d")

    def __init__(self, nj: int, cfg, reg, rho: float, sigma: float, alpha: float, eq_rho_scale: float):
        self._lib = lib = load_native("host_wbc")
        lib.host_wbc_create.restype = ctypes.c_void_p
        lib.host_wbc_create.argtypes = [ctypes.c_int] + [ctypes.c_double] * 6 + [_D] * 4 + [ctypes.c_double] * 4
        lib.host_wbc_destroy.argtypes = [ctypes.c_void_p]
        lib.host_wbc_rows.argtypes = [ctypes.c_void_p]
        lib.host_wbc_assemble.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_void_p] * 5
        lib.host_wbc_solve.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int] + [ctypes.c_void_p] * 4
        f64 = lambda a: np.ascontiguousarray(a, dtype=np.float64)
        base_kp, base_kd = f64(cfg.base_kp), f64(cfg.base_kd)
        limits, reg = f64(np.tile(np.asarray(cfg.torque_limit_per_leg, dtype=np.float64), 2)), f64(reg)
        if (base_kp.shape, base_kd.shape, limits.shape, reg.shape) != ((6,), (6,), (nj,), (6 + 12 + 2 * nj,)):
            raise ValueError(f"base gains {base_kp.shape}, {base_kd.shape} (6 each), torque limits {limits.shape} "
                             f"(nj = {nj}) or reg {reg.shape} (6 + 12 + 2 nj) of the wrong size")
        self._h = lib.host_wbc_create(
            nj, cfg.weight_swing_leg, cfg.weight_base_accel, cfg.weight_contact_force, cfg.swing_kp, cfg.swing_kd,
            cfg.friction_coefficient, base_kp.ctypes.data_as(_D), base_kd.ctypes.data_as(_D),
            limits.ctypes.data_as(_D), reg.ctypes.data_as(_D), rho, sigma, alpha, eq_rho_scale,
        )
        self.n, self.m = reg.size, lib.host_wbc_rows(self._h)
        nv = 6 + nj
        self._sizes = dict(q_m=nv, v_m=nv, M=nv * nv, nle=nv, Jc=12 * nv, dJc=12 * nv, p_contact_m=12,
                           v_contact_m=12, base_J=6 * nv, base_dJ=6 * nv, p_contact_d=12, v_contact_d=12,
                           base_pose_d=6, base_vel_d=6, base_acc_d=6)
        self._kin = (ctypes.c_void_p * 16)()
        self._keep = ()  # the arrays whose addresses _kin holds
        self._residuals = np.empty(2)

    def _bind(self, kin, u_des) -> None:
        """Point the call's array table at kin's arrays (a NativeHostModel
        refills the same buffers every tick) and at u_des."""
        arrays = tuple(getattr(kin, f) for f in self.KIN_FIELDS)
        if len(arrays) != len(self._keep) or any(a is not b for a, b in zip(arrays, self._keep)):
            for i, (name, a) in enumerate(zip(self.KIN_FIELDS, arrays)):
                _check(name, a, self._sizes[name])
                self._kin[i] = a.ctypes.data
            self._keep = arrays
        _check("u_des", u_des, 12, at_least=True)
        self._kin[15] = u_des.ctypes.data
        self._u_des = u_des  # alive for the call

    def assemble(self, kin, u_des, flags):
        """(H, g, A, l, u) of the tick, as HostWbc._assemble returns them."""
        self._bind(kin, u_des)
        flags = np.ascontiguousarray(flags, dtype=np.float64)
        _check("contact flags", flags, 4)
        n, m = self.n, self.m
        H, g, A, l, u = np.empty((n, n)), np.empty(n), np.empty((m, n)), np.empty(m), np.empty(m)  # noqa: E741
        self._lib.host_wbc_assemble(self._h, self._kin, flags.ctypes.data, H.ctypes.data, g.ctypes.data,
                                    A.ctypes.data, l.ctypes.data, u.ctypes.data)
        return H, g, A, l, u

    def solve(self, kin, u_des, flags, iters: int, warm=None):
        """``iters`` ADMM iterations from warm's (x, z, y), or cold: the new
        (x, z, y), the primal and the dual residual."""
        self._bind(kin, u_des)
        flags = np.ascontiguousarray(flags, dtype=np.float64)
        _check("contact flags", flags, 4)
        if warm is None:
            x, z, y = np.empty(self.n), np.empty(self.m), np.empty(self.m)
        else:
            x, z, y = (np.array(a, dtype=np.float64) for a in warm)
            for name, a, size in (("x", x, self.n), ("z", z, self.m), ("y", y, self.m)):
                _check(f"warm {name}", a, size)
        self._lib.host_wbc_solve(self._h, self._kin, flags.ctypes.data, iters, int(warm is None), x.ctypes.data,
                                 z.ctypes.data, y.ctypes.data, self._residuals.ctypes.data)
        return (x, z, y), float(self._residuals[0]), float(self._residuals[1])

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.host_wbc_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

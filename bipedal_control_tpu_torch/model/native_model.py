"""ctypes binding of the native host model (model/native_model.py
counterpart; native/host_model.cc, read where it stands).

The C++ supplies the per-tick model quantities (Pinocchio's role in the
reference, bipedal_wbc/src/WbcBase.cpp:79-133) to the real-time WBC and the
observation.  It mirrors model/host_dynamics.py exactly;
tests/test_torch_host_wbc.py holds the chain C++ == numpy == JAX.

The library builds at its first use into build/host_native/
(utils/native_build.py).  A failed build or load raises: the numpy twin
runs only where the caller asks for it (``native=False`` in wbc/host_wbc.py
and runtime/controller.py).
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..utils.native_build import load_native
from .host_model import HostModel

_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)


def load_library() -> ctypes.CDLL:
    """The host-model library, built on first use; raises if it cannot be.
    Its calls keep the GIL (the control tick's short calls,
    utils/native_build.py)."""
    lib = load_native("host_model", hold_gil=True)
    lib.host_model_create.restype = ctypes.c_void_p
    lib.host_model_create.argtypes = [
        ctypes.c_int, ctypes.c_int, _I, _I, _D, _D, _D, _D, _D, _D, _D,
        ctypes.c_int, _I, _D, _D, ctypes.c_int, _D, _D, _D,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.host_model_destroy.argtypes = [ctypes.c_void_p]
    lib.host_model_q_v_from_rbd.argtypes = [ctypes.c_void_p, _D, _D, _D]
    lib.host_model_observation.argtypes = [ctypes.c_void_p, _D, _D]
    lib.host_model_wbc_kinematics.argtypes = [ctypes.c_void_p] + [_D] * 20
    return lib


def _dp(a):
    return a.ctypes.data_as(_D)


class NativeHostModel:
    """Owns one C++ model instance (NOT thread-safe: one per controller,
    like the reference's per-controller Pinocchio data)."""

    def __init__(self, hm: HostModel):
        self._lib = lib = load_library()
        self.hm = hm
        self.nv = 6 + hm.nj
        self.nc = len(hm.contact_frame_ids)
        c = lambda a, dt: np.ascontiguousarray(a, dtype=dt)
        parent = c(hm.joint_parent_body, np.int32)
        jtype = c(list(hm.joint_type), np.int32)
        cfids = list(hm.contact_frame_ids)
        contact_body = c([hm.frame_body[f] for f in cfids], np.int32)
        contact_R = c(np.stack([hm.frame_R[f] for f in cfids]), np.float64)
        contact_p = c(np.stack([hm.frame_p[f] for f in cfids]), np.float64)
        bf = hm.base_frame_id
        qj_nom = c(
            hm.q_j_nominal if hm.q_j_nominal.size == hm.nj else np.zeros(hm.nj),
            np.float64,
        )
        # keep marshalled arrays alive for the C call
        keep = [
            parent, jtype, c(hm.joint_axis, np.float64), c(hm.joint_offset_R, np.float64),
            c(hm.joint_offset_p, np.float64), c(hm.body_mass, np.float64),
            c(hm.body_com, np.float64), c(hm.body_inertia, np.float64),
            c(hm.ancestor_mask, np.float64), contact_body, contact_R, contact_p,
            c(hm.frame_R[bf], np.float64), c(hm.frame_p[bf], np.float64), qj_nom,
        ]
        self._h = lib.host_model_create(
            int(hm.nj), int(hm.model_type),
            keep[0].ctypes.data_as(_I), keep[1].ctypes.data_as(_I),
            _dp(keep[2]), _dp(keep[3]), _dp(keep[4]), _dp(keep[5]), _dp(keep[6]),
            _dp(keep[7]), _dp(keep[8]),
            self.nc, keep[9].ctypes.data_as(_I), _dp(keep[10]), _dp(keep[11]),
            int(hm.frame_body[bf]), _dp(keep[12]), _dp(keep[13]), _dp(keep[14]),
            float(hm.robot_mass), float(hm.total_mass),
        )
        # preallocated per-tick output buffers
        nv, nc = self.nv, self.nc
        self._out = {
            "q_m": np.empty(nv), "v_m": np.empty(nv),
            "M": np.empty((nv, nv)), "nle": np.empty(nv),
            "Jc": np.empty((nc, 3, nv)), "dJc": np.empty((nc, 3, nv)),
            "p_c": np.empty((nc, 3)), "v_c": np.empty((nc, 3)),
            "base_J": np.empty((6, nv)), "base_dJ": np.empty((6, nv)),
            "q_d": np.empty(nv), "v_d": np.empty(nv),
            "p_d": np.empty((nc, 3)), "v_cd": np.empty((nc, 3)),
            "pose_d": np.empty(6), "vel_d": np.empty(6), "acc_d": np.empty(6),
        }
        self._out_ptrs = [_dp(self._out[k]) for k in (
            "q_m", "v_m", "M", "nle", "Jc", "dJc", "p_c", "v_c", "base_J",
            "base_dJ", "q_d", "v_d", "p_d", "v_cd", "pose_d", "vel_d", "acc_d",
        )]

    def observation(self, rbd: np.ndarray) -> np.ndarray:
        """rbdState -> centroidal state (host_model.py::centroidal_state_from_rbd_np)."""
        x = np.empty(6 + self.nv)
        self._lib.host_model_observation(
            self._h, _dp(np.ascontiguousarray(rbd, dtype=np.float64)), _dp(x)
        )
        return x

    def wbc_kinematics(self, x_des, u_des, rbd):
        """Full measured+desired WBC kinematics; returns the same NamedTuple
        as wbc/host_wbc.py::compute_wbc_kinematics_np."""
        from ..wbc.host_wbc import HostWbcKinematics

        x_des = np.ascontiguousarray(x_des, dtype=np.float64)
        u_des = np.ascontiguousarray(u_des, dtype=np.float64)
        rbd = np.ascontiguousarray(rbd, dtype=np.float64)
        self._lib.host_model_wbc_kinematics(
            self._h, _dp(x_des), _dp(u_des), _dp(rbd), *self._out_ptrs
        )
        o = self._out
        return HostWbcKinematics(
            q_m=o["q_m"], v_m=o["v_m"], M=o["M"], nle=o["nle"],
            Jc=o["Jc"], dJc=o["dJc"], base_J=o["base_J"], base_dJ=o["base_dJ"],
            p_contact_m=o["p_c"], v_contact_m=o["v_c"],
            q_d=o["q_d"], v_d=o["v_d"], p_contact_d=o["p_d"], v_contact_d=o["v_cd"],
            base_pose_d=o["pose_d"], base_vel_d=o["vel_d"], base_acc_d=o["acc_d"],
            forces_d=u_des[: 3 * self.nc].reshape(self.nc, 3),
        )

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.host_model_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

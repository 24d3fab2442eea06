"""Host-rate whole-body QP — the real-time torque path, numpy and native C++
end to end (wbc/host_wbc.py counterpart, a copy).

The reference's 400-500 Hz loop closes the WBC QP on the host CPU
(bipedal_wbc/src/WeightedWbc.cpp:53-81, qpOASES, inside the 2.5 ms tick of
task.info:178); the card never sits on its torque path.  This module is the
same split: the WBC's task rows (the JAX package's wbc/tasks.py +
wbc/weighted_wbc.py) and its ADMM (wbc/qp.py) on the host, consuming the
host dynamics (the C++ of native/host_model.cc, or model/host_dynamics.py's
numpy twin), so a control tick launches nothing on the card.

Backends: ``native=True`` (the default) runs the model quantities in the
C++ of native/ (model/native_model.py) and the whole QP, its task rows, its
factorization and its ADMM, in the port's native/host_wbc.cc
(wbc/native_qp.py::NativeWbc), one call each per tick (the QP's with the
GIL released, the model's with it held), and raises if they cannot be built; ``native=False`` runs their
numpy twins (compute_wbc_kinematics_np, HostWbc._assemble, solve_qp_np).
tests/test_torch_host_wbc.py holds both against the JAX package's HostWbc.

Beyond parity with the device WBC, the host solver warm-starts the ADMM
from the previous tick's (x, z, y) — consecutive 2.5 ms-apart QPs differ
slightly, so a fraction of the cold iteration count reaches the same
residuals (qpOASES gets the identical speedup from its hot-started active set).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from ..model.host_dynamics import (
    base_kinematics_from_centroidal_np,
    frame_jacobians_np,
    frame_jacobians_pos_np,
    generalized_velocity_from_state_input_np,
    host_kinematics_np,
    mass_and_nle_np,
    pos_pass_np,
    rotation_error_in_world_np,
    vel_pass_np,
)
from ..model.host_model import (
    HostModel,
    euler_rate_map_zyx_np,
    generalized_from_rbd_np,
    make_host_model,
    rotmat_from_zyx_np,
)
from ..model.native_model import NativeHostModel
from .native_qp import NativeWbc
from .tasks import NUM_CONTACTS, WbcTaskConfig

_BIG = 1e20
# the ADMM's step, proximal weight, relaxation and equality-row rho scale
RHO, SIGMA, ALPHA, EQ_RHO_SCALE = 0.1, 1e-6, 1.6, 1e3


class HostWbcKinematics(NamedTuple):
    """Numpy twin of tasks.py::WbcKinematics."""

    q_m: np.ndarray
    v_m: np.ndarray
    M: np.ndarray
    nle: np.ndarray
    Jc: np.ndarray  # (nc,3,nv)
    dJc: np.ndarray
    base_J: np.ndarray
    base_dJ: np.ndarray
    p_contact_m: np.ndarray
    v_contact_m: np.ndarray
    q_d: np.ndarray
    v_d: np.ndarray
    p_contact_d: np.ndarray
    v_contact_d: np.ndarray
    base_pose_d: np.ndarray
    base_vel_d: np.ndarray
    base_acc_d: np.ndarray
    forces_d: np.ndarray


class HostQpState(NamedTuple):
    """ADMM iterates carried tick-to-tick for warm starting."""

    x: np.ndarray
    z: np.ndarray
    y: np.ndarray


class HostWbcResult(NamedTuple):
    decision: np.ndarray
    torque: np.ndarray
    primal_residual: float
    dual_residual: float
    qp_state: HostQpState


def compute_wbc_kinematics_np(hm: HostModel, x_des, u_des, rbd_measured) -> HostWbcKinematics:
    """tasks.py::compute_wbc_kinematics twin (measured + desired sides)."""
    rbd = np.asarray(rbd_measured, dtype=np.float64)
    x_des = np.asarray(x_des, dtype=np.float64)
    u_des = np.asarray(u_des, dtype=np.float64)
    q_m, v_m = generalized_from_rbd_np(hm.nj, rbd)
    kin_m = host_kinematics_np(hm, q_m, v_m)
    M, nle = mass_and_nle_np(hm, q_m, v_m, kin=kin_m)
    # contact + base frames in ONE stacked call (the batched layout is what
    # keeps this path under the tick budget)
    fids = tuple(hm.contact_frame_ids) + (hm.base_frame_id,)
    J6, dJ6, pts, _ = frame_jacobians_np(hm, kin_m, fids)
    Jc, dJc, p_c = J6[:-1, :3, :], dJ6[:-1, :3, :], pts[:-1]
    v_c = Jc @ v_m
    base_J, base_dJ = J6[-1], dJ6[-1]

    q_d = x_des[6:]
    pos_d = pos_pass_np(hm, q_d)
    v_d = generalized_velocity_from_state_input_np(hm, x_des, u_des, pos=pos_d)
    kin_d = vel_pass_np(hm, pos_d, q_d, v_d)
    Jd6, p_d = frame_jacobians_pos_np(hm, pos_d, hm.contact_frame_ids)
    v_c_d = Jd6[:, :3, :] @ v_d
    pose_d, vel_d, acc_d = base_kinematics_from_centroidal_np(
        hm, x_des, u_des, pos=pos_d, v=v_d, kin=kin_d
    )
    return HostWbcKinematics(
        q_m=q_m, v_m=v_m, M=M, nle=nle, Jc=Jc, dJc=dJc,
        base_J=base_J, base_dJ=base_dJ, p_contact_m=p_c, v_contact_m=v_c,
        q_d=q_d, v_d=v_d, p_contact_d=p_d, v_contact_d=v_c_d,
        base_pose_d=pose_d, base_vel_d=vel_d, base_acc_d=acc_d,
        forces_d=u_des[: 3 * NUM_CONTACTS].reshape(NUM_CONTACTS, 3),
    )


def solve_qp_np(
    H, g, A, l, u,  # noqa: E741
    iters: int = 120,
    rho: float = RHO,
    sigma: float = SIGMA,
    alpha: float = ALPHA,
    eq_rho_scale: float = EQ_RHO_SCALE,
    warm: HostQpState | None = None,
):
    """wbc/qp.py::solve_qp twin (OSQP-style ADMM, per-row equality rho) in
    numpy: the reference of native/host_wbc.cc's solve and HostWbc's
    native=False path.

    The KKT solve is done through its SPD Schur complement
    P = H + sigma I + A^T diag(rho) A (n x n: 38 for H1, 42 for G1) instead of the
    (n+m) square quasi-definite system the device solver factorizes —
    algebraically the same (x_t identical, nu = rho (A x_t - b)), ~25x
    fewer factorization flops, which is what fits the 2.5 ms tick."""
    n = H.shape[0]
    is_eq = (u - l) < 1e-9
    rho_vec = np.where(is_eq, rho * eq_rho_scale, rho)
    rho_A = rho_vec[:, None] * A
    P = H + sigma * np.eye(n) + A.T @ rho_A
    P_inv = np.linalg.inv(P)
    rho_AT = np.ascontiguousarray(rho_A.T)  # (n, m)

    if warm is None:
        x = np.zeros(n)
        z = np.clip(np.zeros(len(rho_vec)), l, u)
        y = np.zeros(len(rho_vec))
    else:
        x, z, y = warm.x.copy(), warm.z.copy(), warm.y.copy()
    inv_rho = 1.0 / rho_vec
    for _ in range(iters):
        b_rhs = z - y * inv_rho
        x_t = P_inv @ (sigma * x - g + rho_AT @ b_rhs)
        nu = rho_vec * (A @ x_t - b_rhs)
        z_t = z + (nu - y) * inv_rho
        x = alpha * x_t + (1 - alpha) * x
        z_mix = alpha * z_t + (1 - alpha) * z
        z = np.clip(z_mix + y * inv_rho, l, u)
        y = y + rho_vec * (z_mix - z)

    ax = A @ x
    primal = float(np.max(np.abs(ax - np.clip(ax, l, u))))
    dual = float(np.max(np.abs(H @ x + g + A.T @ y)))
    return HostQpState(x=x, z=z, y=y), primal, dual


class HostWbc:
    """Stateful host-side WeightedWbc: constant task rows precomputed once,
    per-tick rows assembled in place, ADMM warm-started from the last tick.
    ``backend`` names what runs the model quantities and the QP: "native"
    (C++) or "numpy" (native=False).
    """

    def __init__(
        self,
        model,
        info,
        cfg: WbcTaskConfig,
        qp_iters: int = 120,
        warm_iters: int = 40,
        hm: HostModel | None = None,
        native: bool = True,
    ):
        self.hm = hm if hm is not None else make_host_model(model, info)
        self.native = native
        self.backend = "native" if native else "numpy"
        self.native_model = NativeHostModel(self.hm) if native else None
        self.cfg = cfg
        self.qp_iters = qp_iters
        self.warm_iters = warm_iters
        hm = self.hm
        self.nv = 6 + hm.nj
        self.nfc = 3 * NUM_CONTACTS
        self.ndec = self.nv + self.nfc + hm.nj
        self._state: HostQpState | None = None

        # constant pieces -------------------------------------------------
        nj, nv, ndec = hm.nj, self.nv, self.ndec
        # torque limits: |tau| <= limits (inequality rows)
        off_tau = nv + self.nfc
        eye = np.zeros((nj, ndec))
        eye[:, off_tau:] = np.eye(nj)
        self._d_tau = np.concatenate([eye, -eye], axis=0)
        limits = np.tile(np.asarray(cfg.torque_limit_per_leg, dtype=np.float64), 2)
        self._f_tau = np.concatenate([limits, limits])
        mu = cfg.friction_coefficient
        self._pyramid = np.array(
            [
                [0.0, 0.0, -1.0],
                [1.0, 0.0, -mu],
                [-1.0, 0.0, -mu],
                [0.0, 1.0, -mu],
                [0.0, -1.0, -mu],
            ]
        )
        self._S_T = np.concatenate([np.zeros((6, nj)), np.eye(nj)], axis=0)
        self._reg = np.concatenate(
            [
                np.full(nv, cfg.accel_reg),
                np.full(self.nfc, cfg.force_reg),
                np.full(nj, cfg.torque_reg),
            ]
        )
        self.native_wbc = (
            NativeWbc(nj, cfg, self._reg, RHO, SIGMA, ALPHA, EQ_RHO_SCALE) if native else None
        )

    # ------------------------------------------------------------------
    def _assemble(self, kin: HostWbcKinematics, flags):
        """Task rows in the exact stacking order of weighted_wbc.py."""
        cfg, hm = self.cfg, self.hm
        nv, nfc, ndec, nj = self.nv, self.nfc, self.ndec, hm.nj
        flags = np.asarray(flags, dtype=np.float64)

        # ---- hard constraints: [eom(nv) | fric_eq(12) | ncm(12)] equalities,
        #      [tau(2nj) | fric_ineq(20)] inequalities
        a_eom = np.zeros((nv, ndec))
        a_eom[:, :nv] = kin.M
        a_eom[:, nv : nv + nfc] = -kin.Jc.reshape(nfc, nv).T
        a_eom[:, nv + nfc :] = -self._S_T
        b_eom = -kin.nle

        a_fric = np.zeros((3 * NUM_CONTACTS, ndec))
        d_fric = np.zeros((5 * NUM_CONTACTS, ndec))
        for i in range(NUM_CONTACTS):
            swing = 1.0 - flags[i]
            a_fric[3 * i : 3 * i + 3, nv + 3 * i : nv + 3 * i + 3] = swing * np.eye(3)
            d_fric[5 * i : 5 * i + 5, nv + 3 * i : nv + 3 * i + 3] = (
                flags[i] * self._pyramid
            )

        a_ncm = np.zeros((3 * NUM_CONTACTS, ndec))
        b_ncm = np.zeros(3 * NUM_CONTACTS)
        for i in range(NUM_CONTACTS):
            m_i = flags[i]
            a_ncm[3 * i : 3 * i + 3, :nv] = m_i * kin.Jc[i]
            b_ncm[3 * i : 3 * i + 3] = m_i * (-(kin.dJc[i] @ kin.v_m))

        A = np.concatenate([a_eom, a_fric, a_ncm, self._d_tau, d_fric], axis=0)
        n_eq = nv + 3 * NUM_CONTACTS + 3 * NUM_CONTACTS
        b_eq = np.concatenate([b_eom, np.zeros(3 * NUM_CONTACTS), b_ncm])
        f_in = np.concatenate([self._f_tau, np.zeros(5 * NUM_CONTACTS)])
        l = np.concatenate([b_eq, np.full(f_in.shape[0], -_BIG)])  # noqa: E741
        u = np.concatenate([b_eq, f_in])

        # ---- weighted tasks: [swing(12) | base(6) | force(12)]
        a_sw = np.zeros((3 * NUM_CONTACTS, ndec))
        b_sw = np.zeros(3 * NUM_CONTACTS)
        for i in range(NUM_CONTACTS):
            swing = 1.0 - flags[i]
            accel = cfg.swing_kp * (kin.p_contact_d[i] - kin.p_contact_m[i]) + cfg.swing_kd * (
                kin.v_contact_d[i] - kin.v_contact_m[i]
            )
            a_sw[3 * i : 3 * i + 3, :nv] = swing * kin.Jc[i]
            b_sw[3 * i : 3 * i + 3] = swing * (accel - kin.dJc[i] @ kin.v_m)

        a_base = np.zeros((6, ndec))
        a_base[:3, :3] = np.eye(3)
        a_base[3:6, :nv] = kin.base_J[3:6]
        theta_m = kin.q_m[3:6]
        omega_m = euler_rate_map_zyx_np(theta_m) @ kin.v_m[3:6]
        kp = np.asarray(cfg.base_kp)
        kd = np.asarray(cfg.base_kd)
        pos_err = kin.base_pose_d[:3] - kin.q_m[:3]
        vel_err = kin.base_vel_d[:3] - kin.v_m[:3]
        rot_err = rotation_error_in_world_np(
            rotmat_from_zyx_np(kin.base_pose_d[3:6]), rotmat_from_zyx_np(theta_m)
        )
        omega_err = kin.base_vel_d[3:] - omega_m
        b_base = np.concatenate(
            [
                kin.base_acc_d[:3] + kp[:3] * pos_err + kd[:3] * vel_err,
                kin.base_acc_d[3:]
                + kp[3:] * rot_err
                + kd[3:] * omega_err
                - kin.base_dJ[3:6] @ kin.v_m,
            ]
        )

        a_force = np.zeros((nfc, ndec))
        a_force[:, nv : nv + nfc] = np.eye(nfc)
        b_force = kin.forces_d.reshape(-1)

        Wa = np.concatenate(
            [
                cfg.weight_swing_leg * a_sw,
                cfg.weight_base_accel * a_base,
                cfg.weight_contact_force * a_force,
            ],
            axis=0,
        )
        Wb = np.concatenate(
            [
                cfg.weight_swing_leg * b_sw,
                cfg.weight_base_accel * b_base,
                cfg.weight_contact_force * b_force,
            ]
        )
        H = Wa.T @ Wa + np.diag(self._reg)
        g = -Wa.T @ Wb
        return H, g, A, l, u

    # ------------------------------------------------------------------
    def update(self, x_des, u_des, rbd_measured, contact_flags, warm: bool = True) -> HostWbcResult:
        """One tick: kinematics -> task rows -> ADMM -> torque."""
        native = self.native_wbc is not None
        if native:
            u_des = np.ascontiguousarray(u_des, dtype=np.float64)
            kin = self.native_model.wbc_kinematics(x_des, u_des, rbd_measured)
        else:
            kin = compute_wbc_kinematics_np(self.hm, x_des, u_des, rbd_measured)
        # Cold-start on a CONTACT-STRUCTURE change: the warm duals belong to
        # the previous active set (stance zero-accel rows vs swing-task
        # rows flip with the flags), and the short warm iteration budget
        # then emits garbage torques for several ticks — measured on Hunter
        # as +-250 N m tau_ff oscillation at lift-off whose 23.7 N m
        # clipped residue pumped the 11 kg robot off the ground.
        flags_key = tuple(bool(f) for f in np.asarray(contact_flags) > 0.5)
        if getattr(self, "_last_flags", None) != flags_key:
            self._state = None
        self._last_flags = flags_key
        state0 = self._state if warm else None
        iters = self.warm_iters if state0 is not None else self.qp_iters
        if native:
            (x, z, y), primal, dual = self.native_wbc.solve(kin, u_des, contact_flags, iters, warm=state0)
            state = HostQpState(x=x, z=z, y=y)
        else:
            H, g, A, l, u = self._assemble(kin, contact_flags)  # noqa: E741
            state, primal, dual = solve_qp_np(H, g, A, l, u, iters=iters, warm=state0)
        if np.all(np.isfinite(state.x)):
            self._state = state
        else:
            self._state = None  # poisoned iterates must not warm the next tick
        nj = self.hm.nj
        return HostWbcResult(
            decision=state.x,
            torque=state.x[-nj:],
            primal_residual=primal,
            dual_residual=dual,
            qp_state=state,
        )

    def reset(self) -> None:
        self._state = None

    def replace_config(self, cfg: WbcTaskConfig) -> None:
        """Swap the task weights/gains on a running instance (the
        dynamic_reconfigure path, BipedalController.cpp:407-478).  Constant
        rows depending on cfg are rebuilt; warm-start state is kept (the QP
        changes only through values, not dimensions)."""
        state = self._state
        HostWbc.__init__(
            self, None, None, cfg,
            qp_iters=self.qp_iters, warm_iters=self.warm_iters, hm=self.hm, native=self.native,
        )
        self._state = state


__all__ = [
    "HostWbc",
    "HostWbcResult",
    "HostQpState",
    "compute_wbc_kinematics_np",
    "solve_qp_np",
]

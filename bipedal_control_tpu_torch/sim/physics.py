"""On-device batched rigid-body physics (sim/jax_physics.py counterpart).

Full floating-base dynamics in generalized coordinates q = [p_base,
euler-zyx, q_j] with coordinate-rate velocities, compliant ground contact at
the contact frames, and the reference's hybrid-joint PD law closed at the
physics rate (ctrl = ff + kp (posDes - q) + kd (velDes - dq),
BipedalMujocoHW.cpp:206-218), on the port's model stack
(model/dynamics.py's mass matrix and nonlinear effects).

Every function takes a leading scenario axis (any number of leading dims):
the JAX package vmaps one scenario, the port batches.  Nothing reads a value
back to the host, so the batched closed loop (sim/batch_loop.py) replays a
step from a CUDA graph.

Contact model, as in the reference:
- normal: Kelvin-Voigt spring-damper, spring explicit, damper implicit
  (folded into the mass-matrix solve);
- tangential: anchored spring (stiction) + implicit viscous damping, the
  spring force capped by the Coulomb cone mu * f_n; on a cap violation the
  anchor is projected back onto the cone (slip), and swing feet re-anchor
  where they are;
- joint damping (the actuator kd) is implicit too.

The implicit step solves (M + dt (D + sum_i J_i^T C_i J_i)) vdot = rhs, a
symmetric positive-definite (nv x nv) system per scenario, by a Cholesky
factorisation without its error check (``cholesky_ex``) and two triangular
solves: the checking solve reads its status back to the host, which would
synchronise the card and cannot be captured in a CUDA graph, and
``cholesky_solve`` and the batched ``solve_ex`` allocate inside MAGMA,
which a capture refuses (H100, PyTorch 2.11, B = 64).  A state that is no
longer finite is the closed loop's freeze-on-fall guard's to handle, as in
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..model.dynamics import mass_matrix, nonlinear_effects
from ..model.kinematics import forward_kinematics, frame_transform, stacked_point_jacobians
from ..utils.rotations import global_angular_velocity_from_zyx_rates


@dataclasses.dataclass(frozen=True)
class SimConfig:
    dt: float = 1.0 / 1000.0  # physics substep
    contact_kp: float = 30000.0  # normal spring [N/m]
    contact_kd: float = 1000.0  # normal damper [N s/m] (implicit)
    tangent_kp: float = 5000.0  # tangential anchor spring [N/m]
    tangent_kd: float = 300.0  # tangential damper [N s/m] (implicit)
    friction_mu: float = 0.7  # ground Coulomb coefficient
    torque_limit: float = 300.0  # actuator clamp [N m]
    ground_height: float = 0.0


class SimState(NamedTuple):
    q: torch.Tensor  # (..., 6+nj) [p_base, euler-zyx, q_j]
    v: torch.Tensor  # (..., 6+nj) coordinate rates
    anchor: torch.Tensor  # (..., nc, 2) tangential stick anchors (world xy)


def _contact_points(model, info, kin):
    """(..., nc, 3) world positions of the contact frames."""
    return torch.stack([frame_transform(model, kin, f)[1] for f in info.contact_frame_ids], dim=-2)


def _contact_jacobians(model, info, kin, pts):
    """(..., nc, 3, nv) translational Jacobians of the contact points."""
    anc = model.ancestor_mask()[[model.frame_body[f] for f in info.contact_frame_ids]]
    return stacked_point_jacobians(model, kin, pts, anc)[..., :3, :]


def sim_step(model, info, cfg: SimConfig, state: SimState, tau_joint, joint_damping=0.0):
    """One physics substep of every scenario under joint torques (..., nj).

    ``joint_damping`` (a scalar or a tensor broadcasting to (..., nj))
    integrates implicitly; pass the PD kd here and put only
    ff + kp (posDes - q) + kd velDes in ``tau_joint``
    (:func:`hybrid_pd_torque_explicit` does the split).  Returns the new
    state and the contact forces (..., nc, 3), the implicit damper's part
    included."""
    q, v, anchor = state
    kin = forward_kinematics(model, q)
    pts = _contact_points(model, info, kin)
    J = _contact_jacobians(model, info, kin, pts)

    depth = cfg.ground_height - pts[..., 2]
    in_c = (depth > 0.0).to(q.dtype)
    f_n = cfg.contact_kp * depth * in_c  # explicit spring part

    # tangential anchor spring with Coulomb-cone projection
    f_t_raw = -cfg.tangent_kp * (pts[..., :2] - anchor)  # (..., nc, 2)
    f_t_norm = torch.sqrt((f_t_raw * f_t_raw).sum(-1) + 1e-12)
    scale = in_c * torch.clamp(cfg.friction_mu * f_n / f_t_norm, max=1.0)
    f_t = scale[..., None] * f_t_raw
    # slip: project the anchor back so the spring sits on the cone; swing
    # feet re-anchor at their current position
    anchor_new = torch.where(
        (in_c * scale)[..., None] > 0.0, pts[..., :2] + (anchor - pts[..., :2]) * scale[..., None], pts[..., :2]
    )
    f_ext = torch.cat([f_t, f_n[..., None]], dim=-1)  # (..., nc, 3) explicit

    tau_j = torch.clamp(tau_joint, -cfg.torque_limit, cfg.torque_limit)
    tau_gen = torch.cat([torch.zeros_like(q[..., :6]), tau_j.expand(q[..., 6:].shape)], dim=-1)
    tau_gen = tau_gen + torch.einsum("...cin,...ci->...n", J, f_ext)

    M = mass_matrix(model, q)
    h = nonlinear_effects(model, q, v)
    # a fill, not a host-to-device copy (a CUDA graph cannot capture one)
    kd_j = joint_damping if torch.is_tensor(joint_damping) else torch.full_like(q[..., 6:], float(joint_damping))
    d = torch.cat([torch.zeros_like(q[..., :6]), kd_j.expand(q[..., 6:].shape)], dim=-1)
    # implicit damping: (M + dt (D + sum_i J_i^T C_i J_i)) vdot =
    #   tau + J^T f_ext - h - D v - sum_i J_i^T C_i (J_i v)
    C = torch.stack([in_c * cfg.tangent_kd, in_c * cfg.tangent_kd, in_c * cfg.contact_kd], dim=-1)  # (..., nc, 3)
    Dc = torch.einsum("...cin,...ci,...cim->...nm", J, C, J)  # (..., nv, nv)
    lhs = M + cfg.dt * (torch.diag_embed(d) + Dc)
    rhs = tau_gen - h - d * v - (Dc @ v[..., None])[..., 0]
    L = torch.linalg.cholesky_ex(lhs)[0]
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    vdot = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
    v_new = v + cfg.dt * vdot
    q_new = q + cfg.dt * v_new  # coordinate rates integrate directly
    forces = f_ext - C * torch.einsum("...cin,...n->...ci", J, v_new)  # incl. the implicit damper part
    return SimState(q=q_new, v=v_new, anchor=anchor_new), forces


def hybrid_pd_torque_explicit(cmd_pos, cmd_vel, kp, kd, tau_ff, q_j):
    """Explicit part of the hybrid-joint law (BipedalMujocoHW::write
    semantics); the -kd dq term goes through sim_step's implicit damping."""
    return tau_ff + kp * (cmd_pos - q_j) + kd * cmd_vel


def rbd_state_from_sim(model, state: SimState):
    """Ground-truth rbdState [euler, pos, q_j, omega_w, v_w, dq_j] (..., 2 nv)
    from the sim state (the cheater estimator of the batched loop)."""
    q, v = state.q, state.v
    omega_w = global_angular_velocity_from_zyx_rates(q[..., 3:6], v[..., 3:6])
    return torch.cat([q[..., 3:6], q[..., 0:3], q[..., 6:], omega_w, v[..., 0:3], v[..., 6:]], dim=-1)


def initial_sim_state(model, info, x0) -> SimState:
    """At rest at the centroidal state's pose x0 (..., nx), anchors under the
    feet."""
    q = x0[..., 6:]
    pts = _contact_points(model, info, forward_kinematics(model, q))
    return SimState(q=q, v=torch.zeros_like(q), anchor=pts[..., :2])

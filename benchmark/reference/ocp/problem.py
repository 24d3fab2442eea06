"""Optimal-control-problem pieces: settings, node references, costs and
masked constraints (ocp/problem.py counterpart).

Equality-residual layout per node (nc = 4 contacts -> 16 rows):
  rows 3i..3i+2  : stance_i ? foot velocity (+ z position-error gain) : F_i
  rows 12+i      : swing_i ? v_ee_z - vref_i + gain (p_ee_z - zref_i) : 0
Soft inequality: friction cone h = mu (Fz + f_grip) - sqrt(Fx^2 + Fy^2 + eps)
as a relaxed log-barrier in the cost.

Every function takes any number of leading batch dimensions (scenario, node).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..model.centroidal import (
    CentroidalModelInfo,
    centroidal_flow_map,
    get_contact_forces,
    get_generalized_coordinates,
    generalized_velocity_from_state_input,
)
from ..model.kinematics import forward_kinematics, frame_position, stacked_point_jacobians
from ..model.robot_model import RobotModel

NUM_CONTACTS = 4


@dataclasses.dataclass(frozen=True)
class OcpSettings:
    """Solver knobs with the JAX package's field names and defaults.

    cone: "soft" (the relaxed log-barrier), "hard" (the barrier's mu and
    delta shrink geometrically over the SQP iterations toward
    cone_mu_final and cone_delta_final) or "ipm" (primal-dual slack and dual
    iterates on the stance cones, solver/sqp.py).  riccati also takes
    "parallel" (associative scan, float64 only) and "parallel_sqrt" (its
    square-root form), solver/parallel_riccati.py.  The structured
    linearization takes integrators "euler" and "rk2"; "rk4" is taken by the
    autodiff :func:`linearize_node` only.
    ``linearize="pallas"``, ``riccati="pallas"`` and ``merit="pallas"`` keep
    their reference names and mean "the hand-written kernel": the CUDA
    kernels of ``ops/linearize_kernel.py``, ``ops/riccati_kernel.py`` and
    ``ops/merit_kernel.py`` for CUDA tensors, and their plain PyTorch
    versions for CPU tensors.  ``linearize="structured"``,
    ``riccati="sequential"`` and ``merit="xla"`` run the plain versions on
    every device."""

    dt: float = 0.015
    horizon: float = 1.0
    sqp_iterations: int = 1
    friction_coefficient: float = 0.5
    barrier_mu: float = 0.1
    barrier_delta: float = 5.0
    cone_regularization: float = 1e-3
    cone: str = "soft"
    cone_mu_decay: float = 0.25
    cone_mu_final: float = 1e-3
    cone_delta_final: float = 1e-2
    ipm_mu_init: float = 1e-2
    ipm_mu_target: float = 1e-4
    ipm_mu_decay: float = 0.2
    ipm_fraction_to_boundary: float = 0.995
    ipm_dual_step_from_primal: bool = False
    gripper_force: float = 0.0
    position_error_gain: float = 0.0
    integrator: str = "rk2"
    exact_rk2_sensitivity: bool = False
    linesearch_alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.05)
    riccati: str = "sequential"
    riccati_penalty: float = 1e6
    merit: str = "xla"
    linearize: str = "structured"

    @property
    def num_intervals(self) -> int:
        return max(1, round(self.horizon / self.dt))


class NodeRefs(NamedTuple):
    """Per-node reference data (leading axes = scenario, node when stacked)."""

    t: torch.Tensor  # ()
    dt: torch.Tensor  # () interval length to the next node
    contact_flags: torch.Tensor  # (4,) float 0/1
    swing_vref: torch.Tensor  # (4,)
    swing_pref: torch.Tensor  # (4,)
    x_nom: torch.Tensor  # (nx,)
    u_nom: torch.Tensor  # (nu,)


def weight_compensating_input(info: CentroidalModelInfo, contact_flags, nu: int):
    """Gravity equally split over stance feet, zero joint velocity:
    (..., 4) flags -> (..., nu)."""
    num_stance = contact_flags.sum(-1, keepdim=True)
    fz = info.robot_mass * 9.81 / torch.clamp(num_stance, min=1.0)
    lead = contact_flags.shape[:-1]
    u = torch.zeros(lead + (nu,), dtype=contact_flags.dtype, device=contact_flags.device)
    u[..., 2 : 3 * NUM_CONTACTS : 3] = fz * contact_flags
    return u


def make_node_refs(info: CentroidalModelInfo, gait_table, swing_table, target_table, t, dt):
    """The references of every node at once from frozen device tables:
    t, dt (..., N) -> NodeRefs with (..., N, ...) fields (the JAX package
    vmaps its one-node version over t)."""
    phase = gait_table.phase_index(t)
    flags = gait_table.contacts[phase]
    contacts = torch.arange(NUM_CONTACTS, device=t.device)
    pref, vref = swing_table.z_position_velocity(contacts, phase[..., None], t[..., None])
    x_nom = target_table.state_at(t)
    u_nom = weight_compensating_input(info, flags, info.input_dim)
    return NodeRefs(t=t, dt=dt, contact_flags=flags, swing_vref=vref, swing_pref=pref, x_nom=x_nom, u_nom=u_nom)


# ---------------------------------------------------------------- constraints
def contact_kinematics(model: RobotModel, info: CentroidalModelInfo, x, u):
    """(positions (..., nc, 3), velocities (..., nc, 3)) of the contact frames."""
    q = get_generalized_coordinates(x)
    v = generalized_velocity_from_state_input(model, info, x, u)
    kin = forward_kinematics(model, q)
    ps = torch.stack([frame_position(model, kin, fid) for fid in info.contact_frame_ids], dim=-2)
    anc = model.ancestor_mask()[[model.frame_body[fid] for fid in info.contact_frame_ids]]
    J = stacked_point_jacobians(model, kin, ps, anc)  # (..., nc, 6, nv)
    vs = (J[..., :3, :] * v[..., None, None, :]).sum(-1)
    return ps, vs


def equality_residual(
    model: RobotModel, info: CentroidalModelInfo, settings: OcpSettings, x, u, refs: NodeRefs
):
    """(..., 16) masked equality constraint residual (module docstring)."""
    p_ee, v_ee = contact_kinematics(model, info, x, u)
    forces = get_contact_forces(u, info)
    gain = settings.position_error_gain
    flags = refs.contact_flags[..., None]
    zero_vel = torch.cat([v_ee[..., :2], v_ee[..., 2:3] + gain * p_ee[..., 2:3]], dim=-1)
    per_contact = flags * zero_vel + (1.0 - flags) * forces
    nvel = (1.0 - refs.contact_flags) * (
        v_ee[..., 2] - refs.swing_vref + gain * (p_ee[..., 2] - refs.swing_pref)
    )
    return torch.cat([per_contact.flatten(-2), nvel], dim=-1)


def friction_cone_values(settings: OcpSettings, u, info: CentroidalModelInfo):
    """(..., nc) cone constraint h_i >= 0."""
    forces = get_contact_forces(u, info)
    f_tangent = torch.sqrt(forces[..., 0] ** 2 + forces[..., 1] ** 2 + settings.cone_regularization)
    return settings.friction_coefficient * (forces[..., 2] + settings.gripper_force) - f_tangent


def friction_cone_grads_u(settings: OcpSettings, u, info: CentroidalModelInfo):
    """(..., nc, nu) gradient of :func:`friction_cone_values` w.r.t. the
    input: each cone depends only on its contact's force slots,
    d h_i / d F_i = [-Fx/f_tan, -Fy/f_tan, mu]."""
    forces = get_contact_forces(u, info)
    nc = forces.shape[-2]
    f_tan = torch.sqrt(forces[..., 0] ** 2 + forces[..., 1] ** 2 + settings.cone_regularization)
    g3 = torch.stack(
        [-forces[..., 0] / f_tan, -forces[..., 1] / f_tan, torch.full_like(f_tan, settings.friction_coefficient)],
        dim=-1,
    )  # (..., nc, 3)
    G = torch.zeros(u.shape[:-1] + (nc, u.shape[-1]), dtype=u.dtype, device=u.device)
    for i in range(nc):
        G[..., i, 3 * i : 3 * i + 3] = g3[..., i, :]
    return G


def relaxed_barrier(h, mu, delta):
    """OCS2 RelaxedBarrierPenalty: -mu ln(h) for h > delta, quadratic below."""
    safe_h = torch.clamp(h, min=delta)
    log_part = -mu * torch.log(safe_h)
    quad_part = mu * (-math.log(delta) + 0.5 * ((h - 2.0 * delta) / delta) ** 2 - 0.5)
    return torch.where(h > delta, log_part, quad_part)


def relaxed_barrier_derivatives(h, mu, delta):
    """(d/dh, d2/dh2) of :func:`relaxed_barrier`."""
    safe_h = torch.clamp(h, min=delta)
    d1 = torch.where(h > delta, -mu / safe_h, mu * (h - 2.0 * delta) / delta**2)
    d2 = torch.where(h > delta, mu / safe_h**2, torch.full_like(h, mu / delta**2))
    return d1, d2


def node_cost(
    model: RobotModel, info: CentroidalModelInfo, settings: OcpSettings, Q, R, x, u, refs: NodeRefs
):
    """Intermediate cost L(x,u) (not yet dt-scaled): quadratic tracking +
    soft friction cones."""
    dx = x - refs.x_nom
    du = u - refs.u_nom
    quad = 0.5 * (dx * (dx @ Q)).sum(-1) + 0.5 * (du * (du @ R)).sum(-1)
    cones = friction_cone_values(settings, u, info)
    pen = relaxed_barrier(cones, settings.barrier_mu, settings.barrier_delta)
    return quad + (refs.contact_flags * pen).sum(-1)


# ---------------------------------------------------------------- dynamics
def discrete_dynamics(model: RobotModel, info: CentroidalModelInfo, settings: OcpSettings, x, u, dt):
    """One shooting interval of the centroidal flow; dt broadcasts as (...,)."""
    f = lambda xx: centroidal_flow_map(model, info, xx, u)
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)[..., None]
    if settings.integrator == "euler":
        return x + dt * f(x)
    if settings.integrator == "rk2":
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        return x + dt * k2
    if settings.integrator == "rk4":
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        k3 = f(x + 0.5 * dt * k2)
        k4 = f(x + dt * k3)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    raise ValueError(settings.integrator)


class LinearizedNode(NamedTuple):
    """Quadratic/linear approximations at one shooting node."""

    A: torch.Tensor  # (nx,nx) d F / d x
    B: torch.Tensor  # (nx,nu)
    c: torch.Tensor  # (nx,) defect F(x_k,u_k) - x_{k+1}
    C: torch.Tensor  # (ne,nx) equality jacobian
    D: torch.Tensor  # (ne,nu)
    e: torch.Tensor  # (ne,) residual
    Qxx: torch.Tensor  # (nx,nx) dt-scaled cost hessian
    Quu: torch.Tensor  # (nu,nu)
    Qux: torch.Tensor  # (nu,nx)
    qx: torch.Tensor  # (nx,)
    qu: torch.Tensor  # (nu,)
    cost: torch.Tensor  # () dt-scaled cost value


def linearize_node(
    model: RobotModel, info: CentroidalModelInfo, settings: OcpSettings, Q, R, x, u, x_next, refs: NodeRefs
) -> LinearizedNode:
    """Full Gauss-Newton data of every node of the leading (scenario, node)
    dims by automatic differentiation (the reference's linearize_node, the
    oracle of the structured linearization): the dynamics and the equality
    residual share one forward-mode Jacobian (``torch.func.jacfwd``, mapped
    over the nodes by ``torch.func.vmap``) through :func:`discrete_dynamics`,
    so every integrator is taken, "rk4" included; the cost's gradient by
    ``torch.func.grad``, its Hessian exact: (Q, R) plus the barrier's u-u
    curvature."""
    nx = x.shape[-1]

    def fused(xx, uu, ref):
        F = discrete_dynamics(model, info, settings, xx, uu, ref.dt)
        e = equality_residual(model, info, settings, xx, uu, ref)
        return torch.cat([F, e], dim=-1)

    val, (Jx, Ju) = _value_and_jacobians(fused, x, u, refs)
    A, C = Jx[..., :nx, :], Jx[..., nx:, :]
    B, D = Ju[..., :nx, :], Ju[..., nx:, :]
    c = val[..., :nx] - x_next

    cost_fn = lambda xx, uu, ref: ref.dt * node_cost(model, info, settings, Q, R, xx, uu, ref)
    grad = lambda xx, uu, ref: torch.func.grad(cost_fn, argnums=(0, 1))(xx, uu, ref)
    qx, qu = _map_nodes(grad, x, u, refs)
    Qxx = refs.dt[..., None, None] * Q
    Quu = refs.dt[..., None, None] * R + _barrier_hessian_u(settings, info, u, refs)
    Qux = torch.zeros(x.shape[:-1] + (u.shape[-1], nx), dtype=x.dtype, device=x.device)
    return LinearizedNode(A, B, c, C, D, val[..., nx:], Qxx, Quu, Qux, qx, qu, cost_fn(x, u, refs))


def _map_nodes(fn, x, u, refs: NodeRefs):
    """fn(x (nx,), u (nu,), ref of one node) mapped by ``torch.func.vmap``
    over the leading dims of x, u and refs' fields, which it flattens."""
    lead = x.shape[:-1]
    flat = lambda a: a.expand(lead + a.shape[len(lead):]).reshape((-1,) + a.shape[len(lead):])
    out = torch.func.vmap(fn)(flat(x), flat(u), NodeRefs(*(flat(f) for f in refs)))
    return torch.utils._pytree.tree_map(lambda a: a.reshape(lead + a.shape[1:]), out)


def _value_and_jacobians(fn, x, u, refs: NodeRefs):
    """(fn(x, u, refs), (d fn / dx, d fn / du)) by forward mode for every
    node of the leading dims; fn maps one node's (x, u, ref)."""
    one = lambda xx, uu, ref: (fn(xx, uu, ref), torch.func.jacfwd(fn, argnums=(0, 1))(xx, uu, ref))
    return _map_nodes(one, x, u, refs)


def _barrier_hessian_u(settings: OcpSettings, info: CentroidalModelInfo, u, refs: NodeRefs):
    """dt-scaled exact Hessian of the masked cone barriers w.r.t. u:
    4 dense 3x3 blocks on the force slots of (..., nu, nu).

    Closed form: pen''(h) g g^T + pen'(h) d2h, with g = dh/dF =
    [-Fx/ft, -Fy/ft, mu] and d2h/dF_xy2 = -(ft^2 I - f f^T) / ft^3."""
    forces = get_contact_forces(u, info)  # (..., nc, 3)
    fx, fy = forces[..., 0], forces[..., 1]
    ft = torch.sqrt(fx**2 + fy**2 + settings.cone_regularization)
    h = settings.friction_coefficient * (forces[..., 2] + settings.gripper_force) - ft
    d1, d2 = relaxed_barrier_derivatives(h, settings.barrier_mu, settings.barrier_delta)
    g = torch.stack([-fx / ft, -fy / ft, torch.full_like(ft, settings.friction_coefficient)], dim=-1)
    ft3 = ft**3
    zero = torch.zeros_like(ft)
    h_xy = torch.stack(
        [
            torch.stack([-(ft**2 - fx**2) / ft3, fx * fy / ft3, zero], dim=-1),
            torch.stack([fx * fy / ft3, -(ft**2 - fy**2) / ft3, zero], dim=-1),
            torch.stack([zero, zero, zero], dim=-1),
        ],
        dim=-2,
    )
    blocks = d2[..., None, None] * g[..., :, None] * g[..., None, :] + d1[..., None, None] * h_xy
    blocks = refs.contact_flags[..., None, None] * blocks  # (..., nc, 3, 3)
    nu = u.shape[-1]
    H = torch.zeros(u.shape[:-1] + (nu, nu), dtype=u.dtype, device=u.device)
    for i in range(NUM_CONTACTS):
        H[..., 3 * i : 3 * i + 3, 3 * i : 3 * i + 3] = blocks[..., i, :, :]
    return refs.dt[..., None, None] * H

"""Carry the JAX package's parameters across to the port.

Each function takes plain numpy arrays (or Python scalars) keyed by the JAX
package's field names and returns the port's counterpart, so both packages
compute on identical parameters:

    model_from_numpy({f.name: np.asarray(getattr(m, f.name)) for f in fields(m)})
    info_from_numpy(dataclasses.asdict(info))
    settings_from_numpy(dataclasses.asdict(settings))
    weights_from_numpy(Q, R)
    refs_from_numpy({name: np.asarray(a) for name, a in refs._asdict().items()})
    interface_from_numpy({"model": ..., "info": ..., "settings": ..., "Q": Q, "R": R})
    wbc_task_config_from_numpy(dataclasses.asdict(wbc_cfg))
    kalman_state_from_numpy({"z": np.asarray(state.z), "P": np.asarray(state.P)})
    sim_state_from_numpy({name: np.asarray(a) for name, a in state._asdict().items()})
    sim_config_from_numpy(dataclasses.asdict(sim_cfg))

Tensors land on ``device``: the card when None (utils/device.py); pass
``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .estim.kalman import KalmanState
from .model.centroidal import CentroidalModelInfo
from .model.robot_model import LEAF_FIELDS, RobotModel, ancestor_mask_from_parents
from .ocp.problem import NodeRefs, OcpSettings
from .sim.physics import SimConfig, SimState
from .utils.device import resolve_device
from .wbc.tasks import WbcTaskConfig


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype, device=resolve_device(device))


def _names(a) -> tuple[str, ...]:
    return tuple(str(s) for s in np.asarray(a).reshape(-1).tolist())


def _ints(a) -> tuple[int, ...]:
    return tuple(int(i) for i in np.asarray(a).reshape(-1).tolist())


def model_from_numpy(fields: dict, dtype=torch.float64, device=None) -> RobotModel:
    """RobotModel from the JAX RobotModel's fields as numpy arrays.

    The ancestor mask is rebuilt from ``joint_parent_body`` (numpy's bytes
    arrays drop trailing zero bytes, so the reference's packed mask does not
    survive ``np.asarray``)."""
    parents = _ints(fields["joint_parent_body"])
    return RobotModel(
        name=str(np.asarray(fields["name"]).item()),
        joint_names=_names(fields["joint_names"]),
        frame_names=_names(fields["frame_names"]),
        joint_parent_body=parents,
        joint_type=_ints(fields["joint_type"]),
        frame_body=_ints(fields["frame_body"]),
        ancestor_joints=ancestor_mask_from_parents(parents).tobytes(),
        **{f: _tensor(fields[f], dtype, device) for f in LEAF_FIELDS},
    )


def model_to_numpy(model: RobotModel) -> dict:
    """Inverse of :func:`model_from_numpy` (round-trip checks)."""
    out = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}
    for f in LEAF_FIELDS:
        out[f] = out[f].detach().cpu().numpy()
    return out


def info_from_numpy(fields: dict) -> CentroidalModelInfo:
    return CentroidalModelInfo(
        nj=int(fields["nj"]),
        contact_frame_ids=_ints(fields["contact_frame_ids"]),
        robot_mass=float(fields["robot_mass"]),
        model_type=int(fields.get("model_type", 0)),
        q_j_nominal=tuple(float(v) for v in np.asarray(fields.get("q_j_nominal", ())).reshape(-1)),
    )


def settings_from_numpy(fields: dict) -> OcpSettings:
    """OcpSettings from ``dataclasses.asdict`` of the reference settings."""
    kwargs = dict(fields)
    kwargs["linesearch_alphas"] = tuple(float(a) for a in kwargs.get("linesearch_alphas", ()))
    return OcpSettings(**kwargs)


def weights_from_numpy(Q, R, dtype=torch.float64, device=None):
    return _tensor(Q, dtype, device), _tensor(R, dtype, device)


def refs_from_numpy(fields: dict, dtype=torch.float64, device=None) -> NodeRefs:
    return NodeRefs(**{name: _tensor(fields[name], dtype, device) for name in NodeRefs._fields})


def interface_from_numpy(fields: dict, dtype=torch.float64, device=None):
    """RobotInterface from ``{"model", "info", "settings", "Q", "R"}`` in
    the forms the functions above take (the JAX interface's parts), with the
    circuit tables of the model kernels built for it."""
    from .interface import RobotInterface
    from .ops.static_model import circuit_static

    model = model_from_numpy(fields["model"], dtype=dtype, device=device)
    info = info_from_numpy(fields["info"])
    Q, R = weights_from_numpy(fields["Q"], fields["R"], dtype=dtype, device=device)
    return RobotInterface(
        model=model, info=info, settings=settings_from_numpy(fields["settings"]), Q=Q, R=R,
        circuit=circuit_static(model, info) if info.model_type == 0 else None,
    )


def interface_to_numpy(iface) -> dict:
    """Inverse of :func:`interface_from_numpy`: the interface's model, info,
    settings and weights as numpy arrays and plain values."""
    info = dataclasses.asdict(iface.info)
    return {
        "model": model_to_numpy(iface.model),
        "info": {k: (np.asarray(v) if isinstance(v, tuple) else v) for k, v in info.items()},
        "settings": dataclasses.asdict(iface.settings),
        "Q": iface.Q.detach().cpu().numpy(),
        "R": iface.R.detach().cpu().numpy(),
    }


def wbc_task_config_from_numpy(fields: dict) -> WbcTaskConfig:
    """WbcTaskConfig from ``dataclasses.asdict`` of the reference's (tuples
    as tuples of floats, scalars as floats)."""
    cast = lambda v: tuple(float(a) for a in np.asarray(v).reshape(-1)) if np.ndim(v) else float(v)
    return WbcTaskConfig(**{k: cast(v) for k, v in fields.items()})


def kalman_state_from_numpy(fields: dict, dtype=torch.float64, device=None) -> KalmanState:
    """The contact LKF's state (z, P) from the reference's as numpy arrays."""
    return KalmanState(z=_tensor(fields["z"], dtype, device), P=_tensor(fields["P"], dtype, device))


def sim_state_from_numpy(fields: dict, dtype=torch.float64, device=None) -> SimState:
    """The physics state (q, v, anchor) from the reference's ``JaxSimState``
    as numpy arrays (any leading scenario dims)."""
    return SimState(**{name: _tensor(fields[name], dtype, device) for name in SimState._fields})


def sim_config_from_numpy(fields: dict) -> SimConfig:
    """SimConfig from ``dataclasses.asdict`` of the reference's ``JaxSimConfig``."""
    return SimConfig(**{k: float(v) for k, v in fields.items()})

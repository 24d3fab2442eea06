"""The reference's own front end: the problem, the frozen gait tables and
each scenario's references, worked out from the raw files and the
benchmark's traffic, never from what the program made.

It mirrors what a cell's program side does through the port's entry points
(``make_interface``, ``ReferenceManager.freeze``, ``build_time_grid``,
``make_node_refs``, ``initial_trajectory``), on this package's frozen copies
of them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .interface import RobotInterface, make_interface
from .ocp.problem import NodeRefs, make_node_refs
from .reference.manager import build_time_grid


def make_problem(files: dict, solver: dict, device, dtype) -> RobotInterface:
    """The interface of a configuration's files (``urdf``, ``task``,
    ``reference``, ``gaits``, ``overrides``) with the configuration's
    solver settings; the settings' backend fields do not matter here."""
    iface = make_interface(files["urdf"], files["task"], files["reference"], files["gaits"], files["overrides"],
                           device=device, dtype=dtype)
    keep = {k: (tuple(v) if isinstance(v, list) else v) for k, v in solver.items()
            if k in ("dt", "horizon", "integrator", "cone", "sqp_iterations", "linesearch_alphas")}
    return dataclasses.replace(iface, settings=dataclasses.replace(iface.settings, **keep))


def frozen_tables(iface: RobotInterface, gait: str, gait_at: float, span: float):
    """(gait, swing, target tables on the interface's device and dtype, the
    event times as numpy) frozen once on the host in float64 from t = 0 over
    ``span`` seconds plus the horizon, with ``gait`` spliced in at
    ``gait_at``."""
    rm = dataclasses.replace(iface.make_reference_manager(), device="cpu", dtype=torch.float64)
    rm.max_phases = max(rm.max_phases, int(8 * (span + 2 * rm.horizon)) + 24)
    rm.set_gait(iface.task.gait_library[gait], start_time=gait_at)
    rm.horizon = span + iface.settings.horizon
    frozen = rm.freeze(0.0)
    to = lambda tab: type(tab)(*(a.to(device=iface.device, dtype=iface.dtype if a.is_floating_point() else a.dtype)
                                 for a in tab))
    return to(frozen.gait), to(frozen.swing), to(frozen.target), frozen.gait.event_times.numpy()


def lane_refs(iface: RobotInterface, tables, event_times, t0s) -> tuple[NodeRefs, torch.Tensor]:
    """(refs with fields (B, N, ...), node grids (B, N+1)) of scenarios that
    start at the times ``t0s`` (B,): each scenario's event-aligned grid over
    the horizon, then every node's references from the frozen tables."""
    s = iface.settings
    grids = np.stack([build_time_grid(float(t0), s.horizon, s.num_intervals, event_times) for t0 in t0s])
    t_nodes = torch.as_tensor(grids, dtype=iface.dtype, device=iface.device)
    t = t_nodes[:, :-1].contiguous()
    refs = make_node_refs(iface.info, tables[0], tables[1], tables[2], t, t_nodes[:, 1:] - t)
    return refs, t_nodes

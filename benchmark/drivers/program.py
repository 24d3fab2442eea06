"""The program's side of every driver: the configuration's settings on the
port's interface and the gait tables frozen by the port's reference
manager (the calls the port's own tools make: ``make_batched_closed_loop``,
``tools/scenario_survival_torch.py``)."""
from __future__ import annotations

import dataclasses

import torch


def program_settings(iface, config: dict):
    """The interface with the configuration's solver settings (the backends
    included) and, where it says so, without captureStepping."""
    keep = {k: (tuple(v) if isinstance(v, list) else v) for k, v in config["solver"].items()}
    iface = dataclasses.replace(iface, settings=dataclasses.replace(iface.settings, **keep))
    if not config.get("capture_stepping", True):
        iface = dataclasses.replace(iface, task=dataclasses.replace(iface.task, capture=None))
    return iface


def frozen_tables(iface, gait: str, gait_at: float, span: float):
    """(gait, swing, target tables on the interface's device and dtype, the
    event times as numpy), frozen once on the host in float64 from t = 0
    over ``span`` seconds plus the horizon, with ``gait`` spliced in at
    ``gait_at``."""
    rm = dataclasses.replace(iface.make_reference_manager(), device="cpu", dtype=torch.float64)
    rm.max_phases = max(rm.max_phases, int(8 * (span + 2 * rm.horizon)) + 24)
    rm.set_gait(iface.task.gait_library[gait], start_time=gait_at)
    rm.horizon = span + iface.settings.horizon
    frozen = rm.freeze(0.0)
    to = lambda tab: type(tab)(*(a.to(device=iface.device, dtype=iface.dtype if a.is_floating_point() else a.dtype)
                                 for a in tab))
    return to(frozen.gait), to(frozen.swing), to(frozen.target), frozen.gait.event_times.numpy()

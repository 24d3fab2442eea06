"""Scenario-batched RTI solver (parallel/batch_solver.py counterpart).

Thousands of independent MPC problems share one solver program; here the
batch is the leading axis of every input.  As in the JAX package, the
production configuration (pallas linearize, Riccati and merit, soft cone)
goes through ``solver/lanes_rti.py``'s entry.  The device mesh of the JAX
package (sharding the batch over chips) is not ported: ``mesh`` must be None.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..model.centroidal import CentroidalModelInfo
from ..model.robot_model import LEAF_FIELDS, RobotModel
from ..ocp.problem import OcpSettings
from ..ops.linearize_kernel import make_node_linearizer
from ..ops.merit_kernel import make_merit_sums
from ..ops.static_model import circuit_static
from ..solver.sqp import SqpSolution, _check_settings, sqp_solve
from ..utils.device import resolve_device
from ..utils.precision import set_full_f32_matmul


class BatchedSolver(nn.Module):
    """f(refs_b, t_nodes_b, x_init_b, xs_b, us_b) -> batched SqpSolution.

    The model's numeric tables, Q, R and the parameter tensor of the circuit
    kernels (linearize and merit) are buffers, so ``.to(device, dtype)``
    moves the whole solver.  The warm-start inputs are not modified (no
    in-place update)."""

    def __init__(self, model: RobotModel, info: CentroidalModelInfo, settings: OcpSettings, Q, R):
        super().__init__()
        _check_settings(info, settings)
        self.info = info
        self.settings = settings
        self._topology = {f.name: getattr(model, f.name) for f in dataclasses.fields(model) if f.name not in LEAF_FIELDS}
        for f in LEAF_FIELDS:
            self.register_buffer(f"model_{f}", getattr(model, f).detach().clone())
        as_t = lambda a: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a, dtype=model.dtype)
        self.register_buffer("Q", as_t(Q).clone())
        self.register_buffer("R", as_t(R).clone())
        self._merit = settings.merit == "pallas" and len(settings.linesearch_alphas) > 0
        self._linearize = settings.linearize == "pallas"
        self._defines = None
        if self._merit or self._linearize:
            self._defines, params = circuit_static(model, info)
            self.register_buffer("circuit_params", params)
        if self._linearize:  # raise now for what the kernel does not implement
            make_node_linearizer(model, info, settings, self.Q, self.R, static=(self._defines, self.circuit_params))

    def robot_model(self) -> RobotModel:
        return RobotModel(**self._topology, **{f: getattr(self, f"model_{f}") for f in LEAF_FIELDS})

    def forward(self, refs_b, t_nodes_b, x_init_b, xs_b, us_b) -> SqpSolution:
        model = self.robot_model()
        static = (self._defines, self.circuit_params) if self._defines is not None else None
        merit_sums = make_merit_sums(model, self.info, self.settings, static=static) if self._merit else None
        linearize = None
        if self._linearize:
            linearize = make_node_linearizer(model, self.info, self.settings, self.Q, self.R, static=static)
        return sqp_solve(
            model, self.info, self.settings, self.Q, self.R, refs_b, t_nodes_b, x_init_b, xs_b, us_b,
            merit_sums=merit_sums, linearize=linearize,
        )


def make_batched_solver(
    model: RobotModel,
    info: CentroidalModelInfo,
    settings: OcpSettings,
    Q,
    R,
    mesh=None,
    device=None,
) -> BatchedSolver:
    """Build the batched solver module (inputs batched on axis 0) on
    ``device``: the card when None, and RuntimeError where CUDA is absent;
    ``device="cpu"`` for the CPU.  Settings that ``solver/lanes_rti.py``
    supports take its entry.  Sets the full-float32 matmul policy
    (utils/precision.py).  A device mesh is not supported yet."""
    from ..solver.lanes_rti import _supports, make_lanes_rti_solver

    if mesh is not None:
        raise NotImplementedError("make_batched_solver: the device mesh is not ported; pass mesh=None")
    if _supports(settings):
        return make_lanes_rti_solver(model, info, settings, Q, R, device=device)
    device = resolve_device(device)
    set_full_f32_matmul()
    return BatchedSolver(model, info, settings, Q, R).to(device)

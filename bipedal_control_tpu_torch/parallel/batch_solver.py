"""Scenario-batched RTI solver (parallel/batch_solver.py counterpart).

Thousands of independent MPC problems share one solver program; here the
batch is the leading axis of every input.  The device mesh of the JAX
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
from ..solver.sqp import SqpSolution, _check_settings, sqp_solve
from ..utils.precision import set_full_f32_matmul


class BatchedSolver(nn.Module):
    """f(refs_b, t_nodes_b, x_init_b, xs_b, us_b) -> batched SqpSolution.

    The model's numeric tables, Q, R and the merit kernel's parameter tensor
    are buffers, so ``.to(device, dtype)`` moves the whole solver.  The
    warm-start inputs are not modified (no in-place update)."""

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
        self._merit_defines = None
        if settings.merit == "pallas" and len(settings.linesearch_alphas):
            from ..ops.merit_kernel import kernel_defines, kernel_params, make_static_model

            sm = make_static_model(model, info.contact_frame_ids)
            self._merit_defines = kernel_defines(sm)
            self.register_buffer("merit_params", torch.as_tensor(kernel_params(sm, info.robot_mass), dtype=model.dtype))

    def robot_model(self) -> RobotModel:
        return RobotModel(**self._topology, **{f: getattr(self, f"model_{f}") for f in LEAF_FIELDS})

    def forward(self, refs_b, t_nodes_b, x_init_b, xs_b, us_b) -> SqpSolution:
        model = self.robot_model()
        merit_sums = None
        if self._merit_defines is not None:
            from ..ops.merit_kernel import make_merit_sums

            merit_sums = make_merit_sums(
                model, self.info, self.settings, static=(self._merit_defines, self.merit_params)
            )
        return sqp_solve(
            model, self.info, self.settings, self.Q, self.R, refs_b, t_nodes_b, x_init_b, xs_b, us_b,
            merit_sums=merit_sums,
        )


def make_batched_solver(
    model: RobotModel,
    info: CentroidalModelInfo,
    settings: OcpSettings,
    Q,
    R,
    mesh=None,
) -> BatchedSolver:
    """Build the batched solver module (inputs batched on axis 0).  Sets the
    full-float32 matmul policy (utils/precision.py).  A device mesh is not
    supported yet."""
    if mesh is not None:
        raise NotImplementedError("make_batched_solver: the device mesh is not ported; pass mesh=None")
    set_full_f32_matmul()
    return BatchedSolver(model, info, settings, Q, R)

"""The production batched entry (solver/lanes_rti.py): linearize, riccati
and merit "pallas" with the soft cone, which make_batched_solver dispatches
to as the reference does.  Its predicate matches the reference's, it
rejects what the reference's rejects, and make_batched_solver takes it for
the production settings only.

The production solve's parity with the reference's vmap(sqp_solve) on the
CPU (alphas (1.0, 0.5), (1.0,) and (), the bars of tests/test_lanes_rti.py,
step_size exact) is the "pallas-*" cases of
tests/test_torch_sqp.py::test_batched_solver_matches_vmap_sqp, which share
their compiled reference with the structured cases.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from bipedal_control_tpu.ocp.problem import OcpSettings as JOcpSettings
from bipedal_control_tpu.solver.lanes_rti import _supports as j_supports
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.model.centroidal import CentroidalModelInfo
from bipedal_control_tpu_torch.ocp.problem import OcpSettings
from bipedal_control_tpu_torch.parallel.batch_solver import BatchedSolver, make_batched_solver
from bipedal_control_tpu_torch.solver import lanes_rti
from bipedal_control_tpu_torch.solver.lanes_rti import _supports, make_lanes_rti_solver

from test_pallas_linearize_kernel import tiny_biped


def test_supports_matches_reference():
    grid = itertools.product(("structured", "pallas"), ("sequential", "pallas", "parallel"),
                             ("soft", "hard", "ipm"), ("xla", "pallas"))
    n_yes = 0
    for lin, ric, cone, mer in grid:
        kw = dict(linearize=lin, riccati=ric, cone=cone, merit=mer)
        assert _supports(OcpSettings(**kw)) == j_supports(JOcpSettings(**kw)), kw
        n_yes += _supports(OcpSettings(**kw))
    assert n_yes == 1


def test_lanes_entry_rejects_what_it_does_not_take():
    info = CentroidalModelInfo(nj=4, contact_frame_ids=(0, 1, 2, 3), robot_mass=13.7)
    production = OcpSettings(linearize="pallas", riccati="pallas", merit="pallas")
    for change in (dict(linearize="structured"), dict(riccati="sequential"), dict(merit="xla"), dict(cone="hard")):
        with pytest.raises(NotImplementedError):
            make_lanes_rti_solver(None, info, dataclasses.replace(production, **change), None, None, device="cpu")
    with pytest.raises(NotImplementedError):
        make_lanes_rti_solver(None, dataclasses.replace(info, model_type=1), production, None, None, device="cpu")


def test_make_batched_solver_dispatches_to_the_lanes_entry(monkeypatch):
    calls = []
    real = lanes_rti.make_lanes_rti_solver
    monkeypatch.setattr(lanes_rti, "make_lanes_rti_solver", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    model, info = tiny_biped()
    tm = convert.model_from_numpy(
        {f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)}, device="cpu"
    )
    ti = convert.info_from_numpy(dataclasses.asdict(info))
    Q, R = np.eye(info.state_dim), np.eye(info.input_dim)
    production = OcpSettings(linearize="pallas", riccati="pallas", merit="pallas", linesearch_alphas=(1.0,))
    solver = make_batched_solver(tm, ti, production, Q, R, device="cpu")
    assert calls == [{"device": "cpu"}]
    assert isinstance(solver, BatchedSolver) and solver.circuit_params.dtype == torch.float64
    make_batched_solver(tm, ti, dataclasses.replace(production, linearize="structured"), Q, R, device="cpu")
    assert len(calls) == 1

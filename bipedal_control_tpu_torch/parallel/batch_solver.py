"""Scenario-batched RTI solver over device meshes (parallel/batch_solver.py
counterpart).

Thousands of independent MPC problems share one solver program; here the
batch is the leading axis of every input.  As in the JAX package, the
production configuration (pallas linearize, Riccati and merit, soft cone)
goes through ``solver/lanes_rti.py``'s entry.

The JAX package shards the batch over a ``jax.sharding.Mesh``; here the
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
initialised world (``utils/distributed.py``), one device per rank, and a
sharded batch is a ``DTensor`` whose axis 0 is split into contiguous
slices (``Shard(0)``), so ``.full_tensor()`` reads the global batch as
JAX's global array does (on NCCL and on gloo with CPU tensors: on gloo with
CUDA tensors its functional collective crashes in torch 2.11, where c10d's
``all_gather_into_tensor`` works; ``graft_entry.py`` gathers so).  The meshed solver runs the batched solver on each
rank's local slice and wraps the outputs back: the solve has no collective
(the JAX package's ``shard_map`` comment), and no DTensor reaches the
kernels' wrappers, which pass raw pointers.
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


def batched_sqp_solve(model, info, settings, Q, R, refs_b, t_nodes_b, x_init_b, xs_b, us_b) -> SqpSolution:
    """Batched SQP over a leading scenario axis on every argument, on the
    inputs' device: the production configuration takes the lanes entry, as
    :func:`make_batched_solver` does."""
    return make_batched_solver(model, info, settings, Q, R, device=x_init_b.device)(
        refs_b, t_nodes_b, x_init_b, xs_b, us_b
    )


def _require_world():
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise a world first (utils/distributed.py: init_world, spawn)")


def make_mesh(axis_name: str = "data", devices=None, device=None):
    """A 1-D DeviceMesh named ``(axis_name,)`` over the ranks ``devices``
    (every rank of the initialised world when None).  ``device``: None for
    the card, ``"cpu"`` for the CPU.  Every rank of the world calls it:
    creating the mesh's process group is collective."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    _require_world()
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    return DeviceMesh(resolve_device(device).type, torch.tensor(ranks), mesh_dim_names=(axis_name,))


def _placements(mesh, axis_name) -> tuple:
    """The DTensor placements of a batch sharded over ``axis_name``: a mesh
    dimension's name (replicated over the others) or placements, such as
    ``parallel/scaling.py::batch_spec``'s."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    if isinstance(axis_name, str):
        if axis_name not in names:
            raise ValueError(f"axis {axis_name!r} is not a dimension of the mesh {names}")
        return tuple(Shard(0) if n == axis_name else Replicate() for n in names)
    placements = tuple(axis_name)
    if len(placements) != len(names):
        raise ValueError(f"{len(placements)} placements for a mesh of {len(names)} dimensions")
    return placements


def _shards(mesh, placements) -> tuple[int, int]:
    """(this rank's slice index, number of slices) of axis 0: row-major over
    the mesh dimensions that shard it."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    index, count = 0, 1
    for dim, p in enumerate(placements):
        if isinstance(p, Shard):
            index, count = index * mesh.size(dim) + coord[dim], count * mesh.size(dim)
    return index, count


def _tree_map(fn, tree):
    """fn on every tensor of a tensor, a (named) tuple or a list of them; None stays."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _local(t, mesh, placements):
    """This rank's slice of axis 0 of a global tensor, or a DTensor's local
    tensor (sharded as the solver's batch)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        if t.device_mesh != mesh or tuple(t.placements) != placements:
            raise ValueError(f"a DTensor placed {tuple(t.placements)} on another mesh or sharding than {placements}")
        return t.to_local()
    index, count = _shards(mesh, placements)
    if t.shape[0] % count:
        raise ValueError(f"batch {t.shape[0]} is not a multiple of the mesh's {count} shards")
    n = t.shape[0] // count
    return t[index * n:(index + 1) * n]


def _global(local, mesh, placements):
    """A DTensor over the mesh from each rank's slice of axis 0 (no
    communication: every slice has the same size)."""
    from torch.distributed.tensor import DTensor

    shape = (local.shape[0] * _shards(mesh, placements)[1],) + tuple(local.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape), stride=stride)


def shard_batch(tree, mesh, axis_name: str = "data"):
    """Place a batched tensor tree with the leading axis sharded over the
    mesh: each rank keeps its contiguous B/W slice of every tensor (on the
    tensor's device) as a DTensor sharded ``Shard(0)``.  Every rank passes
    the same global tensors; B must be a multiple of the number of shards."""
    placements = _placements(mesh, axis_name)
    return _tree_map(lambda t: _global(_local(t, mesh, placements).contiguous(), mesh, placements), tree)


class MeshedSolver(nn.Module):
    """The batched solver over a mesh: f(refs_b, t_nodes_b, x_init_b, xs_b,
    us_b) -> SqpSolution of DTensors sharded over the batch axis.  The
    inputs are DTensors (:func:`shard_batch`) or the global tensors, which
    every rank passes alike; each rank solves its local slice with the
    module's solver."""

    def __init__(self, solver: BatchedSolver, mesh, placements):
        super().__init__()
        self.solver = solver
        self.mesh = mesh
        self.placements = placements

    def forward(self, refs_b, t_nodes_b, x_init_b, xs_b, us_b) -> SqpSolution:
        local = _tree_map(lambda t: _local(t, self.mesh, self.placements), (refs_b, t_nodes_b, x_init_b, xs_b, us_b))
        sol = self.solver(*local)
        return _tree_map(lambda t: _global(t, self.mesh, self.placements), sol)


def make_batched_solver(
    model: RobotModel,
    info: CentroidalModelInfo,
    settings: OcpSettings,
    Q,
    R,
    mesh=None,
    axis_name="data",
    device=None,
):
    """Build the batched solver module (inputs batched on axis 0) on
    ``device``: the card when None, and RuntimeError where CUDA is absent;
    ``device="cpu"`` for the CPU.  Settings that ``solver/lanes_rti.py``
    supports take its entry.  Sets the full-float32 matmul policy
    (utils/precision.py).

    With a ``mesh`` (:func:`make_mesh`, ``parallel/scaling.py``), a
    :class:`MeshedSolver` whose batch axis is sharded over ``axis_name``: a
    mesh dimension's name or placements (``scaling.batch_spec``); the batch
    must be a multiple of the number of shards (ValueError otherwise)."""
    from ..solver.lanes_rti import _supports, make_lanes_rti_solver

    if _supports(settings):
        solver = make_lanes_rti_solver(model, info, settings, Q, R, device=device)
    else:
        device = resolve_device(device)
        set_full_f32_matmul()
        solver = BatchedSolver(model, info, settings, Q, R).to(device)
    if mesh is None:
        return solver
    return MeshedSolver(solver, mesh, _placements(mesh, axis_name))

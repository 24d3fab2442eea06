"""Multi-card / multi-host scaling harness (parallel/scaling.py counterpart).

The scenario batch is the unit of scale-out: within a host the batch axis
shards over the cards, across hosts over the network.  This module provides

- :func:`make_two_level_mesh` — a ("dcn", "ici") DeviceMesh: the outer
  dimension the hosts, the inner one the cards of a host;
- :func:`fleet_stats` — fleet telemetry (mean cost, mean/max defect,
  acceptance rate) reduced over every mesh dimension with ``all_reduce``
  (the JAX package's ``psum``/``pmax`` over ``mesh.axis_names``), the
  counterpart of the reference's ROS-topic aggregation of per-robot
  observers;
- :func:`run_scaling_benchmark` — solves/s at mesh sizes 1, 2, 4, .., W for
  the weak-scaling table (fixed per-device batch).

The world comes from ``utils/distributed.py``: ``torchrun`` with one process
per card, or :func:`~bipedal_control_tpu_torch.utils.distributed.spawn` on
one host.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..utils.device import resolve_device
from .batch_solver import _require_world, make_batched_solver, make_mesh, shard_batch


def make_two_level_mesh(n_hosts: int, chips_per_host: int, devices=None, device=None):
    """("dcn", "ici") DeviceMesh over the ranks ``devices`` (the world's when
    None), host-major: the outer dimension the hosts, the inner the cards of
    a host; n_hosts * chips_per_host must equal their number.  ``device``:
    None for the card, ``"cpu"`` for the CPU.  Every rank of the world calls
    it (creating the dimensions' groups is collective)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    _require_world()
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    if n_hosts * chips_per_host != len(ranks):
        raise ValueError(f"mesh {n_hosts}x{chips_per_host} != {len(ranks)} devices")
    grid = torch.tensor(ranks).reshape(n_hosts, chips_per_host)
    return DeviceMesh(resolve_device(device).type, grid, mesh_dim_names=("dcn", "ici"))


def batch_spec(mesh) -> tuple:
    """Batch axis sharded over every mesh dimension (data-parallel over DCN
    x ICI): the placements ``Shard(0)`` on each."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(0) for _ in mesh.mesh_dim_names)


def fleet_stats(mesh, sol_cost, sol_defect, sol_step):
    """Collective-reduced fleet telemetry.

    Inputs are per-scenario tensors (batch,) sharded over the mesh: DTensors
    or each rank's local slice.  Returns replicated 0-dim tensors (mean
    cost, mean defect, max defect, step-acceptance rate): the sums and the
    maximum are reduced over each mesh dimension's group in turn, the
    counterpart of the reference's observation aggregation topics
    (BipedalController.cpp:275,316)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    local = lambda t: t.to_local() if isinstance(t, DTensor) else t
    cost, defect, step = local(sol_cost), local(sol_defect), local(sol_step)
    sums = torch.stack([
        torch.tensor(float(cost.shape[0]), dtype=cost.dtype, device=cost.device),
        cost.sum(), defect.sum(), (step > 0).to(cost.dtype).sum(),
    ])
    peak = defect.max().reshape(1).clone()
    for dim in range(mesh.ndim):
        group = mesh.get_group(dim)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    n = sums[0]
    return sums[1] / n, sums[2] / n, peak[0], sums[3] / n


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    n_hosts: int
    batch: int
    solves_per_s: float
    solves_per_s_per_device: float
    mean_defect: float


def _sizes(world: int) -> list[int]:
    sizes, n = [], 1
    while n <= world:
        sizes.append(n)
        n *= 2
    if sizes[-1] != world:
        sizes.append(world)
    return sizes


def run_scaling_benchmark(
    model,
    info,
    settings,
    Q,
    R,
    refs,
    t_nodes,
    x0,
    xs,
    us,
    per_device_batch: int = 32,
    steps: int = 5,
    warmup: int = 2,
    chips_per_host: int | None = None,
    device=None,
) -> list[ScalingPoint]:
    """Weak-scaling sweep: fixed per-device batch, mesh sizes 1, 2, 4, ..,
    W over the ranks 0 .. n-1 of the initialised world of W ranks.

    One scenario's data in the port's batch-of-one form (refs fields
    (1, N, ...), t_nodes (1, N+1), x0 (1, nx), xs (1, N+1, nx), us (1, N,
    nu), as the front end gives them) is tiled to the global batch for each
    mesh size.  When chips_per_host is given and divides the mesh size, a
    two-level ("dcn", "ici") mesh is used; otherwise a flat ("data",) mesh.
    Each size is timed as the JAX function does: ``warmup`` solves, then
    ``steps`` warm-chained solves between two barriers of the size's group
    after a device synchronisation.

    Every rank of the world calls it (each size's groups are created by all
    ranks, in one order; the ranks outside a size wait at a barrier), and
    each rank returns the points of the sizes it took part in: rank 0 all
    of them.  ``device``: None for the card, ``"cpu"`` for the CPU."""
    import torch.distributed as dist

    _require_world()
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = dist.get_rank(), dist.get_world_size()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    points = []
    for n_dev in _sizes(world):
        ranks = list(range(n_dev))
        group = dist.new_group(ranks)
        if chips_per_host and n_dev % chips_per_host == 0 and n_dev > chips_per_host:
            n_hosts = n_dev // chips_per_host
            mesh = make_two_level_mesh(n_hosts, chips_per_host, ranks, device=dev)
        else:
            n_hosts = 1
            mesh = make_mesh("data", ranks, device=dev)
        if rank < n_dev:
            spec = batch_spec(mesh)
            B = per_device_batch * n_dev
            tile = lambda a: a.to(dev).expand((B,) + tuple(a.shape[1:]))
            refs_b, t_b, x_b, xs_b, us_b = shard_batch(
                (type(refs)(*(tile(f) for f in refs)), tile(t_nodes), tile(x0), tile(xs), tile(us)), mesh, spec
            )
            solver = make_batched_solver(model, info, settings, Q, R, mesh=mesh, axis_name=spec, device=dev)
            for _ in range(warmup):
                sol = solver(refs_b, t_b, x_b, xs_b, us_b)
                xs_b, us_b = sol.x_traj, sol.u_traj
            sync()
            dist.barrier(group=group)
            t0 = time.perf_counter()
            for _ in range(steps):
                sol = solver(refs_b, t_b, x_b, xs_b, us_b)
                xs_b, us_b = sol.x_traj, sol.u_traj
            sync()
            dist.barrier(group=group)
            dt = time.perf_counter() - t0
            _, mean_defect, _, _ = fleet_stats(mesh, sol.cost, sol.defect_norm, sol.step_size)
            sps = B * steps / dt
            points.append(
                ScalingPoint(
                    n_devices=n_dev,
                    n_hosts=n_hosts,
                    batch=B,
                    solves_per_s=round(sps, 2),
                    solves_per_s_per_device=round(sps / n_dev, 2),
                    mean_defect=float(mean_defect),
                )
            )
        dist.barrier()
    return points

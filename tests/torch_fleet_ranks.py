"""The ranks' side of tests/test_torch_fleet.py: a module that imports the
port and torch only, so the spawned ranks start without JAX.

``fleet_rank`` runs, in each rank of a gloo world on the CPU, every piece of
the port's mesh that the tests hold against the JAX package, on inputs the
test module made with numpy, and returns numpy results.
"""
import dataclasses

import numpy as np
import torch

from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.parallel import make_batched_solver, make_mesh, shard_batch
from bipedal_control_tpu_torch.parallel.scaling import batch_spec, fleet_stats, make_two_level_mesh, \
    run_scaling_benchmark


def _problem(problem_np, sl=slice(None)):
    refs, t_nodes, x_init, xs, us = problem_np
    T = lambda a: torch.as_tensor(np.array(a[sl]))
    return (convert.refs_from_numpy({k: v[sl] for k, v in refs.items()}, device="cpu"),
            T(t_nodes), T(x_init), T(xs), T(us))


def fleet_rank(rank, device, model_np, info_np, settings_np, Q, R, problem_np, stats_np, scaling):
    model = convert.model_from_numpy(model_np, device="cpu")
    info = convert.info_from_numpy(info_np)
    settings = convert.settings_from_numpy(settings_np)
    out = {}

    # the meshed solve (DTensor inputs, and the global tensors), and the unmeshed one
    mesh = make_mesh("data", device=device)
    meshed = make_batched_solver(model, info, settings, Q, R, mesh=mesh, axis_name="data", device=device)
    problem = _problem(problem_np)
    sharded = shard_batch(problem, mesh, "data")
    sol = meshed(*sharded)
    out["local_batch"] = int(sol.x_traj.to_local().shape[0])
    out["meshed"] = {k: v.full_tensor().numpy() for k, v in sol._asdict().items() if v is not None}
    out["meshed_global_inputs"] = {k: v.full_tensor().numpy() for k, v in meshed(*problem)._asdict().items()
                                   if v is not None}
    plain_solver = make_batched_solver(model, info, settings, Q, R, device=device)
    plain = plain_solver(*problem)
    out["unmeshed"] = {k: v.numpy() for k, v in plain._asdict().items() if v is not None}
    try:
        meshed(*_problem(problem_np, slice(0, 3)))
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)

    # fleet_stats on the flat mesh and on the 1x2 and 2x1 two-level meshes
    meshes = {"flat": mesh, "1x2": make_two_level_mesh(1, 2, device=device),
              "2x1": make_two_level_mesh(2, 1, device=device)}
    out["stats"] = {}
    for name, m in meshes.items():
        cost, defect, step = shard_batch(tuple(torch.as_tensor(a) for a in stats_np), m, batch_spec(m))
        out["stats"][name] = [float(v) for v in fleet_stats(m, cost, defect, step)]

    # the weak-scaling sweep on one scenario, and the same chain of solves
    # unmeshed at the sweep's largest batch
    one = _problem(problem_np, slice(scaling["scenario"], scaling["scenario"] + 1))
    points = run_scaling_benchmark(model, info, settings, Q, R, *one, per_device_batch=scaling["per_device_batch"],
                                   steps=scaling["steps"], warmup=scaling["warmup"], device=device)
    out["points"] = [dataclasses.asdict(p) for p in points]
    tile = lambda a: a.expand((scaling["per_device_batch"] * 2,) + tuple(a.shape[1:]))
    refs, t_nodes, x0, xs, us = (type(one[0])(*(tile(f) for f in one[0])), *(tile(a) for a in one[1:]))
    for _ in range(scaling["warmup"] + scaling["steps"]):
        chain = plain_solver(refs, t_nodes, x0, xs, us)
        xs, us = chain.x_traj, chain.u_traj
    out["chain"] = [chain.cost.numpy(), chain.defect_norm.numpy(), chain.step_size.numpy()]
    return out


def fails_in_rank_1(rank, device):
    """Rank 1 raises; rank 0 works on (it is stopped when rank 1 fails)."""
    import time

    if rank == 1:
        raise ValueError("rank 1 of the world fails")
    time.sleep(60.0)


def sleeps(rank, device, seconds):
    import time

    time.sleep(seconds)

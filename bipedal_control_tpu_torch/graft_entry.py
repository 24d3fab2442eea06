"""Entry points of the port: a single-scenario solve and a multi-rank dry run
(the counterpart of the repository's root ``__graft_entry__.py``).

    entry()             -> (fn, args): one single-scenario solve on the card
                           with the production backends (K1, K2+K3, K4);
    dryrun_multichip(n) -> spawn n ranks and run one mesh-sharded batched
                           solve step and the batched closed loop at tiny
                           shapes (8 horizon intervals), with numeric
                           self-checks.

    python -m bipedal_control_tpu_torch.graft_entry   # entry(), then dryrun_multichip($DRYRUN_DEVICES or 2)

The robot is H1 when ``$BIPEDAL_ASSETS`` holds it, otherwise the registry's
G1 configuration on the synthetic G1-shaped URDF of ``tests/data`` (the
robot ``chip_smoke.py`` runs from phase 10 on).  Nothing runs when the
module is imported.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

G1_SHAPED_URDF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data",
                              "g1_shaped_biped.urdf")
# the dry run's bar on the warm-started defect after 4 solves, as a fraction
# of the first: the JAX package's 0.05 on H1.  On the G1-shaped biped the
# JAX package's own chain on the same problem (trot, 8 intervals over 1 s)
# reads 0.5370 -> 0.0439 (0.082) and then stalls, every candidate rejected,
# so its bar is 0.1
CONTRACTION = {"h1": 0.05, "g1": 0.1}


def default_robot() -> tuple[str, str]:
    """(robot, description): H1 when $BIPEDAL_ASSETS holds it, else G1."""
    from .robots import get_assets

    h1 = get_assets("h1")
    if os.path.exists(h1.urdf) and os.path.exists(h1.task_info):
        return "h1", f"unitree H1 ({h1.urdf})"
    return "g1", "G1-shaped synthetic biped (H1 not in $BIPEDAL_ASSETS)"


def default_interface(device=None, dtype=torch.float64):
    """H1's interface, or G1's configuration on the G1-shaped URDF."""
    from .interface import make_interface, make_interface_for
    from .robots import get_assets

    if default_robot()[0] == "h1":
        return make_interface_for("h1", device=device, dtype=dtype)
    g1 = get_assets("g1")
    return make_interface(G1_SHAPED_URDF, g1.task_info, g1.reference_info, g1.gait_info, g1.overrides_info,
                          device=device, dtype=dtype)


def _setup(num_intervals=None, sqp_iterations=1, device=None, dtype=torch.float64):
    """The trot problem of one scenario in the port's batch-of-one form:
    (iface, refs, t_nodes, x0, xs, us), on the production backends
    (``interface.production_settings``), ``num_intervals`` over the task's
    horizon when given."""
    from .interface import production_settings
    from .solver.sqp import build_refs, initial_trajectory

    iface = default_interface(device, dtype)
    print(f"[graft_entry] robot: {default_robot()[1]}", flush=True)
    settings = production_settings(iface.settings, iface.info)
    if num_intervals is not None:
        settings = dataclasses.replace(settings, dt=settings.horizon / num_intervals)
    iface.settings = dataclasses.replace(settings, sqp_iterations=sqp_iterations)
    rm = iface.make_reference_manager()
    rm.num_intervals = iface.settings.num_intervals
    rm.set_gait(iface.task.gait_library["trot"], start_time=0.1)
    frozen = rm.freeze(0.0)
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, frozen.t_nodes)
    x0 = torch.as_tensor(np.asarray(iface.initial_state), dtype=iface.dtype, device=iface.device)[None]
    xs, us = initial_trajectory(iface.info, refs, x0, iface.settings.num_intervals + 1)
    return iface, refs, frozen.t_nodes[None], x0, xs, us


def _solve_fn(iface):
    """f(refs, t_nodes, x0, xs, us) -> SqpSolution: ``sqp_solve`` with the
    kernels' front ends built once (the MPC runner's replan)."""
    from .ops.linearize_kernel import make_node_linearizer
    from .ops.merit_kernel import make_merit_sums
    from .solver.sqp import sqp_solve

    model, info, settings, Q, R = iface.model, iface.info, iface.settings, iface.Q, iface.R
    linearize = (make_node_linearizer(model, info, settings, Q, R, static=iface.circuit)
                 if settings.linearize == "pallas" else None)
    merit = (make_merit_sums(model, info, settings, static=iface.circuit)
             if settings.merit == "pallas" and settings.linesearch_alphas else None)

    def fn(refs, t_nodes, x0, xs, us):
        return sqp_solve(model, info, settings, Q, R, refs, t_nodes, x0, xs, us, merit_sums=merit,
                         linearize=linearize)

    return fn


def entry(device=None):
    """One trot SQP solve of a single scenario (the MPC replan step): (fn,
    args) with fn(refs, t_nodes, x0, xs, us) -> SqpSolution (batch of one).
    fn is a function of tensors that ``utils/cuda_graph.py::GraphedCall``
    can capture.  ``device``: None for the card, ``"cpu"`` for the CPU."""
    iface, refs, t_nodes, x0, xs, us = _setup(device=device)
    return _solve_fn(iface), (refs, t_nodes, x0, xs, us)


def _gathered(t) -> torch.Tensor:
    """The global tensor of a DTensor sharded ``Shard(0)`` over a 1-D mesh,
    by c10d's ``all_gather_into_tensor``: ``DTensor.full_tensor()``'s
    functional collective ends the process with a segmentation fault on
    gloo with CUDA tensors (torch 2.11: two ranks sharing a card), where
    c10d's collectives work."""
    import torch.distributed as dist

    local = t.to_local().contiguous()
    wide = local.to(torch.uint8) if local.dtype == torch.bool else local
    out = wide.new_empty((wide.shape[0] * t.device_mesh.size(),) + tuple(wide.shape[1:]))
    dist.all_gather_into_tensor(out, wide, group=t.device_mesh.get_group())
    return out.bool() if local.dtype == torch.bool else out


def _dryrun_rank(rank: int, device, n_devices: int) -> dict:
    """One rank of :func:`dryrun_multichip`: the checks of the root
    ``__graft_entry__.dryrun_multichip`` on this rank's share of the mesh."""
    from .parallel import make_batched_solver, make_mesh, shard_batch
    from .parallel.batch_solver import _global
    from .sim.batch_loop import BatchLoopConfig, make_batched_closed_loop
    from .solver.sqp import NodeRefs

    mesh = make_mesh("data", device=device)
    robot = default_robot()[0]
    iface, refs, t_nodes, x0, xs, us = _setup(num_intervals=8, sqp_iterations=1, device=device)
    B = n_devices
    tile = lambda a: a.expand((B,) + tuple(a.shape[1:]))
    batch = shard_batch((NodeRefs(*(tile(f) for f in refs)), tile(t_nodes), tile(x0), tile(xs), tile(us)),
                        mesh, "data")
    solver = make_batched_solver(iface.model, iface.info, iface.settings, iface.Q, iface.R, mesh, "data",
                                 device=device)
    sol = solver(*batch)
    x_full = _gathered(sol.x_traj)
    if x_full.shape[0] != B:
        raise AssertionError(f"sharded solve: batch {x_full.shape[0]}, expected {B}")
    is64 = x_full.dtype == torch.float64
    tol = 1e-8 if is64 else 5e-4  # float32 reassociation

    # 1) the sharded solve equals a single-scenario solve of the same problem
    sol_ref = _solve_fn(iface)(refs, t_nodes, x0, xs, us)
    err = float((x_full[0] - sol_ref.x_traj[0]).abs().max())
    if not err < tol:
        raise AssertionError(f"sharded != unsharded solve (max |dx| = {err:.3e})")

    # 2) warm-started RTI chaining contracts the dynamics defect
    d0 = float(_gathered(sol.defect_norm).sum()) / B
    xs_b, us_b = sol.x_traj, sol.u_traj
    for _ in range(4):
        sol = solver(batch[0], batch[1], batch[2], xs_b, us_b)
        xs_b, us_b = sol.x_traj, sol.u_traj
    d4 = float(_gathered(sol.defect_norm).sum()) / B
    if not (np.isfinite(d4) and d4 < CONTRACTION[robot] * max(d0, 1e-9)):
        raise AssertionError(f"warm-started defect did not contract: {d0:.4f} -> {d4:.4f}")
    if rank == 0:
        print(f"dryrun_multichip({n_devices}): ok, sharded==unsharded to {err:.1e}, "
              f"defect {d0:.4f} -> {d4:.6f} over 4 warm solves", flush=True)

    # 3) the batched closed loop (MPC -> WBC -> PD -> physics, sim/batch_loop.py)
    # on the sharded lanes: each rank runs its local lanes, equal to the
    # single-lane run.  Tiny shapes: 2 replans of an 8-interval horizon.
    cfg = BatchLoopConfig(duration=0.04, replan_dt=0.02, control_dt=0.002)
    loop = make_batched_closed_loop(iface, cfg, device=device)
    X = torch.as_tensor(np.asarray(iface.initial_state), dtype=iface.dtype, device=iface.device)[None]
    X_sharded = shard_batch(X.expand(B, -1), mesh, "data")
    res = loop(X_sharded.to_local())
    placements = X_sharded.placements
    q = _gathered(_global(res.final_state.q, mesh, placements))
    fell = _gathered(_global(res.fell, mesh, placements))
    if q.shape[0] != B or tuple(fell.shape) != (B,):
        raise AssertionError(f"sharded cascade: q {tuple(q.shape)}, fell {tuple(fell.shape)} for a batch of {B}")
    res1 = loop(X)  # unsharded single-lane reference
    cerr = float((q[0] - res1.final_state.q[0]).abs().max())
    if not cerr < tol:
        raise AssertionError(f"sharded != unsharded cascade (max |dq| = {cerr:.3e})")
    if not bool(torch.isfinite(q).all()):
        raise AssertionError("sharded cascade: non-finite state")
    if rank == 0:
        print(f"dryrun_multichip({n_devices}): cascade ok, sharded==unsharded to {cerr:.1e}, "
              f"fell={int(fell.sum())}/{B}", flush=True)
    return {"robot": robot, "solve_err": err, "defect_first": d0, "defect_after_4": d4, "cascade_err": cerr,
            "fell": fell.cpu().tolist(), "dtype": str(x_full.dtype), "tol": tol}


def dryrun_multichip(n_devices: int, device=None) -> list[dict]:
    """Spawn ``n_devices`` ranks (``utils/distributed.py::spawn``; on the
    card rank r takes ``cuda:{r % device_count}``, with gloo where ranks
    share a card) and run, over a 1-D mesh of them, one batched solve with
    the batch (one scenario per rank) sharded, checked against the
    unsharded solve (1e-8 in float64, 5e-4 in float32), four warm-started
    solves that must contract the defect (:data:`CONTRACTION`), and the batched closed
    loop on the sharded lanes against the single-lane run.  Returns each
    rank's figures; a failed check raises.  ``device``: None for the card,
    ``"cpu"`` for the CPU."""
    from .utils.distributed import spawn

    return spawn(_dryrun_rank, n_devices, n_devices, device=device)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry: ok", tuple(out.x_traj.shape))
    dryrun_multichip(int(os.environ.get("DRYRUN_DEVICES", "2")))

"""Process groups for the scenario mesh (the port's counterpart of what
``jax.distributed.initialize`` and ``xla_force_host_platform_device_count``
give the JAX package).

:func:`init_world` joins this process to a ``torch.distributed`` world:
under ``torchrun`` through its environment (``env://``), otherwise through a
``file://`` store (a world of one through an in-process store), so no
network address is needed.  :func:`spawn` starts a
world of ranks on this host and returns each rank's result.

Backend rule: NCCL when every rank has a card of its own, gloo when ranks
share a card (NCCL refuses two ranks on one device) or run on the CPU.  Gloo
reduces CUDA tensors too (through the host).  Where gloo finds no network
interface, ``GLOO_SOCKET_IFNAME=lo`` names the loopback one; :func:`spawn`
sets it for its ranks when it is unset, as they all run on this host.
Nothing here runs when the module is imported.
"""
from __future__ import annotations

import os
import tempfile
import time

import torch

from .device import resolve_device

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def under_torchrun() -> bool:
    return all(v in os.environ for v in TORCHRUN_VARS)


def choose_backend(world_size: int, device) -> tuple[str, str]:
    """(backend, reason) by the module's rule for ``world_size`` ranks on
    this host whose devices are of ``device``'s type."""
    if torch.device(device).type != "cuda":
        return "gloo", "ranks on the CPU"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    cards = torch.cuda.device_count()
    if local > cards:
        return "gloo", f"{local} ranks share {cards} card(s); NCCL takes one rank per card"
    return "nccl", f"{local} rank(s), {cards} card(s): a card per rank"


def init_world(rank: int | None = None, world_size: int | None = None, backend: str | None = None,
               init_file: str | None = None, device=None) -> torch.device:
    """Initialise the default process group and return this rank's device.

    Under ``torchrun`` (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT set) the
    rank, the world size and the rendezvous come from the environment and
    the card is LOCAL_RANK's.  Otherwise ``rank`` and ``world_size`` (0 and 1
    when None) meet at the ``file://`` store ``init_file``; a world of one
    needs none (an in-process store).  ``device``: None for the card (``cuda:{LOCAL_RANK or
    rank} % device_count``), ``"cpu"`` for the CPU; ``backend``: None for
    the module's rule, whose choice is printed by rank 0."""
    import torch.distributed as dist

    env = under_torchrun()
    if env:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    rank = 0 if rank is None else rank
    world_size = 1 if world_size is None else world_size
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank)) if env else rank
        dev = torch.device("cuda", local % torch.cuda.device_count() if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    reason = "the caller's"
    if backend is None:
        backend, reason = choose_backend(world_size, dev)
    if env:
        method, rendezvous = "env://", {"init_method": "env://"}
    elif init_file is not None:
        method, rendezvous = f"file://{init_file}", {"init_method": f"file://{init_file}"}
    elif world_size == 1:
        method, rendezvous = "an in-process store", {"store": dist.HashStore()}
    else:
        raise ValueError("init_world: a world of several ranks needs a shared init_file")
    dist.init_process_group(backend, rank=rank, world_size=world_size, **rendezvous)
    if rank == 0:
        print(f"[distributed] world of {world_size} on {dev.type}: backend {backend} ({reason}), {method}",
              flush=True)
    return dev


def _rank_main(rank: int, fn, world_size: int, init_file: str, device, out_dir: str, args) -> None:
    """One spawned rank: join the world, run fn, save its result."""
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if device == "cpu":  # the ranks share the host's cores: one thread each
        torch.set_num_threads(1)
    dev = init_world(rank, world_size, init_file=init_file, device=device)
    try:
        result = fn(rank, dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, *args, device=None, timeout: float | None = 600.0) -> list:
    """Run ``fn(rank, device, *args)`` in ``world_size`` new processes (the
    ``spawn`` start method: CUDA forbids ``fork``), each a rank of one world
    (:func:`init_world`; rank r on ``cuda:{r % device_count}``, or on the
    CPU for ``device="cpu"``, one thread each), and return the ranks'
    results in rank order.  ``fn`` and ``args`` are pickled: fn is a
    module-level function.  A failure in any rank raises here (the other
    ranks are stopped), and so does a world still running after ``timeout``
    seconds (None: no limit), whose ranks are stopped."""
    import torch.multiprocessing as mp

    # raises here where CUDA is absent; each rank then takes its own card
    device = "cpu" if resolve_device(device).type == "cpu" else None
    with tempfile.TemporaryDirectory(prefix="bc_spawn_") as tmp:
        world = mp.start_processes(_rank_main, args=(fn, world_size, os.path.join(tmp, "store"), device, tmp, args),
                                   nprocs=world_size, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not world.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for proc in world.processes:
                    proc.terminate()
                for proc in world.processes:
                    proc.join(10.0)
                raise TimeoutError(f"spawn: the world of {world_size} ranks ran past {timeout} s; stopped")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world_size)]

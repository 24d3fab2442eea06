"""The production batched RTI entry (solver/lanes_rti.py counterpart).

In the JAX package this module is a second, explicitly batched copy of the
SQP iteration.  It exists to keep the scenario batch on the TPU's 128-wide
lane axis between the linearize and Riccati kernels: the vmap/custom_vmap
seam of the standard path forced a lane -> instance -> lane relayout of the
stage data (~120 MB per step at B = 256) there.

The port has no such seam.  Every tensor is batch-leading, and the linearize
kernel writes A, B, c, C, D, e exactly where the Riccati kernel reads them.
So the entry here is thin: it builds the batched solver module of
``parallel/batch_solver.py``, whose forward makes the linearize kernel's
linearizer and the merit kernel's evaluator from the module's buffers and
runs the port's batched ``sqp_solve`` with them.  There is no second copy of
the iteration and filter loop.
"""
from __future__ import annotations

from ..utils.device import resolve_device
from ..utils.precision import set_full_f32_matmul


def _supports(settings) -> bool:
    """The configurations of the JAX package's fused lanes path: pallas
    linearize, Riccati and merit with the soft cone."""
    return (
        settings.linearize == "pallas"
        and settings.riccati == "pallas"
        and settings.cone == "soft"
        and settings.merit == "pallas"
    )


def make_lanes_rti_solver(model, info, settings, Q, R, device=None):
    """Build f(refs_b, t_nodes_b, x_init_b, xs_b, us_b) -> batched SqpSolution
    as an ``nn.Module`` on ``device``: the card when None, and RuntimeError
    where CUDA is absent; ``device="cpu"`` for the CPU (the kernels' plain
    versions).  Raises NotImplementedError for settings that
    :func:`_supports` rejects and for model_type != 0."""
    from ..parallel.batch_solver import BatchedSolver

    if not _supports(settings):
        raise NotImplementedError(
            "lanes RTI takes linearize, riccati and merit 'pallas' with the soft cone; "
            f"got linearize={settings.linearize!r} riccati={settings.riccati!r} merit={settings.merit!r} "
            f"cone={settings.cone!r}"
        )
    if info.model_type != 0:
        raise NotImplementedError("lanes RTI supports FullCentroidalDynamics only")
    device = resolve_device(device)
    set_full_f32_matmul()
    return BatchedSolver(model, info, settings, Q, R).to(device)

"""K2+K3's device time per run at B = 1 (one replan's Riccati sweep and
rollout, a serial chain of N stages), in us, from the profiler."""
from benchmark.core import KERNELS


def read(ctx):
    tr = ctx["trace"]
    runs = tr.count_of(KERNELS["K23"])
    return tr.seconds_of(KERNELS["K23"]) * 1e6 / runs if runs else None

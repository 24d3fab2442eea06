"""K2+K3's share of its roofline in the batched solve: the bound at the
cell's shapes (benchmark/roofline.py) over the profiler's time per launch
(one launch per solve), in %."""
from benchmark.core import KERNELS
from benchmark.roofline import bound_ms, k23_bytes, k23_ops


def read(ctx):
    tr, s = ctx["trace"], ctx["shapes"]
    runs = tr.count_of(KERNELS["K23"])
    if runs == 0:
        return None
    ms = tr.seconds_of(KERNELS["K23"]) * 1e3 / runs
    args = (s["B"], s["N"], s["nx"], s["nu"], s["ne"])
    return 100.0 * bound_ms(k23_bytes(*args), k23_ops(*args)) / ms

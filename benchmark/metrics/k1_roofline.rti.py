"""K1's share of its roofline in the batched solve: the bound at the cell's
shapes (M = B x N node instances; benchmark/roofline.py) over the
profiler's time per launch (one launch per solve), in %."""
from benchmark.core import KERNELS
from benchmark.roofline import bound_ms, k1_bytes, k1_ops


def read(ctx):
    tr, s = ctx["trace"], ctx["shapes"]
    runs = tr.count_of(KERNELS["K1"])
    if runs == 0:
        return None
    ms = tr.seconds_of(KERNELS["K1"]) * 1e3 / runs
    M = s["B"] * s["N"]
    return 100.0 * bound_ms(k1_bytes(M, s["nx"], s["nu"], s["ne"]),
                            k1_ops(s["topology"], M, s["rk2"], s["nx"], s["nu"], s["ne"])) / ms

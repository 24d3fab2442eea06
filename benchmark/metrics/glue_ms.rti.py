"""Device ms per batched solve outside the named kernels (K1, K2+K3, K4):
the plain-torch cost quadratics, candidates, filter and copies of
solver/sqp.py, summed from the profiler's device activities over the traced
solves."""
from benchmark.core import KERNELS


def read(ctx):
    tr, n = ctx["trace"], ctx["counts"]["solves"]
    if not tr.device_ops or n == 0:
        return None
    total = sum(e - s for _, s, e in tr.device_ops) / 1e6
    named = sum(tr.seconds_of(KERNELS[k]) for k in ("K1", "K23", "K4"))
    return (total - named) * 1e3 / n

"""Device busy ms per replan in the traced replans: the union of the
device's activity intervals (the replan graph's replay and the runner's
copies) over the replans traced."""


def read(ctx):
    tr, n = ctx["trace"], ctx["counts"]["replans"]
    if not tr.device_ops or n == 0:
        return None
    return tr.busy_s * 1e3 / n

"""Host ms to enqueue one batched solve (BatchedSolver.forward returning,
before the device finishes), from an idle device: the median of the
driver's probes."""
import statistics


def read(ctx):
    samples = ctx["samples"].get("enqueue_ms")
    return statistics.median(samples) if samples else None

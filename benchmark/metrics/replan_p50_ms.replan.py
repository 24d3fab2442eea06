"""The median replan of the window (the same host-clock samples as
replan_p95_ms: the call to its synchronised result), in ms."""
import statistics


def read(ctx):
    samples = ctx["samples"].get("replan_ms")
    return statistics.median(samples) if samples else None

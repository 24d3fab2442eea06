"""The device's idle share of the traced solves, in % (core.idle_percent)."""
from benchmark.core import idle_percent


def read(ctx):
    return idle_percent(ctx["trace"])

"""The device's idle share of the traced replans, in % (core.idle_percent):
the host's front end (the reference manager's freeze, the tables' upload)
runs before each graph replay."""
from benchmark.core import idle_percent


def read(ctx):
    return idle_percent(ctx["trace"])

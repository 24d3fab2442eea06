"""Faults planted under a cell's timed path, to show that its check fails
them.  Each takes the driver, what the program produced (a named tuple)
and the start it was given ({field: tensor} of the fields the step
changes), and returns what a broken program would have produced.  The
benchmark's own runs plant none; ``benchmark/calibrate.py`` reads them on
the card and ``benchmark/test_bench_controls.py`` on the CPU."""
from __future__ import annotations

import numpy as np


def unchanged(drv, out, start: dict):
    """A step that returns its state unchanged."""
    return out._replace(**{f: v.clone() for f, v in start.items()})


def half(drv, out, start: dict):
    """Half of the batch left out: its second half returned unchanged."""
    def mix(f):
        a = getattr(out, f).clone()
        h = a.shape[0] // 2
        a[h:] = start[f][h:]
        return a
    return out._replace(**{f: mix(f) for f in start})


def altered(drv, out, start: dict):
    """An answer altered where it is produced: one scenario (drawn from the
    seed) given another's result; in a batch of one, two nodes of the
    trajectory swapped."""
    def swap(f):
        a = getattr(out, f).clone()
        if a.shape[0] > 1:
            B = a.shape[0]
            i = int(np.random.default_rng(drv.cell.seed).integers(0, B))
            a[i] = a[(i + B // 2) % B]
        else:
            n = a.shape[1]
            a[:, [1, n // 2]] = a[:, [n // 2, 1]]
        return a
    return out._replace(**{f: swap(f) for f in start})


def nonfinite(drv, out, start: dict):
    """An answer that is not finite: the first scenario's inputs NaN."""
    u = out.u_traj.clone()
    u[0] = float("nan")
    return out._replace(u_traj=u)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered, "nonfinite": nonfinite}

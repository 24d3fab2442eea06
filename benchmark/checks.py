"""The numbers a check compares, computed from a program's outputs and the
reference's, all in float64.

A solve is judged by what it added to the trajectories it started from.
Per scenario, the error is the largest gap between the program's change
and the reference's, over the largest entry of the reference's change,
taken over the fields compared (x and u).  A step that returns its start
unchanged reads 1.

Where the filter refused a scenario's step on both sides, both returned
their start and there is no step to compare: such scenarios are left out,
unless the program's answer is not finite.  A scenario whose step one side
accepted and the other refused reads about 1, as a step returned unchanged
does.  A cell compares the worst scenario's
error (the widest gap, which catches one scenario gone wrong) and the
median scenario's (which moves with the precision of every scenario).
"""
from __future__ import annotations

import torch


def lane_errors(got: dict, want: dict, start: dict, floor: float = 1e-12) -> torch.Tensor:
    """(B,) per scenario: max over the fields of |d_got - d_want|inf /
    max(|d_want|inf, floor), d = field - start."""
    out = None
    for f in want:
        s = start[f].double().flatten(1)
        d_got = got[f].double().flatten(1) - s
        d_want = want[f].double().flatten(1) - s
        e = (d_got - d_want).abs().amax(1) / torch.clamp(d_want.abs().amax(1), min=floor)
        e = torch.nan_to_num(e, nan=float("inf"))
        out = e if out is None else torch.maximum(out, e)
    return out


def summary(errors: torch.Tensor, prefix: str) -> list:
    """[(prefix_worst, value), (prefix_median, value)] over the scenarios
    given (inf where there is none: nothing compared is no pass)."""
    if errors.numel() == 0:
        return [(f"{prefix}_worst", float("inf")), (f"{prefix}_median", float("inf"))]
    return [(f"{prefix}_worst", float(errors.max())), (f"{prefix}_median", float(errors.median()))]


def judge_solves(got: dict, want: dict, start: dict, got_step, want_step, prefix: str) -> list:
    """The worst and median step errors of a batch of solves over the
    scenarios that either side accepted or whose answer is not finite."""
    finite = torch.stack([torch.isfinite(got[f].flatten(1)).all(1) for f in want]).all(0)
    keep = (got_step > 0) | (want_step > 0) | ~finite
    return summary(lane_errors({f: got[f][keep] for f in want}, {f: want[f][keep] for f in want},
                               {f: start[f][keep] for f in want}), prefix)


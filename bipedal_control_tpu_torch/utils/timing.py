"""Latency instrumentation (utils/timing.py counterpart; the reference's
benchmark::RepeatedTimer: max and average at shutdown, plus percentiles).

A timed block on a CUDA device ends with a synchronise of that device
before the clock is read, so a sample is the card's work and not only its
enqueue (the JAX runner ends its block with ``block_until_ready``)."""
from __future__ import annotations

import time

import numpy as np
import torch


class RepeatedTimer:
    def __init__(self, name: str = "timer", device=None):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.samples: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.samples.append(time.perf_counter() - self._t0)
        return False

    @property
    def count(self):
        return len(self.samples)

    def stats(self) -> dict:
        if not self.samples:
            return {"name": self.name, "count": 0}
        arr = np.asarray(self.samples) * 1e3
        return {
            "name": self.name,
            "count": int(arr.size),
            "mean_ms": float(arr.mean()),
            "max_ms": float(arr.max()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
        }

    def report(self) -> str:
        s = self.stats()
        if s["count"] == 0:
            return f"[{self.name}] no samples"
        return (
            f"[{s['name']}] n={s['count']} mean={s['mean_ms']:.3f}ms "
            f"max={s['max_ms']:.3f}ms p50={s['p50_ms']:.3f}ms p99={s['p99_ms']:.3f}ms"
        )

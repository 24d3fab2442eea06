"""The traffic generators: every input a cell hands the program and the
reference, drawn from the run's seed with numpy (the same seed gives the
same inputs on any machine)."""
from __future__ import annotations

import numpy as np


def perturbed_states(rng: np.random.Generator, x0: np.ndarray, batch: int, scale: float) -> np.ndarray:
    """(batch, nx) copies of x0 with Gaussian noise of ``scale`` on every
    component."""
    return x0[None, :] + rng.normal(scale=scale, size=(batch, x0.shape[0]))


def noise_pool(rng: np.random.Generator, sets: int, shape: tuple, scale: float) -> np.ndarray:
    """(sets, *shape) draws of Gaussian measurement noise of ``scale``,
    centred over the sets.  A chain of replans adds the draws in turn, so a
    pool whose draws did not sum to zero would add a fixed bias every
    ``sets`` replans and walk each robot away (by ~1 in a few hundred
    replans)."""
    pool = rng.normal(scale=scale, size=(sets,) + tuple(shape))
    return pool - pool.mean(0, keepdims=True)

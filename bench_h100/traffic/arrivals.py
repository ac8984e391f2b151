"""Open-loop arrival schedules with the same set of gaps for every seed.

A Poisson process at ``rate`` over ``seconds`` is drawn as the n =
round(rate * seconds) quantiles of the exponential gap, in an order
shuffled by the seed: each seed sends the same number of requests over
the same span, with the same gaps in another order, so two seeds differ
in the order of the work and not in its amount."""

from __future__ import annotations

import numpy as np


def poisson_quantile_gaps(rate: float, seconds: float,
                          rng: np.random.Generator) -> np.ndarray:
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps *= seconds / gaps.sum()          # the schedule spans the window
    rng.shuffle(gaps)
    return gaps


def due_times(rate: float, seconds: float, rng) -> np.ndarray:
    """Offsets from the window's start at which each request is due;
    the first is due at 0."""
    gaps = poisson_quantile_gaps(rate, seconds, rng)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])

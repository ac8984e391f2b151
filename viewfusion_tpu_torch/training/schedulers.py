"""Learning-rate schedule: linear warmup, then exponential decay (the
port's copy of ``viewfusion_tpu/training/schedulers.py``).

``LrScheduler`` is the reference's host-side schedule.  ``lr_schedule``
returns the function the optimizer reads before each update; it computes
in float32 as the JAX schedule does inside optax.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LrScheduler", "lr_schedule"]

_f32 = np.float32


class LrScheduler:
    """Host-side schedule (reference API: utils/schedulers.py)."""

    def __init__(self, peak_lr: float = 4e-4, peak_it: int = 10000,
                 decay_rate: float = 0.5, decay_it: int = 100000):
        self.peak_lr = peak_lr
        self.peak_it = peak_it
        self.decay_rate = decay_rate
        self.decay_it = decay_it

    def get_cur_lr(self, it: int) -> float:
        if it < self.peak_it:
            return self.peak_lr * (it / self.peak_it)
        it_since_peak = it - self.peak_it
        return self.peak_lr * (
            self.decay_rate ** (it_since_peak / self.decay_it)
        )


def lr_schedule(peak_lr: float = 1e-4, peak_it: int = 2500,
                decay_rate: float = 0.16, decay_it: int = 4_000_000):
    """``schedule(it) -> lr`` in float32: ``peak_lr * it / peak_it``
    below ``peak_it``, else ``peak_lr * decay_rate ** ((it - peak_it) /
    decay_it)``."""

    def schedule(it: int) -> float:
        it = _f32(it)
        if it < peak_it:
            return float(_f32(peak_lr) * (it / _f32(peak_it)))
        return float(_f32(peak_lr) * _f32(decay_rate) ** (
            (it - _f32(peak_it)) / _f32(decay_it)))

    return schedule

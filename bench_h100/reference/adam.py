"""Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected, as optax and
``torch.optim.Adam`` define it) and the learning-rate schedule of the
configuration: linear warmup from 0 to ``peak_lr`` over ``warmup``
updates, computed in float32, read before each update with the count of
updates already made."""

from __future__ import annotations

import numpy as np
import torch


def lr_at(step: int, peak_lr: float, warmup: int, decay_rate: float,
          decay_it: int) -> float:
    f = np.float32
    if f(step) < warmup:
        return float(f(peak_lr) * (f(step) / f(warmup)))
    return float(f(peak_lr) * f(decay_rate) ** ((f(step) - f(warmup))
                                                 / f(decay_it)))


class Adam:
    def __init__(self, params, b1=0.9, b2=0.999, eps=1e-8):
        self.params = params
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.b1, self.b2, self.eps, self.count = b1, b2, eps, 0

    @torch.no_grad()
    def update(self, grads, lr: float) -> None:
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (self.m[k] / c1)
                   / ((self.v[k] / c2).sqrt() + self.eps))

"""Loss-weight schedules: KL annealing (port of
deepof_tpu/train/schedules.py, pure Python).

Warmup -> plateau -> cooldown with linear / sigmoid / tf_sigmoid shapes, a
pure function of the iteration counter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def _shape(p: float, mode: str) -> float:
    p = max(0.0, min(1.0, p))
    if mode == "linear":
        return p
    if mode == "sigmoid":
        return 1.0 / (1.0 + math.exp(-12.0 * (p - 0.5)))
    if mode == "tf_sigmoid":
        eps = 1e-2
        denom = max(eps, p - p * p)
        return 1.0 / (1.0 + math.exp(-((2.0 * p - 1.0) / denom)))
    return p


@dataclass
class WeightSchedule:
    """Warmup -> plateau -> cooldown weight schedule, in iterations."""

    n_batches_per_epoch: int
    mode: str = "sigmoid"
    warmup_epochs: int = 15
    max_weight: float = 1.0
    at_max_epochs: int = 0
    cooldown_epochs: int = 15
    end_weight: float = 1.0

    def __post_init__(self):
        self.warmup_iters = max(1, self.warmup_epochs * self.n_batches_per_epoch)
        self.at_max_iters = max(0, self.at_max_epochs * self.n_batches_per_epoch)
        self.cooldown_iters = max(0, self.cooldown_epochs * self.n_batches_per_epoch)
        self.total_iters = self.warmup_iters + self.at_max_iters + self.cooldown_iters

    def weight_at(self, t: int) -> float:
        if t >= self.total_iters:
            return self.end_weight
        if self.at_max_iters > 0 and self.warmup_iters <= t < self.warmup_iters + self.at_max_iters:
            return self.max_weight
        if t <= self.warmup_iters:
            return self.max_weight * _shape(t / self.warmup_iters, self.mode)
        if self.cooldown_iters <= 0:
            return self.max_weight
        pc = (t - self.warmup_iters - self.at_max_iters) / self.cooldown_iters
        return (1.0 - pc) * self.max_weight + pc * self.end_weight

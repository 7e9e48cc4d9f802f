"""Learning-rate schedules: pure functions of the (integer) step.

The counterpart of `constant` and `linear_decay` of
`repro.optim.schedules`, computed in float32 as the reference does.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], np.float32]


def constant(lr: float) -> Schedule:
    return lambda step: np.float32(lr)


def _warmup(step, warmup_steps):
    return np.minimum(np.float32(1.0),
                      np.float32(step + 1) / np.float32(max(warmup_steps, 1)))


def linear_decay(lr: float, total_steps: int, warmup_steps: int = 0,
                 end_fraction: float = 0.0) -> Schedule:
    def f(step):
        w = _warmup(step, warmup_steps)
        frac = np.clip(np.float32(step - warmup_steps)
                       / np.float32(max(total_steps - warmup_steps, 1)),
                       np.float32(0.0), np.float32(1.0))
        return (np.float32(lr) * w
                * (np.float32(1.0) - (np.float32(1.0)
                                      - np.float32(end_fraction)) * frac))

    return f

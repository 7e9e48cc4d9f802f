"""Learning-rate schedules: pure functions of the (integer) step.

The counterpart of `repro.optim.schedules` (`constant`, `linear_decay`,
`cosine_decay`, and `wsd`, the Warmup-Stable-Decay schedule MiniCPM
trains with, arXiv:2404.06395), computed in float32 as the reference
does.
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


def _frac(step, start, length):
    return np.clip(np.float32(step - start) / np.float32(max(length, 1)),
                   np.float32(0.0), np.float32(1.0))


def linear_decay(lr: float, total_steps: int, warmup_steps: int = 0,
                 end_fraction: float = 0.0) -> Schedule:
    def f(step):
        w = _warmup(step, warmup_steps)
        frac = _frac(step, warmup_steps, total_steps - warmup_steps)
        return (np.float32(lr) * w
                * (np.float32(1.0) - (np.float32(1.0)
                                      - np.float32(end_fraction)) * frac))

    return f


def cosine_decay(lr: float, total_steps: int, warmup_steps: int = 0,
                 end_fraction: float = 0.1) -> Schedule:
    def f(step):
        w = _warmup(step, warmup_steps)
        frac = _frac(step, warmup_steps, total_steps - warmup_steps)
        cos = np.float32(0.5) * (np.float32(1.0)
                                 + np.cos(np.float32(np.pi) * frac))
        return (np.float32(lr) * w
                * (np.float32(end_fraction)
                   + (np.float32(1.0) - np.float32(end_fraction)) * cos))

    return f


def wsd(lr: float, total_steps: int, warmup_steps: int,
        decay_fraction: float = 0.1, end_fraction: float = 0.01) -> Schedule:
    """Warmup-Stable-Decay (MiniCPM): warmup, a long plateau, then an
    exponential decay to `end_fraction` over the last `decay_fraction` of
    the steps."""
    decay_steps = max(int(total_steps * decay_fraction), 1)
    stable_end = total_steps - decay_steps

    def f(step):
        w = _warmup(step, warmup_steps)
        frac = _frac(step, stable_end, decay_steps)
        decay = np.exp(np.log(np.float32(end_fraction)) * frac)
        return np.float32(lr) * w * (decay if step > stable_end
                                     else np.float32(1.0))

    return f

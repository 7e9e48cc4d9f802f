"""First-order optimizers with an (init, update) interface.

The counterpart of `repro.optim.optimizers`: SGD (+momentum, nesterov),
Adam and AdamW, and `chain_clip_by_global_norm` (non-private global-norm
clipping in front of any of them). Unlike the reference, `update(grads, state, params)`
applies the step IN PLACE: it writes the new parameters into `params`
(and the new moments into the state's tensors) under `torch.no_grad()`
and returns the new state. A (36, 2560, 19456) leaf would otherwise need a
second copy of itself and of each moment. State tensors keep the
parameter dtype, as `jnp.zeros_like` does; the arithmetic follows the
reference's order and dtypes (the step in float32, cast to the parameter
dtype before the add). Large leaves are updated in slices along their
first axis, which changes no result (every op is elementwise) and bounds
the float32 temporaries.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.optim.schedules import Schedule, constant

_SLICE_ELEMS = 1 << 26  # float32 temporaries of at most 256 MiB


def slices(t: torch.Tensor) -> list[torch.Tensor]:
    """Views of `t` along its first axis, each of at most _SLICE_ELEMS
    elements (the whole tensor when small or 0-d)."""
    if t.dim() == 0 or t.numel() <= _SLICE_ELEMS:
        return [t]
    rows = max(1, _SLICE_ELEMS // max(t[0].numel(), 1))
    return list(t.split(rows))


def sliced(*tensors):
    """Aligned slices of same-shaped tensors."""
    return zip(*(slices(t) for t in tensors))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]  # (grads, state, params) -> state


def leaves(*trees):
    """Aligned leaves of nested dicts with the same keys, sorted by key."""
    first = trees[0]
    for k in sorted(first):
        if isinstance(first[k], dict):
            yield from leaves(*(t[k] for t in trees))
        else:
            yield tuple(t[k] for t in trees)


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


class SGDState(NamedTuple):
    step: int
    momentum: Any  # None when momentum == 0


def sgd(lr: float | Schedule, momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        return SGDState(0, _zeros_like(params) if momentum else None)

    @torch.no_grad()
    def update(grads, state, params):
        lr_t = float(sched(state.step))
        trees = (grads, params) + ((state.momentum,) if momentum else ())
        for leaf in leaves(*trees):
            for parts in sliced(*leaf):
                g, p = parts[0], parts[1]
                if weight_decay:
                    g = g + weight_decay * p
                if momentum:
                    m = parts[2]
                    m.mul_(momentum).add_(g)
                    g = momentum * m + g if nesterov else m
                p.add_((-lr_t * g.float()).to(p.dtype))
        return SGDState(state.step + 1, state.momentum)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adam(lr: float | Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         decoupled: bool = False) -> Optimizer:
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        return AdamState(0, _zeros_like(params), _zeros_like(params))

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        # the bias corrections and the rate are float32, as the reference's
        bc1 = float(1 - np.float32(b1) ** np.float32(step))
        bc2 = float(1 - np.float32(b2) ** np.float32(step))
        lr_t = float(sched(state.step))
        for leaf in leaves(grads, params, state.mu, state.nu):
            for g, p, m, v in sliced(*leaf):
                if weight_decay and not decoupled:
                    g = g + weight_decay * p
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).add_(g.float().square().to(v.dtype), alpha=1 - b2)
                mhat = m.float() / bc1
                vhat = v.float() / bc2
                u = -lr_t * mhat / (torch.sqrt(vhat) + eps)
                if weight_decay and decoupled:
                    u = u - lr_t * weight_decay * p
                p.add_(u.to(p.dtype))
        return AdamState(step, state.mu, state.nu)

    return Optimizer(init, update)


def adamw(lr: float | Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay, decoupled=True)


def chain_clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    """Non-private global-norm clipping in front of `opt` (for the
    non_private baselines): the gradients scaled by min(1, max_norm /
    (||g|| + 1e-12)), the norm over every leaf in f32, each leaf cast
    back to its dtype; `grads` itself is left as it was."""

    @torch.no_grad()
    def update(grads, state, params):
        gn = torch.sqrt(sum(g.float().square().sum()
                            for (g,) in leaves(grads)))
        scale = torch.clamp(max_norm / (gn + 1e-12), max=1.0)

        def scaled(tree):
            return {k: scaled(v) if isinstance(v, dict)
                    else (v.float() * scale).to(v.dtype)
                    for k, v in tree.items()}

        return opt.update(scaled(grads), state, params)

    return Optimizer(opt.init, update)

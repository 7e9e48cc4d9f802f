"""Named scopes: the port's counterpart of `jax.named_scope`.

The clipping engine marks what its code means for the static DP-safety
audit (`repro_torch.analysis.taint`): `dp_clip_factor` around the clip
factor computations (`core.ghost.clip_factor`,
`core.clipping.group_clip_factors` / `flat_clip_factors`) and
`dp_noise_add:<leaf>` around each leaf's noise draw and add
(`core.dp_sgd.add_noise_to_grads`). A dispatch mode reads the stack of
the thread an op runs on (`current`).

The stack is thread-local: a DP primitive's `autograd.Function.backward`
runs on autograd's device thread for CUDA tensors, and the factor it
computes there is marked on that thread. Nothing reads the stack outside
an audit; a scope costs a list push and pop.
"""
from __future__ import annotations

import contextlib
import functools
import threading

CLIP_SCOPE = "dp_clip_factor"
NOISE_SCOPE = "dp_noise_add:"

_LOCAL = threading.local()


def _stack() -> list[str]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


@contextlib.contextmanager
def named_scope(name: str):
    """Push `name` on this thread's scope stack for the block."""
    stack = _stack()
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def scoped(name: str):
    """Decorator: run the function inside `named_scope(name)`."""

    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            stack = _stack()
            stack.append(name)
            try:
                return fn(*args, **kwargs)
            finally:
                stack.pop()
        return inner

    return deco


def current() -> str:
    """This thread's scope stack, '/'-joined ('' outside any scope)."""
    return "/".join(_stack())

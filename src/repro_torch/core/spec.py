"""Parameter specification: the counterpart of `repro.core.spec`.

Models declare their parameters as a nested dict of `P` leaves, keyed by
the same paths as the reference, so a parameter tree crosses between the
packages by path (`repro_torch.bridge`). Stacked layers keep the leading
stack dim here; `models.transformer.unstack_blocks` splits it into the
per-layer blocks the port runs.

`GroupLayout` (clipping groups, threshold packing) and the clipping
fields of `P` (group, blocks, sensitivity_mult) wait for the training
slice: serving runs with every threshold at +inf and never reads them.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Iterator

import torch


def stable_hash(name: str) -> int:
    """Process-independent 31-bit string hash (crc32), as in the reference:
    the builtin hash() is randomized per process."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class P:
    """Specification of one parameter tensor."""

    shape: tuple[int, ...]
    init: str = "normal"  # zeros | ones | normal | embed
    scale: float | None = None  # stddev override
    dtype: torch.dtype = torch.float32
    stack: int = 0  # number of leading scan/stack dims in `shape`
    fan_in_axis: int = -2  # axis used for fan-in init scaling


SpecTree = Any  # nested dict[str, P | SpecTree]


def _walk(spec: SpecTree, prefix: tuple[str, ...] = ()
          ) -> Iterator[tuple[tuple[str, ...], P]]:
    for name in sorted(spec):
        node = spec[name]
        path = prefix + (name,)
        if isinstance(node, P):
            yield path, node
        else:
            yield from _walk(node, path)


def init_params(spec: SpecTree, generator: torch.Generator) -> Any:
    """Initialize a parameter tree from a spec tree.

    The leaves are drawn in `_walk` order from `generator`, on the
    generator's device, with the reference's distributions (not its bits:
    JAX's threefry and torch's Philox differ)."""
    out: dict = {}
    for path, p in _walk(spec):
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = _init_leaf(p, generator)
    return out


def _init_leaf(p: P, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=dev)
    if p.init in ("normal", "embed"):
        if p.init == "embed":
            std = p.scale if p.scale is not None else 0.02
        else:
            fan_in = (p.shape[p.fan_in_axis] if len(p.shape) >= 2
                      else max(p.shape[-1], 1))
            std = p.scale if p.scale is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(p.shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return x.mul_(std).to(p.dtype)
    raise ValueError(f"unknown init {p.init!r}")

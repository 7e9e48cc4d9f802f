"""Parameter specification and clipping groups: the counterpart of
`repro.core.spec`.

Models declare their parameters as a nested dict of `P` leaves, keyed by
the same paths as the reference, so a parameter tree crosses between the
packages by path (`repro_torch.bridge`). Stacked layers keep the leading
stack dim here; `models.transformer.unstack_blocks` splits it into the
per-layer views the port runs.

`GroupLayout` enumerates the clipping groups (a linear's {w, b}, a norm's
{s}; each element of a stacked group is its own group), their sizes d_k,
and packs the (K,) encoded thresholds into the per-group (stack + (B,))
tensors the DP primitives take. A blocked weight (`blocks=M`, per-shard
clipping) splits into M groups per stack element: its group's stack
shape is `stack + (M,)` and d_k is the element's size over M.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Iterator

import numpy as np
import torch
from torch._guards import active_fake_mode


def stable_hash(name: str) -> int:
    """Process-independent 31-bit string hash (crc32), as in the reference:
    the builtin hash() is randomized per process."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class P:
    """Specification of one parameter tensor."""

    shape: tuple[int, ...]
    init: str = "normal"  # zeros | ones | normal | embed | uniform
    scale: float | None = None  # stddev override
    dtype: torch.dtype = torch.float32
    group: str | None = None  # explicit group path (shared / joint groups)
    blocks: int = 1  # split into M per-shard clipping groups
    stack: int = 0  # number of leading scan/stack dims in `shape`
    fan_in_axis: int = -2  # axis used for fan-in init scaling
    sensitivity_mult: float = 1.0  # >1 for params shared across use sites


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


def tree_leaves(tree: dict, prefix: tuple[str, ...] = ()
                ) -> Iterator[tuple[tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict (a parameter or gradient tree),
    in sorted-key order: the order `_walk` gives its spec."""
    for name in sorted(tree):
        node = tree[name]
        if isinstance(node, dict):
            yield from tree_leaves(node, prefix + (name,))
        else:
            yield prefix + (name,), node


# Canonical leaf names that join their parent module's group ({w, b} of a
# linear, {s} of a norm, {a, b} of a LoRA adapter pair).
_PARENT_GROUP_NAMES = frozenset({"w", "b", "s", "a"})


def _group_path(path: tuple[str, ...], p: P) -> str:
    if p.group is not None:
        return p.group
    if len(path) > 1 and path[-1] in _PARENT_GROUP_NAMES:
        return "/".join(path[:-1])
    return "/".join(path)


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


def meta_params(spec: SpecTree) -> Any:
    """The parameter tree's shapes and dtypes on the meta device (no
    memory): a template to restore a checkpoint into."""
    return abstract_params(spec)


def shape_only(shape, dtype: torch.dtype, device="meta") -> torch.Tensor:
    """A tensor of `shape` and `dtype` that holds no memory: on the meta
    device, or a fake tensor on `device` inside an active
    `FakeTensorMode` (the dry run's). Raises rather than allocate."""
    device = torch.device(device)
    if device.type != "meta" and active_fake_mode() is None:
        raise RuntimeError(f"a shape-only tensor on {device} needs an "
                           f"active FakeTensorMode (or device='meta')")
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def abstract_params(spec: SpecTree, device="meta") -> Any:
    """One shape-only tensor per leaf of `spec`, in its dtype, keyed as
    the parameters (the reference's ShapeDtypeStruct tree): on the meta
    device, or fake tensors on `device` inside a `FakeTensorMode`
    (`shape_only`). Nothing is allocated, so a full-size model costs
    nothing."""
    out: dict = {}
    for path, p in _walk(spec):
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = shape_only(p.shape, p.dtype, device)
    return out


# largest piece of a leaf drawn in one f32 randn: torch's draws depend only
# on the element count, so a leaf of one piece gets the bits of a single
# draw of its shape
_DRAW_MAX = 2**31


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
        # drawn in pieces into its own dtype, so a leaf past one f32 draw
        # (deepseek-v3's stacked experts, 60 GB of f32 for two layers)
        # never needs its f32 copy whole
        n = math.prod(p.shape)
        out = torch.empty(p.shape, dtype=p.dtype, device=dev)
        flat = out.view(-1)
        for i in range(0, n, _DRAW_MAX):
            m = min(_DRAW_MAX, n - i)
            flat[i:i + m] = torch.randn(m, generator=gen, device=dev,
                                        dtype=torch.float32).mul_(std)
        return out
    if p.init == "uniform":  # U(-scale, scale), as the reference
        r = p.scale if p.scale is not None else 0.02
        u = torch.rand(p.shape, generator=gen, device=dev,
                       dtype=torch.float32)
        return u.mul_(2 * r).sub_(r).to(p.dtype)
    raise ValueError(f"unknown init {p.init!r}")


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    stack_shape: tuple[int, ...]  # e.g. (L,) for stacked layers
    dim: int  # parameters per group element (d_k)
    offset: int  # flat id of element (0, ..., 0)
    sensitivity_mult: float = 1.0

    @property
    def count(self) -> int:
        return int(np.prod(self.stack_shape, dtype=np.int64))


class GroupLayout:
    """Flat enumeration of clipping groups + pack/unpack helpers.

    Built from the spec alone: nothing is allocated, so the layout of a
    full-size model is cheap. Group order, offsets and dims are the
    reference's, so (K,) vectors line up across the two packages."""

    def __init__(self, spec: SpecTree):
        groups: dict[str, dict] = {}
        leaf_group: dict[tuple[str, ...], str] = {}
        for path, p in _walk(spec):
            gname = _group_path(path, p)
            stack_shape = tuple(p.shape[: p.stack])
            if p.blocks > 1:  # a bias joining a blocked weight shares it
                stack_shape = stack_shape + (p.blocks,)
            per_elem = (int(np.prod(p.shape[p.stack:], dtype=np.int64))
                        // p.blocks)
            if gname in groups:
                g = groups[gname]
                g["mult"] = max(g["mult"], p.sensitivity_mult)
                if g["stack_shape"] != stack_shape:
                    raise ValueError(
                        f"group {gname!r}: stack shape mismatch "
                        f"{g['stack_shape']} vs {stack_shape} at {path}")
                g["dim"] += per_elem
            else:
                groups[gname] = {"stack_shape": stack_shape, "dim": per_elem,
                                 "mult": p.sensitivity_mult}
            leaf_group[path] = gname
        self.groups: list[Group] = []
        self._by_name: dict[str, Group] = {}
        offset = 0
        for name in sorted(groups):
            g = groups[name]
            grp = Group(name=name, stack_shape=g["stack_shape"], dim=g["dim"],
                        offset=offset, sensitivity_mult=g["mult"])
            self.groups.append(grp)
            self._by_name[name] = grp
            offset += grp.count
        self.num_groups = offset
        self._leaf_group = leaf_group
        self._spec = spec

    def group(self, name: str) -> Group:
        return self._by_name[name]

    def group_of_leaf(self, path: tuple[str, ...]) -> Group:
        return self._by_name[self._leaf_group[path]]

    @property
    def dims(self) -> np.ndarray:
        """(K,) parameter count per group."""
        out = np.empty(self.num_groups, dtype=np.int64)
        for g in self.groups:
            out[g.offset: g.offset + g.count] = g.dim
        return out

    @property
    def sens_mults(self) -> np.ndarray:
        """(K,) sensitivity multipliers (shared-parameter sites)."""
        out = np.ones(self.num_groups, dtype=np.float32)
        for g in self.groups:
            out[g.offset: g.offset + g.count] = g.sensitivity_mult
        return out

    def flat_names(self) -> list[str]:
        out = []
        for g in self.groups:
            if g.count == 1:
                out.append(g.name)
            else:
                for idx in np.ndindex(g.stack_shape):
                    out.append(g.name + "[" + ",".join(map(str, idx)) + "]")
        return out

    # -- threshold packing ---------------------------------------------------
    # Every packed leaf is a fresh contiguous tensor, so a caller can make
    # it an autograd leaf (requires_grad_) and read norms² from its grad.

    def pack(self, flat: torch.Tensor, batch: int) -> dict[str, torch.Tensor]:
        """(K,) encoded thresholds -> {group name: stack_shape + (B,)}."""
        out = {}
        for g in self.groups:
            piece = flat[g.offset: g.offset + g.count].reshape(
                g.stack_shape + (1,))
            out[g.name] = piece.expand(g.stack_shape + (batch,)).clone()
        return out

    def pack_value(self, value, batch: int, *,
                   device: str | torch.device = "cpu"
                   ) -> dict[str, torch.Tensor]:
        """Same encoded scalar (or (B,) vector) for every group."""
        v = torch.as_tensor(value, dtype=torch.float32, device=device)
        return {g.name: v.expand(g.stack_shape + (batch,)).clone()
                for g in self.groups}

    def pack_rows(self, rows: torch.Tensor) -> dict[str, torch.Tensor]:
        """(K, B) per-group per-example values -> thresholds dict."""
        batch = rows.shape[-1]
        return {g.name: rows[g.offset: g.offset + g.count].reshape(
                    g.stack_shape + (batch,)).clone()
                for g in self.groups}

    def unpack(self, tree: dict[str, torch.Tensor]) -> torch.Tensor:
        """{group: stack_shape + (B,)} norms -> (K, B) flat matrix."""
        return torch.cat([tree[g.name].reshape(g.count, tree[g.name].shape[-1])
                          for g in self.groups], dim=0)


def subth(th: dict, prefix: str) -> dict:
    """Select the threshold-dict subtree under `prefix` (strip 'prefix/')."""
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in th.items() if k.startswith(prefix + "/")}

"""Sharding rules and per-device group ownership: the counterpart of the
numpy part of `repro.launch.sharding`.

Rules are name-based over the parameter spec tree (the same canonical
paths that name clipping groups):

  column-parallel (output dim -> model): qkv / gate_up / in_proj / rwkv
      r,k,v,g / lora b / mla q_b,kv_b / cross kv / head
  row-parallel   (input dim -> model): o / down / out_proj / rwkv o / cm v
  expert-parallel: moe w_gu / w_down shard the EXPERT dim over model
  replicated: norms, small vectors, routers, embed-adjacent gains

`group_shard_assignment` turns them into the supergroups of `per_group`
clipping, on a mesh (its model axis) or without one (`--group-count`
virtual shards), with the reference's assignment exactly (DP-LoRA's
adapter pairs are stacked groups of one block: layer l to shard l * M /
L, whichever member is the largest). `_spec_for`
returns a tuple of axis names (`"model"` or None per dim; () for
replicated) where the reference returns a `PartitionSpec`.

On a mesh (`launch.mesh`), `params_shardings` gives each parameter leaf a
`Placement` (the reference's `NamedSharding`): the launcher STORES the
weights model-sharded between steps (`shard_tree`, each rank its slice)
and all-gathers them at step entry (`gather_tree`, site `weight_gather`),
as the reference's `jit_step` does with its in/out shardings. The sharded
step computes on replicated weights.

The serving and batch placements (`params_shardings(serving=True)`,
`batch_shardings`, `cache_shardings`, `opt_state_shardings`) feed only
the dry run (`launch.dryrun`), which reads each leaf's per-device bytes
from them (`placed_bytes`). Their entries may name the data plane (a
tuple of its axes, as the reference's PartitionSpec entries), which
`Placement.shard` / `gather` do not move.
"""
from __future__ import annotations

import fnmatch
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.spec import P, _walk
from repro_torch.launch.mesh import data_axes

# pattern -> (kind, axis); kind: 'dim' shards that axis on model,
# 'expert' the expert dim, 'replicate' nothing
_RULES: list[tuple[str, Any]] = [
    ("embed/w", ("dim", 0)),            # vocab -> model
    ("head/w", ("dim", -1)),            # vocab -> model
    ("*moe/w_gu", ("expert", -1)),    # fallback: column-parallel in-expert
    ("*moe/w_down", ("expert", -2)),  # fallback: row-parallel in-expert
    ("*moe/router/w", ("replicate", None)),
    ("*moe/shared/gate_up/w", ("dim", -1)),
    ("*moe/shared/down/w", ("dim", -2)),
    ("*attn/qkv/w", ("dim", -1)),
    ("*attn/qkv/b", ("dim", -1)),
    ("*attn/kv/w", ("dim", -1)),
    ("*attn/kv/b", ("dim", -1)),
    ("*attn/o/w", ("dim", -2)),
    ("*attn/q/w", ("dim", -1)),
    ("*attn/q_a/w", ("replicate", None)),
    ("*attn/q_b/w", ("dim", -1)),
    ("*attn/kv_a/w", ("replicate", None)),
    ("*attn/kv_b/w", ("dim", -1)),
    ("*cross/qkv/w", ("dim", -1)),
    ("*cross/kv/w", ("dim", -1)),
    ("*cross/o/w", ("dim", -2)),
    ("*mlp/gate_up/w", ("dim", -1)),
    ("*mlp/down/w", ("dim", -2)),
    ("*in_proj/w", ("dim", -1)),
    ("*out_proj/w", ("dim", -2)),
    ("*tm/r/w", ("dim", -1)),
    ("*tm/k/w", ("dim", -1)),
    ("*tm/v/w", ("dim", -1)),
    ("*tm/g/w", ("dim", -1)),
    ("*tm/o/w", ("dim", -2)),
    ("*cm/k/w", ("dim", -1)),
    ("*cm/v/w", ("dim", -2)),
    ("*cm/r/w", ("dim", -1)),
    ("lora/*/b", ("dim", -1)),          # adapter B column-parallel
    ("lora/*/a", ("replicate", None)),
    ("mtp/proj/w", ("dim", -1)),
]


def _sharded(ndim: int, axis: int) -> tuple:
    out: list = [None] * ndim
    out[axis] = "model"
    return tuple(out)


def _spec_for(path: str, p: P, model_size: int) -> tuple:
    """Axis names per dim of leaf `path` on a `model_size`-way model axis;
    () when replicated. Non-divisible dims fall back to replication."""
    ndim = len(p.shape)
    for pattern, (kind, axis) in _RULES:
        if fnmatch.fnmatch(path, pattern):
            if kind == "replicate":
                return ()
            if kind == "expert":
                # shape (..., E, d, f): the expert dim is -3; when E does
                # not divide the model axis, fall back to intra-expert
                # tensor parallelism
                e_axis = ndim - 3
                if p.shape[e_axis] % model_size == 0:
                    return _sharded(ndim, e_axis)
                ax = axis % ndim
                if p.shape[ax] % model_size == 0:
                    return _sharded(ndim, ax)
                return ()
            ax = axis % ndim
            if p.shape[ax] % model_size == 0:
                return _sharded(ndim, ax)
            return ()
    return ()  # default: replicate (norm scales, small vectors)


def group_shard_assignment(layout, model_size: int) -> tuple[int, ...]:
    """Map every flat clipping group to its owning model-axis shard: the
    supergroups of `per_group` (per-device) clipping, as in the reference.

      * blocked groups (`P.blocks == model_size`) whose weight is
        column-parallel: block j lives on shard j;
      * stacked groups: layer l -> shard l * model_size // L (contiguous
        pipeline-stage ownership, the paper's GPT-3 recipe);
      * singleton groups (embed / head / final norm): round-robin in
        sorted-name order.

    Returns `layout.num_groups` ints in [0, model_size), usable as
    `DPConfig.group_assignment` with `num_supergroups=model_size`."""
    spec = layout._spec
    leaves_by_group: dict[str, list] = {}
    for path, p in _walk(spec):
        leaves_by_group.setdefault(layout._leaf_group[path], []).append(
            (path, p))
    assign = np.zeros(layout.num_groups, dtype=np.int64)
    rr = 0  # round-robin counter for singleton groups
    for g in layout.groups:
        members = leaves_by_group.get(g.name, [])
        # primary leaf: the largest member (the weight, not the bias)
        path, p = max(members, key=lambda kv: int(
            np.prod(kv[1].shape, dtype=np.int64)))
        axes = list(_spec_for("/".join(path), p, model_size))
        axes += [None] * (len(p.shape) - len(axes))
        col_parallel = bool(axes) and axes[-1] == "model"
        ids = np.arange(g.count, dtype=np.int64)
        if g.count == 1:
            assign[g.offset] = rr % model_size
            rr += 1
            continue
        if p.blocks == model_size and p.blocks > 1 and col_parallel:
            # stack_shape ends in the block dim: element (.., j) -> shard j
            owners = ids % model_size
        else:
            first = g.stack_shape[0]
            owners = (ids // max(g.count // first, 1)) * model_size // first
        assign[g.offset: g.offset + g.count] = owners % model_size
    return tuple(int(a) for a in assign)


class Placement:
    """Where a leaf lives on `mesh`: `spec` has one entry per leading dim
    (() replicated), each None, an axis name, or a tuple of axis names
    the dim is split over (the reference's PartitionSpec entries). A
    training placement (`_spec_for`) has "model" on at most one dim."""

    def __init__(self, mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def dim(self) -> int | None:
        """The dim sharded over the model axis, or None (replicated)."""
        return self.spec.index("model") if "model" in self.spec else None

    def __repr__(self) -> str:
        return f"Placement({self.mesh.describe()}, {self.spec})"

    def parts(self, i: int) -> int:
        """The number of pieces dim `i` is split into."""
        e = self.spec[i] if i < len(self.spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        return math.prod(self.mesh.shape[a] for a in axes)

    def local_shape(self, shape) -> tuple[int, ...]:
        """A rank's piece of a leaf of global `shape`."""
        return tuple(-(-n // self.parts(i)) for i, n in enumerate(shape))

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the global `t` (a copy; `t` itself when
        replicated)."""
        self._model_only()
        if self.dim is None:
            return t
        m = self.mesh.shape["model"]
        size = t.shape[self.dim] // m
        idx = self.mesh.axis_index("model")
        with torch.no_grad():
            return t.narrow(self.dim, idx * size, size).clone()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global leaf from every model shard's slice (an all-gather
        over the model axis, site `weight_gather`)."""
        self._model_only()
        if self.dim is None:
            return t
        with torch.no_grad():
            return self.mesh.all_gather(t.detach(), ("model",), self.dim,
                                        site="weight_gather")

    def _model_only(self) -> None:
        if any(e not in (None, "model") for e in self.spec):
            raise ValueError(f"{self}: only model-axis placements move "
                             f"tensors (the others are the dry run's)")


def _data_plane(mesh) -> tuple[tuple[str, ...], int]:
    dp = data_axes(mesh)
    return dp, math.prod(mesh.shape[a] for a in dp)


def params_shardings(spec, mesh, *, serving: bool = False) -> Any:
    """A tree of `Placement`s parallel to the parameters: each leaf's
    `_spec_for` placement on the mesh's model axis. serving=True also
    splits the largest still unsharded dim of every leaf of 2^20 elements
    or more over the data plane (the reference's weight-FSDP for a serve
    step, which has no gradient to all-reduce), where the plane divides
    it."""
    model_size = mesh.shape["model"]
    dp, dp_size = _data_plane(mesh) if serving else ((), 1)

    def walk(node, prefix):
        if isinstance(node, P):
            ps = _spec_for("/".join(prefix), node, model_size)
            if serving and math.prod(node.shape) >= (1 << 20):
                axes = list(ps) + [None] * (len(node.shape) - len(ps))
                cands = [(node.shape[i], i) for i in range(len(axes))
                         if axes[i] is None and node.shape[i] % dp_size == 0]
                if cands:
                    axes[max(cands)[1]] = dp
                    ps = tuple(axes)
            return Placement(mesh, ps)
        return {k: walk(v, prefix + (k,)) for k, v in node.items()}

    return walk(spec, ())


def _tree_map(fn, tree) -> Any:
    """`fn` over the leaves of nested dicts, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return fn(tree)


def batch_shardings(batch, mesh) -> Any:
    """Batch leaves split dim 0 over the data (+ pod) plane where it
    divides, else replicate."""
    dp, dp_size = _data_plane(mesh)

    def one(leaf):
        if leaf.dim() >= 1 and leaf.shape[0] % dp_size == 0:
            return Placement(mesh, (dp,))
        return Placement(mesh, ())

    return _tree_map(one, batch)


def cache_shardings(cache, mesh) -> Any:
    """Decode caches, (L, B, S, heads, hd)-style leaves: dim 1 (the batch)
    over the data plane where it divides, else the sequence dim (2, the
    long-context batch of one); then the model axis on the last trailing
    dim from heads down to dim 2 that it divides."""
    dp, dp_size = _data_plane(mesh)
    model_size = mesh.shape["model"]

    def one(leaf):
        nd = leaf.dim()
        if nd <= 1:
            return Placement(mesh, ())
        ax: list = [None] * nd
        if leaf.shape[1] % dp_size == 0:
            ax[1] = dp
        elif nd >= 3 and leaf.shape[2] % dp_size == 0:
            ax[2] = dp
        for cand in range(nd - 2, 1, -1):  # prefer the heads
            if ax[cand] is None and leaf.shape[cand] % model_size == 0 \
                    and leaf.shape[cand] >= model_size:
                ax[cand] = "model"
                break
        return Placement(mesh, tuple(ax))

    return _tree_map(one, cache)


def _same_keys(a, b) -> bool:
    if isinstance(a, dict) != isinstance(b, dict):
        return False
    if not isinstance(a, dict):
        return True
    return sorted(a) == sorted(b) and all(_same_keys(a[k], b[k]) for k in a)


def opt_state_shardings(opt_state, pshard, mesh) -> Any:
    """Optimizer state: a field with the parameters' tree (the moments)
    is placed as they are; the others (the step) replicate."""

    def assign(node):
        if isinstance(node, dict) and _same_keys(node, pshard):
            return pshard
        return replicated(node, mesh)

    if hasattr(opt_state, "_fields"):
        return type(opt_state)(*[assign(getattr(opt_state, f))
                                 for f in opt_state._fields])
    return assign(opt_state)


def placed_bytes(tree, placements) -> int:
    """The bytes a rank holds of the tensors of `tree` placed by
    `placements` (a parallel tree; a leaf that is no tensor, such as a
    step count, holds none)."""
    if isinstance(tree, dict):
        return sum(placed_bytes(tree[k], placements[k]) for k in tree)
    if isinstance(tree, tuple):
        return sum(placed_bytes(t, p) for t, p in zip(tree, placements))
    if not isinstance(tree, torch.Tensor):
        return 0
    return (math.prod(placements.local_shape(tree.shape))
            * tree.element_size())


def replicated(tree, mesh) -> Any:
    """A replicated `Placement` for every leaf of `tree` (dicts, tuples
    and NamedTuples)."""
    return _tree_map(lambda _: Placement(mesh, ()), tree)


def _map2(fn, tree, placements):
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], placements[k]) for k in tree}
    return fn(tree, placements)


def shard_tree(tree, placements) -> Any:
    """Each rank's slices of a global tree of tensors, keeping each
    leaf's `requires_grad`."""
    return _map2(lambda t, pl: pl.shard(t).requires_grad_(t.requires_grad),
                 tree, placements)


def gather_tree(tree, placements) -> Any:
    """The global tree from every rank's slices (one all-gather per
    model-sharded leaf), keeping each leaf's `requires_grad`."""
    return _map2(lambda t, pl: pl.gather(t).requires_grad_(t.requires_grad),
                 tree, placements)

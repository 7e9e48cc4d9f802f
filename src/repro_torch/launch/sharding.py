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
step computes on replicated weights. The serving and batch placements
(`serving=True`, `batch_shardings`, `cache_shardings`,
`opt_state_shardings`) feed only the dry run: ROADMAP A.14.
"""
from __future__ import annotations

import fnmatch
from typing import Any

import numpy as np
import torch

from repro_torch.core.spec import P, _walk

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
    """Where a leaf lives between steps on `mesh`: `spec` is the
    `_spec_for` tuple (() replicated; "model" on at most one dim)."""

    def __init__(self, mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def dim(self) -> int | None:
        """The dim sharded over the model axis, or None (replicated)."""
        return self.spec.index("model") if "model" in self.spec else None

    def __repr__(self) -> str:
        return f"Placement({self.mesh.describe()}, {self.spec})"

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the global `t` (a copy; `t` itself when
        replicated)."""
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
        if self.dim is None:
            return t
        with torch.no_grad():
            return self.mesh.all_gather(t.detach(), ("model",), self.dim,
                                        site="weight_gather")


def params_shardings(spec, mesh) -> Any:
    """A tree of `Placement`s parallel to the parameters: each leaf's
    `_spec_for` placement on the mesh's model axis."""
    model_size = mesh.shape["model"]

    def walk(node, prefix):
        if isinstance(node, P):
            return Placement(mesh, _spec_for("/".join(prefix), node,
                                             model_size))
        return {k: walk(v, prefix + (k,)) for k, v in node.items()}

    return walk(spec, ())


def replicated(tree, mesh) -> Any:
    """A replicated `Placement` for every leaf of `tree` (dicts, tuples
    and NamedTuples)."""
    if isinstance(tree, dict):
        return {k: replicated(v, mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [replicated(v, mesh) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return Placement(mesh, ())


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

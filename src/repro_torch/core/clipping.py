"""Clipping modes: the counterpart of `repro.core.clipping` for one
device.

Every model exposes  loss_fn(params, batch, thresholds) -> (B,)
per-example losses, where `thresholds` is the GroupLayout dict of encoded
per-example threshold vectors consumed by the DP primitives:

  non_private : thresholds +inf, no norms requested; one backward pass;
                standard summed grads.
  per_layer   : the paper's headline (Sec. 3.1). ONE backward pass, one
                `torch.autograd.grad` over the parameter leaves AND the
                threshold leaves: each layer's backward clips with its own
                C_k as the cotangent reaches it, and the norms² come back
                as the thresholds' gradients.
  ghost_flat  : flat (ghost) clipping, the paper's efficiency baseline.
                Default execution is book-keeping (`bk`, `core.bk`): ONE
                backward pass that reads the norms² AND caches each
                layer's ghost residuals, then a scale-and-contract
                epilogue builds the clipped sums once the flat factor is
                known.
  per_group   : a partition of the layout groups into supergroups
                (per-device clipping, the paper's Sec. 4); the same BK
                execution, with the norms² summed per supergroup before
                the epilogue.

Executions of the flat and group modes (`execution=`, also reachable as
the `ghost_flat_twopass` / `per_group_twopass` mode names):

  bk      : one backward + epilogue. Falls back to twopass, with a
            warning, where the layout cannot be captured (see
            `bk.capture_clipped`).
  twopass : pass 1 reads the norms² only (the loss runs on detached
            parameters, so no primitive contracts a parameter gradient);
            pass 2 applies each example's factor through direct-scale
            thresholds (c = -f), which request no norms.

  naive_flat  : the Opacus-style oracle and the Figure-1 "usual flat"
                baseline: per-example gradients, materialised as
                `jax.jacrev` gives them in the reference, then their norms²
                per layout group, one flat factor per example, and an f32
                contraction of the factors with them. O(B x params)
                memory; `DPConfig.microbatches` bounds B.

naive_flat's per-example gradients are the rows of the Jacobian of the
(B,) loss vector: ONE forward with +inf thresholds, then one
`torch.autograd.grad` per example with a one-hot cotangent (the graph
retained between them; a checkpointed block recomputes its forward in
each). Each backward runs the primitives' no-norm path, so a linear's
weight gradient goes through `clip_reduce` with factor 1 on the card. The
forward is the batch's, so an MoE's dispatch couples the examples as in
the reference. (`torch.func` cannot replace this: functorch refuses the
primitives' `forward(ctx, ...)` Functions, and their CUDA backward takes
no batched tensors.)

per_shard (per-device clipping) is expressed through the layout itself
(blocked groups, `ModelConfig.dp_blocks`, `dp_linear_blocked`) and then
driven as per_layer: each block is its own group with a local norm.

DP-LoRA (`trainable_key`) is ROADMAP A.10; sharded execution is A.13.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import bk
from repro_torch.core.ghost import segment_sum
from repro_torch.core.spec import P, GroupLayout, _walk, tree_leaves
from repro_torch.optim.optimizers import slices

MODES = ("non_private", "per_layer", "ghost_flat", "per_group", "naive_flat",
         "ghost_flat_twopass", "per_group_twopass")
EXECUTIONS = ("bk", "twopass")

LossFn = Callable[[Any, Any, dict], torch.Tensor]  # -> (B,)


class ClipResult(NamedTuple):
    grads: Any  # tree like params: clipped summed grads (param dtype)
    norms_sq: torch.Tensor  # (K, B) per-group per-example squared norms
    loss: torch.Tensor  # scalar mean per-example loss (pre-clipping)


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")


def base_mode(mode: str) -> str:
    """Strip the `_twopass` execution suffix off a mode name."""
    suffix = "_twopass"
    return mode[: -len(suffix)] if mode.endswith(suffix) else mode


def _rebuild(paths, values) -> dict:
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def group_clip_factors(norms_sq_groups: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """min(1, C_g / ||g_g^(i)||) with 0-norm safety: (G, B) from (G, B)
    norms² and (G,) thresholds, f32."""
    norm = torch.sqrt(norms_sq_groups.float() + 1e-12)
    return torch.clamp(c.float()[:, None] / norm, max=1.0)


def flat_clip_factors(total_norms_sq: torch.Tensor,
                      c: float | torch.Tensor) -> torch.Tensor:
    """min(1, C / ||g^(i)||): the flat-clipping per-example factor, (B,)
    f32."""
    c = torch.as_tensor(c, dtype=torch.float32, device=total_norms_sq.device)
    return torch.clamp(c / torch.sqrt(total_norms_sq.float() + 1e-12),
                       max=1.0)


def supergroup_norms(norms_sq: torch.Tensor, assignment: torch.Tensor,
                     num_supergroups: int) -> torch.Tensor:
    """(G, B) f32 norms² per supergroup: the (K, B) group norms² summed
    by `assignment` (K,) (the reference's `jax.ops.segment_sum`), in a
    fixed order (`ghost.segment_sum`)."""
    return segment_sum(norms_sq, assignment, num_supergroups)


def _grads_only(loss_fn, params, batch, thresholds_tree):
    """One backward pass for the parameter gradients under thresholds that
    request no norms (+inf or direct scales)."""
    paths, leaves = zip(*tree_leaves(params))
    val = torch.sum(loss_fn(params, batch, thresholds_tree))
    grads = bk.grad_or_zeros(val, list(leaves))
    return val.detach(), _rebuild(paths, grads)


def _norms_only(loss_fn, params, batch, layout, batch_size):
    """One backward pass for (sum loss, (K, B) norms²): the loss runs on
    detached parameters, so no primitive contracts a parameter gradient."""
    dev = next(t for _, t in tree_leaves(params)).device
    th = {k: v.requires_grad_() for k, v in layout.pack_value(
        float("inf"), batch_size, device=dev).items()}
    names = list(th)
    val = torch.sum(loss_fn(bk.detached(params), batch, th))
    norms = bk.grad_or_zeros(val, [th[k] for k in names])
    return val.detach(), layout.unpack(dict(zip(names, norms)))


def _norms_pass(loss_fn, params, batch, layout, batch_size, execution):
    """The shared first stage of ghost_flat / per_group: one backward pass
    for (sum loss, (K, B) norms²), capturing BK residuals when possible.

    Returns (val, norms, cap) with cap = (residuals, recipes) under BK, or
    None when running (or falling back to) the twopass execution."""
    cap = (bk.capture_clipped(loss_fn, params, batch, layout, batch_size)
           if execution == "bk" else None)
    if cap is not None:
        val, norms, residuals, recipes = cap
        return val, norms, (residuals, recipes)
    val, norms = _norms_only(loss_fn, params, batch, layout, batch_size)
    return val, norms, None


def _naive_group_norms(layout: GroupLayout, jac: list[dict]) -> torch.Tensor:
    """(K, B) f32 per-layout-group norms² of materialised per-example
    gradients, `jac[b]` example b's gradient tree: a stacked leaf gives
    one row per stack element, a blocked leaf one row per column block
    (the blocks after the stack), as every other mode reports them."""
    dev = next(t for _, t in tree_leaves(jac[0])).device
    cols = [torch.zeros(layout.num_groups, dtype=torch.float32, device=dev)
            for _ in jac]
    for path, node in _walk(layout._spec):
        grp = layout.group_of_leaf(path)
        for col, grads in zip(cols, jac):
            col[grp.offset: grp.offset + grp.count] += _leaf_norms_sq(
                _at(grads, path), node).reshape(-1)
    return torch.stack(cols, dim=1)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaf_norms_sq(g: torch.Tensor, node: P) -> torch.Tensor:
    """The squared norms of one example's gradient of leaf `node` by group
    element (the stack shape, then the blocks), in f32, slice by slice
    along the first axis to bound the f32 temporaries."""
    m, keep = node.blocks, node.stack + (node.blocks > 1)

    def part_sq(x):
        x = x.float()
        if m > 1:
            x = torch.movedim(x.reshape(x.shape[:-1] + (m, -1)), -2,
                              node.stack)
        return torch.sum(torch.square(x.reshape(x.shape[:keep] + (-1,))),
                         dim=-1)

    parts = [part_sq(x) for x in slices(g)]
    # slices split the stack axis of a stacked leaf, else an axis within
    # its one group element
    return torch.cat(parts) if node.stack else sum(parts)


def _per_example_grads(loss_fn, params, batch, layout, batch_size):
    """(mean loss, [example b's gradient tree for b < B]): the rows of
    the (B,) loss vector's Jacobian in the parameters' dtype, by one
    forward with +inf thresholds and one backward per example."""
    paths, leaves = zip(*tree_leaves(params))
    dev = leaves[0].device
    th = layout.pack_value(float("inf"), batch_size, device=dev)
    losses = loss_fn(params, batch, th)
    onehot = torch.eye(batch_size, dtype=losses.dtype, device=dev)
    jac = []
    for b in range(batch_size):
        grads = torch.autograd.grad(losses, leaves, grad_outputs=onehot[b],
                                    retain_graph=b < batch_size - 1,
                                    allow_unused=True)
        jac.append(_rebuild(paths, [torch.zeros_like(x) if g is None else g
                                    for x, g in zip(leaves, grads)]))
    return torch.mean(losses.detach()), jac


def _naive_contract(layout: GroupLayout, jac: list[dict],
                    f: torch.Tensor) -> dict:
    """sum_b f_b jac[b] per leaf in f32, cast to the leaf's dtype; each
    example's leaf is released once contracted."""
    paths, leaves = [], []
    for path, node in _walk(layout._spec):
        rows = [_at(grads, path[:-1]).pop(path[-1]) for grads in jac]
        leaf = torch.empty(node.shape, dtype=rows[0].dtype,
                           device=rows[0].device)
        for dst, *src in zip(slices(leaf), *(slices(r) for r in rows)):
            acc = torch.zeros(dst.shape, dtype=torch.float32,
                              device=dst.device)
            for fb, x in zip(f, src):
                acc.add_(x.float() * fb)
            dst.copy_(acc)
        del rows
        paths.append(path)
        leaves.append(leaf)
    return _rebuild(paths, leaves)


def dp_clipped_gradients(loss_fn: LossFn, params: Any, batch: Any,
                         layout: GroupLayout, *, mode: str, batch_size: int,
                         thresholds: torch.Tensor | None = None,
                         flat_threshold: float | torch.Tensor = 1.0,
                         group_assignment: torch.Tensor | None = None,
                         group_thresholds: torch.Tensor | None = None,
                         trainable_key: str | None = None,
                         execution: str = "bk") -> ClipResult:
    """Clipped summed gradients + norms under `mode`.

    params: the reference-layout tree of leaves with `requires_grad`;
    thresholds: (K,) float32 for per_layer; flat_threshold: the scalar C
    of ghost_flat and naive_flat; group_assignment: (K,) ints and
    group_thresholds: (G,) for per_group; execution: bk | twopass for
    ghost_flat / per_group. The norms of non_private are zeros (it never
    computes them). `trainable_key` (DP-LoRA) is not ported yet."""
    check_mode(mode)
    if trainable_key is not None:
        raise NotImplementedError(
            "training a parameter subtree (trainable_key, DP-LoRA) is not "
            "ported yet: ROADMAP.md item A.10")
    if execution not in EXECUTIONS:
        raise ValueError(f"execution {execution!r} not in {EXECUTIONS}")
    if mode.endswith("_twopass"):
        mode, execution = base_mode(mode), "twopass"
    paths, leaves = zip(*tree_leaves(params))
    dev = leaves[0].device

    if mode == "non_private":
        th = layout.pack_value(float("inf"), batch_size, device=dev)
        val, grads = _grads_only(loss_fn, params, batch, th)
        norms = torch.zeros((layout.num_groups, batch_size),
                            dtype=torch.float32, device=dev)
        return ClipResult(grads, norms, val / batch_size)

    if mode == "per_layer":
        if thresholds is None:
            raise ValueError("per_layer mode needs thresholds (K,)")
        th = {k: v.requires_grad_() for k, v in
              layout.pack(thresholds.detach(), batch_size).items()}
        names = list(th)
        val = torch.sum(loss_fn(params, batch, th))
        out = bk.grad_or_zeros(val, list(leaves) + [th[k] for k in names])
        grads, norm_leaves = out[:len(leaves)], out[len(leaves):]
        norms = layout.unpack(dict(zip(names, norm_leaves)))
        return ClipResult(_rebuild(paths, grads), norms,
                          val.detach() / batch_size)

    if mode == "naive_flat":  # the materialising oracle
        loss, jac = _per_example_grads(loss_fn, params, batch, layout,
                                       batch_size)
        norms = _naive_group_norms(layout, jac)
        f = flat_clip_factors(torch.sum(norms, dim=0), flat_threshold)
        return ClipResult(_naive_contract(layout, jac, f), norms, loss)

    if mode == "per_group" and (group_assignment is None
                                or group_thresholds is None):
        raise ValueError("per_group mode needs group_assignment + "
                         "group_thresholds")
    val, norms, cap = _norms_pass(loss_fn, params, batch, layout, batch_size,
                                  execution)
    if mode == "ghost_flat":
        f = flat_clip_factors(torch.sum(norms, dim=0), flat_threshold)
        f_rows = f[None].expand(layout.num_groups, batch_size)
    else:  # per_group
        assign = torch.as_tensor(group_assignment, device=dev).long()
        super_norms = supergroup_norms(norms, assign,
                                       group_thresholds.shape[0])
        f_rows = group_clip_factors(super_norms, group_thresholds)[assign]
    if cap is not None:  # BK epilogue: contract the cached residuals
        residuals, recipes = cap
        grads = bk.contract_clipped(layout, recipes, residuals, f_rows)
    else:  # twopass (or BK fallback): second backward, direct scales
        _, grads = _grads_only(loss_fn, params, batch,
                               layout.pack_rows(-f_rows))
    return ClipResult(grads, norms, val / batch_size)

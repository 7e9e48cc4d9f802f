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

Sharded execution (`sharded_clipped_gradients`, below) runs the same
drivers on every rank of a `launch.mesh.Mesh`: per-device clipping with
shard-local norms, ghost_flat's one norm all-reduce, and the BK
epilogue's interleaved gradient all-reduces.

DP-LoRA (`trainable_key`): only `params[trainable_key]` trains (the
adapters, `core.lora`), and the layout's spec is that subtree. Every
mode then runs on the rest of the tree detached, so a frozen linear's
backward passes dx only: no ghost norm, no weight gradient, and the
clipped grads come back as `{trainable_key: ...}`. BK applies when the
layout covers exactly the trainable subtree, as in the reference. The
sharded driver takes it too: every rank clips the subtree, and only its
leaves are all-reduced (no base leaf crosses the wire).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import bk
from repro_torch.core.ghost import segment_sum
from repro_torch.core.quantile import clip_counts
from repro_torch.core.scopes import CLIP_SCOPE, scoped
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


@scoped(CLIP_SCOPE)
def group_clip_factors(norms_sq_groups: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """min(1, C_g / ||g_g^(i)||) with 0-norm safety: (G, B) from (G, B)
    norms² and (G,) thresholds, f32. Marked `dp_clip_factor` for the
    static audit (`analysis.taint`), as `flat_clip_factors`."""
    norm = torch.sqrt(norms_sq_groups.float() + 1e-12)
    return torch.clamp(c.float()[:, None] / norm, max=1.0)


@scoped(CLIP_SCOPE)
def flat_clip_factors(total_norms_sq: torch.Tensor,
                      c: float | torch.Tensor) -> torch.Tensor:
    """min(1, C / ||g^(i)||): the flat-clipping per-example factor, (B,)
    f32. The one marked implementation that ghost_flat, naive_flat and
    sharded clipping share: the static audit (`analysis.taint`) proves the
    clip by its `dp_clip_factor` scope, so no call site derives the factor
    inline."""
    c = torch.as_tensor(c, dtype=torch.float32, device=total_norms_sq.device)
    return torch.clamp(c / torch.sqrt(total_norms_sq.float() + 1e-12),
                       max=1.0)


def supergroup_norms(norms_sq: torch.Tensor, assignment: torch.Tensor,
                     num_supergroups: int) -> torch.Tensor:
    """(G, B) f32 norms² per supergroup: the (K, B) group norms² summed
    by `assignment` (K,) (the reference's `jax.ops.segment_sum`), in a
    fixed order (`ghost.segment_sum`)."""
    return segment_sum(norms_sq, assignment, num_supergroups)


def _trainable_leaves(params, trainable_key):
    """(path, leaf) of the leaves that train: every leaf, or those of
    `params[trainable_key]` (paths from the root either way)."""
    if trainable_key is None:
        return list(tree_leaves(params))
    return list(tree_leaves(params[trainable_key], (trainable_key,)))


def _freeze_rest(params, trainable_key):
    """`params` with every subtree but `trainable_key` detached: a frozen
    primitive is asked for no parameter gradient (and so computes none)."""
    if trainable_key is None:
        return params
    if trainable_key not in params:
        raise KeyError(f"trainable_key {trainable_key!r} is not a subtree "
                       f"of the parameters ({sorted(params)})")
    return {k: v if k == trainable_key else bk.detached(v)
            for k, v in params.items()}


def _grads_only(loss_fn, params, batch, thresholds_tree,
                trainable_key=None):
    """One backward pass for the parameter gradients under thresholds that
    request no norms (+inf or direct scales)."""
    paths, leaves = zip(*_trainable_leaves(params, trainable_key))
    val = torch.sum(loss_fn(params, batch, thresholds_tree))
    grads = bk.grad_or_zeros(val, list(leaves))
    return val.detach(), _rebuild(paths, grads)


def _grads_and_norms(loss_fn, params, batch, layout, thresholds,
                     batch_size, trainable_key=None):
    """per_layer's one backward pass: (sum loss, clipped grads, (K, B)
    norms²), one `autograd.grad` over the parameter leaves AND the
    threshold leaves."""
    paths, leaves = zip(*_trainable_leaves(params, trainable_key))
    th = {k: v.requires_grad_() for k, v in
          layout.pack(thresholds.detach(), batch_size).items()}
    names = list(th)
    val = torch.sum(loss_fn(params, batch, th))
    out = bk.grad_or_zeros(val, list(leaves) + [th[k] for k in names])
    grads, norm_leaves = out[:len(leaves)], out[len(leaves):]
    norms = layout.unpack(dict(zip(names, norm_leaves)))
    return val.detach(), _rebuild(paths, grads), norms


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


def _bk_capture_ok(layout: GroupLayout, trainable_key) -> bool:
    """BK's epilogue rebuilds the grads by walking the layout's spec, so
    the spec must cover exactly the trainable tree: the whole parameter
    tree, or the DP-LoRA `{trainable_key: ...}` sub-spec."""
    return trainable_key is None or set(layout._spec) == {trainable_key}


def _norms_pass(loss_fn, params, batch, layout, batch_size, execution,
                trainable_key=None):
    """The shared first stage of ghost_flat / per_group: one backward pass
    for (sum loss, (K, B) norms²), capturing BK residuals when possible.

    Returns (val, norms, cap) with cap = (residuals, recipes) under BK, or
    None when running (or falling back to) the twopass execution."""
    cap = None
    if execution == "bk":
        if _bk_capture_ok(layout, trainable_key):
            cap = bk.capture_clipped(loss_fn, params, batch, layout,
                                     batch_size)
        else:
            bk._fallback(f"the layout's spec {sorted(layout._spec)} is not "
                         f"the trainable subtree {trainable_key!r}")
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


def _per_example_grads(loss_fn, params, batch, layout, batch_size,
                       trainable_key=None):
    """(mean loss, [example b's gradient tree for b < B]): the rows of
    the (B,) loss vector's Jacobian in the parameters' dtype, by one
    forward with +inf thresholds and one backward per example."""
    paths, leaves = zip(*_trainable_leaves(params, trainable_key))
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
    computes them). trainable_key: train `params[trainable_key]` only
    (DP-LoRA: the layout's spec is that subtree, the rest runs detached,
    and the grads come back as `{trainable_key: ...}`)."""
    check_mode(mode)
    if execution not in EXECUTIONS:
        raise ValueError(f"execution {execution!r} not in {EXECUTIONS}")
    if mode.endswith("_twopass"):
        mode, execution = base_mode(mode), "twopass"
    params = _freeze_rest(params, trainable_key)
    tk = trainable_key
    paths, leaves = zip(*tree_leaves(params))
    dev = leaves[0].device

    if mode == "non_private":
        th = layout.pack_value(float("inf"), batch_size, device=dev)
        val, grads = _grads_only(loss_fn, params, batch, th, tk)
        norms = torch.zeros((layout.num_groups, batch_size),
                            dtype=torch.float32, device=dev)
        return ClipResult(grads, norms, val / batch_size)

    if mode == "per_layer":
        if thresholds is None:
            raise ValueError("per_layer mode needs thresholds (K,)")
        val, grads, norms = _grads_and_norms(loss_fn, params, batch, layout,
                                             thresholds, batch_size, tk)
        return ClipResult(grads, norms, val / batch_size)

    if mode == "naive_flat":  # the materialising oracle
        loss, jac = _per_example_grads(loss_fn, params, batch, layout,
                                       batch_size, tk)
        norms = _naive_group_norms(layout, jac)
        f = flat_clip_factors(torch.sum(norms, dim=0), flat_threshold)
        return ClipResult(_naive_contract(layout, jac, f), norms, loss)

    if mode == "per_group" and (group_assignment is None
                                or group_thresholds is None):
        raise ValueError("per_group mode needs group_assignment + "
                         "group_thresholds")
    val, norms, cap = _norms_pass(loss_fn, params, batch, layout, batch_size,
                                  execution, tk)
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
                               layout.pack_rows(-f_rows), tk)
    return ClipResult(grads, norms, val / batch_size)


# ---------------------------------------------------------------------------
# Sharded execution: per-device clipping on a mesh of ranks.
#
# Every rank of a `launch.mesh.Mesh` runs this body on its LOCAL batch
# shard (data axes) with its model-axis coordinate m, as the reference's
# shard_map body does. `shard_assignment` maps every layout group to its
# owning model shard (launch.sharding.group_shard_assignment), and the
# driver keeps the paper's Sec. 4 communication contract, readable in the
# mesh's collective log:
#
#   per_group (per-DEVICE clipping): shard m reduces norms² over ONLY the
#       groups it owns and computes its clip factor locally: no
#       model-axis collective before the factors exist;
#   ghost_flat: the total per-example norm² needs every shard's partial:
#       exactly one (B_local,) f32 all-reduce over the model axis, site
#       `flat_norm_psum`;
#   epilogue: each shard contracts every layer with its masked factor rows
#       (unowned groups' rows are zero) and the clipped sums are joined
#       by ONE all-reduce over data + model per stacked leaf, issued
#       asynchronously and waited after the next leaf's contraction
#       (bk.contract_clipped psum_axes).
#
# The loss backward runs data-parallel (parameters replicated at compute
# time; the launcher may STORE them model-sharded between steps, see
# launch.sharding). What this engine distributes over the model axis is
# the clipping bookkeeping: norm reductions, clip factors and the
# scale-and-contract epilogue.
# ---------------------------------------------------------------------------


class ShardedClipResult(NamedTuple):
    grads: Any  # GLOBALLY summed clipped grads (replicated)
    norms_sq: torch.Tensor  # (K, B_local) this data shard's examples
    loss: torch.Tensor  # scalar GLOBAL mean per-example loss
    counts: torch.Tensor  # (G,) global clip counts (replicated)


def _psum_tree(tree, axes, mesh):
    """One all-reduce per leaf (site `grad_psum`, each marked `reduce
    <path>` in the trace just before its issue), all issued before the
    first wait. `tree` holds the trainable leaves only."""
    pending = []
    for path, g in tree_leaves(tree):
        mesh.mark("reduce " + "/".join(path))
        pending.append((path, mesh.psum(g, axes, site="grad_psum",
                                        async_op=True)))
    return _rebuild([p for p, _ in pending], [h.wait() for _, h in pending])


def sharded_clipped_gradients(
        loss_fn: LossFn, params: Any, batch: Any, layout: GroupLayout, *,
        mode: str, batch_size: int, data_size: int, mesh,
        data_axes: tuple | None = None, model_axis: str = "model",
        shard_assignment: torch.Tensor | None = None,
        thresholds: torch.Tensor | None = None,
        flat_threshold: float | torch.Tensor = 1.0,
        group_thresholds: torch.Tensor | None = None,
        trainable_key: str | None = None,
        execution: str = "bk") -> ShardedClipResult:
    """`dp_clipped_gradients` on one rank of `mesh` (see the comment
    above). `batch` is this rank's LOCAL batch shard of `batch_size`
    examples, `data_size` the number of data-plane shards (the global
    batch is both); `data_axes` default to the mesh's. trainable_key:
    as `dp_clipped_gradients` (DP-LoRA's `"lora"`): the grads, and so
    every `grad_psum`, cover `params[trainable_key]` alone."""
    check_mode(mode)
    if mode.endswith("_twopass"):
        mode, execution = base_mode(mode), "twopass"
    if data_axes is None:
        data_axes = tuple(a for a in mesh.axis_names if a != model_axis)
    data_axes = tuple(data_axes)
    all_axes = data_axes + (model_axis,)
    params = _freeze_rest(params, trainable_key)
    tk = trainable_key
    dev = next(t for _, t in tree_leaves(params)).device
    global_b = batch_size * data_size

    def mean_loss(val):
        return mesh.psum(val.detach().float().reshape(1), data_axes,
                         site="loss_psum")[0] / global_b

    if mode == "non_private":
        th = layout.pack_value(float("inf"), batch_size, device=dev)
        val, grads = _grads_only(loss_fn, params, batch, th, tk)
        norms = torch.zeros((layout.num_groups, batch_size),
                            dtype=torch.float32, device=dev)
        return ShardedClipResult(_psum_tree(grads, data_axes, mesh), norms,
                                 mean_loss(val),
                                 torch.zeros((1,), device=dev))

    if mode == "per_layer":
        if thresholds is None:
            raise ValueError("per_layer mode needs thresholds (K,)")
        val, grads, norms = _grads_and_norms(loss_fn, params, batch, layout,
                                             thresholds, batch_size, tk)
        counts = mesh.psum(clip_counts(norms, thresholds), data_axes,
                           site="clip_count_psum")
        return ShardedClipResult(_psum_tree(grads, data_axes, mesh), norms,
                                 mean_loss(val), counts)

    if mode not in ("ghost_flat", "per_group"):
        raise ValueError(
            f"sharded execution supports non_private/per_layer/ghost_flat/"
            f"per_group, not {mode!r} (naive_flat is a single-device oracle)")
    if shard_assignment is None:
        raise ValueError("sharded flat/group modes need shard_assignment")
    if mode == "per_group" and group_thresholds is None:
        raise ValueError("per_group mode needs group_thresholds (M,)")

    val, norms, cap = _norms_pass(loss_fn, params, batch, layout,
                                  batch_size, execution, tk)
    midx = mesh.axis_index(model_axis)
    assign = torch.as_tensor(shard_assignment, device=dev).long()
    own = (assign == midx).float()  # (K,)
    # this shard's contribution: norms² of the groups it owns only
    partial = torch.sum(norms * own[:, None], dim=0)  # (B_local,)

    if mode == "ghost_flat":
        c = torch.as_tensor(flat_threshold, dtype=torch.float32, device=dev)
        # THE flat-clipping model-axis collective: the total per-example
        # norm² crosses every model shard before any factor exists
        total = mesh.psum(partial, (model_axis,), site="flat_norm_psum")
        f = flat_clip_factors(total, c)
        mesh.mark("factors")
        f_rows = f[None, :] * own[:, None]  # masked: the owner contracts
        counts = mesh.psum(torch.sum((total <= c * c).float())[None],
                           data_axes, site="clip_count_psum")
        f_full = f[None].expand(layout.num_groups, batch_size)
    else:  # per_group == per-DEVICE: factors close over shard-local norms
        num_super = group_thresholds.shape[0]
        c_m = group_thresholds[midx].float()
        f_m = flat_clip_factors(partial, c_m)  # (B_local,)
        mesh.mark("factors")
        f_rows = f_m[None, :] * own[:, None]
        slot = (torch.arange(num_super, device=dev) == midx).float()
        counts = mesh.psum(slot * torch.sum((partial <= c_m * c_m).float()),
                           all_axes, site="clip_count_psum")
        f_full = None  # gathered below only if the twopass fallback runs

    if cap is not None:  # BK: masked, collective-overlapped epilogue
        residuals, recipes = cap
        grads = bk.contract_clipped(layout, recipes, residuals, f_rows,
                                    psum_axes=all_axes, mesh=mesh)
        return ShardedClipResult(grads, norms, mean_loss(val), counts)

    # twopass fallback: the second backward produces every group's grads
    # on every shard, so it needs the FULL factor rows; gathering them is
    # factor traffic AFTER the factors exist, not norm traffic
    if f_full is None:
        f_full = mesh.psum(f_rows.contiguous(), (model_axis,),
                           site="factor_gather_psum")
    _, grads = _grads_only(loss_fn, params, batch, layout.pack_rows(-f_full),
                           tk)
    return ShardedClipResult(_psum_tree(grads, data_axes, mesh), norms,
                             mean_loss(val), counts)

"""Book-keeping (BK) execution: one backward pass for the flat and
per-group clipping modes. The counterpart of `repro.core.bk`.

Flat and per-group clipping need clip factors that depend on the TOTAL
per-example norm across groups, known only once backpropagation is done:
the two-pass execution runs a second backward for the clipped sums. Bu et
al., *Differentially Private Optimization on Large Model at Small Cost*
(arXiv:2210.00038), make that pass redundant: cache each layer's ghost
residuals, the activations A_i and output cotangents G_i, during the one
norm-computing backward, then build every clipped weight gradient with
one scale-and-contract per layer,

    dW = sum_i f_i A_iᵀ G_i.

A `BkChannel` takes the place of a group's threshold tensor in the loss:
it carries the (+inf) threshold tensor, whose gradient is the group's
norms² as in every mode, and the group's residual *sinks*. Its `unbind`
gives the per-layer channels of a stacked group, which share the stacked
sinks and write their own row, so the epilogue makes ONE `scale_contract`
call per stacked leaf.

Pipeline (driven by `core.clipping.dp_clipped_gradients`):

  1. `capture_clipped` runs the loss forward on detached parameters with
     channel thresholds, inside `backend.scoped(capture_residuals=True)`.
     Each DP primitive records its group's residual shapes (a `Recipe`)
     as it runs: there is no `jax.eval_shape` here, so the capture forward
     is the probe. Then the sinks are allocated and ONE backward yields
     the norms² and fills the sinks. Under activation checkpointing the
     recomputed forward runs after the recording has closed, so no group
     is counted twice.
  2. `dp_clipped_gradients` computes the per-example clip factors.
  3. `contract_clipped`, the epilogue, builds the clipped summed gradients
     from the sinks (`scale_contract` in the backend engine: the
     hand-written kernel on the card).

Two layouts fall back to the two-pass execution, with a warning, as in
the reference: shared-site parameters (`sensitivity_mult > 1`) and a group
consumed at more than one call site, whose one threshold would sum the
residuals of several sites.

Sharded execution (`core.clipping.sharded_clipped_gradients`) runs the
epilogue on every rank with its masked factor rows and passes
`psum_axes`: each stacked leaf's clipped sum is then all-reduced over
those mesh axes asynchronously, and waited on after the NEXT leaf's
contraction, so each layer's reduction overlaps the next layer's
`scale_contract`, as the reference interleaves its psums.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import warnings
from typing import Any

import torch

from repro_torch.core.ghost import expert_clipped_sum, grouped_clipped_sum
from repro_torch.core.spec import GroupLayout, P, tree_leaves
from repro_torch.kernels import backend

# recipe kinds of the reference that no ported primitive records yet
_NOT_PORTED = {"linear_blocked": "A.16", "shift": "A.8", "broadcast": "A.8"}


# ---------------------------------------------------------------------------
# The channel.
# ---------------------------------------------------------------------------


class BkChannel:
    """Threshold tensor + residual sinks of one clipping group.

    `c` is the encoded-threshold tensor (the group's stack shape + (B,),
    or one row of it); `sink` maps a residual name to its stacked tensor,
    shared by every row of the group and filled in by `capture_clipped`
    once the capture forward has recorded the shapes; `row` is the index
    of this view within the stack (() for the whole group)."""

    def __init__(self, c: torch.Tensor, group: str,
                 sink: dict | None = None, row: tuple[int, ...] = ()):
        self.c = c
        self.group = group
        self.sink = {} if sink is None else sink
        self.row = row

    def unbind(self, dim: int = 0) -> tuple["BkChannel", ...]:
        """Per-row channels along the leading stack axis, as
        `Tensor.unbind(0)` gives per-layer thresholds."""
        if dim != 0:
            raise ValueError("a BkChannel unbinds along its stack axis 0")
        return tuple(BkChannel(ci, self.group, self.sink, self.row + (i,))
                     for i, ci in enumerate(self.c.unbind(0)))


def thresholds_of(c):
    """The encoded-threshold tensor of a maybe-channel threshold arg."""
    return c.c if isinstance(c, BkChannel) else c


def channel_of(c) -> BkChannel | None:
    return c if isinstance(c, BkChannel) else None


def require_capture_scope(channel: BkChannel, eng) -> None:
    """Refuse a channel whose forward ran outside the capture scope: a
    capture pass returns no parameter gradients."""
    if not eng.capture_residuals:
        raise RuntimeError(
            f"BkChannel for group {channel.group!r} reached a DP primitive "
            "outside backend.scoped(capture_residuals=True); capture passes "
            "return no parameter gradients and must only be driven by "
            "repro_torch.core.bk.capture_clipped")


def stash(channel: BkChannel, **values: torch.Tensor) -> None:
    """Write one call's residuals into the channel's row of its sinks."""
    if not channel.sink:
        raise RuntimeError(f"BkChannel for group {channel.group!r} has no "
                           "sinks: only capture_clipped allocates them")
    for name, v in values.items():
        channel.sink[name][channel.row].copy_(v)


# ---------------------------------------------------------------------------
# Recording the recipes during the capture forward.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Recipe:
    """What one DP-primitive call site stashes for one clipping group."""

    kind: str  # linear | lora | embed | scale | expert | expert_grouped
    c_ndim: int  # rank of the PER-CALL threshold (after unbinding)
    sinks: dict  # sink name -> (per-call shape, dtype)
    extras: dict  # kind-specific statics (vocab)
    count: int = 1  # consumptions per step of one row; > 1 -> no BK
    rows: set = dataclasses.field(default_factory=set)  # rows consumed


_RECORDER: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "bk_recorder", default=None)


@contextlib.contextmanager
def _recording():
    rec: dict[str, Recipe] = {}
    token = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(token)


def _record(channel: BkChannel, kind: str, sinks: dict, **extras) -> None:
    rec = _RECORDER.get()
    if rec is None:
        return
    name = channel.group
    if name not in rec:
        rec[name] = Recipe(kind, channel.c.dim(), sinks, extras)
    elif channel.row in rec[name].rows:
        rec[name].count += 1  # one row, several call sites
    rec[name].rows.add(channel.row)


def _tfold(x: torch.Tensor) -> int:
    """Rows per example after the primitives' (B, -1, d) reshape."""
    return math.prod(x.shape[1:-1]) if x.dim() > 2 else 1


# -- kind-specific recorders, called from the DP primitives' forward --------


def record_linear(c: BkChannel, w, x) -> None:
    bsz, tf, din, dout = x.shape[0], _tfold(x), x.shape[-1], w.shape[-1]
    gdt = torch.result_type(x, w)
    _record(c, "linear", {"a": ((bsz, tf, din), x.dtype),
                          "g": ((bsz, tf, dout), gdt)})


def record_lora(c: BkChannel, a, b, x) -> None:
    """An adapter pair (`core.lora.dp_lora_linear`): leaf `a` contracts
    (x, s g Bᵀ), leaf `b` (x A, s g)."""
    bsz, tf = x.shape[0], _tfold(x)
    din, r, dout = a.shape[-2], a.shape[-1], b.shape[-1]
    gdt = torch.result_type(x, b)
    _record(c, "lora", {"a1": ((bsz, tf, din), x.dtype),
                        "g1": ((bsz, tf, r), gdt),
                        "a2": ((bsz, tf, r), x.dtype),
                        "g2": ((bsz, tf, dout), gdt)})


def record_embed(c: BkChannel, table, ids) -> None:
    bsz = ids.shape[0]
    tf = math.prod(ids.shape[1:]) if ids.dim() > 1 else 1
    # token ids stay integers: the reference carries them as floats only
    # because a JAX cotangent must be one
    _record(c, "embed", {"g": ((bsz, tf, table.shape[-1]), table.dtype),
                         "ids": ((bsz, tf), ids.dtype)},
            vocab=table.shape[0])


def record_scale(c: BkChannel, s, xhat) -> None:
    _record(c, "scale",
            {"pg": ((xhat.shape[0], xhat.shape[-1]), torch.float32)})


def record_expert(c: BkChannel, w, x) -> None:
    e, cap, din = x.shape
    gdt = torch.result_type(x, w)
    # the slots' example ids stay integers (the reference carries them as
    # floats, a JAX cotangent must be one)
    _record(c, "expert", {"x": ((e, cap, din), x.dtype),
                          "g": ((e, cap, w.shape[-1]), gdt),
                          "seg": ((e, cap), torch.long)})


def record_expert_grouped(c: BkChannel, w, x) -> None:
    bsz, e, cap, din = x.shape
    gdt = torch.result_type(x, w)
    _record(c, "expert_grouped", {"x": ((bsz, e, cap, din), x.dtype),
                                  "g": ((bsz, e, cap, w.shape[-1]), gdt)})


# ---------------------------------------------------------------------------
# Capture: one backward pass -> norms + residuals.
# ---------------------------------------------------------------------------


def _fallback(reason: str) -> None:
    warnings.warn(f"BK capture cannot apply ({reason}); falling back to the "
                  "twopass execution for this step", stacklevel=3)


def build_channels(layout: GroupLayout, batch_size: int, *,
                   device: str | torch.device = "cpu"
                   ) -> dict[str, BkChannel]:
    """One channel per group: +inf thresholds that require grad, and sinks
    still empty (`capture_clipped` allocates them from the recipes)."""
    inf_tree = layout.pack_value(float("inf"), batch_size, device=device)
    return {k: BkChannel(v.requires_grad_(), k) for k, v in inf_tree.items()}


def _allocate_sinks(channels: dict[str, BkChannel], recipes: dict) -> None:
    """Zero sinks of the stacked shape: the leaf's stack prefix (its rank
    minus the per-call threshold rank) + the per-call residual shape."""
    for name, r in recipes.items():
        ch = channels[name]
        prefix = tuple(ch.c.shape[:ch.c.dim() - r.c_ndim])
        for k, (shape, dtype) in r.sinks.items():
            ch.sink[k] = torch.zeros(prefix + tuple(shape), dtype=dtype,
                                     device=ch.c.device)


def capture_clipped(loss_fn, params, batch, layout: GroupLayout,
                    batch_size: int):
    """One backward pass: (sum loss, (K, B) norms², residuals, recipes),
    or None (after a warning) where BK cannot apply."""
    if any(g.sensitivity_mult > 1 for g in layout.groups):
        # shared-site params: one threshold consumed at several sites would
        # sum residuals across sites
        _fallback("a group with sensitivity_mult > 1")
        return None
    leaves = [t for _, t in tree_leaves(params)]
    channels = build_channels(layout, batch_size, device=leaves[0].device)
    frozen = detached(params)
    with backend.scoped(capture_residuals=True), _recording() as recipes:
        val = torch.sum(loss_fn(frozen, batch, channels))
    reused = sorted(k for k, r in recipes.items() if r.count > 1)
    if reused:
        _fallback(f"group(s) {reused} consumed at more than one call site")
        return None
    _allocate_sinks(channels, recipes)
    names = list(channels)
    norms = grad_or_zeros(val, [channels[k].c for k in names])
    residuals = {k: channels[k].sink for k in recipes}
    return (val.detach(), layout.unpack(dict(zip(names, norms))), residuals,
            recipes)


def grad_or_zeros(val, inputs) -> list[torch.Tensor]:
    """d val / d inputs, zeros for an input the loss never used (as JAX
    gives: a group the loss never consumes has zero norms and grads)."""
    grads = torch.autograd.grad(val, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, grads)]


def detached(tree):
    """The parameter tree with every leaf detached: a loss run on it asks
    no primitive for a parameter gradient."""
    if isinstance(tree, dict):
        return {k: detached(v) for k, v in tree.items()}
    return tree.detach()


# ---------------------------------------------------------------------------
# Epilogue: scale-and-contract the cached residuals into clipped grads.
# ---------------------------------------------------------------------------


def _fold(x: torch.Tensor, per_call_ndim: int) -> torch.Tensor:
    """Collapse the stack prefix into one leading axis of size S (>= 1)."""
    prefix = x.shape[:x.dim() - per_call_ndim]
    return x.reshape((math.prod(prefix),) + x.shape[x.dim() - per_call_ndim:])


def _leaf_grad(layout: GroupLayout, recipes, residuals, f_rows, node: P,
               path, eng) -> torch.Tensor:
    gname = layout._leaf_group[path]
    grp = layout.group(gname)
    r = recipes.get(gname)
    if r is None:
        return torch.zeros(node.shape, dtype=node.dtype, device=f_rows.device)
    if r.kind in _NOT_PORTED:
        raise NotImplementedError(
            f"BK recipe kind {r.kind!r} is not ported yet: ROADMAP.md item "
            f"{_NOT_PORTED[r.kind]}")
    sink = residuals[gname]
    bsz = f_rows.shape[-1]
    f = f_rows[grp.offset: grp.offset + grp.count].reshape(
        grp.stack_shape + (bsz,)).float()
    per_elem = len(node.shape) - node.stack  # leaf rank below the stack

    if r.kind == "lora":
        # the adapter pair: leaf 'a' <- (x, s g Bᵀ), leaf 'b' <- (x A, s g)
        a_s, g_s = ("a1", "g1") if path[-1] == "a" else ("a2", "g2")
        dw = eng.scale_contract(_fold(sink[a_s], 3), _fold(sink[g_s], 3),
                                _fold(f, 1))
        return dw.reshape(node.shape).to(node.dtype)

    if r.kind == "linear":
        g4, f2 = _fold(sink["g"], 3), _fold(f, 1)
        if per_elem == 2:  # the weight
            dw = eng.scale_contract(_fold(sink["a"], 3), g4, f2)
            return dw.reshape(node.shape).to(node.dtype)
        db = torch.einsum("sbto,sb->so", g4.float(), f2)
        return db.reshape(node.shape).to(node.dtype)

    if r.kind == "embed":
        g4, ids3, f2 = _fold(sink["g"], 3), _fold(sink["ids"], 2), _fold(f, 1)
        dt = [eng.clipped_sum_embed(ids3[s], g4[s], f2[s], r.extras["vocab"])
              for s in range(g4.shape[0])]
        dt = dt[0][None] if len(dt) == 1 else torch.stack(dt)
        return dt.reshape(node.shape).to(node.dtype)

    if r.kind == "scale":
        pg = sink["pg"]  # prefix + (B,) + per-call param shape
        s_ = math.prod(pg.shape[:pg.dim() - (1 + per_elem)])
        out = torch.einsum("sbr,sb->sr", pg.reshape(s_, bsz, -1).float(),
                           f.reshape(s_, bsz))
        return out.reshape(node.shape).to(node.dtype)

    if r.kind in ("expert", "expert_grouped"):
        # one layer's slice at a time in f32, cast into the leaf as it
        # goes: the whole stack's f32 products (8 GB for granite's w_gu)
        # and f32 copies of every sink never coexist. The sinks carry
        # prefix + (E, C, d) (grouped: (B, E, C, d)) and the group's stack
        # shape ends in (E,), so the factors fold to (S, E, B)
        grouped = r.kind == "expert_grouped"
        x4 = _fold(sink["x"], 4 if grouped else 3)
        g4 = _fold(sink["g"], 4 if grouped else 3)
        seg = None if grouped else _fold(sink["seg"], 2)
        f3 = f.reshape(x4.shape[0], -1, bsz)
        out = torch.empty((x4.shape[0],) + tuple(node.shape[-3:]),
                          dtype=node.dtype, device=f_rows.device)
        for s_ in range(x4.shape[0]):
            if grouped:
                dw = grouped_clipped_sum(x4[s_].float(), g4[s_].float(),
                                         f3[s_])
            else:
                dw = expert_clipped_sum(x4[s_].float(), g4[s_].float(),
                                        seg[s_], f3[s_])
            out[s_].copy_(dw)
            del dw  # before the next slice's product is allocated
        return out.reshape(node.shape)

    raise ValueError(f"unknown BK recipe kind {r.kind!r}")


def contract_clipped(layout: GroupLayout, recipes: dict, residuals: dict,
                     f_rows: torch.Tensor, *, eng=None, psum_axes=None,
                     mesh=None) -> Any:
    """Clipped summed grads from cached residuals + (K, B) f32 clip
    factors: a tree matching the layout's spec (the trainable tree the
    two-pass execution produces), in the spec leaf dtypes.

    psum_axes (sharded execution, with the rank's `mesh`): every leaf's
    contraction is all-reduced over those mesh axes (site `grad_psum`),
    issued asynchronously as soon as the leaf is contracted and waited on
    after the next leaf's contraction."""
    eng = eng or backend.active()

    def build(node, path):
        if isinstance(node, P):
            return _leaf_grad(layout, recipes, residuals, f_rows, node,
                              path, eng)
        return {k: build(v, path + (k,)) for k, v in node.items()}

    if psum_axes is None:
        return build(layout._spec, ())
    reduced: dict[tuple, torch.Tensor] = {}
    pending = None  # (path, handle) of the previous leaf's all-reduce
    for path, node in _spec_leaves(layout._spec):
        cur = _leaf_grad(layout, recipes, residuals, f_rows, node, path, eng)
        mesh.mark("contract " + "/".join(path))
        handle = mesh.psum(cur, psum_axes, site="grad_psum", async_op=True)
        if pending is not None:
            reduced[pending[0]] = pending[1].wait()
        pending = (path, handle)
    if pending is not None:
        reduced[pending[0]] = pending[1].wait()

    def rebuild(node, path):
        if isinstance(node, P):
            return reduced[path]
        return {k: rebuild(v, path + (k,)) for k, v in node.items()}

    return rebuild(layout._spec, ())


def _spec_leaves(node, path=()):
    """(path, P) of every leaf of a spec tree, in its key order."""
    if isinstance(node, P):
        yield path, node
        return
    for k, v in node.items():
        yield from _spec_leaves(v, path + (k,))

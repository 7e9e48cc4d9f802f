"""DP layer primitives: clipping fused into backpropagation.

The counterpart of `repro.core.dp_layers` (the paper's Sec. 3.1: a layer's
gradient is clipped as soon as backpropagation reaches it). Each primitive
is a `torch.autograd.Function` whose backward

  1. computes per-example gradient norms² without per-example gradients
     (the ghost ops of the engine, `repro_torch.kernels.backend`),
  2. forms clip factors and returns the clipped, summed parameter gradient
     from one fused f32 contraction, cast to the parameter's dtype,
  3. returns the UNCLIPPED input cotangent (Algorithm 1, line 11),
  4. returns the per-example norms² as the gradient of the threshold `c`
     (B,): one `torch.autograd.grad` over (params, thresholds) yields the
     clipped gradients AND every group's norms.

Threshold encoding:  c > 0 clip to c;  c == +inf no clipping;  c < 0
direct scale |c|. PyTorch has no dead-code elimination, so each backward
computes only what is asked of it:

  * the norms only when the threshold's gradient is asked for; a
    threshold passed without `requires_grad` must then be +inf or a
    direct scale (a finite c > 0 there gives NaN gradients rather than a
    skipped clip);
  * the clipped sum only when the parameter's gradient is asked for: the
    norms-only passes (the two-pass modes' first pass) run the loss on
    detached parameters and skip every contraction, as XLA drops them in
    the reference.

Book-keeping capture (`repro_torch.core.bk`): when the threshold arrives
as a `bk.BkChannel` (only inside `backend.scoped(capture_residuals=True)`,
driven by `bk.capture_clipped`), the backward returns the norms² as the
threshold's gradient and, instead of contracting a parameter gradient,
writes the ghost residuals (activations and output cotangents, or the
per-example gradient of a gain) into the channel's sinks. It returns no
parameter gradient: the BK epilogue (`bk.contract_clipped`) builds them.
The channel's threshold tensor stays an argument of `Function.apply`, so
its gradient flows back to the stacked threshold leaf.

The engine and the channel are read in the forward, in the caller's
scope, and kept on the context: the backward of CUDA tensors runs on
autograd's device thread, which does not see the caller's
`backend.scoped(...)`. Under activation checkpointing the forward runs
again during backward, but the backward that runs is the first forward's,
so the norms and residuals arrive once.

`dp_linear_blocked` clips each of M column ('out') or row ('in') blocks
of one weight to its own threshold (per-shard clipping); its BK capture
stashes the linear's activations and cotangents, its (B, M) norms² from
the blocked ghost norm (`linear_norms_sq_blocked`), and the epilogue
contracts each stack slice with its (B, M) factors. `dp_expert_linear`
(flat dispatch) and
`dp_expert_linear_grouped` (per-example buffers) clip each expert of an
MoE layer's stacked weight to its own threshold, with exact per-example
norms through the token dispatch; their BK capture stashes the slots'
activations and cotangents (and the flat one the slots' example ids).

`dp_shift` (y = x + b, a bias of its own group) and `dp_broadcast` (the
broadcast trick for small parameters of any shape: the parameter
expanded to a leading batch axis, whose cotangent IS the per-example
gradient) carry the recurrent families' vectors (Mamba2's conv weight,
dt bias, decay and skip; RWKV-6's token-shift mixes, decay base and
bonus). Their BK capture stashes the (B, ...) per-example gradient
itself, f32.

`LINEAR_CALLS` counts the linears' (`DPLinear`, `DPLinearBlocked`,
`core.lora.DPLoraLinear`) forwards that join the autograd graph outside a
backward (so not a checkpointed block's recompute) and their backwards:
the dry run reads the backward passes of a traced step off them
(`repro_torch.analysis.graph.backward_passes`).
"""
from __future__ import annotations

import collections

import torch

from repro_torch.core import bk
from repro_torch.core.ghost import (clip_factor, expert_clipped_sum,
                                    factor_without_norms,
                                    grouped_clipped_sum)
from repro_torch.kernels import backend


def _flat3(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1])


LINEAR_CALLS: collections.Counter = collections.Counter()


def count_linear_forward(ctx) -> None:
    if any(ctx.needs_input_grad) and \
            torch._C._current_graph_task_id() == -1:
        LINEAR_CALLS["forward"] += 1


def count_linear_backward() -> None:
    LINEAR_CALLS["backward"] += 1


def _forward_context(ctx, channel):
    ctx.engine = backend.active()
    ctx.channel = channel


def _capturing(ctx) -> bk.BkChannel | None:
    """The BK channel of this call, after the scope check."""
    ch = ctx.channel
    if ch is not None:
        bk.require_capture_scope(ch, ctx.engine)
    return ch


class DPLinear(torch.autograd.Function):
    """y = x @ w (+ b); group = {w, b}."""

    @staticmethod
    def forward(ctx, w, b, x, c, channel):
        _forward_context(ctx, channel)
        count_linear_forward(ctx)
        ctx.has_bias = b is not None
        ctx.save_for_backward(w, x, c)
        y = x @ w
        if b is not None:
            y = y + b
        return y

    @staticmethod
    def backward(ctx, gy):
        count_linear_backward()
        w, x, c = ctx.saved_tensors
        eng = ctx.engine
        need_n = ctx.needs_input_grad[3]
        dx = gy @ w.T if ctx.needs_input_grad[2] else None
        a3, g3 = _flat3(x), _flat3(gy)
        extra = (eng.bias_norms_sq(g3) if ctx.has_bias and need_n else None)
        ch = _capturing(ctx)
        if ch is not None or not ctx.needs_input_grad[0]:
            # BK capture or a norms-only pass: no parameter gradient
            n = None
            if need_n:
                n = eng.linear_norms_sq(a3, g3)
                n = n if extra is None else n + extra
            if ch is not None:
                bk.stash(ch, a=a3, g=g3)
            return None, None, dx, n, None
        n, f, dw = eng.linear_clip(a3, g3, c, extra, norms=need_n)
        db = (eng.clipped_sum_bias(g3, f).to(w.dtype) if ctx.has_bias
              else None)
        return dw.to(w.dtype), db, dx, n, None


def dp_linear(w, b, x, c):
    """y = x @ w (+ b) with per-example clipping of {w, b} to c (B,), or
    a BK capture through the channel c."""
    ch = bk.channel_of(c)
    if ch is not None:
        bk.record_linear(ch, w, x)
    return DPLinear.apply(w, b, x, bk.thresholds_of(c), ch)


class DPLinearBlocked(torch.autograd.Function):
    """y = x @ w (+ b); one group per column ('out') or row ('in') block
    of {w, b}, thresholds c (B, M)."""

    @staticmethod
    def forward(ctx, w, b, x, c, block_axis, channel):
        _forward_context(ctx, channel)
        count_linear_forward(ctx)
        ctx.has_bias = b is not None
        ctx.block_axis = block_axis
        ctx.save_for_backward(w, x, c)
        y = x @ w
        if b is not None:
            y = y + b
        return y

    @staticmethod
    def backward(ctx, gy):
        count_linear_backward()
        w, x, c = ctx.saved_tensors
        eng, axis = ctx.engine, ctx.block_axis
        need_n = ctx.needs_input_grad[3]
        dx = gy @ w.T if ctx.needs_input_grad[2] else None
        a3, g3 = _flat3(x), _flat3(gy)
        bsz, t, m = g3.shape[0], g3.shape[1], c.shape[-1]
        n = None
        if need_n:
            n = eng.linear_norms_sq_blocked(a3, g3, m, block_axis=axis)
            if ctx.has_bias:
                # an 'out' bias lives with its column blocks; an 'in' bias
                # is whole on every block and folds into block 0
                if axis == "out":
                    sb = torch.sum(g3.reshape(bsz, t, m, -1).float(), dim=1)
                    n = n + torch.sum(sb * sb, dim=-1)
                else:
                    n[:, 0] += eng.bias_norms_sq(g3)
        ch = _capturing(ctx)
        if ch is not None:
            bk.stash(ch, a=a3, g=g3)
        if ch is not None or not ctx.needs_input_grad[0]:
            # BK capture or a norms-only pass: no parameter gradient
            return None, None, dx, n, None, None
        f = clip_factor(c, n) if need_n else factor_without_norms(c)
        dw = eng.clipped_sum_linear_blocked(a3, g3, f, block_axis=axis)
        db = None
        if ctx.has_bias:
            # in f32, as every clipped sum (the reference takes g's dtype
            # here; the two agree in f32)
            if axis == "out":
                db = torch.einsum("btmo,bm->mo",
                                  g3.reshape(bsz, t, m, -1).float(),
                                  f.float()).reshape(-1)
            else:
                db = eng.clipped_sum_bias(g3, f[:, 0])
            db = db.to(w.dtype)
        return dw.to(w.dtype), db, dx, n, None, None


def dp_linear_blocked(w, b, x, c, block_axis: str = "out"):
    """y = x @ w (+ b) with the weight gradient clipped per block: c is
    (B, M) encoded thresholds, one per column ('out') or row ('in') block
    of w, and the norms² come back as c's gradient, (B, M); or a BK
    channel of them (the capture pass)."""
    if block_axis not in ("out", "in"):
        raise ValueError(f"block_axis must be 'out' or 'in', got "
                         f"{block_axis!r}")
    ch = bk.channel_of(c)
    if ch is not None:
        bk.record_linear_blocked(ch, w, x, block_axis)
    return DPLinearBlocked.apply(w, b, x, bk.thresholds_of(c), block_axis,
                                 ch)


class DPEmbed(torch.autograd.Function):
    """y = table[ids]; collision-exact ghost norms."""

    @staticmethod
    def forward(ctx, table, ids, c, channel):
        _forward_context(ctx, channel)
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        ctx.save_for_backward(ids, c)  # not the table: only its shape
        return table[ids.long()]

    @staticmethod
    def backward(ctx, gy):
        ids, c = ctx.saved_tensors
        eng = ctx.engine
        ids2 = ids.reshape(ids.shape[0], -1)
        g3 = _flat3(gy)
        n = eng.embed_norms_sq(ids2, g3) if ctx.needs_input_grad[2] else None
        ch = _capturing(ctx)
        if ch is not None:
            bk.stash(ch, g=g3, ids=ids2)
        if ch is not None or not ctx.needs_input_grad[0]:
            return None, None, n, None
        f = clip_factor(c, n) if n is not None else factor_without_norms(c)
        dtable = eng.clipped_sum_embed(ids2, g3, f, ctx.vocab).to(ctx.dtype)
        return dtable, None, n, None


def dp_embed(table, ids, c):
    ch = bk.channel_of(c)
    if ch is not None:
        bk.record_embed(ch, table, ids)
    return DPEmbed.apply(table, ids, bk.thresholds_of(c), ch)


class DPScale(torch.autograd.Function):
    """y = xhat * s: an elementwise gain (norm layers)."""

    @staticmethod
    def forward(ctx, s, xhat, c, channel):
        _forward_context(ctx, channel)
        ctx.save_for_backward(s, xhat, c)
        return xhat * s

    @staticmethod
    def backward(ctx, gy):
        s, xhat, c = ctx.saved_tensors
        eng = ctx.engine
        dxhat = gy * s if ctx.needs_input_grad[1] else None
        n = eng.scale_norms_sq(xhat, gy) if ctx.needs_input_grad[2] else None
        ch = _capturing(ctx)
        if ch is not None:
            # the per-example grad itself is small ((B, d)): stash it
            bk.stash(ch, pg=torch.sum(_flat3(gy * xhat).float(), dim=1))
        if ch is not None or not ctx.needs_input_grad[0]:
            return None, dxhat, n, None
        f = clip_factor(c, n) if n is not None else factor_without_norms(c)
        ds = eng.clipped_sum_scale(xhat, gy, f).to(s.dtype)
        return ds, dxhat, n, None


def dp_scale(s, xhat, c):
    ch = bk.channel_of(c)
    if ch is not None:
        bk.record_scale(ch, s, xhat)
    return DPScale.apply(s, xhat, bk.thresholds_of(c), ch)


class DPShift(torch.autograd.Function):
    """y = x + b: a bias of its own clipping group."""

    @staticmethod
    def forward(ctx, b, x, c, channel):
        _forward_context(ctx, channel)
        ctx.dtype = b.dtype
        ctx.save_for_backward(c)
        return x + b

    @staticmethod
    def backward(ctx, gy):
        c, = ctx.saved_tensors
        eng = ctx.engine
        g3 = _flat3(gy)
        n = eng.bias_norms_sq(g3) if ctx.needs_input_grad[2] else None
        dx = gy if ctx.needs_input_grad[1] else None
        ch = _capturing(ctx)
        if ch is not None:
            # the per-example grad sum_t g_t is (B, d): stash it
            bk.stash(ch, pg=torch.sum(g3.float(), dim=1))
        if ch is not None or not ctx.needs_input_grad[0]:
            return None, dx, n, None
        f = clip_factor(c, n) if n is not None else factor_without_norms(c)
        db = eng.clipped_sum_bias(g3, f).to(ctx.dtype)
        return db, dx, n, None


def dp_shift(b, x, c):
    """y = x + b with per-example clipping of b to c (B,), or a BK
    capture through the channel c."""
    ch = bk.channel_of(c)
    if ch is not None:
        bk.record_shift(ch, x)
    return DPShift.apply(b, x, bk.thresholds_of(c), ch)


class DPBroadcast(torch.autograd.Function):
    """p expanded to (B,) + p.shape: the cotangent arriving back is the
    per-example gradient, so its norms² and the clipped sum need no
    ghost identity."""

    @staticmethod
    def forward(ctx, p, c, channel):
        _forward_context(ctx, channel)
        ctx.dtype = p.dtype
        ctx.save_for_backward(c)
        return p.expand((c.shape[-1],) + tuple(p.shape))

    @staticmethod
    def backward(ctx, gy):
        c, = ctx.saved_tensors
        n = (ctx.engine.vector_norms_sq(gy) if ctx.needs_input_grad[1]
             else None)
        ch = _capturing(ctx)
        if ch is not None:
            bk.stash(ch, pg=gy.float())
        if ch is not None or not ctx.needs_input_grad[0]:
            return None, n, None
        f = clip_factor(c, n) if n is not None else factor_without_norms(c)
        dp = torch.tensordot(f.float(), gy.float(), dims=1).to(ctx.dtype)
        return dp, n, None


def dp_broadcast(p, c):
    """p expanded to (B,) + p.shape, B the thresholds' batch, with the
    per-example gradients clipped to c (B,); or a BK capture through the
    channel c."""
    ch = bk.channel_of(c)
    if ch is not None:
        bk.record_broadcast(ch, p)
    return DPBroadcast.apply(p, bk.thresholds_of(c), ch)


class DPExpertLinear(torch.autograd.Function):
    """y[e] = x[e] @ w[e] over dispatched expert slots; one group per
    expert, thresholds c (E, B).

    The slots of one expert mix tokens of different examples, so the norm
    of example i's gradient of expert e needs example-masked grams:

        n[e, i] = sum over slots s, s' of e with ex(s) = ex(s') = i of
                  <x_s, x_s'> <g_s, g_s'>

    built as M_eᵀ (X_e X_eᵀ * G_e G_eᵀ) M_e, read on the diagonal, where
    M_e (C, B + 1) is the one-hot of the slots' example ids (empty slots in
    the overflow column B, dropped). The grams and the clipped sum are
    plain f32 torch matmuls, as the reference leaves them to XLA; the
    clipped sum accumulates in f32 with an f32 factor (the reference's is a
    bf16 einsum with a bf16 factor on a bf16 model; the two agree in f32).
    Under a BK channel the backward stashes x, g and the slots' example
    ids (empty slots B) and returns the norms² only.
    """

    @staticmethod
    def forward(ctx, w, x, exids, c, channel):
        _forward_context(ctx, channel)
        ctx.save_for_backward(w, x, exids, c)
        return torch.einsum("ecd,edf->ecf", x, w)

    @staticmethod
    def backward(ctx, gy):
        w, x, exids, c = ctx.saved_tensors
        need_n = ctx.needs_input_grad[3]
        dx = (torch.einsum("ecf,edf->ecd", gy, w) if ctx.needs_input_grad[1]
              else None)
        bsz = c.shape[-1]
        seg = torch.where(exids >= 0, exids.long(), bsz)  # empty -> B
        x32, g32 = x.float(), gy.float()
        n = None
        if need_n:
            onehot = torch.nn.functional.one_hot(seg, bsz + 1).float()
            gram = (torch.bmm(x32, x32.transpose(1, 2))
                    * torch.bmm(g32, g32.transpose(1, 2)))  # (E, C, C)
            n = torch.sum(onehot * torch.bmm(gram, onehot), dim=1)[:, :bsz]
        ch = _capturing(ctx)
        if ch is not None:
            bk.stash(ch, x=x, g=gy, seg=seg)
        if ch is not None or not ctx.needs_input_grad[0]:
            return None, dx, None, n, None
        f = clip_factor(c, n) if need_n else factor_without_norms(c)
        dw = expert_clipped_sum(x32, g32, seg, f)
        return dw.to(w.dtype), dx, None, n, None


def dp_expert_linear(w, x, exids, c):
    """y (E, C, dout) = x @ w per expert, with the gradient of each expert
    clipped per example: w (E, din, dout); x (E, C, din) dispatched slots;
    exids (E, C) the example id of each slot, -1 for an empty one; c (E, B)
    encoded thresholds, whose gradient is the (E, B) norms², or a BK
    channel."""
    ch = bk.channel_of(c)
    if ch is not None:
        bk.record_expert(ch, w, x)
    return DPExpertLinear.apply(w, x, exids, bk.thresholds_of(c), ch)


class DPExpertLinearGrouped(torch.autograd.Function):
    """y[b, e] = x[b, e] @ w[e] over per-example dispatch buffers; one
    group per expert, thresholds c (E, B).

    Every example owns its slots, so the gradient of example b for expert
    e is the plain block sum_s x_s g_sᵀ over its own slots, and its norm
    is a linear layer's ghost norm at per-example slot counts: the gram
    form <X Xᵀ, G Gᵀ> or the outer form ||Xᵀ G||², whichever the
    reference picks (outer where C din dout < C² (din + dout) and din dout
    <= 2^22), so both packages take the same branch. Plain f32 torch
    matmuls, as the reference leaves them to XLA; the clipped sum in f32
    with f32 factors. Under a BK channel the backward stashes x and g and
    returns the norms² (the gram form) only."""

    @staticmethod
    def forward(ctx, w, x, c, channel):
        _forward_context(ctx, channel)
        ctx.save_for_backward(w, x, c)
        return torch.einsum("becd,edf->becf", x, w)

    @staticmethod
    def backward(ctx, gy):
        w, x, c = ctx.saved_tensors
        need_n = ctx.needs_input_grad[2]
        _, _, cap, din = x.shape
        dout = gy.shape[-1]
        dx = (torch.einsum("becf,edf->becd", gy, w)
              if ctx.needs_input_grad[1] else None)
        x32, g32 = x.float(), gy.float()
        ch = _capturing(ctx)
        use_outer = (cap * din * dout < cap * cap * (din + dout)
                     and din * dout <= (1 << 22)) and ch is None
        n = dw_be = None
        if use_outer and (need_n or ctx.needs_input_grad[0]):
            dw_be = torch.einsum("becd,becf->bedf", x32, g32)
            if need_n:
                n = torch.sum(dw_be * dw_be, dim=(2, 3)).T  # (E, B)
        elif need_n:
            gram_x = torch.einsum("becd,beCd->becC", x32, x32)
            gram_g = torch.einsum("becf,beCf->becC", g32, g32)
            n = torch.sum(gram_x * gram_g, dim=(2, 3)).T  # (E, B)
        if ch is not None:
            bk.stash(ch, x=x, g=gy)
        if ch is not None or not ctx.needs_input_grad[0]:
            return None, dx, n, None
        f = clip_factor(c, n) if need_n else factor_without_norms(c)
        if use_outer:
            dw = torch.einsum("bedf,be->edf", dw_be, f.T)
        else:
            dw = grouped_clipped_sum(x32, g32, f)
        return dw.to(w.dtype), dx, n, None


def dp_expert_linear_grouped(w, x, c):
    """y (B, E, C, dout) = x[b, e] @ w[e], with the gradient of each
    expert clipped per example: w (E, din, dout); x (B, E, C, din) the
    per-example dispatch buffers (empty slots zero); c (E, B) encoded
    thresholds, whose gradient is the (E, B) norms², or a BK channel."""
    ch = bk.channel_of(c)
    if ch is not None:
        bk.record_expert_grouped(ch, w, x)
    return DPExpertLinearGrouped.apply(w, x, bk.thresholds_of(c), ch)

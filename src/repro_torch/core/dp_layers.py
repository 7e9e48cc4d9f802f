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
direct scale |c|. PyTorch has no dead-code elimination, so the norms are
computed only when the threshold's gradient is asked for; a threshold
passed without `requires_grad` must then be +inf or a direct scale (a
finite c > 0 there gives NaN gradients rather than a skipped clip).

The engine is read in the forward, in the caller's scope, and kept on the
context: the backward of CUDA tensors runs on autograd's device thread,
which does not see the caller's `backend.scoped(...)`. Under activation
checkpointing the forward runs again during backward, but the backward
that runs is the first forward's, so the norms arrive once.

`dp_shift`, `dp_broadcast`, the blocked and expert primitives and the BK
capture channel are not ported yet (ROADMAP A.3, A.4, A.7, A.13).
"""
from __future__ import annotations

import torch

from repro_torch.core.ghost import clip_factor, factor_without_norms
from repro_torch.kernels import backend


def _flat3(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1])


class DPLinear(torch.autograd.Function):
    """y = x @ w (+ b); group = {w, b}."""

    @staticmethod
    def forward(ctx, w, b, x, c):
        ctx.engine = backend.active()
        ctx.has_bias = b is not None
        ctx.save_for_backward(w, x, c)
        y = x @ w
        if b is not None:
            y = y + b
        return y

    @staticmethod
    def backward(ctx, gy):
        w, x, c = ctx.saved_tensors
        eng = ctx.engine
        need_n = ctx.needs_input_grad[3]
        dx = gy @ w.T if ctx.needs_input_grad[2] else None
        a3, g3 = _flat3(x), _flat3(gy)
        extra = (eng.bias_norms_sq(g3) if ctx.has_bias and need_n else None)
        n, f, dw = eng.linear_clip(a3, g3, c, extra, norms=need_n)
        db = (eng.clipped_sum_bias(g3, f).to(w.dtype) if ctx.has_bias
              else None)
        return dw.to(w.dtype), db, dx, n


def dp_linear(w, b, x, c):
    """y = x @ w (+ b) with per-example clipping of {w, b} to c (B,)."""
    return DPLinear.apply(w, b, x, c)


class DPEmbed(torch.autograd.Function):
    """y = table[ids]; collision-exact ghost norms."""

    @staticmethod
    def forward(ctx, table, ids, c):
        ctx.engine = backend.active()
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        ctx.save_for_backward(ids, c)  # not the table: only its shape
        return table[ids.long()]

    @staticmethod
    def backward(ctx, gy):
        ids, c = ctx.saved_tensors
        eng = ctx.engine
        ids2 = ids.reshape(ids.shape[0], -1)
        g3 = _flat3(gy)
        if ctx.needs_input_grad[2]:
            n = eng.embed_norms_sq(ids2, g3)
            f = clip_factor(c, n)
        else:
            n, f = None, factor_without_norms(c)
        dtable = eng.clipped_sum_embed(ids2, g3, f, ctx.vocab).to(ctx.dtype)
        return dtable, None, n


def dp_embed(table, ids, c):
    return DPEmbed.apply(table, ids, c)


class DPScale(torch.autograd.Function):
    """y = xhat * s: an elementwise gain (norm layers)."""

    @staticmethod
    def forward(ctx, s, xhat, c):
        ctx.engine = backend.active()
        ctx.save_for_backward(s, xhat, c)
        return xhat * s

    @staticmethod
    def backward(ctx, gy):
        s, xhat, c = ctx.saved_tensors
        eng = ctx.engine
        dxhat = gy * s if ctx.needs_input_grad[1] else None
        if ctx.needs_input_grad[2]:
            n = eng.scale_norms_sq(xhat, gy)
            f = clip_factor(c, n)
        else:
            n, f = None, factor_without_norms(c)
        ds = eng.clipped_sum_scale(xhat, gy, f).to(s.dtype)
        return ds, dxhat, n


def dp_scale(s, xhat, c):
    return DPScale.apply(s, xhat, c)

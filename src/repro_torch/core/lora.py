"""LoRA adapters with DP clipping: the paper's large-model recipe (Sec.
5.3), the counterpart of `repro.core.lora`.

The base weights are frozen (no per-example machinery runs for them) and
the adapters A (d_in x r) and B (r x d_out) train privately:

  * `lora_spec` builds an adapter pair's spec; {a, b} is ONE clipping
    group (the pair is "the layer" in group-wise terms). `b` starts at
    zeros, so a fresh adapter serves the base model exactly.
  * `dp_lora_linear` applies y = x W + (x A) B (alpha / r) with the
    clipping fused into its backward. The per-example gradients of the
    pair factor through the low-rank intermediates,

        dB_i = (X_i A)ᵀ (s G_i)          (r x d_out)
        dA_i = X_iᵀ (s G_i Bᵀ)           (d_in x r),   s = alpha / r,

    so both norms² come from the linear ghost identity
    (`linear_norms_sq(x A, s g)` and `linear_norms_sq(x, s g Bᵀ)`: the
    `ghost_norm` kernel on the card) and the clipped sums from
    `clipped_sum_linear` on the same two pairs (`clip_reduce`). Under BK
    the backward stashes both residual pairs instead; the epilogue
    contracts each with `scale_contract`. The frozen weight gets no
    gradient; only dx flows through it.

Serving (multi-tenant): one base model, many adapters. The adapters of
every live tenant lie in one tenant-stacked buffer per leaf, (n, T, ...)
with the layer stack n outermost (`stacked_adapter_zeros`), and every
decode row gathers its own pair by an int tenant id
(`stacked_lora_delta`). The ids and the buffer are data: admitting a
tenant or hot-swapping an adapter is a `copy_` into one slot of the
allocated buffer (`stacked_slot_update`), and no input shape of
`serve_step` depends on the tenants (`launch.engine.DecodeEngine`,
`launch.swap`). The reference computes the adapter math in XLA, with no
Pallas kernel, so it stays plain torch here (`torch.bmm` included).
"""
from __future__ import annotations

import torch

from repro_torch.core import bk
from repro_torch.core.ghost import clip_factor, factor_without_norms
from repro_torch.core.spec import P, _walk
from repro_torch.kernels import backend


def lora_spec(d_in: int, d_out: int, rank: int, *,
              stack: tuple[int, ...] = (),
              dtype: torch.dtype = torch.float32) -> dict:
    """Adapter spec; {a, b} share one clipping group (their parent path)."""
    s = len(stack)
    return {"a": P(stack + (d_in, rank), init="normal", scale=0.02,
                   dtype=dtype, stack=s),
            "b": P(stack + (rank, d_out), init="zeros", dtype=dtype,
                   stack=s)}


def _flat3(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1])


class DPLoraLinear(torch.autograd.Function):
    """y = x @ w + (x @ a) @ b * (alpha / r); group = {a, b}, w frozen."""

    @staticmethod
    def forward(ctx, a, b, w, x, c, channel, alpha):
        ctx.engine = backend.active()
        ctx.channel = channel
        ctx.scale = alpha / a.shape[-1]
        ctx.save_for_backward(a, b, w, x, c)
        return x @ w + (x @ a) @ b * ctx.scale

    @staticmethod
    def backward(ctx, gy):
        a, b, w, x, c = ctx.saved_tensors
        eng, s = ctx.engine, ctx.scale
        need_n = ctx.needs_input_grad[4]
        x3, g3 = _flat3(x), _flat3(gy)
        gs = g3 * s  # the adapter term's output cotangent
        gbt = gs @ b.T  # (B, T, r): dA_i = X_iᵀ gbt_i
        # the input cotangent, unclipped, through both paths
        dx = (gy @ w.T + (gbt @ a.T).reshape(gy.shape[:-1] + (a.shape[0],))
              if ctx.needs_input_grad[3] else None)
        xa = x3 @ a  # (B, T, r): dB_i = xa_iᵀ gs_i
        n = None
        if need_n:
            n = eng.linear_norms_sq(x3, gbt) + eng.linear_norms_sq(xa, gs)
        ch = ctx.channel
        if ch is not None:
            bk.require_capture_scope(ch, eng)
            bk.stash(ch, a1=x3, g1=gbt, a2=xa, g2=gs)
        if ch is not None or not ctx.needs_input_grad[0]:
            # BK capture or a norms-only pass: no adapter gradient
            return None, None, None, dx, n, None, None
        f = clip_factor(c, n) if need_n else factor_without_norms(c)
        da = eng.clipped_sum_linear(x3, gbt, f).to(a.dtype)
        db = eng.clipped_sum_linear(xa, gs, f).to(b.dtype)
        return da, db, None, dx, n, None, None


def dp_lora_linear(a, b, w_frozen, x, c, alpha: float):
    """y = x @ w_frozen + (x @ a) @ b * (alpha / r), {a, b} one clip group
    with thresholds c (B,) (or a BK channel); w_frozen gets no gradient."""
    ch = bk.channel_of(c)
    if ch is not None:
        bk.record_lora(ch, a, b, x)
    return DPLoraLinear.apply(a, b, w_frozen, x, bk.thresholds_of(c), ch,
                              float(alpha))


def merge_lora(w, a, b, alpha: float):
    """Fold a trained adapter into the frozen weight (offline serving)."""
    return w + (a @ b) * (alpha / a.shape[-1])


# ---------------------------------------------------------------------------
# Multi-tenant serving: tenant-stacked adapters.
# ---------------------------------------------------------------------------


def stacked_lora_delta(x, a_stack, b_stack, tenant, alpha: float):
    """Each row's adapter term from a tenant-stacked buffer.

      x:       (B, t, d_in) activations (t = 1 at decode);
      a_stack: (T, d_in, r), the tenant axis leading; b_stack: (T, r,
               d_out); tenant: (B,) int adapter-slot ids.

    Returns (B, t, d_out): (x @ A[tenant]) @ B[tenant] (alpha / r), row by
    row (each row contracts only its own pair), which is what makes a
    mixed-tenant pool step bitwise the same as serving each tenant alone.
    """
    idx = tenant.long()
    a = a_stack.index_select(0, idx)  # (B, d_in, r)
    b = b_stack.index_select(0, idx)  # (B, r, d_out)
    return torch.bmm(torch.bmm(x, a), b) * (alpha / a_stack.shape[-1])


def stacked_adapter_zeros(spec_tree, num_slots: int, *,
                          device: str | torch.device = "cpu") -> dict:
    """Zero tenant-stacked buffers for an adapter spec tree: every leaf
    P((n, ...)) becomes zeros of (n, num_slots, ...), the tenant axis
    just inside the layer stack, so a layer's slice is (T, ...), tenant
    leading as `stacked_lora_delta` takes it. `b` is zero, so an empty
    slot serves the base model exactly."""
    out: dict = {}
    for path, p in _walk(spec_tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.zeros(
            (p.shape[0], num_slots) + tuple(p.shape[1:]), dtype=p.dtype,
            device=device)
    return out


def stacked_slot_update(stacked: dict, slot: int, adapters) -> dict:
    """Install one tenant's adapter tree into slot `slot` of a stacked
    buffer IN PLACE (the hot-swap write: `copy_` into the allocated
    storage, which does not move). `adapters` leaves are (n, ...), the
    buffer's (n, T, ...) without the tenant axis; None writes zeros (the
    base model). Returns `stacked`."""
    for k, buf in stacked.items():
        if isinstance(buf, dict):
            stacked_slot_update(buf, slot,
                                None if adapters is None else adapters[k])
            continue
        dst = buf[:, slot]
        if adapters is None:
            dst.zero_()
            continue
        src = adapters[k]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"adapter leaf shape {tuple(src.shape)} does not match the "
                f"stacked buffer's per-tenant shape {tuple(dst.shape)}")
        dst.copy_(torch.as_tensor(src).detach())
    return stacked

"""GQA attention for paged decode: the counterpart of the paged branch of
`repro.models.attention`.

The pools are updated IN PLACE (`index_put_`): the reference returns new
pools from a functional scatter, the port writes one row per slot into
the existing tensor and saves a copy of the whole pool on every step.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import paged_attn as K
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def gqa_spec(cfg: ModelConfig, *, stack: tuple[int, ...] = ()) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    out = {
        "qkv": L.linear_spec(d, (h + 2 * kv) * hd, stack=stack,
                             dtype=cfg.dtype),
        "o": L.linear_spec(h * hd, d, stack=stack, dtype=cfg.dtype),
    }
    if cfg.qk_norm:
        out["q_norm"] = L.rmsnorm_spec(hd, stack=stack, dtype=cfg.dtype)
        out["k_norm"] = L.rmsnorm_spec(hd, stack=stack, dtype=cfg.dtype)
    return out


def _split_qkv(cfg, qkv):
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b, t = qkv.shape[0], qkv.shape[1]
    q = qkv[..., : h * hd]
    k = qkv[..., h * hd: (h + kvh) * hd]
    v = qkv[..., (h + kvh) * hd:]
    return (q.reshape(b, t, h, hd), k.reshape(b, t, kvh, hd),
            v.reshape(b, t, kvh, hd))


def _qk_norm(cfg, params, q, k):
    """Per-head RMSNorm: normalise in f32, cast, then scale (the reference
    scales over the flattened heads, which broadcasts the same way)."""
    if not cfg.qk_norm:
        return q, k
    return (L.rmsnorm(params["q_norm"], q, eps=cfg.norm_eps),
            L.rmsnorm(params["k_norm"], k, eps=cfg.norm_eps))


def _paged_write(pool, new, pt, pos, active):
    """One-token scatter through a page table, in place. pool: (N+1, L,
    ...) with the LAST page reserved as the trash page; new: (B, 1, ...);
    pt: (B, P) int32; pos: (B,) write index.

    Row b lands at physical page pt[b, pos // L], offset pos % L. JAX
    clamps an out-of-range gather index and torch.gather raises, so the
    logical page is clamped to P - 1 first (a retired slot's pos may sit
    at the end of its capacity). Inactive rows are redirected to the
    trash page; several of them may land on the same trash row in one
    step, which is harmless: no valid `pos` range ever reaches it."""
    page_len = pool.shape[1]
    lp = torch.clamp(pos // page_len, max=pt.shape[1] - 1)
    off = pos % page_len
    phys = torch.gather(pt, 1, lp[:, None].long())[:, 0]
    if active is not None:
        phys = torch.where(active, phys, pool.shape[0] - 1)
    pool.index_put_((phys.long(), off.long()), new[:, 0].to(pool.dtype))


def gqa_decode_paged(cfg: ModelConfig, params, x, kpool, vpool, pt, pos, *,
                     active=None):
    """One-token GQA decode through a paged KV cache.

    x: (B, 1, D); kpool/vpool: one layer's (N+1, L, KV, hd) pools shared
    by every slot (last page = trash), written in place; pt: (B, P) int32
    page table; pos: (B,) int32 new token index; active: optional (B,)
    bool row mask (inactive rows write only to the trash page).
    Returns the attention output (B, 1, D)."""
    qkv = L.linear(params["qkv"], x)
    q, k, v = _split_qkv(cfg, qkv)
    q, k = _qk_norm(cfg, params, q, k)
    posb = pos[:, None]
    q = L.apply_rope(q, posb, cfg.rope_theta)
    k = L.apply_rope(k, posb, cfg.rope_theta)
    _paged_write(kpool, k, pt, pos, active)
    _paged_write(vpool, v, pt, pos, active)

    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    qr = q[:, 0].reshape(b, kv, h // kv, hd)  # [kv, g] grouping of `attend`
    out = K.paged_attn(qr, kpool, vpool, pt, pos, scale=1.0 / math.sqrt(hd))
    out = out.reshape(b, 1, h * hd).to(q.dtype)
    return L.linear(params["o"], out)

"""Attention: GQA (qk-norm, QKV bias, sliding window) and MLA, the
counterpart of `repro.models.attention`.

* Training: `attend` (f32 scores; a masked softmax in one shot up to
  T * S = 2048², above it the reference's double-blocked online softmax)
  and `gqa_attention`, whose projections and q/k norms are DP primitives;
  the projections are clipped per column block when `cfg.dp_blocks > 1`.
  The reference's attention is plain XLA, so plain torch (einsum,
  softmax, autograd) is its port.
* Contiguous decode: `gqa_decode` over per-slot (B, cap, KV, hd) caches,
  full (cap = the context) or a ring of the sliding window, and MLA's
  absorbed-form `mla_decode` over (B, S, lr) / (B, S, rope) latent
  caches. Both are the reference's plain XLA math, so plain torch is
  their port; the caches are written IN PLACE (`_masked_cache_write`),
  an inactive row's entry rewritten with its own bits.
* Paged decode: `gqa_decode_paged` and MLA's absorbed-form
  `mla_decode_paged`, both through the active ghost-op engine's
  `paged_attn` (`kernels.backend`: the kernel under `kernels`, its plain
  version under `plain`, `auto`'s choice by the reference's shape hints,
  t = logical context, din = query dim, dout = value dim; outside any
  scope the kernel on a CUDA tensor, its plain version on a CPU one).
  The pools are updated IN PLACE (`index_put_`): the reference
  returns new pools from a functional scatter, the port writes one row
  per slot into the existing tensor and saves a copy of the whole pool on
  every step.
* MLA (DeepSeek-V3): `mla_spec`, and `mla_attention`, the full-sequence
  form that materializes per-head K/V from the latent: with thresholds
  it trains (q_a, q_b, kv_a, kv_b, o as `dp_linear`, q_norm and kv_norm
  as `dp_scale`), without it is the plain forward, the decode's oracle.
* DP-LoRA (`core.lora`): `gqa_attention` takes adapters on `qkv` and
  `o`, `mla_attention` on `kv_b` and `o` (`lora`, `lora_th`): each
  adapted projection is a `dp_lora_linear` over its frozen weight, the
  bias added after the adapter term, and `dp_blocks` does not apply to
  it. Every decode entry point takes the multi-tenant serving plane's
  adapters (`lora`: one layer's tenant-stacked pairs, `tenant`: (B,)
  slot ids): GQA adds each row's delta to the qkv and o projections,
  MLA carries the kv_b delta through the absorbed form in factored f32
  (`_mla_lora_sel`) and adds the o delta.

Serving hooks: every decode entry point takes an optional `active` (B,)
row mask, the engine's per-slot write/retire hook: rows with
`active=False` leave their cache entries bit-identical (the caller keeps
their `pos`). `masked_state` is the matching hook for a state tensor that
turns over whole every step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import dp_layers as dpl
from repro_torch.core import lora as lora_lib
from repro_torch.kernels import backend as ghost_backend
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


_SINGLE_SHOT_MAX = 2048 * 2048  # T*S above this -> the blocked branch
_QB, _KB = 512, 1024  # query / kv block sizes of the blocked branch
NEG_INF = -1e30
INVALID_POS = 2**31 - 1 - 8  # kpos >= this => masked out
# the contiguous decode's two key-position sentinels, both >= INVALID_POS:
# a full cache's future slots, and a ring's slots not written yet
_FUTURE_POS = 2**31 - 1
_UNWRITTEN_POS = 2**31 - 2


def masked_state(active, new, old):
    """Row-freeze hook for a decode state that turns over whole every
    step: `old` on rows where `active` is False; `active=None` advances
    every row (and selects nothing)."""
    if active is None:
        return new
    m = active.reshape((active.shape[0],) + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def _masked_cache_write(cache, new, slot, active):
    """Write row b of `new` (B, 1, ...) into `cache` (B, S, ...) at
    `slot[b]`, in place; a row with `active` False rewrites the entry it
    reads, so its bits stay. An index past the end is clamped to S - 1,
    as JAX clamps a dynamic slice."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = torch.clamp(slot, max=cache.shape[1] - 1).long()
    val = new[:, 0].to(cache.dtype)
    if active is not None:
        m = active.reshape((active.shape[0],) + (1,) * (val.dim() - 1))
        val = torch.where(m, val, cache[rows, idx])
    cache[rows, idx] = val


def _mask(qpos, kpos, *, causal, window):
    """(B, T, S) boolean validity mask."""
    m = (kpos[:, None, :] < INVALID_POS).expand(
        qpos.shape[0], qpos.shape[1], kpos.shape[1])
    if causal:
        m = m & (kpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        m = m & (kpos[:, None, :] > qpos[:, :, None] - window)
    return m


def _scores(qg, k):
    """q: (B, T, KV, G, hd), k: (B, S, KV, hd) -> (B, T, KV, G, S) f32."""
    return torch.einsum("btkgd,bskd->btkgs", qg.float(), k.float())


def attend(q, k, v, qpos, kpos, *, causal=True, window=None, scale=None):
    """Grouped-query attention. q: (B, T, H, hd); k, v: (B, S, KV, hd);
    qpos (B, T), kpos (B, S). Single shot up to T * S = 2048², else the
    double-blocked online softmax (`_attend_blocked`)."""
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, t, kv, h // kv, hd) * scale
    if t * s > _SINGLE_SHOT_MAX:
        out = _attend_blocked(qg, k, v, qpos, kpos, causal=causal,
                              window=window)
        return out.reshape(b, t, h, dv).to(q.dtype)
    scores = _scores(qg, k)
    m = _mask(qpos, kpos, causal=causal, window=window)
    scores = scores.masked_fill(~m[:, :, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkgs,bskd->btkgd", w, v.float())
    return out.reshape(b, t, h, dv).to(q.dtype)


def _attend_blocked(qg, k, v, qpos, kpos, *, causal, window):
    """The reference's double-blocked online softmax, (B, T, KV, G, dv)
    f32: query blocks of _QB, within each a running (max, sum, acc) over
    KV blocks of _KB. T and S are padded to whole blocks, qpos with -1
    and kpos with the int32 maximum (masked as invalid), and the output
    cut back to T. NEG_INF is finite, so a fully masked block adds
    exp(0) = 1 per key until a later unmasked block's alpha = 0 wipes it
    out, as in the reference. Autograd keeps each block's tensors: under
    remat one layer's at a time."""
    b, t, kv, g, _ = qg.shape
    s, dv = k.shape[1], v.shape[-1]
    qb, kb = min(_QB, t), min(_KB, s)
    nqb, nkb = -(-t // qb), -(-s // kb)
    pad_t, pad_s = nqb * qb - t, nkb * kb - s
    qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad_t))
    qpos = F.pad(qpos, (0, pad_t), value=-1)
    k = F.pad(k, (0, 0, 0, 0, 0, pad_s))
    v = F.pad(v, (0, 0, 0, 0, 0, pad_s))
    kpos = F.pad(kpos, (0, pad_s), value=2**31 - 1)
    outs = []
    for i in range(nqb):
        rows = slice(i * qb, (i + 1) * qb)
        qi, qpos_i = qg[:, rows], qpos[:, rows]
        m_run = torch.full((b, qb, kv, g), NEG_INF, dtype=torch.float32,
                           device=qg.device)
        l_run = torch.zeros_like(m_run)
        acc = torch.zeros((b, qb, kv, g, dv), dtype=torch.float32,
                          device=qg.device)
        for j in range(nkb):
            cols = slice(j * kb, (j + 1) * kb)
            sc = _scores(qi, k[:, cols])
            msk = _mask(qpos_i, kpos[:, cols], causal=causal, window=window)
            sc = torch.where(msk[:, :, None, None, :], sc, NEG_INF)
            m_new = torch.maximum(m_run, torch.amax(sc, dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(sc - m_new[..., None])
            l_run = l_run * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "btkgs,bskd->btkgd", p, v[:, cols].float())
            m_run = m_new
        outs.append(acc / torch.clamp(l_run[..., None], min=1e-30))
    return torch.cat(outs, dim=1)[:, :t]


def gqa_spec(cfg: ModelConfig, *, stack: tuple[int, ...] = (),
             cross: bool = False, sensitivity_mult: float = 1.0) -> dict:
    """cross: the encoder-decoder's cross-attention block, whose queries
    come from the decoder and keys and values from the encoder: `qkv`
    projects to the queries alone (d -> h * hd) and a separate `kv` to
    both (d -> 2 * kv * hd), neither blocked, as in the reference."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    sm = sensitivity_mult
    out = {
        "qkv": L.linear_spec(d, (h + 2 * kv) * hd, bias=cfg.qkv_bias,
                             stack=stack, dtype=cfg.dtype,
                             blocks=cfg.dp_blocks, sensitivity_mult=sm),
        "o": L.linear_spec(h * hd, d, stack=stack, dtype=cfg.dtype,
                           blocks=cfg.dp_blocks, sensitivity_mult=sm),
    }
    if cross:
        out["qkv"] = L.linear_spec(d, h * hd, bias=cfg.qkv_bias, stack=stack,
                                   dtype=cfg.dtype, sensitivity_mult=sm)
        out["kv"] = L.linear_spec(d, 2 * kv * hd, bias=cfg.qkv_bias,
                                  stack=stack, dtype=cfg.dtype,
                                  sensitivity_mult=sm)
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


def _qk_norm(cfg, params, q, k, th=None):
    """Per-head RMSNorm: normalise in f32, cast, then scale. With
    thresholds the scale is `dp_scale` over the flattened (B, T*H, hd)
    heads, as the reference; without, it broadcasts the same way."""
    if not cfg.qk_norm:
        return q, k
    if th is None:
        return (L.rmsnorm(params["q_norm"], q, eps=cfg.norm_eps),
                L.rmsnorm(params["k_norm"], k, eps=cfg.norm_eps))

    def apply(p, x, thx):
        xh = L._normalize(x, cfg.norm_eps)
        flat = xh.reshape(x.shape[0], -1, x.shape[-1])
        return dpl.dp_scale(p["s"], flat, thx).reshape(x.shape)

    return (apply(params["q_norm"], q, th["q_norm"]),
            apply(params["k_norm"], k, th["k_norm"]))


def _proj(cfg: ModelConfig, params, x, th, lora=None, lora_th=None):
    """A projection: clipped per column block (per-shard clipping) when
    `cfg.dp_blocks > 1`, else as one group; th None is the plain forward.
    With an adapter pair `lora` ({'a', 'b'}) the weight is frozen and the
    pair trains as one group under `lora_th` (`core.lora.dp_lora_linear`;
    None: the plain forward), the bias added after the adapter term, and
    `dp_blocks` does not apply."""
    if lora is not None:
        if lora_th is None:
            y = (x @ params["w"] + (x @ lora["a"]) @ lora["b"]
                 * (cfg.lora_alpha / lora["a"].shape[-1]))
        else:
            y = lora_lib.dp_lora_linear(lora["a"], lora["b"], params["w"],
                                        x, lora_th, cfg.lora_alpha)
        return y + params["b"] if "b" in params else y
    if cfg.dp_blocks > 1 and th is not None:
        return L.linear_blocked(params, x, th)
    return L.linear(params, x, th)


def _pair(lora, lora_th, name):
    """One projection's adapter pair and its thresholds (None, None when
    the projection has no adapter)."""
    if lora is None:
        return None, None
    return lora[name], None if lora_th is None else lora_th[name]


def gqa_attention(cfg: ModelConfig, params, x, th, positions, *,
                  causal=True, window=None, lora=None, lora_th=None):
    """Self-attention, training (and prefill). x: (B, T, D); th: this
    block's attention thresholds ({'qkv', 'o', 'q_norm', 'k_norm'}: (B,)
    each, (M, B) for the projections when `cfg.dp_blocks = M > 1`), or
    None for the plain forward; positions: (B, T), or Qwen2-VL's (3, B,
    T) M-RoPE streams (`L.apply_m_rope` over `cfg.m_rope_sections`, the
    temporal stream driving the mask, as the reference's
    `_mrope_attention`); window: the sliding window, None for full
    attention. lora / lora_th: DP-LoRA's adapters {'qkv', 'o'} of this
    layer and their thresholds (or BK channels), the base projections
    frozen; lora_th None runs them plainly."""
    qkv = _proj(cfg, params["qkv"], x, None if th is None else th["qkv"],
                *_pair(lora, lora_th, "qkv"))
    q, k, v = _split_qkv(cfg, qkv)
    q, k = _qk_norm(cfg, params, q, k, th)
    if positions.dim() == 3:
        q = L.apply_m_rope(q, positions, cfg.rope_theta, cfg.m_rope_sections)
        k = L.apply_m_rope(k, positions, cfg.rope_theta, cfg.m_rope_sections)
        positions = positions[0]
    else:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    out = attend(q, k, v, positions, positions, causal=causal, window=window)
    out = out.reshape(x.shape[0], x.shape[1], -1)
    return _proj(cfg, params["o"], out, None if th is None else th["o"],
                 *_pair(lora, lora_th, "o"))


def _stacked_delta(cfg: ModelConfig, x, lora, tenant):
    """The serving plane's adapter term of one projection: `lora` is its
    tenant-stacked pair {'a': (T, d_in, r), 'b': (T, r, d_out)}, `tenant`
    the (B,) slot ids (`core.lora.stacked_lora_delta`)."""
    return lora_lib.stacked_lora_delta(x, lora["a"], lora["b"], tenant,
                                       cfg.lora_alpha)


def _paged_write(pool, new, pt, pos, active):
    """One-token scatter through a page table, in place. pool: (N+1, L,
    ...) with the LAST page reserved as the trash page (GQA's (N+1, L,
    KV, hd) pools, MLA's (N+1, L, lr + rope) latent pool); new: (B, 1,
    ...); pt: (B, P) int32; pos: (B,) write index.

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
                     active=None, lora=None, tenant=None):
    """One-token GQA decode through a paged KV cache.

    x: (B, 1, D); kpool/vpool: one layer's (N+1, L, KV, hd) pools shared
    by every slot (last page = trash), written in place; pt: (B, P) int32
    page table; pos: (B,) int32 new token index; active: optional (B,)
    bool row mask (inactive rows write only to the trash page); lora /
    tenant: the multi-tenant plane's tenant-stacked {'qkv', 'o'} pairs
    of this layer and the (B,) slot ids (as `gqa_decode`).
    Returns the attention output (B, 1, D)."""
    qkv = L.linear(params["qkv"], x)
    if lora is not None:
        qkv = qkv + _stacked_delta(cfg, x, lora["qkv"], tenant)
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
    out = ghost_backend.active().paged_attn(qr, kpool, vpool, pt, pos,
                                            scale=1.0 / math.sqrt(hd))
    out = out.reshape(b, 1, h * hd).to(q.dtype)
    y = L.linear(params["o"], out)
    if lora is not None:
        y = y + _stacked_delta(cfg, out, lora["o"], tenant)
    return y


def gqa_decode(cfg: ModelConfig, params, x, cache_k, cache_v, pos, *,
               window=None, active=None, lora=None, tenant=None):
    """One-token GQA decode against a contiguous per-slot cache.

    x: (B, 1, D); cache_k / cache_v: one layer's (B, cap, KV, hd) caches,
    written in place, keys post-RoPE; pos: (B,) int32 new token index;
    active: optional (B,) bool row mask (inactive rows keep their entries
    bit for bit; the caller keeps their pos). A full cache (window None)
    has cap = the context, and slot = pos; a sliding-window cache is a
    ring of cap = min(window, context) slots, slot = pos % cap, where
    slot s holds position pos - ((slot - s) mod cap), negative for a slot
    not written yet. lora / tenant: the multi-tenant plane's
    tenant-stacked {'qkv', 'o'} pairs of this layer ({'a': (T, d_in, r),
    'b': (T, r, d_out)}) and the (B,) int slot ids: each row adds its own
    tenant's low-rank delta to the frozen projections, the serving form
    of `dp_lora_linear`'s forward. Returns the attention output (B, 1,
    D)."""
    qkv = L.linear(params["qkv"], x)
    if lora is not None:
        qkv = qkv + _stacked_delta(cfg, x, lora["qkv"], tenant)
    q, k, v = _split_qkv(cfg, qkv)
    q, k = _qk_norm(cfg, params, q, k)
    posb = pos[:, None]
    q = L.apply_rope(q, posb, cfg.rope_theta)
    k = L.apply_rope(k, posb, cfg.rope_theta)
    cap = cache_k.shape[1]
    slot = pos % cap if window is not None else pos
    _masked_cache_write(cache_k, k, slot, active)
    _masked_cache_write(cache_v, v, slot, active)
    ar = torch.arange(cap, device=x.device)[None, :]
    if window is None:
        kpos = torch.where(ar <= posb, ar, _FUTURE_POS)
    else:
        # torch's % on tensors is floor modulo, as jnp's: in [0, cap)
        kpos = posb - ((slot[:, None] - ar) % cap)
        kpos = torch.where(kpos >= 0, kpos, _UNWRITTEN_POS)
    out = attend(q, cache_k, cache_v, posb, kpos, causal=True, window=window)
    out = out.reshape(x.shape[0], 1, -1)
    y = L.linear(params["o"], out)
    if lora is not None:
        y = y + _stacked_delta(cfg, out, lora["o"], tenant)
    return y


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3).
# ---------------------------------------------------------------------------


def mla_spec(cfg: ModelConfig, *, stack: tuple[int, ...] = ()) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    lr, qlr = cfg.kv_lora_rank, cfg.q_lora_rank
    out = {
        "kv_a": L.linear_spec(d, lr + rope, stack=stack, dtype=cfg.dtype),
        "kv_norm": L.rmsnorm_spec(lr, stack=stack, dtype=cfg.dtype),
        "kv_b": L.linear_spec(lr, h * (nope + vd), stack=stack,
                              dtype=cfg.dtype),
        "o": L.linear_spec(h * vd, d, stack=stack, dtype=cfg.dtype),
    }
    if qlr:
        out["q_a"] = L.linear_spec(d, qlr, stack=stack, dtype=cfg.dtype)
        out["q_norm"] = L.rmsnorm_spec(qlr, stack=stack, dtype=cfg.dtype)
        out["q_b"] = L.linear_spec(qlr, h * (nope + rope), stack=stack,
                                   dtype=cfg.dtype)
    else:
        out["q"] = L.linear_spec(d, h * (nope + rope), stack=stack,
                                 dtype=cfg.dtype)
    return out


def _th(th, name):
    """One group's thresholds of a block's dict; None serves."""
    return None if th is None else th[name]


def _mla_q(cfg: ModelConfig, params, x, th=None):
    """(q_nope (B, T, H, nope), q_rope (B, T, H, rope)), before RoPE; th:
    the attention thresholds (q_a, q_norm, q_b or q), None serves."""
    b, t = x.shape[0], x.shape[1]
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        qa = L.linear(params["q_a"], x, _th(th, "q_a"))
        qa = L.rmsnorm(params["q_norm"], qa, _th(th, "q_norm"),
                       eps=cfg.norm_eps)
        q = L.linear(params["q_b"], qa, _th(th, "q_b"))
    else:
        q = L.linear(params["q"], x, _th(th, "q"))
    q = q.reshape(b, t, cfg.num_heads, nope + rope)
    return q[..., :nope], q[..., nope:]


def _mla_latent(cfg: ModelConfig, params, x, positions, th=None):
    """(ckv (B, T, lr), k_rope (B, T, 1, rope)): the normalised latent
    and the decoupled RoPE key, both in the model dtype; th: the
    attention thresholds (kv_a, kv_norm), None serves."""
    b, t = x.shape[0], x.shape[1]
    lr, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kv_a = L.linear(params["kv_a"], x, _th(th, "kv_a"))  # (B, T, lr + rope)
    ckv = L.rmsnorm(params["kv_norm"], kv_a[..., :lr], _th(th, "kv_norm"),
                    eps=cfg.norm_eps)
    k_rope = L.apply_rope(kv_a[..., lr:].reshape(b, t, 1, rope), positions,
                          cfg.rope_theta)
    return ckv, k_rope


def mla_attention(cfg: ModelConfig, params, x, positions, th=None, *,
                  causal=True, lora=None, lora_th=None):
    """Full-sequence MLA with per-head K/V materialized from the latent.
    x: (B, T, D); positions: (B, T); th: this block's attention
    thresholds ({'q_a', 'q_norm', 'q_b' (or 'q'), 'kv_a', 'kv_norm',
    'kv_b', 'o'}: (B,) each) for training, every projection a
    `dp_linear` and each norm a `dp_scale`; None is the plain forward
    (serving's oracle). lora / lora_th: DP-LoRA's adapters {'kv_b', 'o'}
    (the per-head expansion and the output) and their thresholds, as
    `gqa_attention`'s."""
    b, t = x.shape[0], x.shape[1]
    h = cfg.num_heads
    nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    q_nope, q_rope = _mla_q(cfg, params, x, th)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    ckv, k_rope = _mla_latent(cfg, params, x, positions, th)
    kv = _proj(cfg, params["kv_b"], ckv, _th(th, "kv_b"),
               *_pair(lora, lora_th, "kv_b")).reshape(b, t, h, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(b, t, h, rope)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attend(q, k, v, positions, positions, causal=causal,
                 scale=1.0 / math.sqrt(nope + rope))
    return _proj(cfg, params["o"], out.reshape(b, t, h * vd), _th(th, "o"),
                 *_pair(lora, lora_th, "o"))


def _mla_lora_sel(cfg: ModelConfig, lora, tenant):
    """Each row's tenant kv_b adapter factors for the absorbed decode:
    (A (B, lr, r), Bn (B, r, H, nope), Bv (B, r, H, vd), scale), in f32.
    The absorbed form applies the adapter without forming the dense
    (lr, H (nope + vd)) delta of a row's weight: both sides stay O(r)."""
    h, nope, vd = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    idx = tenant.long()
    rk = lora["kv_b"]["a"].shape[-1]
    a = lora["kv_b"]["a"].index_select(0, idx).float()
    bm = lora["kv_b"]["b"].index_select(0, idx).float().reshape(
        idx.shape[0], rk, h, nope + vd)
    return a, bm[..., :nope], bm[..., nope:], cfg.lora_alpha / rk


def _absorbed_q(cfg: ModelConfig, params, q_nope, lora, tenant):
    """q_lat (B, 1, H, lr) f32: q_nope folded through W_UK, plus the kv_b
    adapter's W_UK part when serving tenants; and the row factors."""
    lr, h = cfg.kv_lora_rank, cfg.num_heads
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    w_kv_b = params["kv_b"]["w"].reshape(lr, h, nope + vd)
    q_lat = torch.einsum("bohn,lhn->bohl", q_nope.float(),
                         w_kv_b[..., :nope].float())
    sel = None
    if lora is not None:
        sel = _mla_lora_sel(cfg, lora, tenant)
        la, lbn, _, lsc = sel
        t1 = torch.einsum("bohn,brhn->bohr", q_nope.float(), lbn)
        q_lat = q_lat + torch.einsum("bohr,blr->bohl", t1, la) * lsc
    return q_lat, sel


def _absorbed_out(cfg: ModelConfig, params, x, lat, sel, lora, tenant):
    """The attended latent (B, 1, H, lr) f32 expanded through W_UV (and
    the kv_b adapter's W_UV part), then the o projection (and its
    adapter): the attention output (B, 1, D)."""
    b, lr, h = x.shape[0], cfg.kv_lora_rank, cfg.num_heads
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    w_kv_b = params["kv_b"]["w"].reshape(lr, h, nope + vd)
    out = torch.einsum("bohl,lhv->bohv", lat, w_kv_b[..., nope:].float())
    if sel is not None:
        la, _, lbv, lsc = sel
        t2 = torch.einsum("bohl,blr->bohr", lat, la)
        out = out + torch.einsum("bohr,brhv->bohv", t2, lbv) * lsc
    out = out.reshape(b, 1, h * vd).to(x.dtype)
    y = L.linear(params["o"], out)
    if lora is not None:
        y = y + _stacked_delta(cfg, out, lora["o"], tenant)
    return y


def mla_decode(cfg: ModelConfig, params, x, cache_ckv, cache_krope, pos, *,
               active=None, lora=None, tenant=None):
    """Absorbed-form one-token MLA decode against contiguous latent caches,
    the reference's f32 math line for line.

    x: (B, 1, D); cache_ckv: one layer's (B, S, kv_lora_rank) normalised
    latents, cache_krope: (B, S, rope) RoPE keys, both written in place at
    `pos`; pos: (B,) int32; active: optional (B,) bool row mask. W_UK is
    folded into the query (q_lat = q_nope W_UK per head), the scores are
    the latent and RoPE parts' f32 einsums summed, then scaled, masked to
    `index <= pos` and softmaxed over the S slots; W_UV expands the
    attended latent. lora / tenant: the multi-tenant plane's
    tenant-stacked {'kv_b', 'o'} pairs of this layer and the (B,) slot
    ids: the kv_b delta rides through the absorption (its W_UK part
    shifts q_lat, its W_UV part the latent's expansion), in factored
    form, per row. Returns the attention output (B, 1, D)."""
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    posb = pos[:, None]
    q_nope, q_rope = _mla_q(cfg, params, x)  # (B, 1, H, *)
    q_rope = L.apply_rope(q_rope, posb, cfg.rope_theta)
    ckv, k_rope = _mla_latent(cfg, params, x, posb)
    _masked_cache_write(cache_ckv, ckv, pos, active)
    _masked_cache_write(cache_krope, k_rope[:, :, 0], pos, active)

    q_lat, sel = _absorbed_q(cfg, params, q_nope, lora, tenant)
    scores = (torch.einsum("bohl,bsl->bhos", q_lat, cache_ckv.float())
              + torch.einsum("bohr,bsr->bhos", q_rope.float(),
                             cache_krope.float()))
    scores = scores / math.sqrt(nope + rope)
    s = cache_ckv.shape[1]
    valid = torch.arange(s, device=x.device)[None, :] <= posb
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)  # (B, H, 1, S)
    lat = torch.einsum("bhos,bsl->bohl", w, cache_ckv.float())
    return _absorbed_out(cfg, params, x, lat, sel, lora, tenant)


def mla_decode_paged(cfg: ModelConfig, params, x, latpool, pt, pos, *,
                     active=None, lora=None, tenant=None):
    """Absorbed-form one-token MLA decode through a paged latent cache.

    x: (B, 1, D); latpool: one layer's (N+1, L, lr + rope) pool of the
    concatenated normalised latent and RoPE key per token (last page =
    trash), written in place; pt: (B, P) int32; pos: (B,) int32; active:
    optional (B,) bool row mask. W_UK is folded into the query in f32
    (q_lat = q_nope W_UK per head), so `paged_attn` runs KV = 1, G = H,
    dq = lr + rope against the pool passed as both K and V (the aliased
    plan) with the value read cut to dv = lr; W_UV expands the attended
    latent after it. lora / tenant: as `mla_decode`'s (the q_lat shift
    lands before the kernel, so it sees the adapted query). Returns the
    attention output (B, 1, D)."""
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    lr = cfg.kv_lora_rank
    posb = pos[:, None]
    q_nope, q_rope = _mla_q(cfg, params, x)  # (B, 1, H, *)
    q_rope = L.apply_rope(q_rope, posb, cfg.rope_theta)
    ckv, k_rope = _mla_latent(cfg, params, x, posb)
    _paged_write(latpool, torch.cat([ckv, k_rope[:, :, 0]], dim=-1), pt,
                 pos, active)

    q_lat, sel = _absorbed_q(cfg, params, q_nope, lora, tenant)
    q_cat = torch.cat([q_lat, q_rope.float()], dim=-1)  # KV = 1, G = H
    pool = latpool.unsqueeze(2)  # (N+1, L, 1, lr + rope)
    # the engine's dispatch reads the reference's hints off these shapes:
    # t = P * L, din = lr + rope, dout = lr
    lat = ghost_backend.active().paged_attn(
        q_cat, pool, pool, pt, pos, scale=1.0 / math.sqrt(nope + rope),
        dv=lr)
    return _absorbed_out(cfg, params, x, lat, sel, lora, tenant)

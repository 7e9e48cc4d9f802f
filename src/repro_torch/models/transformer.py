"""Model assembly for every family: the counterpart of
`repro.models.transformer`, cut to what serving and DP training run.
Dense and MoE models (flat or grouped dispatch) with GQA (QKV bias,
sliding window) or MLA attention serve and train; an MTP config
(deepseek-v3-671b) adds DeepSeek's multi-token-prediction loss to
training. The recurrent families serve and train too: Mamba2 stacks and
RWKV-6 stacks (`blocks`; rwkv6-7b) and Zamba2's hybrid (zamba2-7b: a
Mamba2 `backbone` and ONE `shared` attention block run before every
`shared_every`-th layer, its groups at `sensitivity_mult` = the number
of its sites, each site clipped per call as the reference does). They
decode on the contiguous plane only (`init_paged_cache` is None, the
reference's `paged_ok`): O(1) recurrent state per slot and the shared
block's sliding-window ring.

The encoder-decoder and M-RoPE families:
* Qwen2-VL (`cfg.m_rope`, qwen2-vl-72b), a dense decoder whose training
  and prefill take stub patch embeddings (`batch['vision_embeds']`, (B,
  Tv, D), prepended to the text and sliced off before the head) and
  M-RoPE over three position streams (`batch['positions3_full']`, (B, 3,
  Tv + T); without it the 1-D positions broadcast, where M-RoPE is plain
  RoPE). Its decode is the dense one, on 1-D RoPE, as in the reference.
* Whisper's encoder-decoder (arch_type 'audio', whisper-medium,
  `_build_encdec`): stub frame embeddings (`batch['frames']`, (B,
  S_enc, D)) plus sinusoidal positions through `enc_blocks` (non-causal
  attention blocks), then `dec_blocks` whose blocks add a cross-attention
  block (`cross`: `qkv` the queries, `kv` from the encoder output) over
  the encoder's output. `model.encode` runs the encoder and
  `model.prefill_cross` fills a decode cache's `cross_k` / `cross_v`;
  `serve_step` decodes on the contiguous plane (`dec_k` / `dec_v`, the
  sinusoidal table built once per device), and `init_paged_cache` is
  None.

    m = build_model(cfg)
    # serving, on the paged plane or the contiguous one
    params = m.init_params(torch.Generator(device="cuda").manual_seed(0))
    cache = m.init_paged_cache(num_slots, cache_len, num_pages=..,
                               page_len=..)     # or m.init_cache(B, S)
    logits, cache = m.serve_step(params, cache, batch)   # one-token decode
    logits = m.prefill_step(params, {"tokens": ...})     # last position's
    # training
    tparams = m.init_train_params(torch.Generator(device="cuda"))
    losses = m.loss_fn(tparams, batch, th)                # (B,) per example

Parameters are plain dicts keyed by the reference's spec paths. Training
keeps the reference's stacked layout, leaves (n_layers, ...) under
`dense_blocks` (`blocks` / `backbone` for the recurrent families) and,
for an MoE config, `moe_blocks` (its first
`first_k_dense` layers dense, the rest MoE, in the reference's order;
an MTP config adds the unstacked `mtp` subtree, which training runs
and serving carries without reading), so
gradients, noise and optimizer updates land leaf for leaf where the
reference puts them; `loss_fn` splits each stack into per-layer views
that a Python loop walks. Serving splits them once, at init
(`unstack_blocks`). The views share the stacked allocation, so nothing is
copied either way.

DP-LoRA (`cfg.lora_rank > 0`, the paper's large-model recipe): the spec
gains a `lora` subtree, one adapter pair (`core.lora.lora_spec`, leaves
(n, ...)) on each attention stack's qkv and o projections (MLA: kv_b and
o), and everything else is frozen. `layout` is then the adapters' alone
(`dp_spec = {"lora": ...}`, `trainable_key = "lora"`); `base_layout` is
the frozen tree's, whose groups the loss runs at +inf thresholds (no norm
and no weight gradient for them). Serving a multi-tenant pool passes
`params["lora_stack"]`, the tenant-stacked adapters (leaves (n, T, ...),
`core.lora.stacked_adapter_zeros`), with `batch["tenant"]`, (B,) slot
ids: both or neither.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core import dp_layers as dpl
from repro_torch.core import lora as lora_lib
from repro_torch.core import spec as S
from repro_torch.core.spec import P
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.models.config import ModelConfig

# attention stacks: spec subtrees whose leaves carry a leading layer-stack
# dim, in the order the layers run: (name, whether its blocks are MoE)
STACKS = (("dense_blocks", False), ("moe_blocks", True))
# every stacked subtree: the attention stacks, the recurrent families'
# `blocks` (Mamba2's or RWKV-6's), Zamba2's Mamba2 `backbone` and the
# encoder-decoder's two stacks
STACKED = tuple(name for name, _ in STACKS) + ("blocks", "backbone",
                                               "enc_blocks", "dec_blocks")


def _attn_block_spec(cfg: ModelConfig, n: int, *, moe_layer: bool,
                     cross: bool = False, sens: float = 1.0) -> dict:
    """A block's spec, stacked n deep (n = 0: one unstacked block). cross:
    a decoder block of the encoder-decoder, with its cross-attention
    block (`cross_norm`, `cross`). sens: the sensitivity multiplier of a
    block shared by several sites (its projections and MLP; the norms
    keep 1, as in the reference)."""
    stack = (n,) if n else ()
    spec = {
        "attn_norm": L.rmsnorm_spec(cfg.d_model, stack=stack, dtype=cfg.dtype),
        "attn": (A.mla_spec(cfg, stack=stack) if cfg.attention_kind == "mla"
                 else A.gqa_spec(cfg, stack=stack, sensitivity_mult=sens)),
        "mlp_norm": L.rmsnorm_spec(cfg.d_model, stack=stack, dtype=cfg.dtype),
    }
    if cross:
        spec["cross_norm"] = L.rmsnorm_spec(cfg.d_model, stack=stack,
                                            dtype=cfg.dtype)
        spec["cross"] = A.gqa_spec(cfg, stack=stack, cross=True)
    if moe_layer:
        spec["moe"] = MOE.moe_spec(cfg, stack=stack)
    else:
        spec["mlp"] = L.swiglu_spec(cfg.d_model, cfg.d_ff, stack=stack,
                                    dtype=cfg.dtype, sensitivity_mult=sens)
    return spec


def shared_sites(cfg: ModelConfig) -> int:
    """Zamba2: the layers the shared attention block runs before."""
    return -(-cfg.num_layers // cfg.shared_every)


def family(cfg: ModelConfig) -> str:
    """'attention' (dense / MoE stacks), 'mamba2', 'rwkv6' or 'hybrid'
    (Zamba2: a Mamba2 backbone and one shared attention block)."""
    if cfg.shared_attention:
        return "hybrid"
    kinds = set(cfg.pattern())
    if len(kinds) > 1:
        raise NotImplementedError(
            f"{cfg.name}: mixed layer patterns without shared_attention, "
            f"as in the reference")
    return {"a": "attention", "m": "mamba2", "r": "rwkv6"}[kinds.pop()]


def decoder_spec(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    spec = {"embed": {"w": P((v, d), init="embed", dtype=cfg.dtype)},
            "final_norm": L.rmsnorm_spec(d, dtype=cfg.dtype),
            "head": {"w": P((d, v), dtype=cfg.dtype)}}
    fam, n = family(cfg), cfg.num_layers

    def norm():
        return L.rmsnorm_spec(d, stack=(n,), dtype=cfg.dtype)

    if fam == "hybrid":
        spec["backbone"] = {"norm": norm(),
                            "m": M2.mamba2_spec(cfg, stack=(n,))}
        spec["shared"] = _attn_block_spec(cfg, 0, moe_layer=False,
                                          sens=float(shared_sites(cfg)))
    elif fam == "mamba2":
        spec["blocks"] = {"norm": norm(), "m": M2.mamba2_spec(cfg, stack=(n,))}
    elif fam == "rwkv6":
        spec["blocks"] = {"norm1": norm(), "norm2": norm(),
                          **R6.rwkv6_spec(cfg, stack=(n,))}
    n_moe = cfg.num_layers - cfg.first_k_dense if cfg.num_experts else 0
    n_dense = cfg.num_layers - n_moe
    if fam == "attention" and n_dense:
        spec["dense_blocks"] = _attn_block_spec(cfg, n_dense,
                                                moe_layer=False)
    if fam == "attention" and n_moe:
        spec["moe_blocks"] = _attn_block_spec(cfg, n_moe, moe_layer=True)
    if cfg.mtp_depth:
        spec["mtp"] = {"proj": L.linear_spec(2 * d, d, dtype=cfg.dtype),
                       "block": _attn_block_spec(cfg, 0, moe_layer=False),
                       "norm": L.rmsnorm_spec(d, dtype=cfg.dtype)}
    if cfg.lora_rank > 0:
        spec["lora"] = lora_tree(cfg, spec)
    return spec


def lora_tree(cfg: ModelConfig, spec: dict) -> dict:
    """DP-LoRA's adapter specs: a pair of rank `cfg.lora_rank` on every
    attention stack's qkv and o projections (MLA: kv_b, the per-head
    expansion, and o), stacked like the stack's layers. The MTP block
    has none, as in the reference."""
    h, kv, hd, d = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                    cfg.d_model)
    out = {}
    for name, _ in STACKS:
        if name not in spec:
            continue
        n = spec[name]["attn_norm"]["s"].shape[0]

        def pair(din, dout):
            return lora_lib.lora_spec(din, dout, cfg.lora_rank, stack=(n,),
                                      dtype=cfg.dtype)

        if cfg.attention_kind == "mla":
            out[name] = {"kv_b": pair(cfg.kv_lora_rank, h * (
                cfg.qk_nope_head_dim + cfg.v_head_dim)),
                         "o": pair(h * cfg.v_head_dim, d)}
        else:
            out[name] = {"qkv": pair(d, (h + 2 * kv) * hd),
                         "o": pair(h * hd, d)}
    return out


def layer_slice(tree, layer: int):
    """Layer `layer`'s views of a tree of stacked leaves (n, ...)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, layer) for k, v in tree.items()}
    return tree[layer]


def _unstack(node, n: int) -> list:
    if isinstance(node, dict):
        parts = {k: _unstack(v, n) for k, v in node.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    if node.shape[0] != n:
        raise ValueError(f"stacked leaf {tuple(node.shape)} does not lead "
                         f"with the layer count {n}")
    return list(node.unbind(0))


def _stack_len(node) -> int:
    while isinstance(node, dict):
        node = node[next(iter(node))]
    return node.shape[0]


def _layers(params, name) -> list:
    """The per-layer blocks of stack `name`: views of the stacked
    training tree, or the serving tree's list."""
    layers = params[name]
    return (_unstack(layers, _stack_len(layers)) if isinstance(layers, dict)
            else layers)


def _layer_th(th, name):
    """Per-layer threshold dicts of stack `name` (None: the plain
    forward), the stacked (n, B) tensors or BK channels unbound."""
    if th is None:
        return None
    rows = {k: v.unbind(0) for k, v in S.subth(th, name).items()}
    n = len(next(iter(rows.values())))
    return [{k: r[i] for k, r in rows.items()} for i in range(n)]


def unstack_blocks(tree: dict) -> dict:
    """Split every `STACKED` subtree of a reference-shaped parameter tree
    into a list of per-layer subtrees (views along the stack axis)."""
    out = dict(tree)
    for name in STACKED:
        if name in out:
            out[name] = _unstack(out[name], _stack_len(out[name]))
    return out


def _count(spec) -> int:
    return sum(int(np.prod(p.shape, dtype=np.int64))
               for _, p in S._walk(spec))


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    spec: dict
    layout: S.GroupLayout  # clipping groups of `spec`
    loss_fn: Callable  # (stacked params, batch, th) -> (B,) losses
    serve_step: Callable  # (params, cache, batch) -> (logits, cache)
    init_cache: Callable  # (batch_size, cache_len): the contiguous plane
    # (slots, cache_len, *, num_pages, page_len): the paged plane; raises
    # on a sliding-window GQA config, whose ring keeps the contiguous one;
    # None for the recurrent and hybrid families (the reference's
    # `paged_ok`: their O(1) state and ring have nothing to page)
    init_paged_cache: Callable | None
    prefill_step: Callable  # (params, batch) -> last logits (B, V)
    num_params: int
    # groups the loss consumes twice a step (MTP's second `embed` and
    # `head`): BK falls back to two passes on such a layout
    reused_groups: tuple[str, ...] = ()
    # DP-LoRA: the frozen tree's clipping groups (run at +inf); the
    # subtree that trains ("lora", None for a full fine-tune) and the spec
    # the step noises and updates (`{"lora": ...}`, else `spec`)
    base_layout: S.GroupLayout | None = None
    trainable_key: str | None = None
    dp_spec: dict | None = None
    # the encoder-decoder's encoder, (params, frames, th) -> (B, S, D), and
    # its cross cache fill, (params, frames, batch_size, cache_len) -> cache
    encode: Callable | None = None
    prefill_cross: Callable | None = None

    def _draw(self, generator: torch.Generator) -> dict:
        # the base first, so its draws do not depend on the adapters
        base = {k: v for k, v in self.spec.items() if k != "lora"}
        tree = S.init_params(base, generator)
        if "lora" in self.spec:
            tree["lora"] = S.init_params(self.spec["lora"], generator)
        return tree

    def init_params(self, generator: torch.Generator) -> Any:
        """Random serving parameters from `generator`, on its device (a
        LoRA model's adapters stay stacked under `lora`)."""
        return unstack_blocks(self._draw(generator))

    def init_train_params(self, generator: torch.Generator) -> Any:
        """Random training parameters (the reference's stacked layout)
        from `generator`, on its device."""
        return self._draw(generator)

    @staticmethod
    def cache_slot_axes(cache) -> dict:
        return cache_slot_axes(cache)

    def abstract_cache(self, batch_size: int, cache_len: int) -> dict:
        """The shape-only `init_cache(batch_size, cache_len)` of every
        family (the reference's `jax.eval_shape` of it): meta tensors of
        its shapes and dtypes, made under a `FakeTensorMode` (nothing is
        allocated on the model's device)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            cache = self.init_cache(batch_size, cache_len)
        return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in cache.items()}


def build_model(cfg: ModelConfig, *, rwkv_formulation: str = "scan",
                device: str | torch.device = "cuda") -> Model:
    """The model of `cfg`: a decoder (dense or MoE with GQA or MLA, dense
    with M-RoPE, Mamba2, RWKV-6 or Zamba2's hybrid) or Whisper's
    encoder-decoder (arch_type 'audio'). rwkv_formulation: RWKV-6's
    training and prefill form, 'scan' (the reference's default) or
    'chunked'. `device` is where the decode caches allocate; `cuda`
    unless the caller asks for the CPU."""
    if rwkv_formulation not in ("scan", "chunked"):
        raise ValueError(f"rwkv_formulation must be 'scan' or 'chunked', "
                         f"got {rwkv_formulation!r}")
    cfg.validate()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    if cfg.arch_type == "audio":
        return _build_encdec(cfg, device)
    spec = decoder_spec(cfg)
    base_spec = {k: v for k, v in spec.items() if k != "lora"}
    base_layout = S.GroupLayout(base_spec)
    lora_on = "lora" in spec
    dp_spec = {"lora": spec["lora"]} if lora_on else spec
    serve_step, init_cache, init_paged_cache = _make_decoder_serve(
        cfg, base_spec, device)
    return Model(cfg=cfg, spec=spec,
                 layout=S.GroupLayout(dp_spec) if lora_on else base_layout,
                 loss_fn=_make_decoder_loss(cfg, base_layout if lora_on
                                            else None, rwkv_formulation),
                 serve_step=serve_step, init_cache=init_cache,
                 init_paged_cache=init_paged_cache,
                 prefill_step=_make_prefill(cfg, rwkv_formulation),
                 num_params=_count(spec),
                 # the adapters' layout holds no embed or head group
                 reused_groups=(("embed", "head")
                                if cfg.mtp_depth and not lora_on else ()),
                 base_layout=base_layout,
                 trainable_key="lora" if lora_on else None,
                 dp_spec=dp_spec)


# ---------------------------------------------------------------------------
# Training forward.
# ---------------------------------------------------------------------------


def _apply_attn_block(cfg, params, x, th, positions, moe_layer=False,
                      window=None, lora=None, lora_th=None, causal=True,
                      enc_out=None):
    """One block -> (x, aux): aux is the MoE block's (B,) f32 load-balance
    loss, None for a dense block; th: this block's thresholds, (B,) per
    group ((E, B) per expert group), or None for the plain forward
    (prefill); positions: (B, T), or M-RoPE's (3, B, T) streams
    (`A.gqa_attention`); window: GQA's sliding window (MLA has none, as
    in the reference); lora / lora_th: this layer's DP-LoRA adapters and
    their thresholds (`models.attention`); causal: False in the encoder;
    enc_out: the encoder's output (B, S, D), which a decoder block of the
    encoder-decoder attends to after its self-attention
    (`_cross_attention`)."""
    def sub(name):
        return None if th is None else S.subth(th, name)

    def one(name):
        return None if th is None else th[name]

    h = L.rmsnorm(params["attn_norm"], x, one("attn_norm"), eps=cfg.norm_eps)
    if cfg.attention_kind == "mla":
        att = A.mla_attention(cfg, params["attn"], h, positions, sub("attn"),
                              lora=lora, lora_th=lora_th)
    else:
        att = A.gqa_attention(cfg, params["attn"], h, sub("attn"), positions,
                              causal=causal, window=window, lora=lora,
                              lora_th=lora_th)
    x = x + att
    if enc_out is not None:
        h = L.rmsnorm(params["cross_norm"], x, one("cross_norm"),
                      eps=cfg.norm_eps)
        x = x + _cross_attention(cfg, params["cross"], h, sub("cross"),
                                 *_cross_kv(cfg, params["cross"], enc_out,
                                            sub("cross")))
    h = L.rmsnorm(params["mlp_norm"], x, one("mlp_norm"), eps=cfg.norm_eps)
    if moe_layer:
        y, aux = MOE.moe_fn(cfg)(cfg, params["moe"], h, sub("moe"))
    else:
        y = L.swiglu(params["mlp"], h, sub("mlp"), f=cfg.d_ff)
        aux = None
    return x + y, aux


def _remat(cfg, fn, *args):
    """fn(*args), rematerialized in backward when `cfg.remat`."""
    if not cfg.remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def _block(cfg, params, x, th, positions, moe_layer=False, window=None,
           lora=None, lora_th=None, causal=True, enc_out=None):
    """`_apply_attn_block`, rematerialized in backward when `cfg.remat`."""
    return _remat(cfg, _apply_attn_block, cfg, params, x, th, positions,
                  moe_layer, window, lora, lora_th, causal, enc_out)


def _cross_kv(cfg, params, enc_out, th=None):
    """The cross-attention's keys and values, (B, S, KV, hd) each, from the
    encoder output (B, S, D) through `kv`; th None: the plain forward."""
    b, s = enc_out.shape[0], enc_out.shape[1]
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kv = L.linear(params["kv"], enc_out, _one(th, "kv"))
    return (kv[..., : kvh * hd].reshape(b, s, kvh, hd),
            kv[..., kvh * hd:].reshape(b, s, kvh, hd))


def _cross_attention(cfg, params, x, th, k, v):
    """The decoder's non-causal attention over the encoder's keys and
    values k, v (B, S, KV, hd) (`_cross_kv`, or the decode cache's):
    queries from x (B, T, D) through `qkv`, positions arange(T) and
    arange(S) (no rotation, no mask), then `o`; th None: the plain
    forward."""
    b, t, s = x.shape[0], x.shape[1], k.shape[1]
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q = L.linear(params["qkv"], x, _one(th, "qkv")).reshape(b, t, h, hd)
    qpos = torch.arange(t, device=x.device)[None].expand(b, t)
    kpos = torch.arange(s, device=x.device)[None].expand(b, s)
    out = A.attend(q, k, v, qpos, kpos, causal=False)
    return L.linear(params["o"], out.reshape(b, t, h * hd), _one(th, "o"))


def _sub(th, name):
    return None if th is None else S.subth(th, name)


def _one(th, name):
    return None if th is None else th[name]


def _apply_mamba_block(cfg, params, x, th):
    """x + Mamba2(norm(x)); th None: the plain forward."""
    h = L.rmsnorm(params["norm"], x, _one(th, "norm"), eps=cfg.norm_eps)
    return x + M2.mamba2_block(cfg, params["m"], h, _sub(th, "m"))


def _apply_rwkv_block(cfg, params, x, th, formulation):
    """One RWKV-6 layer over a whole sequence from a zero state (token
    shifts from zeros), as the reference's training forward."""
    bsz, d = x.shape[0], cfg.d_model
    _, nh, hd = R6.dims(cfg)
    zeros = x.new_zeros((bsz, 1, d))
    s0 = torch.zeros((bsz, nh, hd, hd), dtype=torch.float32,
                     device=x.device)
    h = L.rmsnorm(params["norm1"], x, _one(th, "norm1"), eps=cfg.norm_eps)
    att, _, _ = R6.time_mix(cfg, params["tm"], h, _sub(th, "tm"),
                            x_prev=zeros, state=s0, formulation=formulation)
    x = x + att
    h = L.rmsnorm(params["norm2"], x, _one(th, "norm2"), eps=cfg.norm_eps)
    ff, _ = R6.channel_mix(cfg, params["cm"], h, _sub(th, "cm"),
                           x_prev=zeros)
    return x + ff


def recurrent_backbone(cfg, params, x, th, positions, formulation="scan"):
    """The layers of a Mamba2, RWKV-6 or Zamba2 model over a sequence, each
    rematerialized when `cfg.remat`. params: the stacked tree (or the
    serving one, whose stacks are per-layer lists); th: the thresholds
    (channels) or None for the plain forward. Zamba2's shared attention
    block runs before layer i whenever i % shared_every == 0, under its
    one set of thresholds at every site."""
    name = "backbone" if cfg.shared_attention else "blocks"
    ths = _layer_th(th, name)
    for i, bp in enumerate(_layers(params, name)):
        bth = None if ths is None else ths[i]
        if cfg.shared_attention:
            if i % cfg.shared_every == 0:
                x, _ = _block(cfg, params["shared"], x, _sub(th, "shared"),
                              positions, window=cfg.sliding_window)
            x = _remat(cfg, _apply_mamba_block, cfg, bp, x, bth)
        elif "tm" in bp:
            x = _remat(cfg, _apply_rwkv_block, cfg, bp, x, bth, formulation)
        else:
            x = _remat(cfg, _apply_mamba_block, cfg, bp, x, bth)
    return x


def _per_example_ce(logits, targets):
    """(B,) mean CE over valid (target >= 0) positions, in f32."""
    valid = targets >= 0
    tsafe = torch.clamp(targets, min=0).long()
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    tok_ll = torch.gather(logits32, -1, tsafe[..., None])[..., 0]
    ce = (lse - tok_ll) * valid
    return torch.sum(ce, dim=-1) / torch.clamp(valid.sum(dim=-1), min=1)


def _with_vision(cfg, x, batch, streams=("positions3_full", "positions3")):
    """The decoder's input rows and positions: x (B, T, D) embedded text,
    with `batch['vision_embeds']` (B, Tv, D) prepended when given, and the
    positions of the Tv + T rows: `batch['positions']` or arange; under
    M-RoPE the first of `streams` in the batch, (B, 3, Tv + T) moved to
    (3, B, Tv + T), else the 1-D positions broadcast to three equal
    streams. Returns (x, positions, Tv)."""
    bsz = x.shape[0]
    tv = 0
    ve = batch.get("vision_embeds")
    if ve is not None:
        x = torch.cat([ve.to(x.dtype), x], dim=1)
        tv = ve.shape[1]
    if cfg.m_rope:
        for key in streams:
            if key in batch:
                return x, batch[key].movedim(1, 0), tv
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None].expand(
            bsz, x.shape[1])
    if cfg.m_rope:
        positions = positions[None].expand((3,) + tuple(positions.shape))
    return x, positions, tv


def _make_decoder_loss(cfg: ModelConfig,
                       base_layout: S.GroupLayout | None = None,
                       rwkv_formulation: str = "scan"):
    """The per-example loss; `base_layout` (DP-LoRA): the frozen tree's
    groups, run at +inf beside the adapters' thresholds."""
    recurrent = family(cfg) != "attention"
    def embed(params, tokens, th):
        return dpl.dp_embed(params["embed"]["w"], tokens, th["embed"])

    def head(params, x, th):
        return dpl.dp_linear(params["head"]["w"], None, x, th["head"])

    def mtp_loss(params, x, th, batch, positions):
        """DeepSeek-V3's MTP (depth 1): h_t (after the final norm) with
        embed(token_{t+1}) predicts token_{t+2} through one more block and
        the main head. `embed` and `head` run a second time under their
        own thresholds, as in the reference."""
        tokens = batch["tokens"]
        bsz = tokens.shape[0]
        nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        e = embed(params, nxt, th)
        mtp = params["mtp"]
        h = L.linear(mtp["proj"], torch.cat([x, e], dim=-1), th["mtp/proj"])
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[
                None].expand(bsz, tokens.shape[1])
        h, _ = _block(cfg, mtp["block"], h, S.subth(th, "mtp/block"),
                      positions)
        h = L.rmsnorm(mtp["norm"], h, th["mtp/norm"], eps=cfg.norm_eps)
        tgt = batch["targets"]
        tgt2 = torch.cat([tgt[:, 2:], tgt.new_full((bsz, 2), -1)], dim=1)
        return _per_example_ce(head(params, h, th), tgt2)

    def loss_fn(params, batch, th):
        """Per-example losses (B,): the cross-entropy plus the MoE layers'
        load-balance losses, plus 0.3 times the MTP loss of an MTP
        config. params: the stacked (reference-layout) tree; batch:
        {'tokens', 'targets' (-1 = ignore), optional 'positions'}, (B, T)
        each, and a VLM's optional 'vision_embeds' and M-RoPE streams
        (`_with_vision`); th: {group name: stack + (B,)} encoded thresholds
        (`GroupLayout.pack*`), or the BK capture's channels
        (`core.bk.build_channels`), which unbind per layer the same way;
        under DP-LoRA the adapters' only (`lora/...`), the frozen groups
        running at +inf. Each block is rematerialized in backward when
        `cfg.remat`."""
        tokens = batch["tokens"]
        bsz = tokens.shape[0]
        if base_layout is not None:
            th = {**base_layout.pack_value(float("inf"), bsz,
                                           device=tokens.device), **th}
        x, positions, tv = _with_vision(cfg, embed(params, tokens, th), batch)
        aux = None
        if recurrent:
            x = recurrent_backbone(cfg, params, x, th, positions,
                                   rwkv_formulation)
        stacks = {} if recurrent else unstack_blocks(params)
        for name, moe_layer in STACKS:
            if name not in stacks:
                continue
            ths = _layer_th(th, name)
            lora = lora_ths = None
            if base_layout is not None:  # the adapters ride the layer loop
                lora = params["lora"][name]
                lora_ths = _layer_th(th, "lora/" + name)
            for layer, bp in enumerate(stacks[name]):
                bth = ths[layer]
                lp = lth = None
                if lora is not None:
                    lp = layer_slice(lora, layer)
                    lth = lora_ths[layer]
                x, aux_l = _block(cfg, bp, x, bth, positions, moe_layer,
                                  cfg.sliding_window, lp, lth)
                if aux_l is not None:
                    aux = aux_l if aux is None else aux + aux_l
        x = L.rmsnorm(params["final_norm"], x[:, tv:], th["final_norm"],
                      eps=cfg.norm_eps)
        ce = _per_example_ce(head(params, x, th), batch["targets"])
        if cfg.mtp_depth:
            ce = ce + 0.3 * mtp_loss(params, x, th, batch, None if cfg.m_rope
                                     else positions)
        return ce if aux is None else ce + aux

    return loss_fn


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------

# Which axis of each decode-cache tensor indexes the slot; page pools are
# shared by every slot (None) and must pass through a slot recycle
# untouched.
_SLOT_AXIS_BY_KEY = {
    "pos": 0, "pt": 0,
    "conv": 1, "ssm": 1,  # mamba2 recurrent state, (n, B, ...)
    "tm_prev": 1, "cm_prev": 1, "wkv": 1,  # rwkv6 recurrent state
    "shared_k": 1, "shared_v": 1,  # zamba2's shared-attention ring
    "dec_k": 1, "dec_v": 1, "cross_k": 1, "cross_v": 1,  # enc-dec
}


def cache_slot_axes(cache) -> dict:
    """Map every decode-cache key to its slot axis (None = slot-free).
    Unknown keys raise, as in the reference."""
    out = {}
    for k in cache:
        if k in _SLOT_AXIS_BY_KEY:
            out[k] = _SLOT_AXIS_BY_KEY[k]
        elif k.endswith(("_kpool", "_vpool", "_latpool")):
            out[k] = None
        elif k.endswith(("_k", "_v", "_ckv", "_krope")):
            out[k] = 1  # per-stack contiguous caches: (n, B, S, ...)
        else:
            raise KeyError(
                f"decode-cache key {k!r} has no slot-axis entry; add it to "
                "transformer._SLOT_AXIS_BY_KEY (or a suffix rule)")
    return out


def _make_recurrent_serve(cfg: ModelConfig, device: torch.device):
    """`serve_step` and `init_cache` of the Mamba2, RWKV-6 and Zamba2
    families (the contiguous plane only: no paged cache)."""
    fam, n = family(cfg), cfg.num_layers
    d = cfg.d_model
    window = cfg.sliding_window

    def zeros(shape, dtype=cfg.dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def init_cache(batch_size: int, cache_len: int):
        """Per-slot state in the reference's keys and layout, `pos` (B,)
        int32 beside it: Mamba2's `conv` (n, B, K - 1, d_inner + 2N) conv
        window and `ssm` (n, B, H, P, N) f32 state; RWKV-6's `tm_prev` /
        `cm_prev` (n, B, 1, D) last inputs and `wkv` (n, B, H, hd, hd) f32
        state; Zamba2 adds its shared block's `shared_k` / `shared_v`
        (sites, B, cap, KV, hd) rings, cap = min(window, cache_len)."""
        b = batch_size
        cache = {"pos": torch.zeros((b,), dtype=torch.int32, device=device)}
        if fam == "rwkv6":
            _, nh, hd = R6.dims(cfg)
            cache["tm_prev"] = zeros((n, b, 1, d))
            cache["cm_prev"] = zeros((n, b, 1, d))
            cache["wkv"] = zeros((n, b, nh, hd, hd), torch.float32)
            return cache
        d_in, nh, nst, p = M2.dims(cfg)
        cache["conv"] = zeros((n, b, cfg.ssm_conv_kernel - 1, d_in + 2 * nst))
        cache["ssm"] = zeros((n, b, nh, p, nst), torch.float32)
        if fam == "hybrid":
            cap = min(window, cache_len) if window else cache_len
            kv = (shared_sites(cfg), b, cap, cfg.num_kv_heads,
                  cfg.resolved_head_dim)
            cache["shared_k"], cache["shared_v"] = zeros(kv), zeros(kv)
        return cache

    def write(view, new, active):
        """The new state into the cache's layer view, in place; rows with
        `active` False keep theirs."""
        view.copy_(A.masked_state(active, new, view))

    @torch.no_grad()
    def serve_step(params, cache, batch):
        """One-token decode (the attention families' contract, no
        tenants): the recurrent state and the shared block's ring are
        written in place, inactive rows keep theirs bit for bit."""
        token, active = batch["token"], batch.get("active")
        if "tenant" in batch or "lora_stack" in params:
            raise ValueError(f"{cfg.name}: multi-tenant serving needs "
                             f"attention stacks with adapters")
        pos = cache["pos"]
        x = params["embed"]["w"][token.long()]  # (B, 1, D)
        if fam == "rwkv6":
            for i, bp in enumerate(params["blocks"]):
                hn = L.rmsnorm(bp["norm1"], x, eps=cfg.norm_eps)
                att, tm_n, st_n = R6.time_mix_decode(
                    cfg, bp["tm"], hn, x_prev=cache["tm_prev"][i],
                    state=cache["wkv"][i])
                x = x + att
                hn = L.rmsnorm(bp["norm2"], x, eps=cfg.norm_eps)
                ff, cm_n = R6.channel_mix_decode(
                    cfg, bp["cm"], hn, x_prev=cache["cm_prev"][i])
                x = x + ff
                write(cache["tm_prev"][i], tm_n, active)
                write(cache["cm_prev"][i], cm_n, active)
                write(cache["wkv"][i], st_n, active)
        else:
            layers = params["backbone" if fam == "hybrid" else "blocks"]
            for i, bp in enumerate(layers):
                if fam == "hybrid" and i % cfg.shared_every == 0:
                    site = i // cfg.shared_every
                    sp = params["shared"]
                    hn = L.rmsnorm(sp["attn_norm"], x, eps=cfg.norm_eps)
                    x = x + A.gqa_decode(
                        cfg, sp["attn"], hn, cache["shared_k"][site],
                        cache["shared_v"][site], pos, window=window,
                        active=active)
                    hn = L.rmsnorm(sp["mlp_norm"], x, eps=cfg.norm_eps)
                    x = x + L.swiglu(sp["mlp"], hn, f=cfg.d_ff)
                hn = L.rmsnorm(bp["norm"], x, eps=cfg.norm_eps)
                out, conv_n, ssm_n = M2.mamba2_decode(
                    cfg, bp["m"], hn, cache["conv"][i], cache["ssm"][i])
                x = x + out
                write(cache["conv"][i], conv_n, active)
                write(cache["ssm"][i], ssm_n, active)
        x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
        logits = L.linear(params["head"], x)
        new_cache = dict(cache)
        new_cache["pos"] = (pos + 1 if active is None
                            else pos + active.to(torch.int32))
        return logits[:, 0], new_cache

    return serve_step, init_cache


def _make_decoder_serve(cfg: ModelConfig, spec: dict, device: torch.device):
    if family(cfg) != "attention":
        return _make_recurrent_serve(cfg, device) + (None,)
    mla = cfg.attention_kind == "mla"
    window = cfg.sliding_window
    # (stack name, layers, whether MoE) in the order the layers run
    stacks = [(name, spec[name]["attn_norm"]["s"].shape[0], moe_layer)
              for name, moe_layer in STACKS if name in spec]
    if mla:
        row = (cfg.kv_lora_rank + cfg.qk_rope_head_dim,)
    else:
        row = (cfg.num_kv_heads, cfg.resolved_head_dim)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    def init_cache(batch_size: int, cache_len: int):
        """The contiguous plane: per-slot caches, one set per layer stack
        in the reference's order and names: `<stack>_k` / `<stack>_v`
        (n, B, cap, KV, hd) for GQA, cap = min(window, cache_len) for a
        sliding-window config (a ring) and cache_len otherwise;
        `<stack>_ckv` (n, B, cache_len, kv_lora_rank) and `<stack>_krope`
        (n, B, cache_len, rope) for MLA; and `pos` (B,) int32."""
        b = batch_size
        cap = min(window, cache_len) if window else cache_len
        cache = {"pos": torch.zeros((b,), dtype=torch.int32, device=device)}
        for name, n, _ in stacks:
            if mla:
                cache[f"{name}_ckv"] = zeros(
                    (n, b, cache_len, cfg.kv_lora_rank))
                cache[f"{name}_krope"] = zeros(
                    (n, b, cache_len, cfg.qk_rope_head_dim))
            else:
                cache[f"{name}_k"] = zeros((n, b, cap) + row)
                cache[f"{name}_v"] = zeros((n, b, cap) + row)
        return cache

    def init_paged_cache(batch_size: int, cache_len: int, *, num_pages: int,
                         page_len: int):
        """Per-slot int32 page tables plus physical page pools shared by
        every slot, one set per layer stack in the reference's order and
        names: `<stack>_kpool` / `<stack>_vpool` (n, num_pages + 1,
        page_len, KV, hd) for GQA, `<stack>_latpool` (n, num_pages + 1,
        page_len, kv_lora_rank + qk_rope_head_dim) for MLA. The extra
        LAST page is the trash page that absorbs writes from inactive
        rows. Tables start fully trash-mapped; the engine overwrites them
        at admission. Each layer's slice `cache[key][l]` is a contiguous
        view. A sliding-window GQA config is refused, as the reference's
        `paged_ok` refuses it: its ring keeps the contiguous plane."""
        if window is not None and not mla:
            raise ValueError(
                "paged cache is only supported for full-attention decoder "
                "stacks (ring-window families bypass paging)")
        b = batch_size
        p_tab = -(-cache_len // page_len)
        cache = {"pos": torch.zeros((b,), dtype=torch.int32, device=device),
                 "pt": torch.full((b, p_tab), num_pages, dtype=torch.int32,
                                  device=device)}
        for name, n, _ in stacks:
            shape = (n, num_pages + 1, page_len) + row
            for kind in (("latpool",) if mla else ("kpool", "vpool")):
                cache[f"{name}_{kind}"] = zeros(shape)
        return cache

    def attention(name, layer, bp, hn, cache, pos, active, lora, tenant):
        """One layer's decode attention on the cache's plane: paged when
        `pt` is in the cache, as the reference chooses, else contiguous;
        lora / tenant: the layer's tenant-stacked adapters and the rows'
        slot ids (None, None for a single model)."""
        kw = dict(active=active, lora=lora, tenant=tenant)
        if "pt" in cache:
            if mla:
                return A.mla_decode_paged(
                    cfg, bp, hn, cache[f"{name}_latpool"][layer],
                    cache["pt"], pos, **kw)
            return A.gqa_decode_paged(
                cfg, bp, hn, cache[f"{name}_kpool"][layer],
                cache[f"{name}_vpool"][layer], cache["pt"], pos, **kw)
        if mla:
            return A.mla_decode(cfg, bp, hn, cache[f"{name}_ckv"][layer],
                                cache[f"{name}_krope"][layer], pos, **kw)
        return A.gqa_decode(cfg, bp, hn, cache[f"{name}_k"][layer],
                            cache[f"{name}_v"][layer], pos, window=window,
                            **kw)

    @torch.no_grad()
    def serve_step(params, cache, batch):
        """batch: {'token': (B, 1) int32, optional 'active': (B,) bool,
        optional 'tenant': (B,) int}; returns (logits (B, V) in the model
        dtype, cache). `cache` is a paged cache (`init_paged_cache`) or a
        contiguous one (`init_cache`).

        Multi-tenant serving: `params['lora_stack']` (the tenant-stacked
        adapters, leaves (n, T, ...)) together with `batch['tenant']` (the
        rows' adapter-slot ids), both or neither, adds every row's own
        adapter delta to the adapted projections. Both are data of fixed
        shape: admitting a tenant or swapping an adapter changes no
        input shape here.

        Rows with `active=False` leave every live entry untouched (a paged
        write goes to the trash page, a contiguous one rewrites its own
        bits) and keep their position; their logits are garbage and must
        be ignored. They are still routed through the MoE layers with the
        rest, as in the reference, so they take expert slots. The caches
        are updated in place; the returned dict holds the same cache
        tensors and a new `pos`."""
        token = batch["token"]
        active = batch.get("active")
        lstack = params.get("lora_stack")
        tenant = batch.get("tenant")
        if (lstack is None) != (tenant is None):
            raise ValueError(
                "multi-tenant serve_step needs BOTH params['lora_stack'] "
                "and batch['tenant'] (or neither)")
        pos = cache["pos"]
        x = params["embed"]["w"][token.long()]  # (B, 1, D)
        for name, _, moe_layer in stacks:
            for layer, bp in enumerate(params[name]):
                lp = (None if lstack is None
                      else layer_slice(lstack[name], layer))
                hn = L.rmsnorm(bp["attn_norm"], x, eps=cfg.norm_eps)
                x = x + attention(name, layer, bp["attn"], hn, cache, pos,
                                  active, lp, tenant)
                hn = L.rmsnorm(bp["mlp_norm"], x, eps=cfg.norm_eps)
                if moe_layer:
                    y, _ = MOE.moe_fn(cfg)(cfg, bp["moe"], hn)
                else:
                    y = L.swiglu(bp["mlp"], hn, f=cfg.d_ff)
                x = x + y
        x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
        logits = L.linear(params["head"], x)
        new_cache = dict(cache)
        new_cache["pos"] = (pos + 1 if active is None
                            else pos + active.to(torch.int32))
        return logits[:, 0], new_cache

    return serve_step, init_cache, init_paged_cache


def _make_prefill(cfg: ModelConfig, rwkv_formulation: str = "scan"):
    recurrent = family(cfg) != "attention"

    @torch.no_grad()
    def prefill_step(params, batch):
        """The full-sequence forward to the last position's logits (B, V),
        in the model dtype: the inference-prefill workload. params: the
        serving parameters (per-layer blocks, as `serve_step` takes);
        batch: {'tokens': (B, T), optional 'positions': (B, T)}, and a
        VLM's optional 'vision_embeds' and 'positions3_full'
        (`_with_vision`; the reference's prefill reads no 'positions3').
        A LoRA model's trained adapters (`params['lora']`, stacked) run
        in their layers, as in the reference's prefill."""
        tokens = batch["tokens"]
        x, positions, _ = _with_vision(
            cfg, params["embed"]["w"][tokens.long()], batch,
            streams=("positions3_full",))
        lora = params.get("lora")
        if recurrent:
            x = recurrent_backbone(cfg, params, x, None, positions,
                                   rwkv_formulation)
        for name, moe_layer in STACKS:
            for layer, bp in enumerate(params.get(name, ())):
                lp = None if lora is None else layer_slice(lora[name], layer)
                x, _ = _apply_attn_block(cfg, bp, x, None, positions,
                                         moe_layer, cfg.sliding_window, lp)
        x = L.rmsnorm(params["final_norm"], x[:, -1:], eps=cfg.norm_eps)
        return L.linear(params["head"], x)[:, 0]

    return prefill_step


# ---------------------------------------------------------------------------
# Encoder-decoder (Whisper; the mel and conv frontend stubbed: `frames` are
# precomputed frame embeddings (B, S_enc, D)).
# ---------------------------------------------------------------------------


def _build_encdec(cfg: ModelConfig, device: torch.device) -> Model:
    """Whisper's backbone: `enc_blocks` (non-causal blocks over the frames
    plus sinusoidal positions, then `enc_norm`) and `dec_blocks` (causal
    self-attention, cross-attention over the encoder output, SwiGLU),
    each block rematerialized when `cfg.remat`. One clipping group per
    leaf, as in the reference; the reference builds no adapters here, so
    a `lora_rank` is refused."""
    if cfg.lora_rank:
        raise ValueError(f"{cfg.name}: the encoder-decoder has no DP-LoRA "
                         f"layout (the reference builds none)")
    d, v = cfg.d_model, cfg.vocab_size
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    spec = {
        "embed": {"w": P((v, d), init="embed", dtype=cfg.dtype)},
        "enc_blocks": _attn_block_spec(cfg, n_enc, moe_layer=False),
        "enc_norm": L.rmsnorm_spec(d, dtype=cfg.dtype),
        "dec_blocks": _attn_block_spec(cfg, n_dec, moe_layer=False,
                                       cross=True),
        "final_norm": L.rmsnorm_spec(d, dtype=cfg.dtype),
        "head": {"w": P((d, v), dtype=cfg.dtype)},
    }
    layout = S.GroupLayout(spec)

    def arange(b, t, dev):
        return torch.arange(t, device=dev)[None].expand(b, t)

    def encode(params, frames, th=None):
        """(B, S, D) frame embeddings -> the encoder output (B, S, D);
        th: the thresholds (or BK channels), None for the plain forward."""
        b, s = frames.shape[0], frames.shape[1]
        x = (frames.to(cfg.dtype)
             + L.sinusoidal_positions(s, d, frames.device).to(cfg.dtype))
        positions = arange(b, s, frames.device)
        ths = _layer_th(th, "enc_blocks")
        blk = _apply_attn_block if th is None else _block
        for i, bp in enumerate(_layers(params, "enc_blocks")):
            x, _ = blk(cfg, bp, x, None if ths is None else ths[i],
                       positions, causal=False)
        return L.rmsnorm(params["enc_norm"], x, _one(th, "enc_norm"),
                         eps=cfg.norm_eps)

    def decode_seq(params, batch, th):
        """The decoder over the whole token sequence, after the final norm:
        (B, T, D)."""
        tokens = batch["tokens"]
        b, t = tokens.shape
        enc_out = encode(params, batch["frames"], th)
        if th is None:
            x = params["embed"]["w"][tokens.long()]
        else:
            x = dpl.dp_embed(params["embed"]["w"], tokens, th["embed"])
        x = x + L.sinusoidal_positions(t, d, x.device).to(x.dtype)
        positions = arange(b, t, tokens.device)
        ths = _layer_th(th, "dec_blocks")
        blk = _apply_attn_block if th is None else _block
        for i, bp in enumerate(_layers(params, "dec_blocks")):
            x, _ = blk(cfg, bp, x, None if ths is None else ths[i],
                       positions, enc_out=enc_out)
        return x

    def loss_fn(params, batch, th):
        """Per-example losses (B,): the decoder's cross-entropy. batch:
        {'frames': (B, S_enc, D), 'tokens', 'targets' (-1 = ignore)}."""
        x = decode_seq(params, batch, th)
        x = L.rmsnorm(params["final_norm"], x, th["final_norm"],
                      eps=cfg.norm_eps)
        return _per_example_ce(
            dpl.dp_linear(params["head"]["w"], None, x, th["head"]),
            batch["targets"])

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    def init_cache(batch_size: int, cache_len: int):
        """The contiguous plane: `dec_k` / `dec_v` (n_dec, B, cache_len,
        KV, hd) self-attention caches, `cross_k` / `cross_v` (n_dec, B,
        encoder_seq_len, KV, hd) cross-attention caches (zeros until
        `prefill_cross`), and `pos` (B,) int32."""
        b = batch_size
        self_kv = (n_dec, b, cache_len, kvh, hd)
        cross_kv = (n_dec, b, cfg.encoder_seq_len, kvh, hd)
        return {"pos": torch.zeros((b,), dtype=torch.int32, device=device),
                "dec_k": zeros(self_kv), "dec_v": zeros(self_kv),
                "cross_k": zeros(cross_kv), "cross_v": zeros(cross_kv)}

    @torch.no_grad()
    def prefill_cross(params, frames, batch_size: int, cache_len: int):
        """A fresh decode cache whose cross-attention caches hold each
        decoder layer's keys and values of the encoder output of `frames`
        (B, S, D)."""
        enc_out = encode(params, frames)
        cache = init_cache(batch_size, cache_len)
        ks, vs = zip(*(_cross_kv(cfg, bp["cross"], enc_out)
                       for bp in _layers(params, "dec_blocks")))
        cache["cross_k"], cache["cross_v"] = torch.stack(ks), torch.stack(vs)
        return cache

    postab = {}  # the sinusoidal decode table, built once per device

    @torch.no_grad()
    def serve_step(params, cache, batch):
        """One-token decode (no tenants): the self-attention cache written
        in place (`gqa_decode`, inactive rows keep their bits), the
        cross-attention over the cache's encoder keys and values; the
        token's sinusoidal position at min(pos, max_seq_len - 1), as the
        reference."""
        token, active = batch["token"], batch.get("active")
        if "tenant" in batch or "lora_stack" in params:
            raise ValueError(f"{cfg.name}: multi-tenant serving needs "
                             f"attention stacks with adapters")
        pos = cache["pos"]
        x = params["embed"]["w"][token.long()]  # (B, 1, D)
        dev = x.device
        if dev not in postab:
            postab[dev] = L.sinusoidal_positions(cfg.max_seq_len, d,
                                                 dev).to(cfg.dtype)
        tab = postab[dev]
        x = x + tab[torch.clamp(pos, max=cfg.max_seq_len - 1).long()][:, None]
        for i, bp in enumerate(params["dec_blocks"]):
            hn = L.rmsnorm(bp["attn_norm"], x, eps=cfg.norm_eps)
            x = x + A.gqa_decode(cfg, bp["attn"], hn, cache["dec_k"][i],
                                 cache["dec_v"][i], pos, active=active)
            hn = L.rmsnorm(bp["cross_norm"], x, eps=cfg.norm_eps)
            x = x + _cross_attention(cfg, bp["cross"], hn, None,
                                     cache["cross_k"][i], cache["cross_v"][i])
            hn = L.rmsnorm(bp["mlp_norm"], x, eps=cfg.norm_eps)
            x = x + L.swiglu(bp["mlp"], hn, f=cfg.d_ff)
        x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
        logits = L.linear(params["head"], x)
        new_cache = dict(cache)
        new_cache["pos"] = (pos + 1 if active is None
                            else pos + active.to(torch.int32))
        return logits[:, 0], new_cache

    @torch.no_grad()
    def prefill_step(params, batch):
        """The full-sequence forward to the last position's logits (B, V):
        batch {'frames': (B, S_enc, D), 'tokens': (B, T)}."""
        x = decode_seq(params, batch, None)
        x = L.rmsnorm(params["final_norm"], x[:, -1:], eps=cfg.norm_eps)
        return L.linear(params["head"], x)[:, 0]

    return Model(cfg=cfg, spec=spec, layout=layout, loss_fn=loss_fn,
                 serve_step=serve_step, init_cache=init_cache,
                 init_paged_cache=None, prefill_step=prefill_step,
                 num_params=_count(spec), base_layout=layout,
                 dp_spec=spec, encode=encode, prefill_cross=prefill_cross)

"""Model assembly for the dense and MoE decoder families: the counterpart
of `repro.models.transformer`, cut to what serving and DP training run.
Dense and MoE models (flat or grouped dispatch) with GQA (QKV bias,
sliding window) or MLA attention serve and train; an MTP config
(deepseek-v3-671b) adds DeepSeek's multi-token-prediction loss to
training.

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
`dense_blocks` and, for an MoE config, `moe_blocks` (its first
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
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig

# spec subtrees whose leaves carry a leading layer-stack dim, in the
# order the layers run: (name, whether its blocks are MoE)
STACKS = (("dense_blocks", False), ("moe_blocks", True))
STACKED = tuple(name for name, _ in STACKS)


def _attn_block_spec(cfg: ModelConfig, n: int, *, moe_layer: bool) -> dict:
    """A block's spec, stacked n deep (n = 0: one unstacked block)."""
    stack = (n,) if n else ()
    spec = {
        "attn_norm": L.rmsnorm_spec(cfg.d_model, stack=stack, dtype=cfg.dtype),
        "attn": (A.mla_spec(cfg, stack=stack) if cfg.attention_kind == "mla"
                 else A.gqa_spec(cfg, stack=stack)),
        "mlp_norm": L.rmsnorm_spec(cfg.d_model, stack=stack, dtype=cfg.dtype),
    }
    if moe_layer:
        spec["moe"] = MOE.moe_spec(cfg, stack=stack)
    else:
        spec["mlp"] = L.swiglu_spec(cfg.d_model, cfg.d_ff, stack=stack,
                                    dtype=cfg.dtype)
    return spec


def decoder_spec(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    spec = {"embed": {"w": P((v, d), init="embed", dtype=cfg.dtype)},
            "final_norm": L.rmsnorm_spec(d, dtype=cfg.dtype),
            "head": {"w": P((d, v), dtype=cfg.dtype)}}
    n_moe = cfg.num_layers - cfg.first_k_dense if cfg.num_experts else 0
    n_dense = cfg.num_layers - n_moe
    if n_dense:
        spec["dense_blocks"] = _attn_block_spec(cfg, n_dense,
                                                moe_layer=False)
    if n_moe:
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
    for name in STACKED:
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


def unstack_blocks(tree: dict) -> dict:
    """Split every `STACKED` subtree of a reference-shaped parameter tree
    into a list of per-layer subtrees (views along the stack axis)."""
    out = dict(tree)
    for name in STACKED:
        if name in out:
            n = out[name]["attn_norm"]["s"].shape[0]
            out[name] = _unstack(out[name], n)
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
    # on a sliding-window GQA config, whose ring keeps the contiguous one
    init_paged_cache: Callable
    prefill_step: Callable  # (params, {'tokens'}) -> last logits (B, V)
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


def build_model(cfg: ModelConfig, *, device: str | torch.device = "cuda"
                ) -> Model:
    """The dense or MoE decoder, GQA or MLA. `device` is where
    `init_paged_cache` allocates; `cuda` unless the caller asks for the
    CPU."""
    cfg.validate()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
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
                                            else None),
                 serve_step=serve_step, init_cache=init_cache,
                 init_paged_cache=init_paged_cache,
                 prefill_step=_make_prefill(cfg),
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
                      window=None, lora=None, lora_th=None):
    """One block -> (x, aux): aux is the MoE block's (B,) f32 load-balance
    loss, None for a dense block; th: this block's thresholds, (B,) per
    group ((E, B) per expert group), or None for the plain forward
    (prefill); window: GQA's sliding window (MLA has none, as in the
    reference); lora / lora_th: this layer's DP-LoRA adapters and their
    thresholds (`models.attention`)."""
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
                              window=window, lora=lora, lora_th=lora_th)
    x = x + att
    h = L.rmsnorm(params["mlp_norm"], x, one("mlp_norm"), eps=cfg.norm_eps)
    if moe_layer:
        y, aux = MOE.moe_fn(cfg)(cfg, params["moe"], h, sub("moe"))
    else:
        y = L.swiglu(params["mlp"], h, sub("mlp"), f=cfg.d_ff)
        aux = None
    return x + y, aux


def _block(cfg, params, x, th, positions, moe_layer=False, window=None,
           lora=None, lora_th=None):
    """`_apply_attn_block`, rematerialized in backward when `cfg.remat`."""
    if not cfg.remat:
        return _apply_attn_block(cfg, params, x, th, positions, moe_layer,
                                 window, lora, lora_th)
    return torch.utils.checkpoint.checkpoint(
        _apply_attn_block, cfg, params, x, th, positions, moe_layer, window,
        lora, lora_th, use_reentrant=False, preserve_rng_state=False)


def _per_example_ce(logits, targets):
    """(B,) mean CE over valid (target >= 0) positions, in f32."""
    valid = targets >= 0
    tsafe = torch.clamp(targets, min=0).long()
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    tok_ll = torch.gather(logits32, -1, tsafe[..., None])[..., 0]
    ce = (lse - tok_ll) * valid
    return torch.sum(ce, dim=-1) / torch.clamp(valid.sum(dim=-1), min=1)


def _make_decoder_loss(cfg: ModelConfig,
                       base_layout: S.GroupLayout | None = None):
    """The per-example loss; `base_layout` (DP-LoRA): the frozen tree's
    groups, run at +inf beside the adapters' thresholds."""
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
        each; th: {group name: stack + (B,)} encoded thresholds
        (`GroupLayout.pack*`), or the BK capture's channels
        (`core.bk.build_channels`), which unbind per layer the same way;
        under DP-LoRA the adapters' only (`lora/...`), the frozen groups
        running at +inf. Each block is rematerialized in backward when
        `cfg.remat`."""
        tokens = batch["tokens"]
        bsz, t = tokens.shape
        if base_layout is not None:
            th = {**base_layout.pack_value(float("inf"), bsz,
                                           device=tokens.device), **th}
        x = embed(params, tokens, th)
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(t, device=tokens.device)[None].expand(
                bsz, t)
        aux = None
        stacks = unstack_blocks(params)
        for name, moe_layer in STACKS:
            if name not in stacks:
                continue
            rows = {k: v.unbind(0) for k, v in S.subth(th, name).items()}
            lora = lora_rows = None
            if base_layout is not None:  # the adapters ride the layer loop
                lora = params["lora"][name]
                lora_rows = {k: v.unbind(0) for k, v in
                             S.subth(th, "lora/" + name).items()}
            for layer, bp in enumerate(stacks[name]):
                bth = {k: r[layer] for k, r in rows.items()}
                lp = lth = None
                if lora is not None:
                    lp = layer_slice(lora, layer)
                    lth = {k: r[layer] for k, r in lora_rows.items()}
                x, aux_l = _block(cfg, bp, x, bth, positions, moe_layer,
                                  cfg.sliding_window, lp, lth)
                if aux_l is not None:
                    aux = aux_l if aux is None else aux + aux_l
        x = L.rmsnorm(params["final_norm"], x, th["final_norm"],
                      eps=cfg.norm_eps)
        ce = _per_example_ce(head(params, x, th), batch["targets"])
        if cfg.mtp_depth:
            ce = ce + 0.3 * mtp_loss(params, x, th, batch, positions)
        return ce if aux is None else ce + aux

    return loss_fn


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------

# Which axis of each decode-cache tensor indexes the slot; page pools are
# shared by every slot (None) and must pass through a slot recycle
# untouched.
_SLOT_AXIS_BY_KEY = {"pos": 0, "pt": 0}


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


def _make_decoder_serve(cfg: ModelConfig, spec: dict, device: torch.device):
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


def _make_prefill(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        """The full-sequence forward to the last position's logits (B, V),
        in the model dtype: the inference-prefill workload. params: the
        serving parameters (per-layer blocks, as `serve_step` takes);
        batch: {'tokens': (B, T), optional 'positions': (B, T)}. A LoRA
        model's trained adapters (`params['lora']`, stacked) run in
        their layers, as in the reference's prefill. The reference's
        vision and M-RoPE branches are ROADMAP A.9."""
        tokens = batch["tokens"]
        bsz, t = tokens.shape
        x = params["embed"]["w"][tokens.long()]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(t, device=tokens.device)[None].expand(
                bsz, t)
        lora = params.get("lora")
        for name, moe_layer in STACKS:
            for layer, bp in enumerate(params.get(name, ())):
                lp = None if lora is None else layer_slice(lora[name], layer)
                x, _ = _apply_attn_block(cfg, bp, x, None, positions,
                                         moe_layer, cfg.sliding_window, lp)
        x = L.rmsnorm(params["final_norm"], x[:, -1:], eps=cfg.norm_eps)
        return L.linear(params["head"], x)[:, 0]

    return prefill_step

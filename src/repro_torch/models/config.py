"""Model configuration for the dense and MoE decoder families.

The counterpart of `repro.models.config.ModelConfig`, cut to the fields
the dense and MoE families read (GQA with its QKV bias and sliding window,
or MLA attention; flat or grouped dispatch; DeepSeek-V3's MTP depth); the
recurrent, encoder-decoder and M-RoPE fields arrive with their families.
`dtype` is a torch dtype.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int | None = None  # default d_model // num_heads
    qk_norm: bool = False  # per-head RMSNorm on q, k (Qwen3)
    qkv_bias: bool = False  # Qwen1.5
    sliding_window: int | None = None  # window size; None = full attention
    rope_theta: float = 10_000.0
    attention_kind: str = "gqa"  # gqa | mla
    # MLA (DeepSeek-V3): compressed-latent attention
    q_lora_rank: int = 0  # 0 => direct q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # MoE: token-choice top-k routing with capacity dispatch
    num_experts: int = 0  # 0 => dense MLP
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (d_ff: the dense layers')
    first_k_dense: int = 0  # leading dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # flat: global capacity, masked-gram norms; grouped: per-(example,
    # expert) buffers, block-diagonal norms (~B x cheaper)
    moe_dispatch: str = "flat"
    # DeepSeek-V3 multi-token prediction: one extra block predicting token
    # t+2 (its loss weighs 0.3; serving carries the `mtp` parameters and
    # does not read them)
    mtp_depth: int = 0
    dtype: torch.dtype = torch.float32
    norm_eps: float = 1e-5
    # per-shard clipping layout: the qkv and o projections split into M
    # column blocks, each its own clipping group (M virtual model shards)
    dp_blocks: int = 1
    # DP-LoRA (the paper's large-model recipe, Sec. 5.3): adapters of rank
    # lora_rank on the attention projections, the base frozen; 0 = a full
    # fine-tune. The adapter term is scaled by lora_alpha / lora_rank.
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # rematerialize each block in the training forward (activation
    # checkpointing): backward keeps only block inputs and recomputes the
    # rest, at about 1.33x the forward FLOPs
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def validate(self) -> None:
        if self.arch_type not in ("dense", "moe"):
            raise NotImplementedError(
                f"{self.name}: only the dense and MoE decoder families are "
                f"ported")
        if self.attention_kind not in ("gqa", "mla"):
            raise NotImplementedError(
                f"{self.name}: attention {self.attention_kind!r} is not "
                f"ported (the port has gqa and mla)")
        if self.num_experts:
            if self.moe_dispatch not in ("flat", "grouped"):
                raise ValueError(f"{self.name}: moe_dispatch "
                                 f"{self.moe_dispatch!r} is not flat or "
                                 f"grouped")
            if self.num_experts_per_tok < 1 or self.moe_d_ff < 1:
                raise ValueError(f"{self.name}: an MoE config needs "
                                 f"num_experts_per_tok and moe_d_ff")
        if self.num_kv_heads < 1 or self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"{self.name}: num_heads={self.num_heads} must be a multiple "
                f"of num_kv_heads={self.num_kv_heads}")
        m = self.dp_blocks
        qkv = (self.num_heads + 2 * self.num_kv_heads) * self.resolved_head_dim
        if m < 1 or qkv % m or self.d_model % m:
            raise ValueError(
                f"{self.name}: dp_blocks={m} must divide the qkv output "
                f"width {qkv} and the o output width {self.d_model}")

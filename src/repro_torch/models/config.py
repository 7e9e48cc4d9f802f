"""Model configuration for the dense decoder family.

The counterpart of `repro.models.config.ModelConfig`, cut to the fields
the dense family reads; the MLA, MoE, recurrent, encoder-decoder and
M-RoPE fields arrive with their families. `dtype` is a torch dtype.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense (the only family ported so far)
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int | None = None  # default d_model // num_heads
    qk_norm: bool = False  # per-head RMSNorm on q, k (Qwen3)
    rope_theta: float = 10_000.0
    dtype: torch.dtype = torch.float32
    norm_eps: float = 1e-5
    # per-shard clipping layout: the qkv and o projections split into M
    # column blocks, each its own clipping group (M virtual model shards)
    dp_blocks: int = 1
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
        if self.arch_type != "dense":
            raise NotImplementedError(
                f"{self.name}: only the dense decoder family is ported")
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

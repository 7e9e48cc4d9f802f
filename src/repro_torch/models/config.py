"""Model configuration for every family the port runs.

The counterpart of `repro.models.config.ModelConfig`, cut to the fields
the families read: dense and MoE decoders (GQA with its QKV bias and
sliding window, or MLA attention; flat or grouped dispatch; DeepSeek-V3's
MTP depth), Mamba2 and RWKV-6 blocks and Zamba2's shared attention block,
Whisper's encoder-decoder (`encoder_layers`, `encoder_seq_len`, the
sinusoidal table's `max_seq_len`) and Qwen2-VL's M-RoPE (`m_rope`,
`m_rope_sections`). `dtype` is a torch dtype.

`InputShape` and `INPUT_SHAPES` are the reference's four workload shapes,
which the dry run (`launch.dryrun`) builds its inputs from.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0  # 0 => attention-free (pure SSM)
    num_kv_heads: int = 0
    head_dim: int | None = None  # default d_model // num_heads
    qk_norm: bool = False  # per-head RMSNorm on q, k (Qwen3)
    qkv_bias: bool = False  # Qwen1.5
    sliding_window: int | None = None  # window size; None = full attention
    rope_theta: float = 10_000.0
    attention_kind: str = "gqa"  # gqa | mla | none
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
    # SSM: Mamba2 (state size 0 => no Mamba2 layers)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256
    # SSM: RWKV-6
    rwkv_head_dim: int = 64
    # hybrid layout: per-layer kinds (m = mamba2, a = attention, r = rwkv)
    layer_pattern: str | None = None
    # Zamba2: ONE attention block shared by every site, applied before
    # every `shared_every`-th layer (sensitivity_mult = the site count)
    shared_attention: bool = False
    shared_every: int = 6
    # encoder-decoder (Whisper): the encoder's layers and the length of its
    # stub frame embeddings, (B, encoder_seq_len, d_model) (the mel and conv
    # frontend is stubbed, as in the reference)
    encoder_layers: int = 0
    encoder_seq_len: int = 1500
    # VLM (Qwen2-VL): multimodal RoPE over (t, h, w) position streams,
    # `m_rope_sections` frequency slots of head_dim / 2 each
    m_rope: bool = False
    m_rope_sections: tuple[int, ...] = (16, 24, 24)
    # the decoder's position horizon (Whisper's sinusoidal decode table)
    max_seq_len: int = 131_072
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

    @property
    def has_attention(self) -> bool:
        return self.attention_kind != "none" and self.num_heads > 0

    def pattern(self) -> str:
        """Per-layer block kinds, length num_layers."""
        if self.layer_pattern is None:
            base = ("a" if self.has_attention
                    else ("r" if self.ssm_state == 0 else "m"))
            return base * self.num_layers
        reps = self.num_layers // len(self.layer_pattern) + 1
        return (self.layer_pattern * reps)[: self.num_layers]

    def validate(self) -> None:
        if self.arch_type not in ("dense", "moe", "ssm", "hybrid", "audio",
                                  "vlm"):
            raise ValueError(f"{self.name}: unknown arch_type "
                             f"{self.arch_type!r}")
        if self.arch_type == "audio" and self.encoder_layers < 1:
            raise ValueError(f"{self.name}: an audio config needs "
                             f"encoder_layers > 0")
        if self.attention_kind not in ("gqa", "mla", "none"):
            raise ValueError(
                f"{self.name}: attention {self.attention_kind!r} is not "
                f"gqa, mla or none")
        if self.num_experts:
            if self.moe_dispatch not in ("flat", "grouped"):
                raise ValueError(f"{self.name}: moe_dispatch "
                                 f"{self.moe_dispatch!r} is not flat or "
                                 f"grouped")
            if self.num_experts_per_tok < 1 or self.moe_d_ff < 1:
                raise ValueError(f"{self.name}: an MoE config needs "
                                 f"num_experts_per_tok and moe_d_ff")
        if not self.has_attention:
            return
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


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

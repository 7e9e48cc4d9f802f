"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936,
qk_norm, explicit head_dim=128. [hf:Qwen/Qwen3-8B family]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", arch_type="dense",
    num_layers=36, d_model=2560, d_ff=9728, vocab_size=151_936,
    num_heads=32, num_kv_heads=8, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
)

REDUCED = ModelConfig(
    name="qwen3-4b-reduced", arch_type="dense",
    num_layers=2, d_model=256, d_ff=512, vocab_size=1_000,
    num_heads=4, num_kv_heads=2, head_dim=64,
    qk_norm=True, rope_theta=1_000_000.0,
)

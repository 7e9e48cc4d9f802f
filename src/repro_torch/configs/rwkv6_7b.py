"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536
— Finch: data-dependent decay time-mix. long_500k native (O(1) state).
[arXiv:2404.05892]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", arch_type="ssm",
    num_layers=32, d_model=4096, d_ff=14_336, vocab_size=65_536,
    num_heads=0, num_kv_heads=0, attention_kind="none",
    rwkv_head_dim=64,
    dtype=torch.bfloat16,
)

REDUCED = ModelConfig(
    name="rwkv6-7b-reduced", arch_type="ssm",
    num_layers=2, d_model=256, d_ff=512, vocab_size=1_000,
    num_heads=0, num_kv_heads=0, attention_kind="none",
    rwkv_head_dim=64,
)

"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
(per expert) vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", arch_type="moe",
    num_layers=32, d_model=1536, d_ff=512, vocab_size=49_155,
    num_heads=24, num_kv_heads=8,
    num_experts=40, num_experts_per_tok=8, moe_d_ff=512,
    dtype=torch.bfloat16,
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m-reduced", arch_type="moe",
    num_layers=2, d_model=192, d_ff=128, vocab_size=1_000,
    num_heads=6, num_kv_heads=2,
    num_experts=4, num_experts_per_tok=2, moe_d_ff=128,
)

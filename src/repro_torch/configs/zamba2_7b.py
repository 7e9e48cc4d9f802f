"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + SHARED attention block
applied every 6 layers (parameter sharing; sensitivity_mult = #sites).
The shared attention uses a 4096-token sliding window so long_500k runs
natively (the reference's adaptation). [arXiv:2411.15242]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", arch_type="hybrid",
    num_layers=81, d_model=3584, d_ff=14_336, vocab_size=32_000,
    num_heads=32, num_kv_heads=32, head_dim=112,
    ssm_state=64, ssm_head_dim=64,
    shared_attention=True, shared_every=6,
    sliding_window=4096,
    dtype=torch.bfloat16,
)

REDUCED = ModelConfig(
    name="zamba2-7b-reduced", arch_type="hybrid",
    num_layers=4, d_model=256, d_ff=512, vocab_size=1_000,
    num_heads=4, num_kv_heads=4, head_dim=64,
    ssm_state=16, ssm_head_dim=64, ssm_chunk=32,
    shared_attention=True, shared_every=2,
    sliding_window=64,
)

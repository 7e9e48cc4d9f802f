"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE (t/h/w sections), dynamic resolution. Vision tower
STUBBED: the batch carries precomputed patch embeddings.
[arXiv:2409.12191]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", arch_type="vlm",
    num_layers=80, d_model=8192, d_ff=29_568, vocab_size=152_064,
    num_heads=64, num_kv_heads=8,
    m_rope=True, m_rope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
)

REDUCED = ModelConfig(
    name="qwen2-vl-72b-reduced", arch_type="vlm",
    num_layers=2, d_model=256, d_ff=512, vocab_size=1_000,
    num_heads=4, num_kv_heads=2,
    m_rope=True, m_rope_sections=(8, 12, 12),
    rope_theta=1_000_000.0,
)

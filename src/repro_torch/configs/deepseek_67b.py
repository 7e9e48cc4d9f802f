"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama architecture. [arXiv:2401.02954]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", arch_type="dense",
    num_layers=95, d_model=8192, d_ff=22_016, vocab_size=102_400,
    num_heads=64, num_kv_heads=8,
    dtype=torch.bfloat16,
)

REDUCED = ModelConfig(
    name="deepseek-67b-reduced", arch_type="dense",
    num_layers=2, d_model=256, d_ff=512, vocab_size=1_000,
    num_heads=4, num_kv_heads=2,
)

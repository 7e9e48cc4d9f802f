"""qwen1.5-32b [dense]: 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064 — QKV bias. [hf:Qwen/Qwen1.5-0.5B family]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", arch_type="dense",
    num_layers=64, d_model=5120, d_ff=27_392, vocab_size=152_064,
    num_heads=40, num_kv_heads=40,
    qkv_bias=True,
    dtype=torch.bfloat16,
)

REDUCED = ModelConfig(
    name="qwen1.5-32b-reduced", arch_type="dense",
    num_layers=2, d_model=256, d_ff=512, vocab_size=1_000,
    num_heads=4, num_kv_heads=4,
    qkv_bias=True,
)

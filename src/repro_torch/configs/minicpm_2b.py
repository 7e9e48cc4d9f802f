"""minicpm-2b [dense]: 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753 — llama-like; trained with the WSD schedule
(repro_torch.optim.wsd). [arXiv:2404.06395]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", arch_type="dense",
    num_layers=40, d_model=2304, d_ff=5760, vocab_size=122_753,
    num_heads=36, num_kv_heads=36,
    dtype=torch.bfloat16,
)

REDUCED = ModelConfig(
    name="minicpm-2b-reduced", arch_type="dense",
    num_layers=2, d_model=256, d_ff=512, vocab_size=1_000,
    num_heads=4, num_kv_heads=4,
)

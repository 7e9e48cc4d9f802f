"""whisper-medium [audio]: 24L (enc) + 24L (dec) d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865 — encoder-decoder; mel+conv frontend STUBBED:
the batch carries precomputed frame embeddings (B, 1500, d_model).
[arXiv:2212.04356]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", arch_type="audio",
    num_layers=24, encoder_layers=24, encoder_seq_len=1500,
    d_model=1024, d_ff=4096, vocab_size=51_865,
    num_heads=16, num_kv_heads=16,
    max_seq_len=65_536,
    dtype=torch.bfloat16,
)

REDUCED = ModelConfig(
    name="whisper-medium-reduced", arch_type="audio",
    num_layers=2, encoder_layers=2, encoder_seq_len=32,
    d_model=128, d_ff=256, vocab_size=1_000,
    num_heads=4, num_kv_heads=4,
    max_seq_len=4_096,
)

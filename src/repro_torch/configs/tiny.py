"""Tiny dense config for unit tests (not an assigned arch)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tiny", arch_type="dense",
    num_layers=2, d_model=64, d_ff=128, vocab_size=257,
    num_heads=4, num_kv_heads=2,
)
REDUCED = CONFIG

"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048 (per routed
expert) vocab=129280 — MLA (q_lora=1536, kv_lora=512, nope=128, rope=64,
v=128), 1 shared + 256 routed experts top-8, first 3 layers dense
(d_ff=18432), MTP. [arXiv:2412.19437]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", arch_type="moe",
    num_layers=61, d_model=7168, d_ff=18_432, vocab_size=129_280,
    num_heads=128, num_kv_heads=128,
    attention_kind="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    num_experts=256, num_experts_per_tok=8, num_shared_experts=1,
    moe_d_ff=2048, first_k_dense=3,
    mtp_depth=1,
    dtype=torch.bfloat16,
)

REDUCED = ModelConfig(
    name="deepseek-v3-671b-reduced", arch_type="moe",
    num_layers=2, d_model=256, d_ff=512, vocab_size=1_000,
    num_heads=4, num_kv_heads=4,
    attention_kind="mla",
    q_lora_rank=64, kv_lora_rank=32,
    qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
    num_experts=4, num_experts_per_tok=2, num_shared_experts=1,
    moe_d_ff=128, first_k_dense=1,
    mtp_depth=1,
)

"""DP-LoRA fine-tuning with the PyTorch port, the counterpart of
`examples/dp_lora_finetune.py`: the paper's large-model recipe (Sec. 5.3)
at laptop scale. The base model is frozen; rank-8 adapters on the
attention projections train with per-layer clipping, each adapter pair
one clipping group; then an adapter is merged into its frozen weight for
serving.

    PYTHONPATH=src python examples/torch_dp_lora_finetune.py   # the GPU
    PYTHONPATH=src python examples/torch_dp_lora_finetune.py --device cpu

It trains deepseek-v3's reduced config (MLA attention, MoE, MTP), the
family the paper-scale run uses; on a CUDA device every adapter's norms
and clipped sums run through the hand-written kernels (`ghost_norm`,
`clip_reduce`), and the frozen linears run no kernel at all.
"""
import argparse
import dataclasses

import torch

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core.dp_sgd import DPConfig, make_dp_train_step
from repro_torch.core.lora import merge_lora
from repro_torch.core.spec import tree_leaves
from repro_torch.data import (PoissonSampler, SyntheticLM, make_lm_batch,
                              pack_documents)
from repro_torch.models.transformer import build_model

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--steps", type=int, default=40)
args = ap.parse_args()

# deepseek-v3 reduced with lora_rank: DP-LoRA on kv_b and o of every layer
cfg = dataclasses.replace(get_config("deepseek-v3-671b", reduced=True),
                          lora_rank=8)
model = build_model(cfg, device=args.device)
assert model.trainable_key == "lora"
params = model.init_train_params(
    torch.Generator(device=args.device).manual_seed(0))
for _, leaf in tree_leaves(params["lora"]):
    leaf.requires_grad_()  # the adapters train; the base stays frozen
n_lora = sum(t.numel() for _, t in tree_leaves(params["lora"]))
print(f"base params: {model.num_params - n_lora:,} (frozen)   "
      f"LoRA params: {n_lora:,} (trained, K={model.layout.num_groups} "
      f"groups)")

src = SyntheticLM(vocab_size=cfg.vocab_size, num_docs=96, doc_len=96)
rows = pack_documents(src.documents(), seq_len=48)
BATCH, STEPS = 8, args.steps
sampler = PoissonSampler(rows.shape[0], BATCH / rows.shape[0], BATCH)

# equal-budget noise allocation: each group's noise is independent of the
# other groups' thresholds, the per-device scheme (paper Sec. 4)
dp = DPConfig(mode="per_layer", epsilon=4.0, delta=1e-5,
              sampling_rate=BATCH / rows.shape[0], steps=STEPS,
              adaptive=True, noise_strategy="equal_budget",
              init_threshold=1e-2)
init_fn, step_fn, plan = make_dp_train_step(
    model.loss_fn, model.dp_spec, model.layout, optim.adam(5e-3), dp,
    batch_size=BATCH, trainable_key="lora")
opt_state, dp_state = init_fn(params)
base_before = {name: t.clone() for name, t in tree_leaves(
    {k: v for k, v in params.items() if k != "lora"})}
for i in range(STEPS):
    batch = make_lm_batch(rows, sampler.next_indices(), BATCH)
    batch = {k: torch.from_numpy(v).to(args.device) for k, v in batch.items()}
    params, opt_state, dp_state, m = step_fn(params, opt_state, dp_state,
                                             batch, 2)
    if i % 10 == 0 or i == STEPS - 1:
        print(f"step {i:3d}  loss {float(m.loss):.3f}  "
              f"clip_frac {float(m.clip_fraction):.2f}")
frozen = all(torch.equal(t, base_before[name]) for name, t in tree_leaves(
    {k: v for k, v in params.items() if k != "lora"}))
print(f"base bit for bit unchanged: {frozen}")

# merge one layer's o adapter into its frozen weight (offline serving)
name = "moe_blocks" if "moe_blocks" in params["lora"] else "dense_blocks"
site = params["lora"][name]["o"]
w = params[name]["attn"]["o"]["w"]
with torch.no_grad():
    merged = merge_lora(w[0], site["a"][0], site["b"][0], cfg.lora_alpha)
print("merged adapter into", name, "o-proj:",
      bool(not torch.equal(merged, w[0])))

"""Quickstart of the PyTorch port: differentially private training with
adaptive per-layer clipping (the paper's Algorithm 1), the counterpart of
`examples/quickstart.py`.

    PYTHONPATH=src python examples/torch_quickstart.py            # the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

It trains qwen3-4b's reduced config; on a CUDA device every linear
layer's norms and clipped sums run through the hand-written kernels.
"""
import argparse

import torch

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core.accounting import compute_epsilon
from repro_torch.core.dp_sgd import DPConfig, make_dp_train_step
from repro_torch.core.spec import tree_leaves
from repro_torch.data import (PoissonSampler, SyntheticLM, make_lm_batch,
                              pack_documents)
from repro_torch.models.transformer import build_model

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--steps", type=int, default=60)
args = ap.parse_args()

# 1. A model: reduced=True gives the small variant of the same family.
cfg = get_config("qwen3-4b", reduced=True)
model = build_model(cfg, device=args.device)
params = model.init_train_params(
    torch.Generator(device=args.device).manual_seed(0))
for _, leaf in tree_leaves(params):
    leaf.requires_grad_()
print(f"model: {cfg.name}  params={model.num_params:,}  "
      f"clipping groups K={model.layout.num_groups}")

# 2. Data with POISSON subsampling (what the accountant assumes).
src = SyntheticLM(vocab_size=cfg.vocab_size, num_docs=128, doc_len=128)
rows = pack_documents(src.documents(), seq_len=64)
BATCH, STEPS = 16, args.steps
sampler = PoissonSampler(num_examples=rows.shape[0],
                         rate=BATCH / rows.shape[0], max_batch=BATCH)

# 3. The DP recipe: adaptive per-layer clipping, eps=8, 1% of the budget
#    spent on private quantile estimation (paper Sec 3.3).
dp = DPConfig(mode="per_layer", epsilon=8.0, delta=1e-5,
              sampling_rate=BATCH / rows.shape[0], steps=STEPS,
              adaptive=True, target_quantile=0.5,
              quantile_budget_fraction=0.01)
init_fn, step_fn, plan = make_dp_train_step(
    model.loss_fn, model.spec, model.layout, optim.adam(1e-3), dp,
    batch_size=BATCH)
opt_state, dp_state = init_fn(params)
print(f"sigma={plan.sigma:.3f} -> sigma_new={plan.sigma_new:.3f} "
      f"(Prop 3.1 split, sigma_b={plan.sigma_b:.1f})")

# 4. Train: step_fn updates params in place.
for i in range(STEPS):
    batch = make_lm_batch(rows, sampler.next_indices(), BATCH)
    batch = {k: torch.from_numpy(v).to(args.device) for k, v in batch.items()}
    params, opt_state, dp_state, m = step_fn(params, opt_state, dp_state,
                                             batch, 1)
    if i % 10 == 0 or i == STEPS - 1:
        print(f"step {i:3d}  loss {float(m.loss):.3f}  "
              f"clip_frac {float(m.clip_fraction):.2f}  "
              f"mean C_k {float(m.mean_threshold):.3f}")

eps = compute_epsilon(sigma=plan.sigma, sampling_rate=dp.sampling_rate,
                      steps=STEPS, delta=dp.delta)
print(f"privacy spent: eps={eps:.2f} at delta={dp.delta}")

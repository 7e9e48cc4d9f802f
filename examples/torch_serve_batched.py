"""Continuous-batching serving demo of the PyTorch port, the counterpart
of `examples/serve_batched.py`: a ragged request stream through the
slot-pool DecodeEngine for the GQA KV cache (qwen3-4b) and the MLA latent
cache (deepseek-v3-671b), reduced. Four requests share three slots, so the
last one is admitted mid-flight into a recycled slot; each output is,
up to argmax ties, what the request gives alone, unpadded, through
`greedy_decode` (the count of equal ones is printed for both data
planes). The reference's recurrent case (rwkv6-7b) waits for ROADMAP.md
A.8.

    PYTHONPATH=src python examples/torch_serve_batched.py          # the GPU
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.engine import DecodeEngine
from repro_torch.launch.inputs import synthetic_requests
from repro_torch.launch.serve import greedy_decode
from repro_torch.models.transformer import build_model

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

for arch in ("qwen3-4b", "deepseek-v3-671b"):
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, device=args.device)
    params = model.init_params(
        torch.Generator(device=args.device).manual_seed(0))
    reqs = synthetic_requests(cfg.vocab_size, 4, min_len=2, max_len=8,
                              seed=1)
    for paging in ("auto", "off"):
        t0 = time.time()
        engine = DecodeEngine(model, params, num_slots=3, cache_len=64,
                              paging=paging)
        rids = [engine.submit(r, max_new_tokens=24) for r in reqs]
        done = engine.run()
        dt = time.time() - t0
        alone = sum(done[rid].tokens == greedy_decode(
            model, params, torch.as_tensor(r[None], device=args.device), 24,
            64)[0].tolist() for rid, r in zip(rids, reqs))
        kind = {"gqa": "KV cache", "mla": "MLA latent cache"}[
            cfg.attention_kind]
        plane = "paged" if engine.paged else "contiguous"
        print(f"{arch:18s} [{kind:16s}, {plane:10s}] "
              f"lens={[len(r) for r in reqs]} 4x24 tokens over 3 slots in "
              f"{dt:5.2f}s ({engine.stats['decode_dispatches']} decode "
              f"dispatches, {alone}/4 as alone)  sample: "
              f"{done[rids[0]].tokens[:8]}")

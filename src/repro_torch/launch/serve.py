"""Serving CLI: ragged synthetic requests through the slot-pool engine.

The counterpart of `repro.launch.serve` in engine mode on the paged KV
plane, single tenant. The parser has only the flags that work in the
port; a flag of the reference that is not ported yet fails in argparse.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --batch 16 --prompt-len 192 --min-prompt-len 64 --gen 32 \\
      --slots 8 --shared-prefix 32

Add `--device cpu` (and `--reduced`) to run without a GPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.engine import DecodeEngine
from repro_torch.launch.inputs import synthetic_requests
from repro_torch.models.transformer import build_model


def build_serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests in the synthetic set")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="maximum prompt length")
    ap.add_argument("--min-prompt-len", type=int, default=None,
                    help="minimum prompt length (default = --prompt-len)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mode", default="engine", choices=["engine"],
                    help="engine: continuous-batching slot pool (batch "
                         "mode is not ported yet)")
    ap.add_argument("--slots", type=int, default=None,
                    help="engine slot-pool size (default = --batch)")
    ap.add_argument("--paging", default="auto", choices=["auto", "on"],
                    help="KV data plane: the paged plane (the contiguous "
                         "plane, off, is not ported yet)")
    ap.add_argument("--page-len", type=int, default=16,
                    help="tokens per physical KV page")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size (default: slots * cache pages; "
                         "set lower to exercise eviction/spill)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many common system-prompt tokens "
                         "to every request")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cuda unless asked)")
    return ap


def build_requests(vocab_size: int, n: int, *, min_len: int, max_len: int,
                   shared_prefix: int, seed: int) -> list[np.ndarray]:
    """The CLI's request set: the reference's synthetic prompts (seed 1)
    behind an optional common system prompt drawn from `seed`."""
    reqs = synthetic_requests(vocab_size, n, min_len=min_len,
                              max_len=max_len, seed=1)
    if shared_prefix:
        rng = np.random.RandomState(seed + 100)
        sysp = rng.randint(1, vocab_size, shared_prefix).astype(np.int32)
        reqs = [np.concatenate([sysp, r]) for r in reqs]
    return reqs


def serve_requests(model, params, reqs, *, gen: int, num_slots: int,
                   cache_len: int, paging: str = "auto", page_len: int = 16,
                   num_pages: int | None = None):
    """Serve `reqs` through a fresh DecodeEngine; returns (engine,
    completions keyed by request id)."""
    eng = DecodeEngine(model, params, num_slots=num_slots,
                       cache_len=cache_len, paging=paging,
                       page_len=page_len, num_pages=num_pages)
    for r in reqs:
        eng.submit(r, max_new_tokens=gen)
    return eng, eng.run()


def last_logits(model, params, seq, page_len: int = 16) -> torch.Tensor:
    """(V,) f32 logits after feeding the tokens `seq` one by one through a
    fresh single-slot paged cache: the per-request reference used to
    judge argmax ties."""
    n = -(-(len(seq) + 1) // page_len)
    dev = params["embed"]["w"].device
    cache = model.init_paged_cache(1, n * page_len, num_pages=n,
                                   page_len=page_len)
    cache["pt"] = torch.arange(n, dtype=torch.int32, device=dev)[None]
    for tok in seq:
        logits, cache = model.serve_step(params, cache, {
            "token": torch.tensor([[int(tok)]], dtype=torch.int32,
                                  device=dev)})
    return logits[0].float()


def main(argv=None) -> int:
    args = build_serve_parser().parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = model.init_params(gen)

    lo = (args.prompt_len if args.min_prompt_len is None
          else args.min_prompt_len)
    reqs = build_requests(cfg.vocab_size, args.batch, min_len=lo,
                          max_len=args.prompt_len,
                          shared_prefix=args.shared_prefix, seed=args.seed)
    cache_len = args.shared_prefix + args.prompt_len + args.gen + 8
    # paging needs cache_len % page_len == 0: round up
    cache_len = -(-cache_len // args.page_len) * args.page_len
    num_slots = args.batch if args.slots is None else args.slots

    t0 = time.perf_counter()
    eng, done = serve_requests(model, params, reqs, gen=args.gen,
                               num_slots=num_slots, cache_len=cache_len,
                               paging=args.paging, page_len=args.page_len,
                               num_pages=args.num_pages)
    wall = time.perf_counter() - t0
    toks = np.full((args.batch, args.gen), -1, np.int32)
    for rid, c in done.items():
        toks[rid, :len(c.tokens)] = c.tokens
    s = eng.stats
    total = sum(len(r) for r in reqs) + args.batch * args.gen
    print(f"# arch={cfg.name} device={args.device} mode=engine "
          f"batch={args.batch} prompt_lens={[len(r) for r in reqs]} "
          f"slots={eng.num_slots} "
          f"dispatches={s['decode_dispatches']}d+{s['prefill_dispatches']}p "
          f"paged=yes pages={eng.num_pages}x{eng.page_len} "
          f"peak_pages={s['peak_pages_in_use']} "
          f"prefix_hits={s['prefix_hits']} shared={s['shared_pages']} "
          f"evicted={s['evicted_pages']} "
          f"readmitted={s['readmitted_pages']} "
          f"cache_mb={eng.cache_bytes() / 2**20:.1f} "
          f"generated {args.gen} tokens/seq in {wall:.2f}s "
          f"({total / wall:.1f} tok/s incl. prefill)")
    print(toks[:, :16])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

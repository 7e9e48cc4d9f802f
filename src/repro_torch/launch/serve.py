"""Serving: ragged-batch greedy decode and the slot-pool engine.

The counterpart of `repro.launch.serve`. Two entry points share the
model's `serve_step`:

  * `greedy_decode` / `fused_prefill`, the static-batch path on the
    contiguous plane (`--mode batch`). Prompts may be right-padded ragged
    (`lengths=`): pad tokens are masked out of the cache (serve_step's
    `active` row mask) and the first generated token comes from each
    sequence's true last prompt token, so a ragged batch decodes as each
    prompt alone, unpadded. `prefill="fused"` (the default) is one call
    that runs every prompt position with its row masks made on the
    device up front and no read by the host inside; `"loop"` is the
    reference's token-at-a-time oracle. Both give the same tokens.
  * `launch.engine.DecodeEngine`, continuous batching over a fixed slot
    pool (`--mode engine`, the default), on the paged plane or the
    contiguous one (`--paging auto|on|off`).

Multi-tenant DP-LoRA serving (`--tenants T`, engine mode only): the model
is built with `--lora-rank` adapters, and the engine holds T adapter
slots; tenant i serves the i-th `--adapter-dir` (a training service's
`<service_dir>/publish`, its newest verified publish installed at the
start) or the base model, and the requests go round-robin over the
tenants. `--watch` polls each directory between pool steps and hot-swaps
a new publish into the live engine (`launch.swap.AdapterWatcher`).

The parser has only the flags that work in the port; a flag of the
reference that is not ported yet fails in argparse.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --batch 16 --prompt-len 192 --min-prompt-len 64 --gen 32 \\
      --slots 8 --shared-prefix 32

Add `--device cpu` (and `--reduced`) to run without a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.engine import DecodeEngine
from repro_torch.launch.inputs import pad_ragged_prompts, synthetic_requests
from repro_torch.models.transformer import build_model


@torch.no_grad()
def fused_prefill(model, params, prompts: torch.Tensor, cache_len: int,
                  lengths: torch.Tensor | None = None):
    """Run every prompt position through a fresh contiguous cache in one
    call: returns (last logits (B, V) f32, filled cache).

    prompts: (B, P) int32, right-padded; lengths: optional (B,) int32 true
    prompt lengths on the prompts' device (None: every row uses all P
    tokens, with no row mask). Pad positions are masked out of the cache,
    and the returned logits are each row's true last token's. The row
    masks of every position are made on the device before the first
    step, so the host reads nothing inside."""
    b, p = prompts.shape
    cache = model.init_cache(b, cache_len)
    last = torch.zeros((b, model.cfg.vocab_size), dtype=torch.float32,
                       device=prompts.device)
    if lengths is None:  # equal-length fast path: no row mask
        for t in range(p):
            logits, cache = model.serve_step(
                params, cache, {"token": prompts[:, t:t + 1]})
            last = logits.float()
        return last, cache
    acts = (torch.arange(p, dtype=torch.int32, device=prompts.device)[:, None]
            < lengths[None, :])  # (P, B)
    for t in range(p):
        logits, cache = model.serve_step(
            params, cache, {"token": prompts[:, t:t + 1], "active": acts[t]})
        last = torch.where(acts[t][:, None], logits.float(), last)
    return last, cache


@torch.no_grad()
def greedy_decode(model, params, prompts: torch.Tensor, gen: int,
                  cache_len: int, *, prefill: str = "fused", lengths=None):
    """Greedy tokens (B, gen) int32 on the prompts' device. prompts: (B,
    P) int32, right-padded if ragged; lengths: optional (B,) true prompt
    lengths. prefill: 'fused' (`fused_prefill`) or 'loop' (the
    reference's oracle: the same steps, each row mask made at its step)."""
    b, p = prompts.shape
    if p == 0:
        raise ValueError(
            "empty prompt (P == 0): greedy_decode needs at least one prompt "
            "token per sequence — seed requests with a BOS token")
    dev = prompts.device
    ln = (None if lengths is None
          else torch.as_tensor(lengths, dtype=torch.int32, device=dev))
    if prefill == "fused":
        logits, cache = fused_prefill(model, params, prompts, cache_len, ln)
    elif prefill == "loop":
        cache = model.init_cache(b, cache_len)
        logits = torch.zeros((b, model.cfg.vocab_size), dtype=torch.float32,
                             device=dev)
        for t in range(p):
            if ln is None:  # equal-length fast path: no row mask
                lg, cache = model.serve_step(
                    params, cache, {"token": prompts[:, t:t + 1]})
                logits = lg.float()
                continue
            act = torch.full((b,), t, dtype=torch.int32, device=dev) < ln
            lg, cache = model.serve_step(
                params, cache, {"token": prompts[:, t:t + 1], "active": act})
            # only rows still inside their prompt update, so the final
            # value is each row's true last token's logits
            logits = torch.where(act[:, None], lg.float(), logits)
    else:
        raise ValueError(f"prefill must be 'fused' or 'loop', got "
                         f"{prefill!r}")
    if gen <= 0:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    out = []
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    for _ in range(gen):
        out.append(tok)
        logits, cache = model.serve_step(params, cache, {"token": tok})
        tok = torch.argmax(logits.float(), dim=-1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1)


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
    ap.add_argument("--mode", default="engine", choices=["engine", "batch"],
                    help="engine: continuous-batching slot pool; batch: "
                         "the static padded-batch greedy_decode")
    ap.add_argument("--slots", type=int, default=None,
                    help="engine slot-pool size (default = --batch)")
    ap.add_argument("--prefill", default="fused", choices=["fused", "loop"],
                    help="batch mode: fused = one call over the prompt; "
                         "loop = the token-at-a-time oracle")
    ap.add_argument("--paging", default="auto", choices=["auto", "on", "off"],
                    help="engine mode KV data plane: auto pages where the "
                         "model can, off keeps per-slot contiguous caches, "
                         "on forces paging")
    ap.add_argument("--page-len", type=int, default=16,
                    help="tokens per physical KV page")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size (default: slots * cache pages; "
                         "set lower to exercise eviction/spill)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many common system-prompt tokens "
                         "to every request")
    ap.add_argument("--tenants", type=int, default=None,
                    help="serve multi-tenant: the adapter-slot count of "
                         "the tenant-stacked DP-LoRA buffer (engine mode "
                         "only); requests round-robin over the tenants")
    ap.add_argument("--lora-rank", type=int, default=4,
                    help="adapter rank for multi-tenant serving (the rank "
                         "the adapters were trained at)")
    ap.add_argument("--adapter-dir", action="append", default=None,
                    metavar="DIR",
                    help="a training service's publish directory "
                         "(<service_dir>/publish) to load a tenant's "
                         "adapter from; repeatable, one tenant each, the "
                         "other tenants (up to --tenants) serve the base "
                         "model")
    ap.add_argument("--watch", action="store_true",
                    help="poll each --adapter-dir between pool steps and "
                         "hot-swap new publishes into the live engine")
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
                   num_pages: int | None = None, on_token=None):
    """Serve `reqs` through a fresh DecodeEngine (`on_token`: its
    per-token callback); returns (engine, completions keyed by request
    id)."""
    eng = DecodeEngine(model, params, num_slots=num_slots,
                       cache_len=cache_len, paging=paging,
                       page_len=page_len, num_pages=num_pages,
                       on_token=on_token)
    for r in reqs:
        eng.submit(r, max_new_tokens=gen)
    return eng, eng.run()


def serve_tenants(eng, reqs, *, gen: int, adapter_dirs=(),
                  watch: bool = False, num_tenants: int, say=print):
    """Multi-tenant serving on `eng` (a `DecodeEngine` with
    `max_tenants`): `num_tenants` tenants, the i-th tracking
    `adapter_dirs[i]` through an `AdapterWatcher` (its newest verified
    publish installed first) or serving the base model; the requests go
    round-robin over the tenants. With `watch` the pool runs in bursts of
    8 steps and every watcher polls between them. Returns (tenant ids,
    completions keyed by request id)."""
    from repro_torch.launch.swap import AdapterWatcher
    tids = [eng.add_tenant(name=f"tenant-{i}") for i in range(num_tenants)]
    watchers = []
    for tid, d in zip(tids, adapter_dirs or ()):
        w = AdapterWatcher(eng, tid, d)
        got = w.poll()
        say(f"# tenant {tid} <- {d}: "
            f"{'step ' + str(got.step) if got else 'base model'}")
        watchers.append(w)
    for i, r in enumerate(reqs):
        eng.submit(r, max_new_tokens=gen, tenant=tids[i % len(tids)])
    if not (watch and watchers):
        return tids, eng.run()
    # a swap lands between dispatches, never inside one
    while eng.num_pending or eng.num_live:
        eng.run(max_steps=8)
        for w in watchers:
            got = w.poll()
            if got is not None:
                say(f"# hot swap: tenant {got.tenant} -> step {got.step} "
                    f"(v{got.version}, bitwise ok)")
    return tids, eng.completions()


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


def serve_params(model, seed: int, device: str):
    """The CLI's random parameters: drawn from `seed` on `device`."""
    return model.init_params(torch.Generator(device=device).manual_seed(seed))


def main(argv=None) -> int:
    args = build_serve_parser().parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.tenants is not None:
        if args.mode != "engine":
            raise SystemExit("--tenants requires --mode engine")
        cfg = dataclasses.replace(cfg, lora_rank=args.lora_rank)
    model = build_model(cfg, device=args.device)
    params = serve_params(model, args.seed, args.device)

    lo = (args.prompt_len if args.min_prompt_len is None
          else args.min_prompt_len)
    reqs = build_requests(cfg.vocab_size, args.batch, min_len=lo,
                          max_len=args.prompt_len,
                          shared_prefix=args.shared_prefix, seed=args.seed)
    cache_len = args.shared_prefix + args.prompt_len + args.gen + 8

    t0 = time.perf_counter()
    if args.mode == "engine":
        if args.paging != "off":
            # paging needs cache_len % page_len == 0: round up
            cache_len = -(-cache_len // args.page_len) * args.page_len
        num_slots = args.batch if args.slots is None else args.slots
        if args.tenants is None:
            eng, done = serve_requests(
                model, params, reqs, gen=args.gen, num_slots=num_slots,
                cache_len=cache_len, paging=args.paging,
                page_len=args.page_len, num_pages=args.num_pages)
        else:
            eng = DecodeEngine(model, params, num_slots=num_slots,
                               cache_len=cache_len, paging=args.paging,
                               page_len=args.page_len,
                               num_pages=args.num_pages,
                               max_tenants=args.tenants)
            tids, done = serve_tenants(
                eng, reqs, gen=args.gen, adapter_dirs=args.adapter_dir,
                watch=args.watch, num_tenants=args.tenants)
        wall = time.perf_counter() - t0
        toks = np.full((args.batch, args.gen), -1, np.int32)
        for rid, c in done.items():
            toks[rid, :len(c.tokens)] = c.tokens
        s = eng.stats
        extra = (f"slots={eng.num_slots} dispatches={s['decode_dispatches']}"
                 f"d+{s['prefill_dispatches']}p "
                 f"paged={'yes' if eng.paged else 'no'} ")
        if eng.multi_tenant:
            extra += (f"tenants={len(tids)} swaps={s['adapter_swaps']} "
                      f"adapter_storages={len(eng.adapter_storages)} ")
            for tid in tids:
                ts = eng.tenant_stats(tid)
                print(f"# tenant {tid} ({ts['name']}): v{ts['version']} "
                      f"done={ts['requests_done']} "
                      f"tokens={ts['tokens_out']}")
        if eng.paged:
            extra += (f"pages={eng.num_pages}x{eng.page_len} "
                      f"peak_pages={s['peak_pages_in_use']} "
                      f"prefix_hits={s['prefix_hits']} "
                      f"shared={s['shared_pages']} "
                      f"evicted={s['evicted_pages']} "
                      f"readmitted={s['readmitted_pages']} ")
        extra += f"cache_mb={eng.cache_bytes() / 2**20:.1f}"
    else:
        prompts, lengths = pad_ragged_prompts(reqs)
        toks = greedy_decode(
            model, params, torch.as_tensor(prompts, device=args.device),
            args.gen, cache_len, prefill=args.prefill,
            lengths=torch.as_tensor(lengths, device=args.device)
        ).cpu().numpy()
        wall = time.perf_counter() - t0
        extra = f"prefill={args.prefill}"
    total = sum(len(r) for r in reqs) + args.batch * args.gen
    print(f"# arch={cfg.name} device={args.device} mode={args.mode} "
          f"batch={args.batch} prompt_lens={[len(r) for r in reqs]} "
          f"{extra} generated {args.gen} tokens/seq in {wall:.2f}s "
          f"({total / wall:.1f} tok/s incl. prefill)")
    print(toks[:, :16])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the script
exits non-zero:

  1 build     nvcc builds every kernel under src/repro_torch/kernels/csrc
              (the card's name and power limit, the build time).
  3 main path qwen3-4b at full width and depth, bf16, random parameters
              from a seeded torch.Generator, served through the serve
              CLI's own `serve_requests`: 8 slots, page_len 16, 16
              synthetic requests of 64-192 tokens behind a 32-token
              shared prefix, 32 generated tokens each (cache_len 272, 136
              pages). Every launch counter is set to 0 just before and
              read just after; paged_attn must have launched 36 times per
              serve_step.
  2 kernels   (run after phase 3, so its launches stay out of phase 3's
              count) each kernel against its plain PyTorch version on the
              card: a sweep of ragged tables, partial last pages, trash
              entries, dv < dvp on an aliased pool, head dims 16/64/128,
              bf16 and f32; then at the main path's own shapes, on
              q/pools/pt/pos captured from layer 0 during phase 3, with
              kernel, plain, bound and library (gather + SDPA) times.
  4 cuda/cpu  qwen3-4b-reduced in f32 from one numpy parameter tree,
              served on the card (kernel) and on the CPU (plain version):
              the tokens must be identical, up to an argmax tie (top-2
              gap of the CPU logits under 1e-4 at the first divergence).

The last three lines are the kernels' JSON line, the card's name and
power limit, and {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = dict(rtol=1e-4, atol=1e-4)  # kernel vs plain: f32 summation order
TIE_GAP = 1e-4
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2

# data-sheet memory bandwidth (bytes/s) by card name
BANDWIDTH = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12)]
# data-sheet peak operation rate for the inputs' type (dense): bf16 on the
# tensor cores, f32 outside them
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bandwidth(name: str) -> float:
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    raise RuntimeError(f"no data-sheet bandwidth for {name!r}")


def cuda_ms(torch, fn, iters=50, warmup=5, flush=None):
    """Mean ms per call by CUDA events around each call, with the L2
    flushed before each one (the main path meets the pools cold)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# ---------------------------------------------------------------------------
# Phase 2 helpers.
# ---------------------------------------------------------------------------

def sweep_inputs(torch, b, kv, g, dq, dv, n, page_len, p_tab, dtype, seed):
    """Ragged page tables with trash-mapped tails (trash page = n),
    positions covering one token, a partial page and a full table; an
    aliased pool when dv is given."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, dq)).astype(np.float32)
    kp = rng.standard_normal((n + 1, page_len, kv, dq)).astype(np.float32)
    pos = rng.integers(0, p_tab * page_len, size=b).astype(np.int32)
    pos[0] = 0
    pos[-1] = p_tab * page_len - 1
    if b > 2:
        pos[1] = page_len + page_len // 2
    pt = rng.integers(0, n, size=(b, p_tab)).astype(np.int32)
    for i in range(b):
        pt[i, pos[i] // page_len + 1:] = n
    dt = getattr(torch, dtype)
    tq = torch.from_numpy(q).to("cuda", dt)
    tk = torch.from_numpy(kp).to("cuda", dt)
    if dv is None:
        vp = rng.standard_normal(kp.shape).astype(np.float32)
        tv = torch.from_numpy(vp).to("cuda", dt)
    else:
        tv = tk
    return (tq, tk, tv, torch.from_numpy(pt).cuda(),
            torch.from_numpy(pos).cuda())


SWEEP = [  # b, kv, g, dq, dv (None: separate value pool), n, L, P
    (3, 2, 2, 16, None, 7, 8, 3),
    (4, 1, 1, 16, None, 9, 2, 5),
    (3, 2, 4, 64, None, 9, 16, 4),
    (2, 1, 8, 64, 32, 5, 4, 4),        # aliased pool, dv < dvp
    (8, 8, 4, 128, None, 40, 16, 17),  # qwen3-4b head layout
    (2, 2, 16, 128, 64, 6, 16, 3),     # aliased pool, dv < dvp
    (3, 1, 3, 128, None, 12, 16, 6),   # odd G
]


def library_attn(torch, q, kpool, vpool, pt, pos, scale, dv):
    """Yardstick, never called by the port: gather through the table, then
    one F.scaled_dot_product_attention call."""
    import torch.nn.functional as F
    b, kv, g, dq = q.shape
    s = pt.shape[1] * kpool.shape[1]
    idx = pt.long()
    k = kpool[idx].reshape(b, s, kv, dq).transpose(1, 2)
    v = vpool[idx].reshape(b, s, kv, -1)[..., :dv].transpose(1, 2)
    mask = (torch.arange(s, device=q.device)[None] <= pos[:, None])
    out = F.scaled_dot_product_attention(
        q.reshape(b, kv * g, 1, dq), k, v, attn_mask=mask[:, None, None],
        scale=scale, enable_gqa=True)
    return out.reshape(b, kv, g, dv)


def paged_attn_bound(q, kpool, vpool, pt, pos, dv, bw):
    """(bound ms, bound_by) for the work this input needs: each valid K/V
    row, q, the used table entries and pos read once, out written once;
    2 * (dq + dv) operations per (query head, valid row)."""
    b, kv, g, dq = q.shape
    page_len = kpool.shape[1]
    cap = pt.shape[1] * page_len
    n_valid = np.minimum(pos.cpu().numpy().astype(np.int64) + 1, cap)
    esize = q.element_size()
    rows = int(n_valid.sum())
    nbytes = (rows * kv * (dq + dv) * esize + q.numel() * esize
              + b * kv * g * dv * 4
              + int((-(-n_valid // page_len)).sum()) * 4 + b * 4)
    ops = rows * kv * g * 2 * (dq + dv)
    t_bytes = nbytes / bw
    t_ops = ops / PEAK_OPS[str(q.dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_build(torch, gpu):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.BUILD_LOGS.items()}
    emit({"phase": "build", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernels": sorted(libs),
          "build_s": build_s, "ptxas": ptxas})


def phase_main_path(torch, gpu):
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import paged_attn as K
    from repro_torch.launch import serve
    from repro_torch.models.transformer import build_model

    n_req, slots, page_len, gen, prefix = 16, 8, 16, 32, 32
    cfg = get_config("qwen3-4b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = serve.build_requests(cfg.vocab_size, n_req, min_len=64,
                                max_len=192, shared_prefix=prefix, seed=0)
    cache_len = -(-(prefix + 192 + gen + 8) // page_len) * page_len

    # capture layer 0's inputs every 16th serve_step (layer 0 is every
    # 36th call); the pools are updated in place, so they are cloned
    real = K.paged_attn
    calls, snaps = [0], []

    def recording(q, kpool, vpool, pt, pos, **kw):
        if calls[0] % (16 * cfg.num_layers) == 0:
            snaps.append((q.clone(), kpool.clone(), vpool.clone(),
                          pt.clone(), pos.clone(), kw))
        calls[0] += 1
        return real(q, kpool, vpool, pt, pos, **kw)

    K.paged_attn = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        eng, done = serve.serve_requests(
            model, params, reqs, gen=gen, num_slots=slots,
            cache_len=cache_len, page_len=page_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        K.paged_attn = real
    s = eng.stats
    if sorted(done) != list(range(n_req)):
        raise RuntimeError(f"completed {sorted(done)} of {n_req} requests")
    for rid, c in done.items():
        if len(c.tokens) != gen or not all(0 <= t < cfg.vocab_size
                                           for t in c.tokens):
            raise RuntimeError(f"request {rid}: bad tokens {c.tokens}")
    if s["prefix_hits"] < 1:
        raise RuntimeError("prefix sharing never hit")
    if counts["paged_attn"] != cfg.num_layers * s["serve_steps"]:
        raise RuntimeError(
            f"paged_attn launched {counts['paged_attn']} times for "
            f"{s['serve_steps']} serve_steps of {cfg.num_layers} layers")
    prompt_toks = sum(len(r) for r in reqs)
    emit({"phase": "main_path", "gpu": gpu, "arch": cfg.name,
          "num_params": model.num_params, "dtype": str(cfg.dtype),
          "requests": n_req, "slots": slots, "page_len": page_len,
          "cache_len": cache_len, "num_pages": eng.num_pages,
          "prompt_tokens": prompt_toks, "generated_tokens": n_req * gen,
          "init_params_s": init_s, "wall_s": wall,
          "generated_tok_per_s": n_req * gen / wall,
          "tok_per_s_incl_prefill": (prompt_toks + n_req * gen) / wall,
          "ms_per_decode_dispatch":
              1e3 * eng.seconds["decode"] / s["decode_dispatches"],
          "ms_per_prefill_dispatch":
              1e3 * eng.seconds["prefill"] / s["prefill_dispatches"],
          "ms_per_serve_step": 1e3 * wall / s["serve_steps"],
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": counts, "stats": s,
          "first_tokens": done[0].tokens[:8]})
    profile_decode(torch, gpu, model, params, eng, 1e3 * wall
                   / s["serve_steps"])
    # the capture with the most valid cache rows stands for the main path
    best = max(snaps, key=lambda sn: int(
        np.minimum(sn[4].cpu().numpy() + 1, sn[3].shape[1] * page_len)
        .sum()))
    return counts["paged_attn"], best


def profile_decode(torch, gpu, model, params, eng, step_ms, steps=3):
    """Device time per serve_step by kernel, from torch.profiler over a
    few full-pool decode steps on the engine's cache after the run (its
    requests are done, so the writes land on dead pages). The idle share
    compares the device time with the unprofiled ms per serve_step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    slots = eng.num_slots
    batch = {"token": torch.zeros((slots, 1), dtype=torch.int32,
                                  device="cuda"),
             "active": torch.ones((slots,), dtype=torch.bool, device="cuda")}
    cache = dict(eng.cache)
    model.serve_step(params, cache, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model.serve_step(params, cache, batch)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    emit({"phase": "profile", "gpu": gpu, "serve_steps": steps,
          "device_ms_per_serve_step": device_ms,
          "unprofiled_ms_per_serve_step": step_ms,
          "device_idle_share": 1.0 - device_ms / step_ms,
          "device_ops_per_serve_step": sum(r[2] for r in rows),
          "top": [{"name": k[:80], "ms_per_step": ms, "calls_per_step": n}
                  for k, ms, n in rows[:8]]})


def phase_kernels(torch, gpu, main_snap):
    from repro_torch.kernels import paged_attn as K
    bw = bandwidth(gpu)
    worst = 0.0
    for i, shape in enumerate(SWEEP):
        for dtype in ("float32", "bfloat16"):
            q, kp, vp, pt, pos = sweep_inputs(torch, *shape, dtype, seed=i)
            dv = shape[4]
            scale = 1.0 / math.sqrt(shape[3])
            got = K.paged_attn(q, kp, vp, pt, pos, scale=scale, dv=dv)
            want = K.paged_attn_ref(q, kp, vp, pt, pos, scale=scale, dv=dv)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, **TOL))
            worst = max(worst, err)
            emit({"phase": "kernel_vs_plain", "kernel": "paged_attn",
                  "shape": dict(zip(["b", "kv", "g", "dq", "dv", "n", "L",
                                     "P"], shape)), "dtype": dtype,
                  "max_abs_err": err, "tol": TOL, "ok": ok})
            if not ok:
                raise RuntimeError(f"paged_attn disagrees at {shape} "
                                   f"{dtype}: max abs err {err}")

    q, kp, vp, pt, pos, kw = main_snap
    dv = vp.shape[-1]
    got = K.paged_attn(q, kp, vp, pt, pos, **kw)
    want = K.paged_attn_ref(q, kp, vp, pt, pos, **kw)
    lib = library_attn(torch, q, kp, vp, pt, pos, kw["scale"], dv)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    worst = max(worst, err)
    if not torch.allclose(got, want, **TOL):
        raise RuntimeError(f"paged_attn disagrees at the main path's "
                           f"shapes: max abs err {err}")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(torch, lambda: K.paged_attn(q, kp, vp, pt, pos, **kw),
                 flush=flush)
    plain_ms = cuda_ms(torch, lambda: K.paged_attn_ref(q, kp, vp, pt, pos,
                                                       **kw), flush=flush)
    lib_ms = cuda_ms(torch, lambda: library_attn(torch, q, kp, vp, pt, pos,
                                                 kw["scale"], dv),
                     flush=flush)
    bound_ms, bound_by = paged_attn_bound(q, kp, vp, pt, pos, dv, bw)
    result = {"name": "paged_attn", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
              "replaces": "src/repro/kernels/paged_attn.py:83",
              "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": lib_ms}
    emit({"phase": "kernel_main_shapes", "gpu": gpu, "kernel": "paged_attn",
          "q": list(q.shape), "kpool": list(kp.shape), "pt": list(pt.shape),
          "pos": pos.tolist(), "dtype": str(q.dtype), "max_abs_err": err,
          "library_max_abs_err": float((lib.float() - want).abs().max()),
          "tol": TOL, **{k: result[k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms")}})
    return result


def phase_cuda_vs_cpu(torch, gpu):
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models.transformer import build_model

    cfg = get_config("qwen3-4b", reduced=True)
    n_req, gen, page_len, prefix = 6, 16, 8, 16
    tree = bridge.numpy_params(build_model(cfg, device="cpu").spec, seed=0)
    reqs = serve.build_requests(cfg.vocab_size, n_req, min_len=8,
                                max_len=40, shared_prefix=prefix, seed=0)
    cache_len = -(-(prefix + 40 + gen + 8) // page_len) * page_len
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        params = bridge.params_from_numpy(tree, dev)
        reset_launch_counts()
        eng, done = serve.serve_requests(model, params, reqs, gen=gen,
                                         num_slots=3, cache_len=cache_len,
                                         page_len=page_len)
        runs[dev] = (model, params, done, launch_counts()["paged_attn"])
    if runs["cuda"][3] == 0 or runs["cpu"][3] != 0:
        raise RuntimeError(f"launches cuda={runs['cuda'][3]} "
                           f"cpu={runs['cpu'][3]}: the card run must use "
                           f"the kernel and the CPU run the plain version")
    model, params, want, _ = runs["cpu"]
    got = runs["cuda"][2]
    identical, ties = 0, []
    for rid, r in enumerate(reqs):
        a, b = got[rid].tokens, want[rid].tokens
        if a == b:
            identical += 1
            continue
        i = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        top2 = torch.topk(serve.last_logits(model, params,
                                            list(r) + b[:i], page_len), 2)
        gap = float(top2.values[0] - top2.values[1])
        if gap >= TIE_GAP:
            raise RuntimeError(f"request {rid}: cuda and cpu tokens diverge "
                               f"at {i} with top-2 gap {gap}")
        ties.append({"rid": rid, "at": i, "gap": gap})
    emit({"phase": "cuda_vs_cpu", "gpu": gpu, "arch": cfg.name,
          "requests": n_req, "identical": identical, "ties": ties,
          "cuda_launches": runs["cuda"][3]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_name_and_power()
    phase_build(torch, gpu)
    launches, snap = phase_main_path(torch, gpu)
    kernel = phase_kernels(torch, gpu, snap)
    kernel["launches"] = launches
    phase_cuda_vs_cpu(torch, gpu)
    emit({"kernels": [kernel]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

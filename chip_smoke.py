#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the script
exits non-zero:

  1 build     nvcc builds every kernel under src/repro_torch/kernels/csrc
              (the card's name and power limit, the build time).
  3 serve     qwen3-4b at full width and depth, bf16, random parameters
              from a seeded torch.Generator, served through the serve
              CLI's own `serve_requests`: 8 slots, page_len 16, 16
              synthetic requests of 64-192 tokens behind a 32-token
              shared prefix, 32 generated tokens each (cache_len 272, 136
              pages). Every launch counter is set to 0 just before and
              read just after; paged_attn must have launched 36 times per
              serve_step.
  2 kernels   (run after phase 3, so its launches stay out of phase 3's
              count) paged_attn against its plain PyTorch version on the
              card: a sweep of ragged tables, partial last pages, trash
              entries, dv < dvp on an aliased pool, head dims 16/64/128,
              bf16 and f32; then at the main path's own shapes, on
              q/pools/pt/pos captured from layer 0 during phase 3, with
              kernel, plain, bound and library (gather + SDPA) times.
  4 cuda/cpu  qwen3-4b-reduced in f32 from one numpy parameter tree,
              served on the card (kernel) and on the CPU (plain version):
              the tokens must be identical, up to an argmax tie (top-2
              gap of the CPU logits under 1e-4 at the first divergence).
  5 train     qwen3-4b at full width and depth (bf16, random seeded
              parameters) trained through the train CLI's own `Trainer`:
              B = 8, T = 256, adam, epsilon 8, 1 warm-up + 3 timed steps
              of `per_layer`, then of `non_private`. Counters are set to 0
              before each mode's steps and read after: every step calls
              clip_reduce 145 times (4 linears x 36 blocks + the head) and
              per_layer ghost_norm as often, non_private never. ms per
              step, their ratio, losses, thresholds, clip fraction, peak
              memory, and one profiled step per mode. The kernels' inputs
              at the five linear shapes are captured for phase 6.
  6 kernels   ghost_norm and clip_reduce against their plain versions on
              the card: a sweep (ragged T, T = 1, din != dout, f32 and
              bf16, factors 0 / 1e-3 / 0.5 / 1), then at the captured
              main-path shapes with kernel, plain, bound and library
              times.
  7 cuda/cpu  qwen3-4b-reduced in f32 from one numpy parameter tree and
              one numpy batch: one per_layer `dp_clipped_gradients` on the
              card (kernels) and on the CPU (plain versions) must agree
              in loss, (K, B) norms and every clipped gradient leaf.

The last three lines are the kernels' JSON line, the card's name and
power limit, and {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import gc
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
# ghost_norm / clip_reduce vs plain: f32 sums of many terms in another
# order, so atol is relative to the largest magnitude of the plain result
SUM_RTOL, SUM_ATOL_FRAC = 1e-4, 1e-4
# train card vs CPU (phase 7): the forward, backward and kernels all sum
# in another order on each side (f32, TF32 off)
TRAIN_RTOL, TRAIN_ATOL_FRAC = 1e-3, 1e-4
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


# ---------------------------------------------------------------------------
# Phases 5-7: the training slice.
# ---------------------------------------------------------------------------

TRAIN_WARMUP, TRAIN_TIMED = 1, 3
SUM_SWEEP = [  # B, T, din, dout: ragged T, T = 1, din != dout both ways
    (3, 37, 20, 45), (2, 1, 130, 7), (4, 64, 200, 300), (1, 33, 128, 129),
    (5, 100, 257, 64), (8, 256, 256, 384)]
SUM_FACTORS = [0.0, 1e-3, 0.5, 1.0]


def linear_shapes(cfg) -> dict:
    """(din, dout) -> name of the five linear shapes of a dense step."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return {(d, (h + 2 * kv) * hd): "qkv", (h * hd, d): "o",
            (d, 2 * cfg.d_ff): "gate_up", (cfg.d_ff, d): "down",
            (d, cfg.vocab_size): "head"}


def train_args(mode: str):
    from repro_torch.launch import train
    return train.build_train_parser().parse_args(
        ["--arch", "qwen3-4b", "--clipping", mode, "--epsilon", "8",
         "--steps", str(TRAIN_WARMUP + TRAIN_TIMED), "--batch", "8",
         "--seq", "256", "--docs", "64", "--optimizer", "adam",
         "--seed", "0"])


def profile_step(torch, trainer, step_ms) -> dict:
    """Device time of one more training step by kernel (torch.profiler,
    CUDA activity); the idle share compares it with the unprofiled ms per
    step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"device_ms_per_step": device_ms,
            "unprofiled_ms_per_step": step_ms,
            "device_idle_share": 1.0 - device_ms / step_ms,
            "device_ops_per_step": sum(r[2] for r in rows),
            "top": [{"name": k[:80], "ms_per_step": ms, "calls_per_step": n}
                    for k, ms, n in rows[:8]]}


def phase_train(torch, gpu):
    """Returns (launches by kernel over both modes' counted steps, the
    kernels' inputs captured at each linear shape of the first step)."""
    from repro_torch.kernels import clip_reduce as CR
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train

    steps = TRAIN_WARMUP + TRAIN_TIMED
    launches = {"ghost_norm": 0, "clip_reduce": 0}
    caps, step_ms = {}, {}
    real = CR.clip_reduce
    for mode in ("per_layer", "non_private"):
        t0 = time.perf_counter()
        trainer = train.Trainer(train_args(mode))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        shapes = linear_shapes(trainer.cfg)
        linears = 4 * trainer.cfg.num_layers + 1

        def recording(a, g, factors):
            name = shapes.get((a.shape[-1], g.shape[-1]))
            if name is not None and name not in caps:
                caps[name] = (a.clone(), g.clone(), factors.clone())
            return real(a, g, factors)

        rec = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        for i in range(steps):
            if mode == "per_layer" and i == 0:
                CR.clip_reduce = recording
            try:
                t0 = time.perf_counter()
                met = trainer.step()
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
            finally:
                CR.clip_reduce = real
            rec.append({"ms": ms, "loss": float(met.loss),
                        "mean_threshold": float(met.mean_threshold),
                        "clip_fraction": float(met.clip_fraction),
                        "grad_norm": float(met.grad_norm)})
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                   for r in rec):
            raise RuntimeError(f"{mode}: non-finite loss or update: {rec}")
        want = {"ghost_norm": linears * steps if mode == "per_layer" else 0,
                "clip_reduce": linears * steps}
        if {k: counts[k] for k in want} != want:
            raise RuntimeError(f"{mode}: launches {counts} over {steps} "
                               f"steps, expected {want}")
        for k in launches:
            launches[k] += counts[k]
        step_ms[mode] = sum(r["ms"] for r in rec[TRAIN_WARMUP:]) / TRAIN_TIMED
        emit({"phase": "train", "gpu": gpu, "arch": trainer.cfg.name,
              "mode": mode, "backend": trainer.plan.config.backend,
              "num_params": trainer.model.num_params,
              "dtype": str(trainer.cfg.dtype),
              "batch": trainer.args.batch, "seq": trainer.args.seq,
              "groups": trainer.model.layout.num_groups,
              "sigma": trainer.plan.sigma,
              "sigma_new": trainer.plan.sigma_new,
              "init_s": init_s, "warmup_steps": TRAIN_WARMUP,
              "timed_steps": TRAIN_TIMED, "ms_per_step": step_ms[mode],
              "tokens_per_s": trainer.args.batch * trainer.args.seq
              / (step_ms[mode] / 1e3),
              "steps": rec, "peak_memory_gb": peak, "launches": counts})
        emit({"phase": "train_profile", "gpu": gpu, "mode": mode,
              **profile_step(torch, trainer, step_ms[mode])})
        del trainer, met
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "train_ratio", "gpu": gpu,
          "ratio_vs_nonprivate": step_ms["per_layer"]
          / step_ms["non_private"], "ms_per_step": step_ms})
    if sorted(caps) != sorted(shapes.values()):
        raise RuntimeError(f"captured {sorted(caps)} of the linear shapes")
    return launches, caps


def sum_check(torch, got, want):
    """(max abs error, within tolerance) of a kernel against its plain
    version."""
    err = float((got - want).abs().max())
    atol = SUM_ATOL_FRAC * float(want.abs().max())
    return err, bool(torch.allclose(got, want, rtol=SUM_RTOL, atol=atol))


def sum_bound(kernel, a, g, bw):
    """(bound ms, bound_by): the inputs read once and the f32 output
    written once against the data-sheet bandwidth, and the operations on
    the inputs' type: B T² (din + dout) for ghost_norm (the symmetric
    half of the grams), 2 B T din dout for clip_reduce."""
    b, t, din = a.shape
    dout = g.shape[-1]
    nbytes = a.numel() * a.element_size() + g.numel() * g.element_size()
    if kernel == "ghost_norm":
        nbytes += 4 * b
        ops = b * t * t * (din + dout)
    else:
        nbytes += 4 * b + 4 * din * dout
        ops = 2 * b * t * din * dout
    t_bytes = nbytes / bw
    t_ops = ops / PEAK_OPS[str(a.dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_sum(torch, kernel, a, g, f):
    """Yardsticks, never called by the port: two bmm grams for
    ghost_norm, one f32 matmul with the factor on g's rows for
    clip_reduce."""
    if kernel == "ghost_norm":
        a32, g32 = a.float(), g.float()
        return (torch.bmm(a32, a32.transpose(1, 2))
                * torch.bmm(g32, g32.transpose(1, 2))).sum((1, 2))
    t = a.shape[1]
    a2 = a.reshape(-1, a.shape[-1])
    g2 = g.reshape(-1, g.shape[-1])
    return a2.float().T @ (g2.float() * f.repeat_interleave(t)[:, None])


def phase_train_kernels(torch, gpu, caps, num_layers):
    from repro_torch.kernels import clip_reduce as CR
    from repro_torch.kernels import ghost_norm as GN
    bw = bandwidth(gpu)
    impl = {"ghost_norm": (lambda a, g, f: GN.ghost_norm(a, g),
                           lambda a, g, f: GN.ghost_norm_ref(a, g)),
            "clip_reduce": (CR.clip_reduce, CR.clip_reduce_ref)}
    worst = dict.fromkeys(impl, 0.0)
    for i, (b, t, din, dout) in enumerate(SUM_SWEEP):
        for dtype in ("float32", "bfloat16"):
            rng = np.random.default_rng(i)
            dt = getattr(torch, dtype)
            a = torch.from_numpy(rng.standard_normal((b, t, din)).astype(
                np.float32)).to("cuda", dt)
            g = torch.from_numpy(rng.standard_normal((b, t, dout)).astype(
                np.float32)).to("cuda", dt)
            f = torch.tensor(np.resize(SUM_FACTORS, b), dtype=torch.float32,
                             device="cuda")
            for name, (kern, plain) in impl.items():
                got, want = kern(a, g, f), plain(a, g, f)
                torch.cuda.synchronize()
                err, ok = sum_check(torch, got, want)
                worst[name] = max(worst[name], err)
                emit({"phase": "kernel_vs_plain", "kernel": name,
                      "shape": {"b": b, "t": t, "din": din, "dout": dout},
                      "dtype": dtype, "max_abs_err": err,
                      "tol": {"rtol": SUM_RTOL,
                              "atol_of_max": SUM_ATOL_FRAC}, "ok": ok})
                if not ok:
                    raise RuntimeError(f"{name} disagrees at {(b, t, din, dout)}"
                                       f" {dtype}: max abs err {err}")

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    per_step = {name: dict.fromkeys(keys, 0.0) for name in impl}
    by = {name: {"bytes": 0.0, "operations": 0.0} for name in impl}
    for lname, (a, g, f) in caps.items():
        calls = 1 if lname == "head" else num_layers
        for name, (kern, plain) in impl.items():
            got, want = kern(a, g, f), plain(a, g, f)
            lib = library_sum(torch, name, a, g, f)
            torch.cuda.synchronize()
            err, ok = sum_check(torch, got, want)
            worst[name] = max(worst[name], err)
            if not ok:
                raise RuntimeError(f"{name} disagrees at the main path's "
                                   f"{lname} shapes: max abs err {err}")
            iters = 5 if lname == "head" else 20
            times = {
                "ms": cuda_ms(torch, lambda: kern(a, g, f), iters, 2, flush),
                "plain_ms": cuda_ms(torch, lambda: plain(a, g, f), iters, 2,
                                    flush),
                "library_ms": cuda_ms(torch, lambda: library_sum(
                    torch, name, a, g, f), iters, 2, flush)}
            times["bound_ms"], bound_by = sum_bound(name, a, g, bw)
            for k in keys:
                per_step[name][k] += calls * times[k]
            by[name][bound_by] += calls * times["bound_ms"]
            emit({"phase": "kernel_main_shapes", "gpu": gpu, "kernel": name,
                  "linear": lname, "a": list(a.shape), "g": list(g.shape),
                  "dtype": str(a.dtype), "calls_per_step": calls,
                  "max_abs_err": err,
                  "library_max_abs_err": float((lib - want).abs().max()),
                  "tol": {"rtol": SUM_RTOL, "atol_of_max": SUM_ATOL_FRAC},
                  **times, "bound_by": bound_by})
    src = "src/repro_torch/kernels/csrc/{}.cu"
    replaces = {"ghost_norm": "src/repro/kernels/ghost_norm.py:77",
                "clip_reduce": "src/repro/kernels/clip_reduce.py:47"}
    return [{"name": name, "route": "cuda", "source": src.format(name),
             "replaces": replaces[name], "max_abs_err": worst[name],
             **per_step[name],
             "bound_by": max(by[name], key=by[name].get),
             "per": f"one training step: the sum over its "
                    f"{4 * num_layers + 1} calls at the 5 captured linear "
                    f"shapes"}
            for name in impl]


def phase_train_cuda_vs_cpu(torch, gpu):
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.core.clipping import dp_clipped_gradients
    from repro_torch.kernels import backend, launch_counts, reset_launch_counts
    from repro_torch.models.transformer import build_model

    cfg = get_config("qwen3-4b", reduced=True)
    b, t = 4, 64
    spec_model = build_model(cfg, device="cpu")
    tree = bridge.numpy_params(spec_model.spec, seed=0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    targets[:, -1] = -1
    thr = rng.uniform(0.05, 2.0, spec_model.layout.num_groups).astype(
        np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        params = bridge.train_params_from_numpy(tree, dev)
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "targets": torch.from_numpy(targets).to(dev)}
        reset_launch_counts()
        with backend.scoped("kernels"):
            res = dp_clipped_gradients(
                model.loss_fn, params, batch, model.layout,
                mode="per_layer", batch_size=b,
                thresholds=torch.from_numpy(thr).to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (res, launch_counts())
    (got, cuda_counts), (want, cpu_counts) = runs["cuda"], runs["cpu"]
    for name in ("ghost_norm", "clip_reduce"):
        if cuda_counts[name] == 0 or cpu_counts[name] != 0:
            raise RuntimeError(
                f"{name} launches cuda={cuda_counts[name]} "
                f"cpu={cpu_counts[name]}: the card run must use the kernel "
                f"and the CPU run the plain version")

    def rel(x, y):
        x, y = x.detach().float().cpu(), y.detach().float()
        atol = TRAIN_ATOL_FRAC * float(y.abs().max())
        ok = bool(torch.allclose(x, y, rtol=TRAIN_RTOL, atol=atol))
        return float((x - y).abs().max() / y.abs().max().clamp_min(1e-30)), ok

    checks = {"loss": rel(got.loss, want.loss),
              "norms_sq": rel(got.norms_sq, want.norms_sq)}

    def leaves(tree, prefix=()):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), tree[k]

    for (name, x), (_, y) in zip(leaves(got.grads), leaves(want.grads)):
        checks["grad:" + name] = rel(x, y)
    bad = {k: v[0] for k, v in checks.items() if not v[1]}
    n = want.norms_sq
    emit({"phase": "train_cuda_vs_cpu", "gpu": gpu, "arch": cfg.name,
          "batch": b, "seq": t,
          "clipped_share": float((n > torch.from_numpy(thr)[:, None] ** 2)
                                 .float().mean()),
          "max_err_over_max": {k: v[0] for k, v in checks.items()},
          "tol": {"rtol": TRAIN_RTOL, "atol_of_max": TRAIN_ATOL_FRAC},
          "cuda_launches": {k: cuda_counts[k]
                            for k in ("ghost_norm", "clip_reduce")}})
    if bad:
        raise RuntimeError(f"train: card and CPU disagree: {bad}")



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
    del snap
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, caps = phase_train(torch, gpu)
    from repro_torch.configs import get_config
    train_kernels = phase_train_kernels(
        torch, gpu, caps, get_config("qwen3-4b").num_layers)
    del caps
    for k in train_kernels:
        k["launches"] = train_launches[k["name"]]
    phase_train_cuda_vs_cpu(torch, gpu)
    emit({"kernels": [kernel] + train_kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

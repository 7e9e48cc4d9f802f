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
              of each of six Figure-1 variants (the labels of
              benchmarks/bench_throughput.py): per_layer, non_private,
              ghost_flat_twopass, per_group_twopass, ghost_flat_bk,
              per_group_bk (per_group: --group-count 2), and of
              per_shard (per-device clipping: --group-count 16 column
              blocks of qkv and o, run as per_layer over 1,371 groups),
              before the BK variants. Counters are set to 0 before each
              variant's steps and read after; per step (4 linears x 36
              blocks + the head = 145 linears; 72 of them blocked under
              per_shard), launches of ghost_norm / ghost_norm_blocked /
              clip_reduce / scale_contract:
                per_layer     145 /  0 / 145 / 0
                non_private     0 /  0 / 145 / 0
                *_twopass     145 /  0 / 145 / 0
                per_shard      73 / 72 / 145 / 0
                *_bk          145 /  0 /   0 / 5
              and a BK variant must raise no fallback warning. ms per
              step, ratio_vs_nonprivate, ratio_bk_vs_twopass per mode,
              ratio_vs_per_layer for per_shard, losses, thresholds, clip
              fraction, peak memory, and one profiled step per variant.
              The kernels' inputs at the five linear shapes (per_layer's
              first step), at the two blocked shapes (per_shard's first
              step) and the five BK sinks (per_group_bk's last step) are
              captured for phase 6.
  6 kernels   ghost_norm, ghost_norm_blocked, clip_reduce and
              scale_contract against their plain versions on the card: a
              sweep (S = 1 and 3 and the 3-D form for scale_contract, both
              block axes and M = 1 / 4 / 16 for ghost_norm_blocked, ragged
              T, T = 1, din != dout, f32 and bf16, factors 0 / 1e-3 / 0.5
              / 1), then at the captured main-path shapes with kernel,
              plain, bound and library times.
  7 cuda/cpu  qwen3-4b-reduced in f32 from one numpy parameter tree and
              one numpy batch: one `dp_clipped_gradients` each of
              per_layer, ghost_flat (bk), per_group (bk) and per_shard
              (per_layer over M = 4 blocks) on the card (kernels) and on
              the CPU (plain versions) must agree in loss, (K, B) norms
              and every clipped gradient leaf; on the card bk must agree
              with twopass too.

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
import warnings

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
# (label, --clipping, --execution, --group-count): the Figure-1 variants
# of benchmarks/bench_throughput.py but naive_flat, and per-device
# clipping (per_shard) with the model-axis size of the reference's
# production mesh (src/repro/launch/mesh.py: 16); the BK variants last, so
# the sinks captured from the last one stay out of the others' peaks
VARIANTS = [("per_layer", "per_layer", "bk", 2),
            ("non_private", "non_private", "bk", 2),
            ("ghost_flat_twopass", "ghost_flat", "twopass", 2),
            ("per_group_twopass", "per_group", "twopass", 2),
            ("per_shard", "per_shard", "bk", 16),
            ("ghost_flat_bk", "ghost_flat", "bk", 2),
            ("per_group_bk", "per_group", "bk", 2)]
SUM_SWEEP = [  # B, T, din, dout: ragged T, T = 1, din != dout both ways
    (3, 37, 20, 45), (2, 1, 130, 7), (4, 64, 200, 300), (1, 33, 128, 129),
    (5, 100, 257, 64), (8, 256, 256, 384)]
SC_STACKS = [1, 3, None]  # scale_contract's S over the sweep; None: 3-D
SUM_FACTORS = [0.0, 1e-3, 0.5, 1.0]
SUM_KERNELS = ("ghost_norm", "ghost_norm_blocked", "clip_reduce",
               "scale_contract")
# ghost_norm_blocked's sweep: B, T, din, dout, M, axis (ragged T, T = 1,
# both axes, blocks narrower and wider than a 32-column chunk, M = 1)
BLOCKED_SWEEP = [(3, 37, 20, 48, 4, "out"), (2, 1, 64, 24, 4, "in"),
                 (4, 64, 200, 160, 16, "out"), (2, 100, 96, 130, 2, "in"),
                 (1, 33, 128, 129, 1, "out"), (8, 256, 256, 384, 16, "out")]


def linear_shapes(cfg) -> dict:
    """(din, dout) -> name of the five linear shapes of a dense step."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return {(d, (h + 2 * kv) * hd): "qkv", (h * hd, d): "o",
            (d, 2 * cfg.d_ff): "gate_up", (cfg.d_ff, d): "down",
            (d, cfg.vocab_size): "head"}


def train_args(mode: str, execution: str = "bk", group_count: int = 2):
    from repro_torch.launch import train
    return train.build_train_parser().parse_args(
        ["--arch", "qwen3-4b", "--clipping", mode, "--execution", execution,
         "--group-count", str(group_count), "--epsilon", "8",
         "--steps", str(TRAIN_WARMUP + TRAIN_TIMED), "--batch", "8",
         "--seq", "256", "--docs", "64", "--optimizer", "adam",
         "--seed", "0"])


def expected_launches(label: str, num_layers: int) -> dict:
    """Kernel launches per step of a variant (the table in the doc)."""
    linears = 4 * num_layers + 1
    if label.endswith("_bk"):
        return {"ghost_norm": linears, "ghost_norm_blocked": 0,
                "clip_reduce": 0, "scale_contract": 5}
    if label == "per_shard":  # qkv and o of each block are blocked
        return {"ghost_norm": linears - 2 * num_layers,
                "ghost_norm_blocked": 2 * num_layers,
                "clip_reduce": linears, "scale_contract": 0}
    return {"ghost_norm": 0 if label == "non_private" else linears,
            "ghost_norm_blocked": 0, "clip_reduce": linears,
            "scale_contract": 0}


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
    """Returns (launches by kernel over every variant's counted steps, the
    clip_reduce inputs at each linear shape of per_layer's first step, the
    ghost_norm_blocked inputs at the two blocked shapes of per_shard's
    first step, the scale_contract inputs of per_group_bk's last
    epilogue)."""
    from repro_torch.kernels import bk as SC
    from repro_torch.kernels import clip_reduce as CR
    from repro_torch.kernels import ghost_norm as GN
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train

    steps = TRAIN_WARMUP + TRAIN_TIMED
    launches = dict.fromkeys(SUM_KERNELS, 0)
    caps, gnb_caps, sc_caps, step_ms = {}, {}, {}, {}
    real_cr, real_sc = CR.clip_reduce, SC.scale_contract
    real_gnb = GN.ghost_norm_blocked
    for label, mode, execution, group_count in VARIANTS:
        t0 = time.perf_counter()
        trainer = train.Trainer(train_args(mode, execution, group_count))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        shapes = linear_shapes(trainer.cfg)
        num_layers = trainer.cfg.num_layers

        def recording_cr(a, g, factors):
            name = shapes.get((a.shape[-1], g.shape[-1]))
            if name is not None and name not in caps:
                caps[name] = (a.clone(), g.clone(), factors.clone())
            return real_cr(a, g, factors)

        def recording_gnb(a, g, num_blocks, *, block_axis="out"):
            name = shapes.get((a.shape[-1], g.shape[-1]))
            if name is not None and name not in gnb_caps:
                gnb_caps[name] = (a.clone(), g.clone(),
                                  (num_blocks, block_axis))
            return real_gnb(a, g, num_blocks, block_axis=block_axis)

        def recording_sc(a, g, factors):
            # the sinks: nothing writes them after the epilogue, so a
            # reference (not a copy of ~8 GB) keeps them for phase 6
            name = shapes.get((a.shape[-1], g.shape[-1]))
            if name is not None:
                sc_caps[name] = (a, g, factors)
            return real_sc(a, g, factors)

        rec = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(steps):
                if i == 0 and label == "per_layer":
                    CR.clip_reduce = recording_cr
                if i == 0 and label == "per_shard":
                    GN.ghost_norm_blocked = recording_gnb
                if i == steps - 1 and label == "per_group_bk":
                    # the last step: the kept sinks overlap no later step
                    # of the measured peak
                    SC.scale_contract = recording_sc
                try:
                    t0 = time.perf_counter()
                    met = trainer.step()
                    torch.cuda.synchronize()
                    ms = 1e3 * (time.perf_counter() - t0)
                finally:
                    CR.clip_reduce, SC.scale_contract = real_cr, real_sc
                    GN.ghost_norm_blocked = real_gnb
                rec.append({"ms": ms, "loss": float(met.loss),
                            "mean_threshold": float(met.mean_threshold),
                            "clip_fraction": float(met.clip_fraction),
                            "grad_norm": float(met.grad_norm)})
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        fallbacks = [str(w.message) for w in caught
                     if "falling back to the twopass" in str(w.message)]
        if fallbacks:
            raise RuntimeError(f"{label}: BK fell back: {fallbacks}")
        if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                   for r in rec):
            raise RuntimeError(f"{label}: non-finite loss or update: {rec}")
        want = {k: v * steps
                for k, v in expected_launches(label, num_layers).items()}
        if {k: counts[k] for k in want} != want:
            raise RuntimeError(f"{label}: launches {counts} over {steps} "
                               f"steps, expected {want}")
        for k in launches:
            launches[k] += counts[k]
        step_ms[label] = sum(r["ms"] for r in rec[TRAIN_WARMUP:]) / TRAIN_TIMED
        emit({"phase": "train", "gpu": gpu, "arch": trainer.cfg.name,
              "variant": label, "mode": trainer.plan.config.mode,
              "dp_blocks": trainer.cfg.dp_blocks,
              "execution": trainer.execution,
              "backend": trainer.plan.config.backend,
              "num_params": trainer.model.num_params,
              "dtype": str(trainer.cfg.dtype),
              "batch": trainer.args.batch, "seq": trainer.args.seq,
              "groups": trainer.model.layout.num_groups,
              "noise_groups": trainer.plan.num_noise_groups,
              "sigma": trainer.plan.sigma,
              "sigma_new": trainer.plan.sigma_new,
              "init_s": init_s, "warmup_steps": TRAIN_WARMUP,
              "timed_steps": TRAIN_TIMED, "ms_per_step": step_ms[label],
              "ratio_vs_nonprivate": (step_ms[label] / step_ms["non_private"]
                                      if "non_private" in step_ms else None),
              "ratio_vs_per_layer": step_ms[label] / step_ms["per_layer"],
              "tokens_per_s": trainer.args.batch * trainer.args.seq
              / (step_ms[label] / 1e3),
              "steps": rec, "peak_memory_gb": peak, "launches": counts,
              "launches_per_step": {k: counts[k] // steps for k in want}})
        emit({"phase": "train_profile", "gpu": gpu, "variant": label,
              **profile_step(torch, trainer, step_ms[label])})
        del trainer, met
        gc.collect()
        torch.cuda.empty_cache()
    base = step_ms["non_private"]
    emit({"phase": "train_ratio", "gpu": gpu, "ms_per_step": step_ms,
          "ratio_vs_nonprivate": {k: v / base for k, v in step_ms.items()},
          "ratio_bk_vs_twopass": {
              m: step_ms[f"{m}_bk"] / step_ms[f"{m}_twopass"]
              for m in ("ghost_flat", "per_group")},
          "ratio_per_shard_vs_per_layer":
              step_ms["per_shard"] / step_ms["per_layer"]})
    for name, got, want in (("clip_reduce", caps, shapes.values()),
                            ("scale_contract", sc_caps, shapes.values()),
                            ("ghost_norm_blocked", gnb_caps, ("qkv", "o"))):
        if sorted(got) != sorted(want):
            raise RuntimeError(f"{name}: captured {sorted(got)} of the "
                               f"linear shapes {sorted(want)}")
    return launches, caps, gnb_caps, sc_caps


def sum_check(torch, got, want):
    """(max abs error, within tolerance) of a kernel against its plain
    version."""
    err = float((got - want).abs().max())
    atol = SUM_ATOL_FRAC * float(want.abs().max())
    return err, bool(torch.allclose(got, want, rtol=SUM_RTOL, atol=atol))


def sum_bound(kernel, a, g, bw, num_blocks=1):
    """(bound ms, bound_by): the inputs read once and the f32 output
    written once against the data-sheet bandwidth, and the operations on
    the inputs' type: B T² (din + dout) for ghost_norm and
    ghost_norm_blocked (the symmetric half of the grams; the blocked grams
    cover the blocked operand once), 2 B T din dout for clip_reduce, 2 S B
    T din dout for scale_contract."""
    din, dout = a.shape[-1], g.shape[-1]
    rows = a.numel() // din  # B T, times S for scale_contract
    nbytes = a.numel() * a.element_size() + g.numel() * g.element_size()
    if kernel in ("ghost_norm", "ghost_norm_blocked"):
        b, t = a.shape[0], a.shape[1]
        nbytes += 4 * b * num_blocks
        ops = b * t * t * (din + dout)
    else:
        s = rows // (a.shape[-2] * a.shape[-3])  # stack slices (1 if 3-D)
        nbytes += 4 * (rows // a.shape[-2]) + 4 * s * din * dout
        ops = 2 * rows * din * dout
    t_bytes = nbytes / bw
    t_ops = ops / PEAK_OPS[str(a.dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_sum(torch, kernel, a, g, f):
    """Yardsticks, never called by the port: two bmm grams for
    ghost_norm; for ghost_norm_blocked (f = (M, axis)) the plain path's
    three grams (the shared operand's, the blocked one's per block, their
    inner products) as batched f32 matmuls; one f32 matmul with the
    factor on g's rows for clip_reduce, one f32 bmm over the stack for
    scale_contract."""
    if kernel == "ghost_norm":
        a32, g32 = a.float(), g.float()
        return (torch.bmm(a32, a32.transpose(1, 2))
                * torch.bmm(g32, g32.transpose(1, 2))).sum((1, 2))
    if kernel == "ghost_norm_blocked":
        m, axis = f
        s, x = (a, g) if axis == "out" else (g, a)
        b, t = s.shape[0], s.shape[1]
        s32 = s.float()
        xb = x.float().reshape(b, t, m, -1).transpose(1, 2)
        gram_s = torch.matmul(s32, s32.transpose(1, 2))  # (B, T, T)
        gram_x = torch.matmul(xb, xb.transpose(2, 3))  # (B, M, T, T)
        return torch.matmul(gram_x.reshape(b, m, 1, t * t),
                            gram_s.reshape(b, 1, t * t, 1))[:, :, 0, 0]
    t = a.shape[-2]
    if kernel == "scale_contract":
        s = f.shape[0]
        a3 = a.reshape(s, -1, a.shape[-1]).float()
        g3 = g.reshape(s, -1, g.shape[-1]).float()
        return torch.bmm(a3.transpose(1, 2),
                         g3 * f.repeat_interleave(t, dim=1)[:, :, None])
    a2 = a.reshape(-1, a.shape[-1])
    g2 = g.reshape(-1, g.shape[-1])
    return a2.float().T @ (g2.float() * f.repeat_interleave(t)[:, None])


def sweep_sum_inputs(torch, name, b, t, din, dout, dtype, stack, seed):
    """Seeded inputs of one sweep point; scale_contract's carry a stack
    of `stack` slices (3-D when None) with factors drawn per (s, b) from
    SUM_FACTORS."""
    rng = np.random.default_rng(seed)
    lead = (b,) if stack is None else (stack, b)
    dt = getattr(torch, dtype)
    a = torch.from_numpy(rng.standard_normal(lead + (t, din)).astype(
        np.float32)).to("cuda", dt)
    g = torch.from_numpy(rng.standard_normal(lead + (t, dout)).astype(
        np.float32)).to("cuda", dt)
    f = rng.choice(SUM_FACTORS, size=lead) if name == "scale_contract" \
        else np.resize(SUM_FACTORS, b)
    return a, g, torch.tensor(f, dtype=torch.float32, device="cuda")


def phase_train_kernels(torch, gpu, caps, gnb_caps, sc_caps, num_layers):
    """The training kernels against their plain versions: the sweeps,
    then the captured main-path shapes with kernel, plain, bound and
    library times summed over one step's calls. ghost_norm_blocked's
    third argument is (M, block axis) where the others take factors."""
    from repro_torch.kernels import bk as SC
    from repro_torch.kernels import clip_reduce as CR
    from repro_torch.kernels import ghost_norm as GN
    bw = bandwidth(gpu)
    impl = {"ghost_norm": (lambda a, g, f: GN.ghost_norm(a, g),
                           lambda a, g, f: GN.ghost_norm_ref(a, g)),
            "ghost_norm_blocked": (
                lambda a, g, f: GN.ghost_norm_blocked(a, g, f[0],
                                                      block_axis=f[1]),
                lambda a, g, f: GN.ghost_norm_blocked_ref(a, g, *f)),
            "clip_reduce": (CR.clip_reduce, CR.clip_reduce_ref),
            "scale_contract": (SC.scale_contract, SC.scale_contract_ref)}
    worst = dict.fromkeys(impl, 0.0)

    def check(name, a, g, f, point, dtype):
        kern, plain = impl[name]
        got, want = kern(a, g, f), plain(a, g, f)
        torch.cuda.synchronize()
        err, ok = sum_check(torch, got, want)
        worst[name] = max(worst[name], err)
        emit({"phase": "kernel_vs_plain", "kernel": name, "shape": point,
              "dtype": dtype, "max_abs_err": err,
              "tol": {"rtol": SUM_RTOL, "atol_of_max": SUM_ATOL_FRAC},
              "ok": ok})
        if not ok:
            raise RuntimeError(f"{name} disagrees at {point} {dtype}: max "
                               f"abs err {err}")

    for i, (b, t, din, dout) in enumerate(SUM_SWEEP):
        for dtype in ("float32", "bfloat16"):
            points = [(n, None) for n in ("ghost_norm", "clip_reduce")] + [
                ("scale_contract", s) for s in SC_STACKS]
            for name, stack in points:
                a, g, f = sweep_sum_inputs(torch, name, b, t, din, dout,
                                           dtype, stack, seed=i)
                check(name, a, g, f, {"s": stack, "b": b, "t": t,
                                      "din": din, "dout": dout}, dtype)
    for i, (b, t, din, dout, m, axis) in enumerate(BLOCKED_SWEEP):
        for dtype in ("float32", "bfloat16"):
            a, g, _ = sweep_sum_inputs(torch, "ghost_norm_blocked", b, t,
                                       din, dout, dtype, None, seed=100 + i)
            check("ghost_norm_blocked", a, g, (m, axis),
                  {"b": b, "t": t, "din": din, "dout": dout, "m": m,
                   "axis": axis}, dtype)

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    per_step = {name: dict.fromkeys(keys, 0.0) for name in impl}
    by = {name: {"bytes": 0.0, "operations": 0.0} for name in impl}
    work = [(lname, name, caps[lname], 1 if lname == "head" else num_layers)
            for lname in caps for name in ("ghost_norm", "clip_reduce")]
    # one scale_contract call per linear leaf and step; the stacked calls
    # run for hundreds of ms, so they are timed over few iterations
    work += [(lname, "scale_contract", sc_caps[lname], 1)
             for lname in sc_caps]
    work += [(lname, "ghost_norm_blocked", gnb_caps[lname], num_layers)
             for lname in gnb_caps]
    for lname, name, (a, g, f), calls in work:
        kern, plain = impl[name]
        got, want = kern(a, g, f), plain(a, g, f)
        lib = library_sum(torch, name, a, g, f)
        torch.cuda.synchronize()
        err, ok = sum_check(torch, got, want)
        lib_err = float((lib - want).abs().max())
        del got, lib, want
        worst[name] = max(worst[name], err)
        if not ok:
            raise RuntimeError(f"{name} disagrees at the main path's "
                               f"{lname} shapes: max abs err {err}")
        if name == "scale_contract":
            iters, warm = 3, 1
        else:
            iters, warm = (5, 2) if lname == "head" else (20, 2)
        times = {
            "ms": cuda_ms(torch, lambda: kern(a, g, f), iters, warm, flush),
            "plain_ms": cuda_ms(torch, lambda: plain(a, g, f), iters, warm,
                                flush),
            "library_ms": cuda_ms(torch, lambda: library_sum(
                torch, name, a, g, f), iters, warm, flush)}
        times["bound_ms"], bound_by = sum_bound(
            name, a, g, bw, f[0] if name == "ghost_norm_blocked" else 1)
        for k in keys:
            per_step[name][k] += calls * times[k]
        by[name][bound_by] += calls * times["bound_ms"]
        emit({"phase": "kernel_main_shapes", "gpu": gpu, "kernel": name,
              "linear": lname, "a": list(a.shape), "g": list(g.shape),
              "dtype": str(a.dtype), "calls_per_step": calls,
              "max_abs_err": err, "library_max_abs_err": lib_err,
              "tol": {"rtol": SUM_RTOL, "atol_of_max": SUM_ATOL_FRAC},
              "timing_iters": iters, **times, "bound_by": bound_by})
    src = "src/repro_torch/kernels/csrc/{}.cu"
    replaces = {"ghost_norm": "src/repro/kernels/ghost_norm.py:77",
                "ghost_norm_blocked": "src/repro/kernels/ghost_norm.py:159",
                "clip_reduce": "src/repro/kernels/clip_reduce.py:47",
                "scale_contract": "src/repro/kernels/bk.py:53"}
    linears = f"{4 * num_layers + 1} calls at the 5 captured linear shapes"
    per = {"ghost_norm": linears, "clip_reduce": linears,
           "scale_contract": "5 calls at the 5 captured linear shapes",
           "ghost_norm_blocked": f"{2 * num_layers} calls at the 2 captured "
                                 f"blocked shapes (a per_shard step)"}
    return [{"name": name, "route": "cuda", "source": src.format(name),
             "replaces": replaces[name], "max_abs_err": worst[name],
             **per_step[name],
             "bound_by": max(by[name], key=by[name].get),
             "per": f"one training step: the sum over its {per[name]}"}
            for name in impl]


def phase_train_cuda_vs_cpu(torch, gpu):
    import dataclasses

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.core.clipping import dp_clipped_gradients
    from repro_torch.kernels import backend, launch_counts, reset_launch_counts
    from repro_torch.launch.sharding import group_shard_assignment
    from repro_torch.models.transformer import build_model

    cfg = get_config("qwen3-4b", reduced=True)
    b, t = 4, 64
    spec_model = build_model(cfg, device="cpu")
    layout = spec_model.layout
    tree = bridge.numpy_params(spec_model.spec, seed=0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    targets[:, -1] = -1
    thr = rng.uniform(0.05, 2.0, layout.num_groups).astype(np.float32)
    assign = np.asarray(group_shard_assignment(layout, 2), np.int64)
    group_thr = rng.uniform(0.2, 1.0, 2).astype(np.float32)
    # per_shard: the same weights (blocks split only the groups) clipped
    # per_layer over M = 4 column blocks of qkv and o
    shard_cfg = dataclasses.replace(cfg, dp_blocks=4)
    shard_thr = rng.uniform(0.05, 2.0, build_model(
        shard_cfg, device="cpu").layout.num_groups).astype(np.float32)
    # (label, mode, execution, config, kwargs of numpy arrays)
    cases = [("per_layer", "per_layer", "bk", cfg, {"thresholds": thr}),
             ("ghost_flat", "ghost_flat", "bk", cfg,
              {"flat_threshold": np.float32(0.5)}),
             ("per_group", "per_group", "bk", cfg,
              {"group_assignment": assign, "group_thresholds": group_thr}),
             ("per_shard", "per_layer", "bk", shard_cfg,
              {"thresholds": shard_thr})]
    counted = SUM_KERNELS

    def run(mode, execution, cfg, dev, kw):
        model = build_model(cfg, device=dev)
        params = bridge.train_params_from_numpy(tree, dev)
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "targets": torch.from_numpy(targets).to(dev)}
        reset_launch_counts()
        with backend.scoped("kernels"), warnings.catch_warnings():
            # a BK fallback fails the phase
            warnings.filterwarnings("error", message="BK capture cannot")
            res = dp_clipped_gradients(
                model.loss_fn, params, batch, model.layout, mode=mode,
                batch_size=b, execution=execution,
                **{k: torch.as_tensor(v, device=dev) for k, v in kw.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
        counts = launch_counts()
        return res, {k: counts[k] for k in counted}

    def rel(x, y):
        x, y = x.detach().float().cpu(), y.detach().float().cpu()
        atol = TRAIN_ATOL_FRAC * float(y.abs().max())
        ok = bool(torch.allclose(x, y, rtol=TRAIN_RTOL, atol=atol))
        return float((x - y).abs().max() / y.abs().max().clamp_min(1e-30)), ok

    def leaves(tree, prefix=()):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), tree[k]

    def compare(got, want):
        checks = {"loss": rel(got.loss, want.loss),
                  "norms_sq": rel(got.norms_sq, want.norms_sq)}
        for (name, x), (_, y) in zip(leaves(got.grads), leaves(want.grads)):
            checks["grad:" + name] = rel(x, y)
        return checks

    for label, mode, execution, case_cfg, kw in cases:
        got, cuda_counts = run(mode, execution, case_cfg, "cuda", kw)
        want, cpu_counts = run(mode, execution, case_cfg, "cpu", kw)
        uses = [k for k, v in expected_launches(
            f"{label}_bk" if mode != "per_layer" else label, 1).items() if v]
        for name in uses:
            if cuda_counts[name] == 0 or cpu_counts[name] != 0:
                raise RuntimeError(
                    f"{label}: {name} launches cuda={cuda_counts[name]} "
                    f"cpu={cpu_counts[name]}: the card run must use the "
                    f"kernel and the CPU run the plain version")
        checks = compare(got, want)
        twopass = {}
        if mode != "per_layer":  # bk against twopass, on the card
            tp, _ = run(mode, "twopass", case_cfg, "cuda", kw)
            twopass = compare(got, tp)
        bad = {k: v[0] for k, v in {**checks, **{
            "twopass:" + k: v for k, v in twopass.items()}}.items()
            if not v[1]}
        n = want.norms_sq
        out = {"phase": "train_cuda_vs_cpu", "gpu": gpu, "arch": cfg.name,
               "variant": label, "mode": mode, "execution": execution,
               "dp_blocks": case_cfg.dp_blocks, "batch": b, "seq": t,
               "max_err_over_max": {k: v[0] for k, v in checks.items()},
               "bk_vs_twopass_max_err_over_max":
                   {k: v[0] for k, v in twopass.items()},
               "tol": {"rtol": TRAIN_RTOL, "atol_of_max": TRAIN_ATOL_FRAC},
               "cuda_launches": cuda_counts}
        if mode == "per_layer":
            out["clipped_share"] = float((n > torch.from_numpy(
                kw["thresholds"])[:, None] ** 2).float().mean())
        emit(out)
        if bad:
            raise RuntimeError(f"train {label}: disagreement: {bad}")


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
    train_launches, caps, gnb_caps, sc_caps = phase_train(torch, gpu)
    from repro_torch.configs import get_config
    num_layers = get_config("qwen3-4b").num_layers
    train_kernels = phase_train_kernels(torch, gpu, caps, gnb_caps,
                                        sc_caps, num_layers)
    del caps, gnb_caps, sc_caps
    gc.collect()
    torch.cuda.empty_cache()
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

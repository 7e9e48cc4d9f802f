#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the script
exits non-zero:

  1 build     nvcc builds every kernel under src/repro_torch/kernels/csrc
              (the card's name and power limit, the build time, and from
              -Xptxas -v each kernel's name, registers and spills,
              ptxas's notes on the wgmma pipeline and the bytes of spill
              stores per library).
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
              entries, dv < dvp on an aliased pool, head dims 3/12/16/
              64/128 (rows of 6, 24 and 32 bytes among them), bf16 and
              f32, MLA's latent widths (KV = 1, G = 128, dq = 576, dv =
              512 on an aliased pool, B = 2 and 8, an f32 query over bf16
              and over f32 pools, 4,096 tokens) and long GQA contexts
              (4,096 tokens at qwen3-4b's head layout, 32 splits at B =
              1), two calls bitwise equal at every point; then at the
              main path's own shapes, on q/pools/pt/pos captured from
              layer 0 during phase 3, and at MLA's (B = 8, 4,096 tokens,
              f32 q over a bf16 pool), with kernel (eager and CUDA-graph
              replay), plain, bound and library (gather + SDPA) times,
              the bitwise repeat, the device ms of the split kernel
              and of the combine (torch.profiler) and the host's µs to
              enqueue a call.
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
              per_shard; none within the fused route's rule), launches of
              ghost_norm / ghost_norm_blocked / clip_reduce /
              scale_contract / fused_norm_clip:
                per_layer     145 /  0 / 145 / 0 / 0
                non_private     0 /  0 / 145 / 0 / 0
                *_twopass     145 /  0 / 145 / 0 / 0
                per_shard      73 / 72 / 145 / 0 / 0
                *_bk          145 /  0 /   0 / 5 / 0
              (`expected_launches` derives them from the config and the
              route rule) and a BK variant must raise no fallback
              warning. ms per
              step, ratio_vs_nonprivate, ratio_bk_vs_twopass per mode,
              ratio_vs_per_layer for per_shard, losses, thresholds, clip
              fraction, peak memory, and one profiled step of per_layer
              and of non_private (the others are not profiled: a profile
              costs 11-24 s of the time limit).
              The kernels' inputs at the five linear shapes (per_layer's
              first step), at the two blocked shapes (per_shard's first
              step: ghost_norm_blocked's, and clip_reduce's with the
              (B, M) factors, all 145 of whose calls must take bf16
              inputs, no f32 fold) and the five BK sinks (per_group_bk's
              last step) are captured for phase 6.
  6 kernels   ghost_norm, ghost_norm_blocked, clip_reduce and
              scale_contract against their plain versions on the card: a
              sweep (S = 1 and 3 and the 3-D form for scale_contract, both
              block axes and M = 1 / 4 / 16 for ghost_norm_blocked and for
              clip_reduce's block factors, ragged T, T = 1, din != dout,
              granite's router 1536 -> 40, an odd dout past 4,096, T =
              1024 (the ghost norms' one-chunk plan), T = 4096 at qwen3-
              4b's qkv and head widths for ghost_norm and clip_reduce (the
              long-context path's length), ghost_norm_blocked's
              24-column blocks (a multiple of 8, not of 16), f32 and bf16,
              factors 0 / 1e-3 / 0.5 / 1; two calls of each of the four
              kernels bitwise equal at every point), then at the captured
              main-path shapes (and per_shard's blocked clip_reduce) with
              kernel, plain, bound and library times, the bitwise repeat,
              and for the ghost norms a CUDA-graph replay time beside the
              eager one (a call takes tens of microseconds), the
              device ms of each kernel a call launches (torch.profiler),
              and the kernel's and the plain version's relative errors
              against a float64 evaluation.
  7 cuda/cpu  qwen3-4b-reduced in f32 from one numpy parameter tree and
              one numpy batch: one `dp_clipped_gradients` each of
              per_layer by the fused route (every linear of the reduced
              config is within its rule), by the composed one (the rule
              patched off) and in 2 microbatches (`dp_sgd
              .clipped_microbatches`, the accumulation), naive_flat (one
              no-norm backward per example: 4 x 9 clip_reduce),
              ghost_flat (bk), per_group (bk) and per_shard (per_layer
              over M = 4 blocks), and per_layer on
              granite-moe-3b-a800m-reduced (f32), on the
              card (kernels) and on the CPU (plain versions): they must
              agree in loss, (K, B) norms and every clipped gradient leaf;
              on the card bk must agree with twopass too. The card must
              launch exactly the kernels of the route, the CPU none.
  8 moe train granite-moe-3b-a800m at full width and depth (32 layers,
              d_model 1536, 40 experts top-8, bf16, 3.37 B parameters,
              2,723 clipping groups; flat dispatch) through the same
              `Trainer`: 1 warm-up + 3 timed steps of per_layer and of
              non_private, B = 8, T = 256, adam, epsilon 8, each with one
              profiled step. Launches per step (65 linears outside the
              fused route's rule: qkv and o of 32 layers and the head; 32
              routers within it; the experts run no kernel) of
              fused_norm_clip / ghost_norm / clip_reduce:
                per_layer      32 / 65 / 65
                non_private     0 /  0 / 97
              The router's inputs of per_layer's first step are captured
              for phase 9, and the clip_reduce inputs at the shapes no
              qwen3-4b linear has (qkv 1536 -> 2560, o 1536 -> 1536, the
              head 1536 -> 49155 from per_layer's first step; the router
              1536 -> 40 from non_private's) for phase 10.
  9 kernels   fused_norm_clip against its plain version on the card: a
              sweep (B = 1 / 3 / 8 / 1024 / 16,384, T = 1 / 8 / 37 / 200
              / 256 / 300, din and dout off the 64-wide tiles, 1024 ->
              1024 at the route rule's limit, c of +inf, positive,
              negative and mixed, extra None and given, f32 and bf16;
              at every point two calls bitwise equal and the call's
              extra device memory within its plan's scratch + 1 MB);
              DP-scale batches (the router at B = 64 and 1024, the
              sweep's B = 1024 and 16,384) by CUDA graph replay beside
              the composed route; then at the captured router shape
              with kernel, plain, bound, library (per-example f32 bmm)
              and composed (ghost_norm + clip_reduce kernels) times:
              device times from CUDA graph replays (a call takes tens of
              microseconds, below the host's launch overhead), eager
              times beside them; exactly one device kernel a call (the
              nodes of a captured call, read through the driver; the
              kernel's ms by torch.profiler, which may drop events); the
              kernel's and the plain version's relative errors against a
              float64 evaluation.
 10 kernels   ghost_norm and clip_reduce (per_layer: qkv, o, head) and
              clip_reduce (non_private: router) against their plain
              versions at granite's captured inputs, with phase 6's
              tolerances, bitwise repeats and times (ghost_norm's graph
              replay too); the
              kernels line carries them under each kernel's "moe" key, and
              its max_abs_err is the worst over both models' inputs.
 11 scale     the rest of single-device training at full width through
              the same `Trainer` (1 warm-up + 3 timed steps each, the
              sampling rate 1/16 of phase 5): qwen3-4b naive_flat (B = 8,
              T = 256, --microbatches 4: the fewest whose per-example
              gradients, 8.8 GB each, fit beside the f32 accumulator) as
              the seventh Figure-1 variant with its ratio_vs_nonprivate;
              per_layer at B = 64 in 8 microbatches on qwen3-4b and on
              granite; qwen3-4b per_layer at T = 4096, B = 2 (every
              layer's attention on the double-blocked branch). None is
              profiled (the profiler's post-processing of one such step
              takes about two minutes). Each prints ms per step,
              ms per example against its model's B = 8 per_layer run,
              peak memory, and each step's mean threshold and clip
              fraction. Launches per step of ghost_norm / clip_reduce /
              fused_norm_clip (`expected_launches`, per microbatch times
              the microbatches; naive_flat one clip_reduce per linear and
              example):
                qwen3-4b naive_flat        0 / 1,160 /   0
                qwen3-4b per_layer B = 64  1,160 / 1,160 / 0
                granite per_layer B = 64   520 /   520 / 256
                qwen3-4b per_layer T = 4096  145 / 145 / 0
              naive_flat's clip_reduce inputs at the five linear shapes
              (its first step, kept on the host: B = 2 a call, factor 1,
              one example's rows zero) then go through clip_reduce, and
              the T = 4096 path's through ghost_norm and clip_reduce,
              against their plain versions with phase 6's tolerances,
              times and float64 errors, under each kernel's "naive_flat"
              and "long_context" keys of the kernels line (times summed
              over a step's calls: 8 per linear and layer for
              naive_flat).

 12 service   the crash-safe training service (`launch.service`) on phase
              5's settings (qwen3-4b at full width and depth, per_layer,
              B = 8, T = 256, adam, epsilon 8, rate 1/16; 4 steps, a
              checkpoint every 2), on one shared `ServiceRuntime`:
              (a) the first step from the seeded state twice, each state's
              39 leaf crc32s compared bitwise (printed, differing leaves
              named), then 3 more steps: the uninterrupted run's final
              crcs, in memory; (b) a `TrainService` crashed by
              FaultInjector("post-ledger-append", 3, mode="raise"), its
              state dropped, a second incarnation resumed to 4 steps: the
              final manifest's crcs must equal (a)'s, the ledger hold 4
              records before and after the resume (re-executed steps add
              none) and the final step verify; each save's, the load's and
              the verify's seconds and GB/s, the raw and stored bytes, the
              codec, threads and free disk, and one host thread's zlib
              rates on bf16 weights (level 6, Huffman only, stored);
              ghost_norm / clip_reduce launches 145 each per executed
              step, re-executions included (5 executed steps in (a), 5 in
              (b)); (c) the service CLI in subprocesses at --reduced width:
              `--fault-at post-ledger-append:3` exits 86, the resume exits
              0 with the crcs of an uninterrupted CLI run, a flipped byte
              in the newest shard falls back to step 2 and re-trains to the
              same crcs, and `--calib-steps 2` stops cleanly with
              status=budget_exhausted at step 2, epsilon within budget.

Each kernel of the kernels' line carries max_abs_err and max_rel_err,
the latter relative to the largest magnitude of the plain result (the
scale of the checks' atol), the worst over its checks; its launches are
the sum over phases 5, 8, 11 and 12.

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


def graph_ms(torch, fn, iters=50, flush=None):
    """Mean ms per call of `fn` replayed from a CUDA graph, with the L2
    flushed before each replay: the device time of a call of a few tens
    of microseconds, which eager timing (`cuda_ms`) measures as the
    host's launch overhead. The flush runs while the host enqueues the
    replay, so the device does not wait on the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, iters, warmup=3, flush=flush)


# ---------------------------------------------------------------------------
# Phase 2 helpers.
# ---------------------------------------------------------------------------

def sweep_inputs(torch, b, kv, g, dq, dv, n, page_len, p_tab, dtype, seed,
                 pool_dtype=None, full=False):
    """Ragged page tables with trash-mapped tails (trash page = n),
    positions covering one token, a partial page and a full table (every
    position full with `full`); an aliased pool when dv is given; the
    pools in `pool_dtype` (default: q's)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, dq)).astype(np.float32)
    kp = rng.standard_normal((n + 1, page_len, kv, dq)).astype(np.float32)
    pos = rng.integers(0, p_tab * page_len, size=b).astype(np.int32)
    pos[0] = 0
    pos[-1] = p_tab * page_len - 1
    if b > 2:
        pos[1] = page_len + page_len // 2
    if full:
        pos[:] = p_tab * page_len - 1
    pt = rng.integers(0, n, size=(b, p_tab)).astype(np.int32)
    for i in range(b):
        pt[i, pos[i] // page_len + 1:] = n
    dt = getattr(torch, dtype)
    pdt = dt if pool_dtype is None else getattr(torch, pool_dtype)
    tq = torch.from_numpy(q).to("cuda", dt)
    tk = torch.from_numpy(kp).to("cuda", pdt)
    if dv is None:
        vp = rng.standard_normal(kp.shape).astype(np.float32)
        tv = torch.from_numpy(vp).to("cuda", pdt)
    else:
        tv = tk
    return (tq, tk, tv, torch.from_numpy(pt).cuda(),
            torch.from_numpy(pos).cuda())


SAME = (("float32", None), ("bfloat16", None))  # q dtype, pool dtype
MIXED = (("float32", "bfloat16"), ("float32", "float32"))
SWEEP = [  # b, kv, g, dq, dv (None: separate value pool), n, L, P; dtypes
    ((3, 2, 2, 16, None, 7, 8, 3), SAME),
    ((4, 1, 1, 16, None, 9, 2, 5), SAME),
    ((3, 2, 4, 64, None, 9, 16, 4), SAME),
    ((2, 1, 8, 64, 32, 5, 4, 4), SAME),         # aliased pool, dv < dvp
    ((8, 8, 4, 128, None, 40, 16, 17), SAME),   # qwen3-4b head layout
    ((2, 2, 16, 128, 64, 6, 16, 3), SAME),      # aliased pool, dv < dvp
    ((3, 1, 3, 128, None, 12, 16, 6), SAME),    # odd G
    ((3, 2, 3, 12, None, 7, 8, 3), SAME),       # 24- / 48-byte rows
    ((2, 2, 2, 3, 2, 7, 4, 5), SAME),           # 6-byte bf16 rows, aliased
    # MLA's latent decode (deepseek-v3): KV = 1, G = 128, dq = 512 + 64,
    # the value read cut to 512 on the aliased pool, 4,096 tokens
    ((2, 1, 128, 576, 512, 300, 16, 256), MIXED),
    ((8, 1, 128, 576, 512, 600, 16, 256), MIXED),
    # long GQA contexts at qwen3-4b's head layout: 4,096 tokens (5
    # splits of 832 rows), and B = 1 (32 splits of 128)
    ((8, 8, 4, 128, None, 2100, 16, 256), SAME),
    ((1, 8, 4, 128, None, 300, 16, 256), SAME + (("float32", "bfloat16"),)),
]
# the MLA point timed beside the main path: B = 8, 4,096 tokens each, an
# f32 query over a bf16 latent pool
MLA_TIMED = ((8, 1, 128, 576, 512, 600, 16, 256), "float32", "bfloat16")
HOST_CALLS = 200


def library_attn(torch, q, kpool, vpool, pt, pos, scale, dv):
    """Yardstick, never called by the port: gather through the table, then
    one F.scaled_dot_product_attention call (the pools cast to q's dtype
    where they differ)."""
    import torch.nn.functional as F
    b, kv, g, dq = q.shape
    s = pt.shape[1] * kpool.shape[1]
    idx = pt.long()
    k = kpool[idx].reshape(b, s, kv, dq).transpose(1, 2).to(q.dtype)
    v = vpool[idx].reshape(b, s, kv, -1)[..., :dv].transpose(1, 2).to(
        q.dtype)
    mask = (torch.arange(s, device=q.device)[None] <= pos[:, None])
    out = F.scaled_dot_product_attention(
        q.reshape(b, kv * g, 1, dq), k, v, attn_mask=mask[:, None, None],
        scale=scale, enable_gqa=True)
    return out.reshape(b, kv, g, dv)


def paged_attn_bound(q, kpool, vpool, pt, pos, dv, bw):
    """(bound ms, bound_by) for the work this input needs: each valid K/V
    row (an aliased pool's row once: its first dv features are the value),
    q, the used table entries and pos read once, out written once; 2 * (dq
    + dv) operations per (query head, valid row), at the peak rate of q's
    type."""
    b, kv, g, dq = q.shape
    page_len = kpool.shape[1]
    cap = pt.shape[1] * page_len
    n_valid = np.minimum(pos.cpu().numpy().astype(np.int64) + 1, cap)
    esize = kpool.element_size()
    rows = int(n_valid.sum())
    row_width = dq if vpool.data_ptr() == kpool.data_ptr() else dq + dv
    nbytes = (rows * kv * row_width * esize + q.numel() * q.element_size()
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
    # -Xptxas -v: each kernel's name, registers and spills, and ptxas's
    # notes on the wgmma pipeline (C75xx)
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "Compiling entry" in ln or "registers" in ln
                    or "spill" in ln or "(C75" in ln]
             for name, log in _build.BUILD_LOGS.items()}
    spills = {name: sum(int(ln.split(" bytes spill stores")[0].split()[-1])
                        for ln in log.splitlines() if "spill stores" in ln)
              for name, log in _build.BUILD_LOGS.items()}
    emit({"phase": "build", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernels": sorted(libs),
          "build_s": build_s, "ptxas": ptxas, "spill_store_bytes": spills})


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
          # the split kernel and the combine
          "paged_attn_ms_per_step": sum(ms for k, ms, _ in rows
                                        if "paged_attn" in k),
          "top": [{"name": k[:80], "ms_per_step": ms, "calls_per_step": n}
                  for k, ms, n in rows[:8]]})


def phase_kernels(torch, gpu, main_snap):
    from repro_torch.kernels import paged_attn as K
    bw = bandwidth(gpu)
    worst = worst_rel = 0.0
    for i, (shape, dtypes) in enumerate(SWEEP):
        for dtype, pool_dtype in dtypes:
            q, kp, vp, pt, pos = sweep_inputs(torch, *shape, dtype, seed=i,
                                              pool_dtype=pool_dtype)
            dv = shape[4]
            scale = 1.0 / math.sqrt(shape[3])
            got = K.paged_attn(q, kp, vp, pt, pos, scale=scale, dv=dv)
            again = K.paged_attn(q, kp, vp, pt, pos, scale=scale, dv=dv)
            want = K.paged_attn_ref(q, kp, vp, pt, pos, scale=scale, dv=dv)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, **TOL))
            bitwise = bool(torch.equal(got, again))
            rel = rel_err(err, want)
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            pl = K.plan(*shape[:3], shape[3], vp.shape[-1] if dv is None
                        else dv, shape[7], shape[6], kp.dtype, dv is not None)
            emit({"phase": "kernel_vs_plain", "kernel": "paged_attn",
                  "shape": dict(zip(["b", "kv", "g", "dq", "dv", "n", "L",
                                     "P"], shape)), "dtype": dtype,
                  "pool_dtype": pool_dtype or dtype,
                  "plan": pl._asdict(), "max_abs_err": err,
                  "max_rel_err": rel, "tol": TOL, "ok": ok,
                  "bitwise_repeat": bitwise})
            if not ok:
                raise RuntimeError(f"paged_attn disagrees at {shape} "
                                   f"{dtype}/{pool_dtype}: max abs err "
                                   f"{err}")
            if not bitwise:
                raise RuntimeError(f"paged_attn: two calls at {shape} "
                                   f"{dtype}/{pool_dtype} differ")
            del q, kp, vp, got, again, want

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    q, kp, vp, pt, pos, kw = main_snap
    row = paged_attn_times(torch, gpu, K, "main_path", q, kp, vp, pt, pos,
                           kw["scale"], vp.shape[-1], bw, flush)
    shape, dtype, pool_dtype = MLA_TIMED
    mla_in = sweep_inputs(torch, *shape, dtype, seed=99,
                          pool_dtype=pool_dtype, full=True)
    mla = paged_attn_times(torch, gpu, K, "mla", *mla_in,
                           1.0 / math.sqrt(192), shape[4], bw, flush)
    worst = max(worst, row["max_abs_err"], mla["max_abs_err"])
    worst_rel = max(worst_rel, row["max_rel_err"], mla["max_rel_err"])
    result = {"name": "paged_attn", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
              "replaces": "src/repro/kernels/paged_attn.py:83",
              "max_abs_err": worst, "max_rel_err": worst_rel,
              **{k: row[k] for k in ("ms", "graph_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
              "mla": {k: mla[k] for k in ("q", "kpool", "dtype",
                                          "pool_dtype", "ms", "graph_ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "max_abs_err",
                                          "max_rel_err")}}
    return result


def paged_attn_times(torch, gpu, K, label, q, kp, vp, pt, pos, scale, dv,
                     bw, flush) -> dict:
    """paged_attn at one input against its plain version (TOL), the
    bitwise repeat, then kernel (eager and CUDA-graph replay), plain,
    library and bound ms per call, the L2 flushed before each, and the
    device ms of the split kernel and the combine; emits and returns the
    kernel_main_shapes line. Raises on a disagreement."""
    kw = dict(scale=scale, dv=dv)
    got = K.paged_attn(q, kp, vp, pt, pos, **kw)
    again = K.paged_attn(q, kp, vp, pt, pos, **kw)
    want = K.paged_attn_ref(q, kp, vp, pt, pos, **kw)
    lib = library_attn(torch, q, kp, vp, pt, pos, scale, dv)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **TOL):
        raise RuntimeError(f"paged_attn disagrees at the {label} shapes: "
                           f"max abs err {err}")
    if not torch.equal(got, again):
        raise RuntimeError(f"paged_attn: two calls at the {label} shapes "
                           f"differ")
    lib_err = float((lib.float() - want).abs().max())
    rel = rel_err(err, want)
    del got, again, want, lib
    call = lambda: K.paged_attn(q, kp, vp, pt, pos, **kw)  # noqa: E731
    times = {
        "ms": cuda_ms(torch, call, flush=flush),
        "graph_ms": graph_ms(torch, call, flush=flush),
        "plain_ms": cuda_ms(torch, lambda: K.paged_attn_ref(
            q, kp, vp, pt, pos, **kw), flush=flush),
        "library_ms": cuda_ms(torch, lambda: library_attn(
            torch, q, kp, vp, pt, pos, scale, dv), flush=flush)}
    times["bound_ms"], bound_by = paged_attn_bound(q, kp, vp, pt, pos, dv,
                                                   bw)
    # the host's time to enqueue a call (the wrapper's checks, plan,
    # allocation and two launches), which a serving step pays 36 times
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        call()
    host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    b, kv, g, dq = q.shape
    pl = K.plan(b, kv, g, dq, dv, pt.shape[1], kp.shape[1], kp.dtype,
                vp.data_ptr() == kp.data_ptr())
    row = {"phase": "kernel_main_shapes", "gpu": gpu, "kernel": "paged_attn",
           "point": label, "q": list(q.shape), "kpool": list(kp.shape),
           "vpool_is_kpool": vp.data_ptr() == kp.data_ptr(),
           "pt": list(pt.shape), "pos": pos.tolist(),
           "dtype": str(q.dtype), "pool_dtype": str(kp.dtype),
           "plan": pl._asdict(), "max_abs_err": err, "max_rel_err": rel,
           "library_max_abs_err": lib_err, "tol": TOL,
           "bitwise_repeat": True, **times, "bound_by": bound_by,
           "host_us_per_call": host_us,
           "launch_ms": launch_split(torch, call)}
    emit(row)
    return row


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
# phase 5's profiled variants: the Figure-1 pair (a profile costs 11-24 s
# of the run's time limit)
PROFILED = ("per_layer", "non_private")
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
# B, T, din, dout: ragged T, T = 1, din != dout both ways, granite's
# router (1536 -> 40: 12 output tiles, split over the examples), an odd
# dout past 4,096 (g's rows unaligned: plain loads instead of TMA) and T =
# 1024 (the ghost norm's plan takes one chunk of the shared operand, five
# tensor-core chains of 512 features)
SUM_SWEEP = [
    (3, 37, 20, 45), (2, 1, 130, 7), (4, 64, 200, 300), (1, 33, 128, 129),
    (5, 100, 257, 64), (8, 256, 256, 384), (8, 256, 1536, 40),
    (2, 70, 192, 4097), (4, 1024, 2304, 2560)]
# ghost_norm and clip_reduce at the long-context path's B = 2, T = 4096
# and qwen3-4b's widths: qkv 2560 -> 6144 and the head 2560 -> 151,936,
# with factors 1 and 0.5
LONG_SWEEP = [(2, 4096, 2560, 6144), (2, 4096, 2560, 151936)]
# clip_reduce with (B, M) block factors: B, T, din, dout, M, axis (both
# axes; M = 16 with o's 160-wide blocks, not a multiple of the 128-wide
# tile; M = 4; M = 1; ragged T, T = 1)
BLOCK_FACTOR_SWEEP = [(4, 64, 256, 2560, 16, "out"),
                      (4, 64, 2560, 256, 16, "in"),
                      (3, 37, 640, 320, 4, "out"), (3, 37, 320, 640, 4, "in"),
                      (2, 33, 130, 96, 1, "out"), (2, 1, 96, 45, 1, "in")]
# kernels whose two calls on one input must give the same bits (no atomics)
BITWISE = ("clip_reduce", "scale_contract", "ghost_norm",
           "ghost_norm_blocked")
# kernels whose main-shape rows carry a CUDA-graph replay time beside the
# eager one (tens of microseconds a call: eager timing sees the host)
GRAPHED = ("ghost_norm", "ghost_norm_blocked")
SC_STACKS = [1, 3, None]  # scale_contract's S over the sweep; None: 3-D
SUM_FACTORS = [0.0, 1e-3, 0.5, 1.0]
SUM_KERNELS = ("ghost_norm", "ghost_norm_blocked", "clip_reduce",
               "scale_contract")
TRAIN_KERNELS = SUM_KERNELS + ("fused_norm_clip",)
# ghost_norm_blocked's sweep: B, T, din, dout, M, axis (ragged T, T = 1,
# both axes, blocks narrower and wider than a 32-column chunk, M = 1,
# blocks of 24 columns: a multiple of 8, not of 16, so TMA's 4-D map with
# two k16 steps of the 64-feature box)
BLOCKED_SWEEP = [(3, 37, 20, 48, 4, "out"), (2, 1, 64, 24, 4, "in"),
                 (4, 64, 200, 160, 16, "out"), (2, 100, 96, 130, 2, "in"),
                 (1, 33, 128, 129, 1, "out"), (8, 256, 256, 384, 16, "out"),
                 (4, 64, 256, 384, 16, "out")]


def linear_shapes(cfg) -> dict:
    """(din, dout) -> name of the linear shapes of a step (five on a dense
    config)."""
    return {(din, dout): leaf for leaf, din, dout, _ in linear_leaves(cfg)}


def train_args(mode: str, execution: str = "bk", group_count: int = 2,
               arch: str = "qwen3-4b", batch: int = 8, seq: int = 256,
               microbatches: int = 1, docs: int = 64):
    from repro_torch.launch import train
    return train.build_train_parser().parse_args(
        ["--arch", arch, "--clipping", mode, "--execution", execution,
         "--group-count", str(group_count), "--epsilon", "8",
         "--steps", str(TRAIN_WARMUP + TRAIN_TIMED), "--batch", str(batch),
         "--seq", str(seq), "--docs", str(docs), "--microbatches",
         str(microbatches), "--optimizer", "adam", "--seed", "0"])


def linear_leaves(cfg) -> list:
    """(leaf, din, dout, blocked) of every linear a training step clips:
    qkv and o of each layer (blocked when cfg.dp_blocks > 1), gate_up and
    down of each dense layer, the router of each MoE layer, the head. The
    experts run no kernel."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    n_moe = cfg.num_layers - cfg.first_k_dense if cfg.num_experts else 0
    n_dense = cfg.num_layers - n_moe
    blocked = cfg.dp_blocks > 1
    return ([("qkv", d, (h + 2 * kv) * hd, blocked),
             ("o", h * hd, d, blocked)] * cfg.num_layers
            + [("gate_up", d, 2 * cfg.d_ff, False),
               ("down", cfg.d_ff, d, False)] * n_dense
            + [("router", d, cfg.num_experts, False)] * n_moe
            + [("head", d, cfg.vocab_size, False)])


def expected_launches(label: str, cfg, fused_route: bool = True, *,
                      batch: int = 8, microbatches: int = 1) -> dict:
    """Kernel launches per step of a variant (the tables in the doc), per
    microbatch times `microbatches`: a BK step takes ghost_norm per linear
    and one scale_contract per linear leaf; non_private clip_reduce per
    linear; naive_flat clip_reduce per linear and example (one no-norm
    backward per example); a blocked linear ghost_norm_blocked and
    clip_reduce; a twopass step ghost_norm and clip_reduce; per_layer
    fused_norm_clip where the route rule passes (unless `fused_route` is
    off), else ghost_norm and clip_reduce."""
    from repro_torch.kernels.fused_clip import fits
    counts = dict.fromkeys(TRAIN_KERNELS, 0)

    def add(*names):
        for name in names:
            counts[name] += 1

    leaves = linear_leaves(cfg)
    for _, din, dout, blocked in leaves:
        if label.endswith("_bk"):
            add("ghost_norm")
        elif label == "non_private":
            add("clip_reduce")
        elif label == "naive_flat":
            counts["clip_reduce"] += batch // microbatches
        elif blocked:
            add("ghost_norm_blocked", "clip_reduce")
        elif not label.endswith("_twopass") and fused_route \
                and fits(din, dout):
            add("fused_norm_clip")
        else:
            add("ghost_norm", "clip_reduce")
    if label.endswith("_bk"):
        counts["scale_contract"] = len({leaf for leaf, *_ in leaves})
    return {k: v * microbatches for k, v in counts.items()}


def profile_step(torch, trainer, step_ms) -> dict:
    """Device time of one more training step by kernel (torch.profiler,
    CUDA activity); the idle share compares it with the unprofiled ms per
    step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"profile_s": time.perf_counter() - t0,
            "device_ms_per_step": device_ms,
            "unprofiled_ms_per_step": step_ms,
            "device_idle_share": 1.0 - device_ms / step_ms,
            "device_ops_per_step": sum(r[2] for r in rows),
            "top": [{"name": k[:80], "ms_per_step": ms, "calls_per_step": n}
                    for k, ms, n in rows[:8]]}


def train_variant(torch, gpu, label, args, step_ms, patches=(), *,
                  kind=None, profile=True):
    """Train one variant through the CLI's `Trainer`: TRAIN_WARMUP +
    TRAIN_TIMED steps with every launch counter set to 0 before and read
    after, then (with `profile`) one profiled step. `patches` are (step,
    module, attribute, replacement) swapped in for that step only (the
    input recorders). Checks finite losses, no BK fallback and the
    launches per step of `kind` (default: the label) at the run's batch
    and microbatches; emits the train (and train_profile) lines; records
    ms per step in `step_ms`, whose non_private and per_layer entries (B
    = 8) give the ratios. Returns the launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    steps = TRAIN_WARMUP + TRAIN_TIMED
    t0 = time.perf_counter()
    trainer = train.Trainer(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rec = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(steps):
            swapped = [(mod, attr, getattr(mod, attr))
                       for s, mod, attr, _ in patches if s == i]
            for s, mod, attr, fn in patches:
                if s == i:
                    setattr(mod, attr, fn)
            try:
                t0 = time.perf_counter()
                met = trainer.step()
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
            finally:
                for mod, attr, fn in swapped:
                    setattr(mod, attr, fn)
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
    batch, nmb = trainer.args.batch, trainer.args.microbatches
    per_step = expected_launches(kind or label, trainer.cfg, batch=batch,
                                 microbatches=nmb)
    want = {k: v * steps for k, v in per_step.items()}
    if {k: counts[k] for k in want} != want:
        raise RuntimeError(f"{label}: launches {counts} over {steps} "
                           f"steps, expected {want}")
    step_ms[label] = sum(r["ms"] for r in rec[TRAIN_WARMUP:]) / TRAIN_TIMED
    base, per_layer = step_ms.get("non_private"), step_ms["per_layer"]
    emit({"phase": "train", "gpu": gpu, "arch": trainer.cfg.name,
          "variant": label, "mode": trainer.plan.config.mode,
          "dp_blocks": trainer.cfg.dp_blocks,
          "execution": trainer.execution,
          "backend": trainer.plan.config.backend,
          "num_params": trainer.model.num_params,
          "dtype": str(trainer.cfg.dtype),
          "batch": batch, "seq": trainer.args.seq, "microbatches": nmb,
          "groups": trainer.model.layout.num_groups,
          "noise_groups": trainer.plan.num_noise_groups,
          "sigma": trainer.plan.sigma,
          "sigma_new": trainer.plan.sigma_new,
          "init_s": init_s, "warmup_steps": TRAIN_WARMUP,
          "timed_steps": TRAIN_TIMED, "ms_per_step": step_ms[label],
          "ratio_vs_nonprivate": (step_ms[label] / base if base else None),
          "ratio_vs_per_layer": step_ms[label] / per_layer,
          "ms_per_example": step_ms[label] / batch,
          "ms_per_example_vs_per_layer_b8":
              step_ms[label] / batch / (per_layer / 8),
          "tokens_per_s": batch * trainer.args.seq
          / (step_ms[label] / 1e3),
          "steps": rec, "peak_memory_gb": peak, "launches": counts,
          "launches_per_step": per_step})
    if profile:
        emit({"phase": "train_profile", "gpu": gpu,
              "arch": trainer.cfg.name, "variant": label,
              **profile_step(torch, trainer, step_ms[label])})
    del trainer, met
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_train(torch, gpu, step_ms):
    """Records each variant's ms per step in `step_ms`. Returns (launches
    by kernel over every variant's counted steps, the
    clip_reduce inputs at each linear shape of per_layer's first step, the
    ghost_norm_blocked inputs at the two blocked shapes of per_shard's
    first step, the scale_contract inputs of per_group_bk's last
    epilogue, the blocked clip_reduce inputs (a, g, ((B, M) factors,
    axis)) of per_shard's first step). Checks that every clip_reduce call
    of that step took bfloat16 inputs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import bk as SC
    from repro_torch.kernels import clip_reduce as CR
    from repro_torch.kernels import ghost_norm as GN

    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    caps, gnb_caps, sc_caps = {}, {}, {}
    blk_caps, shard_dtypes = {}, []
    real_cr, real_sc = CR.clip_reduce, SC.scale_contract
    real_gnb = GN.ghost_norm_blocked
    shapes = linear_shapes(get_config("qwen3-4b"))

    def recording_cr(a, g, factors, block_axis="out"):
        name = shapes.get((a.shape[-1], g.shape[-1]))
        if name is not None and name not in caps:
            caps[name] = (a.clone(), g.clone(), factors.clone())
        return real_cr(a, g, factors, block_axis)

    def recording_blocked_cr(a, g, factors, block_axis="out"):
        shard_dtypes.append(str(a.dtype))
        name = shapes.get((a.shape[-1], g.shape[-1]))
        if factors.dim() == 2 and name is not None and name not in blk_caps:
            # on the host: the later variants' peaks stay as they were
            blk_caps[name] = (a.cpu(), g.cpu(), (factors.cpu(), block_axis))
        return real_cr(a, g, factors, block_axis)

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

    last = TRAIN_WARMUP + TRAIN_TIMED - 1
    # per_group_bk's last step: the kept sinks overlap no later step of
    # the measured peak
    patches = {"per_layer": [(0, CR, "clip_reduce", recording_cr)],
               "per_shard": [(0, GN, "ghost_norm_blocked", recording_gnb),
                             (0, CR, "clip_reduce", recording_blocked_cr)],
               "per_group_bk": [(last, SC, "scale_contract", recording_sc)]}
    for label, mode, execution, group_count in VARIANTS:
        counts = train_variant(torch, gpu, label,
                               train_args(mode, execution, group_count),
                               step_ms, patches.get(label, ()),
                               profile=label in PROFILED)
        for k in launches:
            launches[k] += counts[k]
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
                            ("ghost_norm_blocked", gnb_caps, ("qkv", "o")),
                            ("blocked clip_reduce", blk_caps, ("qkv", "o"))):
        if sorted(got) != sorted(want):
            raise RuntimeError(f"{name}: captured {sorted(got)} of the "
                               f"linear shapes {sorted(want)}")
    # per_shard's contraction takes the bf16 operands and its (B, M)
    # factors as they are: no f32 fold before it
    per_step = expected_launches("per_shard", get_config("qwen3-4b"))
    if shard_dtypes != ["torch.bfloat16"] * per_step["clip_reduce"]:
        raise RuntimeError(f"per_shard's first step: clip_reduce inputs "
                           f"{shard_dtypes}, expected "
                           f"{per_step['clip_reduce']} bfloat16 calls")
    emit({"phase": "per_shard_contraction", "gpu": gpu,
          "clip_reduce_calls": len(shard_dtypes), "dtypes":
              sorted(set(shard_dtypes)),
          "blocked": {k: {"a": list(v[0].shape), "g": list(v[1].shape),
                          "factors": list(v[2][0].shape), "axis": v[2][1]}
                      for k, v in blk_caps.items()}})
    return launches, caps, gnb_caps, sc_caps, blk_caps


def rel_err(err, want) -> float:
    """An absolute error relative to the largest magnitude of the plain
    result, the scale the checks' atol takes."""
    return err / max(float(want.abs().max()), 1e-30)


def sum_check(torch, got, want):
    """(max abs error, it relative to the largest magnitude, within
    tolerance) of a kernel against its plain version."""
    err = float((got - want).abs().max())
    atol = SUM_ATOL_FRAC * float(want.abs().max())
    return (err, rel_err(err, want),
            bool(torch.allclose(got, want, rtol=SUM_RTOL, atol=atol)))


def sum_bound(kernel, a, g, bw, num_blocks=1):
    """(bound ms, bound_by): the inputs read once and the f32 output
    written once against the data-sheet bandwidth, and the operations on
    the inputs' type: B T² (din + dout) for ghost_norm and
    ghost_norm_blocked (the symmetric half of the grams; the blocked grams
    cover the blocked operand once), 2 B T din dout for clip_reduce (its
    factors (B, num_blocks)), 2 S B T din dout for scale_contract."""
    din, dout = a.shape[-1], g.shape[-1]
    rows = a.numel() // din  # B T, times S for scale_contract
    nbytes = a.numel() * a.element_size() + g.numel() * g.element_size()
    if kernel in ("ghost_norm", "ghost_norm_blocked"):
        b, t = a.shape[0], a.shape[1]
        nbytes += 4 * b * num_blocks
        ops = b * t * t * (din + dout)
    else:
        s = rows // (a.shape[-2] * a.shape[-3])  # stack slices (1 if 3-D)
        nbytes += 4 * (rows // a.shape[-2]) * num_blocks + 4 * s * din * dout
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
    factor on g's rows for clip_reduce (with (B, M) block factors, f =
    (factors, axis): the f32 fold into the blocked operand, then one f32
    matmul), one f32 bmm over the stack for scale_contract."""
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
    if isinstance(f, tuple):
        from repro_torch.core.ghost import fold_block_factors
        a32, g32 = fold_block_factors(a, g, *f)
        return a32.reshape(-1, a.shape[-1]).T @ g32.reshape(-1, g.shape[-1])
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


def train_impls():
    """name -> (kernel wrapper, plain version) of the training kernels but
    fused_norm_clip; ghost_norm_blocked's third argument is (M, block
    axis) where the others take factors, clip_reduce's factors or
    ((B, M) factors, block axis)."""
    from repro_torch.kernels import bk as SC
    from repro_torch.kernels import clip_reduce as CR
    from repro_torch.kernels import ghost_norm as GN
    return {"ghost_norm": (lambda a, g, f: GN.ghost_norm(a, g),
                           lambda a, g, f: GN.ghost_norm_ref(a, g)),
            "ghost_norm_blocked": (
                lambda a, g, f: GN.ghost_norm_blocked(a, g, f[0],
                                                      block_axis=f[1]),
                lambda a, g, f: GN.ghost_norm_blocked_ref(a, g, *f)),
            "clip_reduce": (
                lambda a, g, f: CR.clip_reduce(a, g, *_pair(f)),
                lambda a, g, f: CR.clip_reduce_ref(a, g, *_pair(f))),
            "scale_contract": (SC.scale_contract, SC.scale_contract_ref)}


def _pair(f):
    """(factors, block axis) of clip_reduce's third argument."""
    return f if isinstance(f, tuple) else (f, "out")


SHAPE_KEYS = ("ms", "plain_ms", "bound_ms", "library_ms")


def launch_split(torch, fn, calls=5) -> dict:
    """Where a call of `fn` spends its device time, by kernel
    (torch.profiler, CUDA activity, the L2 warm): the mean ms per
    recorded launch and the launches recorded over `calls` calls. The
    mean is per launch, not per call: the profiler may drop some of a
    run's events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: {"ms": e.self_device_time_total / 1e3 / e.count,
                         "launches": e.count}
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}


def graph_nodes(torch, fn) -> list:
    """The node types (CUgraphNodeType, 0 = kernel) of a CUDA graph that
    captures one call of `fn`, read through the driver: the device work
    of a call, which torch.profiler can drop in a long process."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds.append(kind.value)
    return kinds


def f64_norms(torch, name, a, g, f):
    """The ghost norms by the gram identity in float64: (B,) for
    ghost_norm, (B, M) for ghost_norm_blocked (f = (M, axis))."""
    a64, g64 = a.double(), g.double()
    if name == "ghost_norm":
        return (torch.bmm(a64, a64.transpose(1, 2))
                * torch.bmm(g64, g64.transpose(1, 2))).sum((1, 2))
    m, axis = f
    s, x = (a64, g64) if axis == "out" else (g64, a64)
    b, t = s.shape[0], s.shape[1]
    xb = x.reshape(b, t, m, -1).transpose(1, 2)  # (B, M, T, w)
    gram_s = torch.bmm(s, s.transpose(1, 2))
    return (torch.matmul(xb, xb.transpose(2, 3)) * gram_s[:, None]).sum(
        (2, 3))


def f64_errors(torch, name, kern, plain, a, g, f) -> dict:
    """Largest relative error of the kernel and of the f32 plain version
    against the float64 evaluation, and the kernel's mean signed relative
    error (a bias shows there)."""
    want = f64_norms(torch, name, a, g, f)
    got, ref32 = kern(a, g, f).double(), plain(a, g, f).double()
    den = want.abs().clamp_min(torch.finfo(torch.float64).tiny)
    return {"f64_rel_err": float(((got - want).abs() / den).max()),
            "f64_signed_rel_err": float(((got - want) / den).mean()),
            "plain_f64_rel_err": float(((ref32 - want).abs() / den).max())}


def step_keys(name) -> tuple:
    """The times a kernel's main-shape rows carry."""
    return SHAPE_KEYS + (("graph_ms",) if name in GRAPHED else ())


def main_shape_row(torch, gpu, name, lname, a, g, f, calls, bw, flush,
                   **extra) -> dict:
    """One kernel at one captured main-path input against its plain
    version (the sweep's tolerances), then kernel, plain, bound and
    library ms per call; emits the kernel_main_shapes line and returns
    it. Raises on a disagreement."""
    kern, plain = train_impls()[name]
    got, want = kern(a, g, f), plain(a, g, f)
    lib = library_sum(torch, name, a, g, f)
    torch.cuda.synchronize()
    err, rel, ok = sum_check(torch, got, want)
    lib_err = float((lib - want).abs().max())
    del lib, want
    if not ok:
        raise RuntimeError(f"{name} disagrees at the main path's {lname} "
                           f"shapes {extra}: max abs err {err}")
    if name in BITWISE:
        extra["bitwise_repeat"] = bool(torch.equal(got, kern(a, g, f)))
        if not extra["bitwise_repeat"]:
            raise RuntimeError(f"{name}: two calls at the main path's "
                               f"{lname} shapes differ")
    del got
    if name == "scale_contract":  # the stacked calls run for hundreds of ms
        iters, warm = 3, 1
    else:
        iters, warm = (5, 2) if lname == "head" else (20, 2)
    times = {
        "ms": cuda_ms(torch, lambda: kern(a, g, f), iters, warm, flush),
        "plain_ms": cuda_ms(torch, lambda: plain(a, g, f), iters, warm,
                            flush),
        "library_ms": cuda_ms(torch, lambda: library_sum(
            torch, name, a, g, f), iters, warm, flush)}
    if name in GRAPHED:
        times["graph_ms"] = graph_ms(torch, lambda: kern(a, g, f), iters,
                                     flush)
        extra["launch_ms"] = launch_split(torch, lambda: kern(a, g, f))
        extra.update(f64_errors(torch, name, kern, plain, a, g, f))
    blocks = (f[0] if name == "ghost_norm_blocked" else
              f[0].shape[1] if isinstance(f, tuple) else 1)
    times["bound_ms"], bound_by = sum_bound(name, a, g, bw, blocks)
    row = {"phase": "kernel_main_shapes", "gpu": gpu, "kernel": name,
           **extra, "linear": lname, "a": list(a.shape), "g": list(g.shape),
           **({"factors": list(f[0].shape), "axis": f[1]}
              if name == "clip_reduce" and isinstance(f, tuple) else {}),
           "dtype": str(a.dtype), "calls_per_step": calls,
           "max_abs_err": err, "max_rel_err": rel,
           "library_max_abs_err": lib_err,
           "tol": {"rtol": SUM_RTOL, "atol_of_max": SUM_ATOL_FRAC},
           "timing_iters": iters, **times, "bound_by": bound_by}
    emit(row)
    return row


def phase_train_kernels(torch, gpu, caps, gnb_caps, sc_caps, blk_caps,
                        num_layers):
    """The training kernels against their plain versions: the sweeps (two
    calls of each contraction bitwise equal at every point), then the
    captured main-path shapes with kernel, plain, bound and library times
    summed over one step's calls; clip_reduce's blocked calls of a
    per_shard step under its "per_shard" key."""
    bw = bandwidth(gpu)
    impl = train_impls()
    worst = dict.fromkeys(impl, 0.0)
    worst_rel = dict.fromkeys(impl, 0.0)

    def check(name, a, g, f, point, dtype):
        kern, plain = impl[name]
        got, want = kern(a, g, f), plain(a, g, f)
        torch.cuda.synchronize()
        err, rel, ok = sum_check(torch, got, want)
        worst[name] = max(worst[name], err)
        worst_rel[name] = max(worst_rel[name], rel)
        same = bool(torch.equal(got, kern(a, g, f))) \
            if name in BITWISE else None
        emit({"phase": "kernel_vs_plain", "kernel": name, "shape": point,
              "dtype": dtype, "max_abs_err": err, "max_rel_err": rel,
              "tol": {"rtol": SUM_RTOL, "atol_of_max": SUM_ATOL_FRAC},
              "ok": ok, "bitwise_repeat": same})
        if not ok:
            raise RuntimeError(f"{name} disagrees at {point} {dtype}: max "
                               f"abs err {err}")
        if same is False:
            raise RuntimeError(f"{name}: two calls at {point} {dtype} "
                               f"differ")

    for i, (b, t, din, dout) in enumerate(SUM_SWEEP):
        for dtype in ("float32", "bfloat16"):
            points = [(n, None) for n in ("ghost_norm", "clip_reduce")] + [
                ("scale_contract", s) for s in SC_STACKS]
            for name, stack in points:
                a, g, f = sweep_sum_inputs(torch, name, b, t, din, dout,
                                           dtype, stack, seed=i)
                check(name, a, g, f, {"s": stack, "b": b, "t": t,
                                      "din": din, "dout": dout}, dtype)
    for i, (b, t, din, dout) in enumerate(LONG_SWEEP):
        for dtype in ("float32", "bfloat16"):
            a, g, _ = sweep_sum_inputs(torch, "clip_reduce", b, t, din,
                                       dout, dtype, None, seed=300 + i)
            f = torch.tensor(SUM_FACTORS[::-1][:b], device="cuda")
            for name in ("ghost_norm", "clip_reduce"):
                check(name, a, g, f, {"b": b, "t": t, "din": din,
                                      "dout": dout}, dtype)
            del a, g, f
    for i, (b, t, din, dout, m, axis) in enumerate(BLOCKED_SWEEP):
        for dtype in ("float32", "bfloat16"):
            a, g, _ = sweep_sum_inputs(torch, "ghost_norm_blocked", b, t,
                                       din, dout, dtype, None, seed=100 + i)
            check("ghost_norm_blocked", a, g, (m, axis),
                  {"b": b, "t": t, "din": din, "dout": dout, "m": m,
                   "axis": axis}, dtype)
    for i, (b, t, din, dout, m, axis) in enumerate(BLOCK_FACTOR_SWEEP):
        for dtype in ("float32", "bfloat16"):
            a, g, _ = sweep_sum_inputs(torch, "clip_reduce", b, t, din,
                                       dout, dtype, None, seed=200 + i)
            f = torch.tensor(np.resize(SUM_FACTORS, (b, m)),
                             dtype=torch.float32, device="cuda")
            check("clip_reduce", a, g, (f, axis),
                  {"b": b, "t": t, "din": din, "dout": dout, "m": m,
                   "axis": axis}, dtype)

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    per_step = {name: dict.fromkeys(step_keys(name), 0.0) for name in impl}
    by = {name: {"bytes": 0.0, "operations": 0.0} for name in impl}
    work = [(lname, name, caps[lname], 1 if lname == "head" else num_layers)
            for lname in caps for name in ("ghost_norm", "clip_reduce")]
    # one scale_contract call per linear leaf and step
    work += [(lname, "scale_contract", sc_caps[lname], 1)
             for lname in sc_caps]
    work += [(lname, "ghost_norm_blocked", gnb_caps[lname], num_layers)
             for lname in gnb_caps]
    for lname, name, (a, g, f), calls in work:
        row = main_shape_row(torch, gpu, name, lname, a, g, f, calls, bw,
                             flush)
        worst[name] = max(worst[name], row["max_abs_err"])
        worst_rel[name] = max(worst_rel[name], row["max_rel_err"])
        for k in per_step[name]:
            per_step[name][k] += calls * row[k]
        by[name][row["bound_by"]] += calls * row["bound_ms"]
    shard = {**dict.fromkeys(SHAPE_KEYS, 0.0), "calls": 0, "shapes": []}
    for lname, (a, g, (f, axis)) in blk_caps.items():
        row = main_shape_row(torch, gpu, "clip_reduce", lname, a.cuda(),
                             g.cuda(), (f.cuda(), axis), num_layers, bw,
                             flush, variant="per_shard")
        worst["clip_reduce"] = max(worst["clip_reduce"], row["max_abs_err"])
        worst_rel["clip_reduce"] = max(worst_rel["clip_reduce"],
                                       row["max_rel_err"])
        for k in SHAPE_KEYS:
            shard[k] += num_layers * row[k]
        shard["calls"] += num_layers
        shard["shapes"].append({k: row[k] for k in (
            "linear", "a", "g", "factors", "axis", "calls_per_step",
            "max_abs_err", "max_rel_err", *SHAPE_KEYS, "bound_by")})
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
             "max_rel_err": worst_rel[name],
             **per_step[name],
             "bound_by": max(by[name], key=by[name].get),
             "per": f"one qwen3-4b training step: the sum over its "
                    f"{per[name]}",
             **({"per_shard": {**shard, "per": "the blocked calls (M = 16) "
                               "of one per_shard step"}}
                if name == "clip_reduce" else {})}
            for name in impl]


def phase_train_cuda_vs_cpu(torch, gpu):
    import dataclasses

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.core.clipping import dp_clipped_gradients
    from repro_torch.core.dp_sgd import clipped_microbatches
    from repro_torch.kernels import backend, launch_counts, reset_launch_counts
    from repro_torch.kernels import fused_clip as FC
    from repro_torch.launch.sharding import group_shard_assignment
    from repro_torch.models.transformer import build_model

    cfg = get_config("qwen3-4b", reduced=True)
    moe_cfg = get_config("granite-moe-3b-a800m", reduced=True)
    b, t = 4, 64
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    targets[:, -1] = -1
    trees, layouts = {}, {}
    for c in (cfg, moe_cfg):
        spec_model = build_model(c, device="cpu")
        trees[c.name] = bridge.numpy_params(spec_model.spec, seed=0)
        layouts[c.name] = spec_model.layout
    layout = layouts[cfg.name]
    thr = rng.uniform(0.05, 2.0, layout.num_groups).astype(np.float32)
    assign = np.asarray(group_shard_assignment(layout, 2), np.int64)
    group_thr = rng.uniform(0.2, 1.0, 2).astype(np.float32)
    # per_shard: the same weights (blocks split only the groups) clipped
    # per_layer over M = 4 column blocks of qkv and o
    shard_cfg = dataclasses.replace(cfg, dp_blocks=4)
    shard_thr = rng.uniform(0.05, 2.0, build_model(
        shard_cfg, device="cpu").layout.num_groups).astype(np.float32)
    moe_thr = rng.uniform(0.05, 2.0, layouts[moe_cfg.name].num_groups
                          ).astype(np.float32)
    # (label, mode, execution, config, fused route, microbatches, kwargs
    # of numpy arrays): per_layer on qwen3-4b-reduced by both routes
    # (every linear there is within the fused route's rule; the composed
    # one runs with the rule patched off) and in 2 microbatches (the
    # accumulation), naive_flat (one backward per example), and per_layer
    # on the MoE config
    cases = [("per_layer", "per_layer", "bk", cfg, True, 1,
              {"thresholds": thr}),
             ("per_layer_composed", "per_layer", "bk", cfg, False, 1,
              {"thresholds": thr}),
             ("per_layer_mb2", "per_layer", "bk", cfg, True, 2,
              {"thresholds": thr}),
             ("naive_flat", "naive_flat", "bk", cfg, True, 1,
              {"flat_threshold": np.float32(0.5)}),
             ("ghost_flat", "ghost_flat", "bk", cfg, True, 1,
              {"flat_threshold": np.float32(0.5)}),
             ("per_group", "per_group", "bk", cfg, True, 1,
              {"group_assignment": assign, "group_thresholds": group_thr}),
             ("per_shard", "per_layer", "bk", shard_cfg, True, 1,
              {"thresholds": shard_thr}),
             ("moe_per_layer", "per_layer", "bk", moe_cfg, True, 1,
              {"thresholds": moe_thr})]
    counted = TRAIN_KERNELS

    def run(mode, execution, cfg, fused, nmb, dev, kw):
        model = build_model(cfg, device=dev)
        params = bridge.train_params_from_numpy(trees[cfg.name], dev)
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "targets": torch.from_numpy(targets).to(dev)}
        kw = {k: torch.as_tensor(v, device=dev) for k, v in kw.items()}
        reset_launch_counts()
        real_fits = FC.fits
        if not fused:
            FC.fits = lambda din, dout: False
        try:
            with backend.scoped("kernels"), warnings.catch_warnings():
                # a BK fallback fails the phase
                warnings.filterwarnings("error", message="BK capture cannot")
                res = clipped_microbatches(
                    lambda mb, n: dp_clipped_gradients(
                        model.loss_fn, params, mb, model.layout, mode=mode,
                        batch_size=n, execution=execution, **kw),
                    batch, b, nmb)
        finally:
            FC.fits = real_fits
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

    for label, mode, execution, case_cfg, fused, nmb, kw in cases:
        got, cuda_counts = run(mode, execution, case_cfg, fused, nmb, "cuda",
                               kw)
        want, cpu_counts = run(mode, execution, case_cfg, fused, nmb, "cpu",
                               kw)
        # one clip is one step: the card launches exactly the kernels of
        # the route, the CPU none
        kind = f"{label}_bk" if mode in ("ghost_flat", "per_group") else label
        expected = expected_launches(kind, case_cfg, fused, batch=b,
                                     microbatches=nmb)
        if cuda_counts != expected or any(cpu_counts.values()):
            raise RuntimeError(
                f"{label}: launches cuda={cuda_counts} cpu={cpu_counts}, "
                f"expected cuda={expected} and none on the CPU")
        checks = compare(got, want)
        twopass = {}
        if mode in ("ghost_flat", "per_group"):  # bk against twopass
            tp, _ = run(mode, "twopass", case_cfg, fused, nmb, "cuda", kw)
            twopass = compare(got, tp)
        bad = {k: v[0] for k, v in {**checks, **{
            "twopass:" + k: v for k, v in twopass.items()}}.items()
            if not v[1]}
        n = want.norms_sq
        out = {"phase": "train_cuda_vs_cpu", "gpu": gpu,
               "arch": case_cfg.name, "variant": label, "mode": mode,
               "execution": execution, "fused_route": fused,
               "microbatches": nmb,
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


# ---------------------------------------------------------------------------
# Phases 8-9: MoE training and the fused kernel.
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-3b-a800m"
# launches per step (the table in the doc): 65 linears outside the fused
# route's rule (qkv and o of 32 layers, the head) and 32 routers within it
MOE_LAUNCHES = {
    "per_layer": {"fused_norm_clip": 32, "ghost_norm": 65,
                  "clip_reduce": 65, "ghost_norm_blocked": 0,
                  "scale_contract": 0},
    "non_private": {"fused_norm_clip": 0, "ghost_norm": 0,
                    "clip_reduce": 97, "ghost_norm_blocked": 0,
                    "scale_contract": 0}}
# fused_norm_clip's sweep: B, T, din, dout (T = 1, T past one 256-row
# chunk, din and dout off the 64-wide tiles both ways, the fit rule's
# limit, a small ragged case, DP-scale batches: B = 1024 at the limit and
# B = 16,384 past the first kernel's limit of 12,288)
FUSED_SWEEP = [(1, 1, 64, 4096), (3, 200, 1000, 40), (8, 300, 40, 1000),
               (8, 256, 1024, 1024), (3, 37, 20, 45), (1024, 8, 1024, 1024),
               (16384, 1, 64, 40)]
# DP-scale batches timed beside the composed route (bf16): the router at
# B = 64 and 1024 (what microbatches bring it), the sweep's two above
FUSED_DP_SCALE = [(64, 256, 1536, 40), (1024, 256, 1536, 40),
                  (1024, 8, 1024, 1024), (16384, 1, 64, 40)]
MB = 1 << 20  # the allocator's slack on a call's extra memory
# the granite linears that run ghost_norm and clip_reduce (per_layer) or
# clip_reduce alone (non_private) at shapes no qwen3-4b linear has
MOE_COMPOSED = {"per_layer": ("qkv", "o", "head"),
                "non_private": ("router",)}
FUSED_THRESHOLDS = {"inf": [math.inf], "positive": [0.5, 0.01],
                    "negative": [-0.7, -2.0],
                    "mixed": [0.5, math.inf, -0.7, 0.01]}


def phase_moe_train(torch, gpu, step_ms):
    """Records each variant's ms per step in `step_ms`. Returns (launches
    by kernel over both variants' counted steps, the
    router's fused_norm_clip inputs (a, g, c, extra) from per_layer's
    first step, the clip_reduce inputs (a, g, factors) by linear at the
    shapes qwen3-4b never gives ghost_norm and clip_reduce: qkv, o and the
    head from per_layer's first step, the router from non_private's)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import clip_reduce as CR
    from repro_torch.kernels import fused_clip as FC
    cfg = get_config(MOE_ARCH)
    for label, want in MOE_LAUNCHES.items():
        if expected_launches(label, cfg) != want:
            raise RuntimeError(f"{label}: the route rule expects "
                               f"{expected_launches(label, cfg)}, the "
                               f"table {want}")
    real, real_cr = FC.fused_norm_clip, CR.clip_reduce
    shapes = linear_shapes(cfg)
    cap, cr_caps = [], {}

    def recording(a, g, c, extra=None):
        if not cap:
            cap.append(tuple(None if x is None else x.clone()
                             for x in (a, g, c, extra)))
        return real(a, g, c, extra)

    def recording_cr(names):
        def rec(a, g, factors, block_axis="out"):
            name = shapes.get((a.shape[-1], g.shape[-1]))
            if name in names and name not in cr_caps:
                cr_caps[name] = (a.clone(), g.clone(), factors.clone())
            return real_cr(a, g, factors, block_axis)
        return rec

    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    patches = {"per_layer": [(0, FC, "fused_norm_clip", recording),
                             (0, CR, "clip_reduce",
                              recording_cr(MOE_COMPOSED["per_layer"]))],
               "non_private": [(0, CR, "clip_reduce",
                                recording_cr(MOE_COMPOSED["non_private"]))]}
    for label in MOE_LAUNCHES:
        counts = train_variant(torch, gpu, label,
                               train_args(label, arch=MOE_ARCH), step_ms,
                               patches[label])
        for k in launches:
            launches[k] += counts[k]
    emit({"phase": "moe_train_ratio", "gpu": gpu, "arch": cfg.name,
          "ms_per_step": step_ms,
          "ratio_vs_nonprivate":
              step_ms["per_layer"] / step_ms["non_private"]})
    if not cap:
        raise RuntimeError("per_layer never launched fused_norm_clip")
    want = sorted(n for names in MOE_COMPOSED.values() for n in names)
    if sorted(cr_caps) != want:
        raise RuntimeError(f"clip_reduce: captured {sorted(cr_caps)} of "
                           f"the {MOE_ARCH} linears {want}")
    return launches, cap[0], cr_caps


def captured_rows(torch, gpu, caps, num_layers, variants, repeats=1,
                  **tags):
    """ghost_norm and clip_reduce against their plain versions at inputs a
    training path gave them (phase 6's tolerances and timing): `caps`
    maps a linear to its captured (a, g, factors), on the card or the
    host; `variants` maps a variant to (its linears, the kernels they
    ran); each linear runs once a layer (the head once) times `repeats`
    a step (naive_flat: one backward per example). Returns name -> a
    kernels-line entry: the worst error, the kernel, plain, bound and
    library ms summed over each variant's step, and the per-call rows."""
    bw = bandwidth(gpu)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = {}
    for variant, (lnames, kernels) in variants.items():
        for lname in lnames:
            a, g, f = (x.cuda() for x in caps[lname])
            calls = repeats * (1 if lname == "head" else num_layers)
            for name in kernels:
                row = main_shape_row(torch, gpu, name, lname, a, g, f, calls,
                                     bw, flush, variant=variant, **tags)
                o = out.setdefault(name, {"max_abs_err": 0.0,
                                          "max_rel_err": 0.0,
                                          "per_step": {}, "shapes": []})
                o["max_abs_err"] = max(o["max_abs_err"], row["max_abs_err"])
                o["max_rel_err"] = max(o["max_rel_err"], row["max_rel_err"])
                step = o["per_step"].setdefault(
                    variant, {**dict.fromkeys(step_keys(name), 0.0),
                              "calls": 0})
                for k in step_keys(name):
                    step[k] += calls * row[k]
                step["calls"] += calls
                o["shapes"].append({k: row[k] for k in (
                    "variant", "linear", "a", "g", "calls_per_step",
                    "max_abs_err", "max_rel_err",
                    *step_keys(name), "bound_by")})
            del a, g, f
    return out


def fused_inputs(torch, b, t, din, dout, dtype, thresholds, seed):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    a = torch.from_numpy(rng.standard_normal((b, t, din)).astype(
        np.float32)).to("cuda", dt)
    g = torch.from_numpy(rng.standard_normal((b, t, dout)).astype(
        np.float32)).to("cuda", dt)
    c = torch.tensor(np.resize(FUSED_THRESHOLDS[thresholds], b),
                     dtype=torch.float32, device="cuda")
    extra = torch.from_numpy(rng.uniform(0.0, 1.0, b).astype(
        np.float32)).cuda()
    return a, g, c, extra


def fused_bound(a, g, extra, bw):
    """(bound ms, bound_by): a, g, c (and extra) read once, n and the f32
    dW written once; 2 B T din dout operations on the inputs' type."""
    b, t, din = a.shape
    dout = g.shape[-1]
    nbytes = (a.numel() * a.element_size() + g.numel() * g.element_size()
              + 4 * b * (2 if extra is None else 3) + 4 * din * dout)
    t_bytes = nbytes / bw
    t_ops = 2 * b * t * din * dout / PEAK_OPS[str(a.dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fused_library(torch, a, g, c, extra):
    """Yardstick, never called by the port: the per-example gradients as
    one f32 bmm, their norms², the factors, the weighted sum."""
    from repro_torch.core.ghost import clip_factor
    w = torch.bmm(a.float().transpose(1, 2), g.float())
    n = w.square().sum((1, 2))
    f = clip_factor(c, n if extra is None else n + extra)
    return n, torch.einsum("b,bio->io", f, w)


def fused_composed(a, g, c, extra):
    """What the fused route replaces: the ghost_norm and clip_reduce
    kernels with the factor between them."""
    from repro_torch.core.ghost import clip_factor
    from repro_torch.kernels import clip_reduce as CR
    from repro_torch.kernels import ghost_norm as GN
    n = GN.ghost_norm(a, g)
    f = clip_factor(c, n if extra is None else n + extra)
    return n, CR.clip_reduce(a, g, f)


def f64_fused(torch, a, g, c, extra):
    """fused_norm_clip in float64: the per-example gradients, their
    norms², the factors (as core.ghost.clip_factor), the weighted sum."""
    w = torch.bmm(a.double().transpose(1, 2), g.double())
    n = w.square().sum((1, 2))
    c64 = c.double()
    total = n if extra is None else n + extra.double()
    clipped = torch.clamp(c64 * torch.rsqrt(total + 1e-12), max=1.0)
    f = torch.where(c64 < 0, -c64,
                    torch.where(torch.isinf(c64), torch.ones_like(c64),
                                clipped))
    return n, torch.einsum("b,bio->io", f, w)


def fused_f64_errors(torch, kern, plain, want) -> dict:
    """Relative errors of the kernel's and the plain version's (n, dW)
    against float64: n elementwise, dW relative to its largest
    magnitude."""
    def errs(got):
        n, dw = (x.double() for x in got)
        den = want[0].abs().clamp_min(torch.finfo(torch.float64).tiny)
        return {"n": float(((n - want[0]).abs() / den).max()),
                "dw": rel_err(float((dw - want[1]).abs().max()), want[1])}
    return {"f64_rel_err": errs(kern), "plain_f64_rel_err": errs(plain)}


def phase_fused_kernel(torch, gpu, router):
    """fused_norm_clip against its plain version: the sweep (each point's
    extra memory within the plan's scratch, two calls bitwise equal),
    DP-scale batches beside the composed route, then the router's captured
    inputs: one device kernel a call, errors against float64, kernel,
    plain, bound, library and composed-kernels times (per call, and per
    step over its 32 calls)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_clip as FC
    bw = bandwidth(gpu)
    worst = worst_rel = 0.0

    def check(a, g, c, extra, point):
        nonlocal worst, worst_rel
        b, t, din = a.shape
        dout = g.shape[-1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = FC.fused_norm_clip(a, g, c, extra)
        torch.cuda.synchronize()
        extra_mem = (torch.cuda.max_memory_allocated() - before
                     - 4 * (b + din * dout))
        again = FC.fused_norm_clip(a, g, c, extra)
        want = FC.fused_norm_clip_ref(a, g, c, extra)
        torch.cuda.synchronize()
        errs = [sum_check(torch, x, w) for x, w in zip(got, want)]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        bitwise = all(bool(torch.equal(x, y)) for x, y in zip(got, again))
        scratch = 4 * FC.plan(b, t, din, dout, a.dtype,
                              FC.sm_count(a.device)).scratch
        ok = all(e[2] for e in errs)
        emit({"phase": "kernel_vs_plain", "kernel": "fused_norm_clip",
              "shape": point, "dtype": str(a.dtype),
              "max_abs_err": {"n": errs[0][0], "dw": errs[1][0]},
              "max_rel_err": {"n": errs[0][1], "dw": errs[1][1]},
              "tol": {"rtol": SUM_RTOL, "atol_of_max": SUM_ATOL_FRAC},
              "ok": ok, "bitwise_repeat": bitwise,
              "extra_mem_bytes": extra_mem, "scratch_bytes": scratch})
        if not ok:
            raise RuntimeError(f"fused_norm_clip disagrees at {point} "
                               f"{a.dtype}: max abs err {errs}")
        if not bitwise:
            raise RuntimeError(f"fused_norm_clip: two calls at {point} "
                               f"{a.dtype} differ")
        if extra_mem > scratch + MB:
            raise RuntimeError(f"fused_norm_clip at {point} {a.dtype} held "
                               f"{extra_mem} bytes past its outputs, more "
                               f"than its plan's {scratch} of scratch")
        return err, rel, extra_mem

    for i, (b, t, din, dout) in enumerate(FUSED_SWEEP):
        for dtype in ("float32", "bfloat16"):
            for thresholds in FUSED_THRESHOLDS:
                a, g, c, extra = fused_inputs(torch, b, t, din, dout, dtype,
                                              thresholds, seed=200 + i)
                for e in (None, extra):
                    check(a, g, c, e, {"b": b, "t": t, "din": din,
                                       "dout": dout, "c": thresholds,
                                       "extra": e is not None})
                del a, g, c, extra

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dp_scale = []
    for i, (b, t, din, dout) in enumerate(FUSED_DP_SCALE):
        a, g, c, extra = fused_inputs(torch, b, t, din, dout, "bfloat16",
                                      "mixed", seed=300 + i)
        point = {"b": b, "t": t, "din": din, "dout": dout}
        _, _, extra_mem = check(a, g, c, extra, point)
        row = {"phase": "kernel_dp_scale", "gpu": gpu,
               "kernel": "fused_norm_clip", **point, "dtype": "bfloat16",
               "plan": FC.plan(b, t, din, dout, a.dtype,
                               FC.sm_count(a.device))._asdict(),
               "extra_mem_bytes": extra_mem,
               "graph_ms": graph_ms(torch, lambda: FC.fused_norm_clip(
                   a, g, c, extra), iters=10, flush=flush),
               "composed_graph_ms": graph_ms(torch, lambda: fused_composed(
                   a, g, c, extra), iters=10, flush=flush),
               "bound_ms": fused_bound(a, g, extra, bw)[0]}
        emit(row)
        dp_scale.append({k: v for k, v in row.items()
                         if k not in ("phase", "gpu", "kernel")})
        del a, g, c, extra

    a, g, c, extra = router
    err, rel, extra_mem = check(a, g, c, extra,
                                {"router": list(a.shape) + [g.shape[-1]]})
    lib_n, lib_dw = fused_library(torch, a, g, c, extra)
    want_n, want_dw = FC.fused_norm_clip_ref(a, g, c, extra)
    lib_err = max(float((lib_n - want_n).abs().max()),
                  float((lib_dw - want_dw).abs().max()))
    f64 = fused_f64_errors(torch, FC.fused_norm_clip(a, g, c, extra),
                           (want_n, want_dw), f64_fused(torch, a, g, c,
                                                        extra))
    del lib_n, lib_dw, want_n, want_dw
    fns = {"ms": lambda: FC.fused_norm_clip(a, g, c, extra),
           "plain_ms": lambda: FC.fused_norm_clip_ref(a, g, c, extra),
           "library_ms": lambda: fused_library(torch, a, g, c, extra),
           "composed_ms": lambda: fused_composed(a, g, c, extra)}
    # device times from graph replays; eager times (host launch overhead
    # included) beside them
    times = {k: graph_ms(torch, fn, flush=flush) for k, fn in fns.items()}
    eager = {k: cuda_ms(torch, fn, flush=flush) for k, fn in fns.items()}
    times["bound_ms"], bound_by = fused_bound(a, g, extra, bw)
    # the device work of a call: the nodes of a captured call (one kernel,
    # nothing else), and the kernels' ms by torch.profiler (the L2 warm),
    # which may drop events in this long process but must not show two
    nodes = graph_nodes(torch, fns["ms"])
    launch = launch_split(torch, fns["ms"])
    if nodes != [0] or len(launch) > 1:
        raise RuntimeError(f"fused_norm_clip: a call ran graph nodes "
                           f"{nodes} (profiler: {sorted(launch)}), not one "
                           f"kernel")
    calls = get_config(MOE_ARCH).num_layers  # one router per layer
    emit({"phase": "kernel_main_shapes", "gpu": gpu,
          "kernel": "fused_norm_clip", "linear": "router",
          "a": list(a.shape), "g": list(g.shape), "dtype": str(a.dtype),
          "extra": extra is not None, "calls_per_step": calls,
          "plan": FC.plan(*a.shape, g.shape[-1], a.dtype,
                          FC.sm_count(a.device))._asdict(),
          "max_abs_err": err, "max_rel_err": rel,
          "library_max_abs_err": lib_err, **f64,
          "tol": {"rtol": SUM_RTOL, "atol_of_max": SUM_ATOL_FRAC},
          **times, "bound_by": bound_by, "timing": "CUDA graph replay",
          "eager": eager, "graph_nodes": nodes, "launch_ms": launch,
          "extra_mem_bytes": extra_mem})
    return {"name": "fused_norm_clip", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_norm_clip.cu",
            "replaces": "src/repro/kernels/fused_clip.py:94",
            "max_abs_err": worst, "max_rel_err": worst_rel,
            **{k: calls * v for k, v in times.items()},
            "bound_by": bound_by,
            "eager_ms": calls * eager["ms"],
            "per": f"one {MOE_ARCH} training step: the sum over its {calls} "
                   f"calls at the captured router shape (CUDA graph replay; "
                   f"eager_ms the same calls eagerly)",
            "dp_scale": dp_scale}


# ---------------------------------------------------------------------------
# Phase 11: the rest of single-device training at full width.
# ---------------------------------------------------------------------------

# (label, arch, --clipping, B, T, --microbatches, --docs): naive_flat as
# the seventh Figure-1 variant in the fewest microbatches whose
# per-example gradients (8.8 GB each) fit beside the f32 accumulator, a
# DP-scale batch of 64 on both models, and qwen3-4b at T = 4096 (every
# layer's attention on the blocked branch); --docs keeps the sampling
# rate B / N at phase 5's 1/16, so sigma and the count noise are those of
# the B = 8 runs. None is profiled: the profiler's post-processing of a
# step of 120,000-134,000 device ops takes about two minutes.
SCALE_PATHS = [
    ("naive_flat", "qwen3-4b", "naive_flat", 8, 256, 4, 64),
    ("per_layer_b64", "qwen3-4b", "per_layer", 64, 256, 8, 512),
    ("moe_per_layer_b64", MOE_ARCH, "per_layer", 64, 256, 8, 512),
    ("per_layer_t4096", "qwen3-4b", "per_layer", 2, 4096, 1, 16),
]
# the qwen3-4b paths whose clip_reduce inputs no earlier phase checks:
# naive_flat's (B = 2 a call, factor 1, one example's rows zero) and
# T = 4096's; the B = 64 paths' microbatches of 8 give phases 6 and 10's
# B = 8 shapes
CAPTURED_PATHS = ("naive_flat", "per_layer_t4096")


def phase_scale_train(torch, gpu, qwen_ms, moe_ms):
    """Each of SCALE_PATHS through the CLI's `Trainer` (train_variant: the
    launches per step of its mode at its batch and microbatches; ratios
    and ms per example against the B = 8 runs of phases 5 and 8, whose ms
    per step `qwen_ms` and `moe_ms` hold and which take each path's ms
    per step under its label). Returns (launches by kernel over every
    path's counted steps, path label -> the clip_reduce inputs at each
    linear shape of its first step, on the host, for naive_flat and the
    T = 4096 path)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import clip_reduce as CR
    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    caps, real_cr = {}, CR.clip_reduce
    shapes = linear_shapes(get_config("qwen3-4b"))

    def recording_cr(path):
        def rec(a, g, factors, block_axis="out"):
            name = shapes.get((a.shape[-1], g.shape[-1]))
            if name is not None and name not in caps[path]:
                # on the host: the path's peak stays its own
                caps[path][name] = (a.cpu(), g.cpu(), factors.cpu())
            return real_cr(a, g, factors, block_axis)
        return rec

    for label, arch, mode, batch, seq, nmb, docs in SCALE_PATHS:
        patches = []
        if label in CAPTURED_PATHS:
            caps[label] = {}
            patches = [(0, CR, "clip_reduce", recording_cr(label))]
        counts = train_variant(
            torch, gpu, label, train_args(mode, arch=arch, batch=batch,
                                          seq=seq, microbatches=nmb,
                                          docs=docs),
            moe_ms if arch == MOE_ARCH else qwen_ms, patches, kind=mode,
            profile=False)
        for k in launches:
            launches[k] += counts[k]
    for label, got in caps.items():
        if sorted(got) != sorted(shapes.values()):
            raise RuntimeError(f"{label}: clip_reduce captured {sorted(got)} "
                               f"of {sorted(shapes.values())}")
    step_ms = {p[0]: (moe_ms if p[1] == MOE_ARCH else qwen_ms)[p[0]]
               for p in SCALE_PATHS}
    emit({"phase": "scale_train_ratio", "gpu": gpu, "ms_per_step": step_ms,
          "ms_per_example": {p[0]: step_ms[p[0]] / p[3]
                             for p in SCALE_PATHS},
          "naive_flat_ratio_vs_nonprivate":
              step_ms["naive_flat"] / qwen_ms["non_private"]})
    return launches, caps


# phase 12: the crash-safe service on phase 5's training settings
SERVICE_ARGV = ["--arch", "qwen3-4b", "--clipping", "per_layer",
                "--epsilon", "8", "--steps", "4", "--batch", "8",
                "--seq", "256", "--docs", "64", "--optimizer", "adam",
                "--seed", "0", "--checkpoint-every", "2", "--log-every", "1"]
SERVICE_CRASH = ("post-ledger-append", 3)
# (c)'s CLI runs at --reduced width (a few seconds a run)
SERVICE_CLI_ARGV = ["--arch", "qwen3-4b", "--reduced", "--clipping",
                    "per_layer", "--epsilon", "8", "--steps", "4",
                    "--batch", "8", "--seq", "64", "--docs", "64",
                    "--seed", "0", "--checkpoint-every", "2",
                    "--log-every", "1"]
SERVICE_CLI_TIMEOUT = 300


def service_args(service_dir: str):
    from repro_torch.launch import service
    return service.build_service_parser().parse_args(
        ["--service-dir", service_dir, *SERVICE_ARGV])


def leaf_names(tree, prefix="") -> list:
    """Names of a state's leaves in the checkpoint's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [n for f, v in zip(tree._fields, tree)
                for n in leaf_names(v, f"{prefix}{f}/")]
    return [prefix.rstrip("/")]


def run_steps(torch, runtime, state, sampler, steps):
    """`steps` service steps of `runtime` on `state` (updated in place);
    returns each step's loss."""
    from repro_torch.data import make_lm_batch
    losses = []
    for _ in range(steps):
        batch = make_lm_batch(runtime.rows, sampler.next_indices(),
                              runtime.batch)
        batch = {k: torch.from_numpy(v).to(runtime.device)
                 for k, v in batch.items()}
        p, o, d, met = runtime.step(state["params"], state["opt_state"],
                                    state["dp_state"], batch,
                                    runtime.seed + 1)
        state.update(params=p, opt_state=o, dp_state=d)
        losses.append(float(met.loss))
    return losses


def step_repeat_and_reference(torch, gpu, runtime, steps):
    """(a): the first step from the seeded state twice, each state's
    per-leaf crc32 before and after compared bitwise (every leaf that
    differs named); then `steps` - 1 more steps from the second: the
    uninterrupted run's final crcs, computed in memory (no checkpoint
    written). Returns those crcs and the steps executed."""
    from repro_torch.checkpoint import tree_crcs
    from repro_torch.launch.train import init_state
    runs = []
    for _ in range(2):
        if runs:
            del state
            gc.collect()
            torch.cuda.empty_cache()
        state = init_state(runtime.model, runtime.init_fn, runtime.seed,
                           runtime.device)
        sampler = runtime.make_sampler()
        before = tree_crcs(state)
        t0 = time.perf_counter()
        loss = run_steps(torch, runtime, state, sampler, 1)[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after = tree_crcs(state)
        runs.append({"before": before, "after": after, "loss": loss,
                     "step_s": t1 - t0,
                     "crc_s": time.perf_counter() - t1})
    names = leaf_names(state)
    differ = [n for n, x, y in zip(names, runs[0]["after"],
                                   runs[1]["after"]) if x != y]
    emit({"phase": "step_repeat", "gpu": gpu, "arch": runtime.cfg.name,
          "mode": runtime.plan.config.mode, "batch": runtime.batch,
          "leaves": len(names),
          "initial_bitwise": runs[0]["before"] == runs[1]["before"],
          "bitwise": not differ, "differing_leaves": differ,
          "losses": [r["loss"] for r in runs],
          "crcs": dict(zip(names, runs[1]["after"])),
          "crc_s": runs[1]["crc_s"]})
    if runs[0]["before"] != runs[1]["before"] or differ:
        raise RuntimeError(f"a repeated step from the same state differs "
                           f"in {differ}")
    losses = run_steps(torch, runtime, state, sampler, steps - 1)
    torch.cuda.synchronize()
    crcs = tree_crcs(state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return crcs, [r["loss"] for r in runs] + losses, steps + 1


def state_bytes(torch, runtime) -> int:
    """Raw bytes of the service's checkpointed state (0-d leaves: 4)."""
    from repro_torch.checkpoint.store import tree_flatten
    from repro_torch.core.spec import meta_params
    params = meta_params(runtime.model.spec)
    opt, dp = runtime.init_fn(params)
    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
               else 4 for x in tree_flatten([params, opt, dp]))


def codec_probe(torch, runtime) -> dict:
    """zlib level 6 (the reference's), Huffman coding only and stored
    blocks (the store's pieces) on 16 MiB of bf16 weights as the model
    initializes them (N(0, 0.02)): MB/s of one host thread each way and
    the stored fraction."""
    import zlib
    gen = torch.Generator(device=runtime.device).manual_seed(runtime.seed)
    x = (torch.randn(8 << 20, generator=gen, device=runtime.device)
         * 0.02).to(torch.bfloat16)
    raw = x.view(torch.int16).cpu().numpy().tobytes()
    out = {}
    for name, level, strategy in (("zlib6", 6, zlib.Z_DEFAULT_STRATEGY),
                                  ("huffman_only", 1, zlib.Z_HUFFMAN_ONLY),
                                  ("stored", 0, zlib.Z_DEFAULT_STRATEGY)):
        t0 = time.perf_counter()
        c = zlib.compressobj(level, zlib.DEFLATED, 15, 8, strategy)
        comp = c.compress(raw) + c.flush()
        t1 = time.perf_counter()
        if zlib.decompress(comp) != raw:
            raise RuntimeError(f"codec probe: {name} does not round-trip")
        out[name] = {"deflate_mb_per_s": len(raw) / (t1 - t0) / 1e6,
                     "inflate_mb_per_s":
                         len(raw) / (time.perf_counter() - t1) / 1e6,
                     "stored_fraction": len(comp) / len(raw)}
    return out


def cli_service(work, name, *extra):
    """Start the service CLI in a subprocess over `work/name`."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.service",
           "--service-dir", os.path.join(work, name), *SERVICE_CLI_ARGV,
           *extra]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    proc.started = time.perf_counter()
    proc.run_args = (name, list(extra))
    return proc


def cli_wait(proc, expect) -> str:
    """Wait for a `cli_service` run; its exit code must be `expect`.
    Returns its standard output."""
    out, err = proc.communicate(timeout=SERVICE_CLI_TIMEOUT)
    name, extra = proc.run_args
    if proc.returncode != expect:
        raise RuntimeError(f"service CLI {name} {extra}: exit "
                           f"{proc.returncode}, expected {expect}\n"
                           f"{out[-2000:]}\n{err[-4000:]}")
    emit({"phase": "service_cli", "run": name, "args": extra,
          "exit": proc.returncode, "s": time.perf_counter() - proc.started,
          "lines": [ln for ln in out.splitlines()
                    if ln.startswith("# service")]})
    return out


def phase_service_cli(work) -> dict:
    """(c): the service CLI at --reduced width in subprocesses: the
    uninterrupted run and the budget stop beside the crash, resume,
    corrupt-shard and fallback chain."""
    import re
    from repro_torch.checkpoint import store
    from repro_torch.launch.service import PrivacyLedger

    def crcs(name):
        return store.manifest_crcs(os.path.join(work, name, "ckpt"), 4)

    point, step = SERVICE_CRASH
    # sigma calibrated for 2 steps: the gate refuses step 2
    side = [cli_service(work, "straight"),
            cli_service(work, "budget", "--calib-steps", "2")]
    try:
        cli_wait(cli_service(work, "crash", "--fault-at", f"{point}:{step}"),
                 86)
        cli_wait(cli_service(work, "crash"), 0)
        crash_crcs = crcs("crash")
        # one flipped byte in the newest shard: the resume falls back to
        # the previous verified step and re-trains the gap
        ckpt = os.path.join(work, "crash", "ckpt")
        shard = os.path.join(ckpt, "step_00000004", sorted(
            f for f in os.listdir(os.path.join(ckpt, "step_00000004"))
            if f.startswith("shard_"))[-1])
        with open(shard, "r+b") as f:
            f.seek(os.path.getsize(shard) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
        fallback = store.latest_verified_step(ckpt)
        out = cli_wait(cli_service(work, "crash"), 0)
        resumed_at = int(re.search(r"resume_at=(\d+)", out).group(1))
        cli_wait(side[0], 0)
        budget_out = cli_wait(side[1], 0)
    finally:
        for proc in side:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if crash_crcs != crcs("straight"):
        raise RuntimeError("CLI resume: final crcs differ from the "
                           "uninterrupted CLI run's")
    if fallback != 2 or resumed_at != 2 or crcs("crash") != crcs("straight"):
        raise RuntimeError(f"corrupt shard: fallback {fallback}, resumed at "
                           f"{resumed_at}, final crcs equal "
                           f"{crcs('crash') == crcs('straight')}")
    records = len(PrivacyLedger(os.path.join(work, "crash",
                                             "ledger.jsonl")).replay())
    m = re.search(r"status=budget_exhausted step=(\d+) epsilon=([0-9.]+) "
                  r"budget=([0-9.]+)", budget_out)
    if m is None or int(m.group(1)) != 2 or \
            float(m.group(2)) > float(m.group(3)):
        raise RuntimeError(f"budget stop: {budget_out[-1000:]}")
    return {"crash_exit": 86, "resume_crcs_equal": True,
            "corrupt_fallback_step": fallback,
            "resumed_at_after_corruption": resumed_at,
            "ledger_records": records,
            "budget_stop": {"step": int(m.group(1)),
                            "epsilon": float(m.group(2)),
                            "budget": float(m.group(3))}}


def phase_service(torch, gpu):
    """Phase 12. Returns the launches by kernel over (a) and (b)."""
    import shutil
    from repro_torch.checkpoint import store
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import service
    from repro_torch.launch.service import (FaultInjector, PrivacyLedger,
                                            SimulatedCrash, TrainService)
    work = os.path.join(ROOT, "build", "smoke_service")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    args = service_args(os.path.join(work, "svc"))
    t0 = time.perf_counter()
    runtime = service.build_runtime(args)
    build_s = time.perf_counter() - t0
    raw = state_bytes(torch, runtime)
    free = shutil.disk_usage(work).free
    need = 2 * raw + (4 << 30)  # two published steps, the stage, slack
    if free < need:
        raise RuntimeError(f"phase 12 needs {need / 1e9:.1f} GB of disk "
                           f"under {work} (two {raw / 1e9:.1f} GB "
                           f"checkpoints), {free / 1e9:.1f} GB free")
    steps = args.steps
    per_step = expected_launches("per_layer", runtime.cfg)
    launches = dict.fromkeys(TRAIN_KERNELS, 0)

    def count(executed, what):
        got = launch_counts()
        want = {k: v * executed for k, v in per_step.items()}
        if {k: got[k] for k in want} != want:
            raise RuntimeError(f"{what}: launches {got} over {executed} "
                               f"steps, expected {want}")
        for k in launches:
            launches[k] += got[k]
        return {k: got[k] for k in ("ghost_norm", "clip_reduce")}

    # (a) the step repeat and the uninterrupted reference
    reset_launch_counts()
    ref_crcs, ref_losses, executed = step_repeat_and_reference(
        torch, gpu, runtime, steps)
    a_counts = count(executed, "uninterrupted")

    # (b) crash after step 3's ledger append, resume to 4 steps
    saves, loads = [], []
    real_save, real_restore = service.save_checkpoint, service.restore_latest

    def timed_save(*a, **kw):
        t = time.perf_counter()
        path = real_save(*a, **kw)
        saves.append({"step": a[1], "s": time.perf_counter() - t})
        return path

    def timed_restore(*a, **kw):
        t = time.perf_counter()
        found = real_restore(*a, **kw)
        torch.cuda.synchronize()
        if found is not None:
            loads.append({"step": found[0], "s": time.perf_counter() - t})
        return found

    ledger_path = os.path.join(args.service_dir, "ledger.jsonl")
    service.save_checkpoint = timed_save
    service.restore_latest = timed_restore
    try:
        reset_launch_counts()
        point, at = SERVICE_CRASH
        svc = TrainService(args, runtime=runtime,
                           fault=FaultInjector(point, at, mode="raise"))
        try:
            svc.run()
            raise RuntimeError(f"fault {point}@{at} never fired")
        except SimulatedCrash:
            pass
        crashed_committed = svc.committed
        del svc  # the crashed incarnation's 26.5 GB of state
        gc.collect()
        torch.cuda.empty_cache()
        records_at_crash = len(PrivacyLedger(ledger_path).replay())
        svc = TrainService(args, runtime=runtime)
        resumed_at = svc.committed
        status = svc.run()
        torch.cuda.synchronize()
        del svc
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        service.save_checkpoint = real_save
        service.restore_latest = real_restore
    b_executed = crashed_committed + (steps - resumed_at)
    b_counts = count(b_executed, "crash and resume")
    ckpt = os.path.join(args.service_dir, "ckpt")
    records = PrivacyLedger(ledger_path).replay()
    final = store.manifest_crcs(ckpt, steps)
    t0 = time.perf_counter()
    verified = store.verify_checkpoint(ckpt, steps)
    verify_s = time.perf_counter() - t0
    step_dir = os.path.join(ckpt, f"step_{steps:08d}")
    stored = sum(os.path.getsize(os.path.join(step_dir, f))
                 for f in os.listdir(step_dir))
    manifest = store.load_manifest(ckpt, steps)
    differ = [i for i, (x, y) in enumerate(zip(final, ref_crcs)) if x != y]
    result = {
        "phase": "service", "gpu": gpu, "arch": runtime.cfg.name,
        "params": runtime.model.num_params, "mode":
            runtime.plan.config.mode, "batch": runtime.batch,
        "seq": args.seq, "steps": steps, "sigma": runtime.plan.sigma,
        "build_s": build_s, "crash": f"{point}@{at}",
        "committed_at_crash": crashed_committed, "resumed_at": resumed_at,
        "status": status["status"], "epsilon": status["epsilon"],
        "ledger_records_at_crash": records_at_crash,
        "ledger_records": len(records),
        "final_crcs_equal": final == ref_crcs, "differing_leaf_indices":
            differ, "leaves": len(final), "verified": verified,
        "reference_losses": ref_losses,
        "codec": manifest["codec"], "threads": os.cpu_count(),
        "free_disk_gb": free / 1e9, "raw_bytes": raw,
        "stored_bytes": stored, "stored_fraction": stored / raw,
        "num_shards": manifest["num_shards"],
        "saves": [dict(x, gb_per_s=raw / x["s"] / 1e9) for x in saves],
        "loads": [dict(x, gb_per_s=raw / x["s"] / 1e9) for x in loads],
        "verify": {"s": verify_s, "gb_per_s": raw / verify_s / 1e9},
        "codec_probe": codec_probe(torch, runtime),
        "launches_uninterrupted": a_counts, "executed_uninterrupted":
            executed, "launches_crash_resume": b_counts,
        "executed_crash_resume": b_executed,
        "launches_per_executed_step": {k: per_step[k] for k in
                                       ("ghost_norm", "clip_reduce")}}
    emit(result)
    shutil.rmtree(args.service_dir)
    if not (final == ref_crcs and verified and len(records) == steps
            and records_at_crash == steps and status["status"] == "complete"
            and [r["step"] for r in records] == list(range(steps))):
        raise RuntimeError("phase 12: the resumed service differs from the "
                           "uninterrupted run")
    del runtime
    gc.collect()
    torch.cuda.empty_cache()
    cli = phase_service_cli(work)
    emit({"phase": "service_cli_summary", "gpu": gpu, **cli})
    shutil.rmtree(work)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def clock(after):  # the run's own time budget, phase by phase
        emit({"phase": "clock", "after": after,
              "elapsed_s": time.perf_counter() - t_start})

    gpu = gpu_name_and_power()
    phase_build(torch, gpu)
    clock("build")
    launches, snap = phase_main_path(torch, gpu)
    clock("serve")
    kernel = phase_kernels(torch, gpu, snap)
    kernel["launches"] = launches
    clock("paged_attn kernels")
    phase_cuda_vs_cpu(torch, gpu)
    clock("serve cuda/cpu")
    del snap
    gc.collect()
    torch.cuda.empty_cache()
    qwen_ms, moe_ms = {}, {}
    train_launches, caps, gnb_caps, sc_caps, blk_caps = phase_train(
        torch, gpu, qwen_ms)
    clock("train")
    from repro_torch.configs import get_config
    num_layers = get_config("qwen3-4b").num_layers
    train_kernels = phase_train_kernels(torch, gpu, caps, gnb_caps,
                                        sc_caps, blk_caps, num_layers)
    del caps, gnb_caps, sc_caps, blk_caps
    gc.collect()
    torch.cuda.empty_cache()
    clock("train kernels")
    phase_train_cuda_vs_cpu(torch, gpu)
    clock("train cuda/cpu")
    moe_launches, router, moe_caps = phase_moe_train(torch, gpu, moe_ms)
    clock("moe train")
    fused = phase_fused_kernel(torch, gpu, router)
    del router
    clock("fused kernel")
    # phase 10: granite's composed linears of a per_layer step, and its
    # router's clip_reduce of a non_private step
    moe = captured_rows(torch, gpu, moe_caps, get_config(MOE_ARCH).num_layers,
                        {"per_layer": (MOE_COMPOSED["per_layer"],
                                       ("ghost_norm", "clip_reduce")),
                         "non_private": (MOE_COMPOSED["non_private"],
                                         ("clip_reduce",))}, arch=MOE_ARCH)
    del moe_caps
    gc.collect()
    torch.cuda.empty_cache()
    clock("moe kernels")
    scale_launches, scale_caps = phase_scale_train(torch, gpu, qwen_ms,
                                                   moe_ms)
    clock("scale train")
    # naive_flat: one backward per example, B = 8 of them a step
    naive = captured_rows(torch, gpu, scale_caps["naive_flat"], num_layers, {
        "naive_flat": (tuple(scale_caps["naive_flat"]), ("clip_reduce",))},
        repeats=next(p[3] for p in SCALE_PATHS if p[0] == "naive_flat"))
    long = captured_rows(torch, gpu, scale_caps["per_layer_t4096"],
                         num_layers, {"per_layer_t4096": (
                             tuple(scale_caps["per_layer_t4096"]),
                             ("ghost_norm", "clip_reduce"))})
    del scale_caps
    clock("scale kernels")
    service_launches = phase_service(torch, gpu)
    clock("service")
    # the training kernels' launches over every training path; the worst
    # error over every path's inputs, granite's, naive_flat's and the
    # T = 4096 path's times beside qwen3-4b's
    for k in train_kernels + [fused]:
        k["launches"] = sum(run[k["name"]] for run in (
            train_launches, moe_launches, scale_launches, service_launches))
        for key, extra in (("moe", moe), ("naive_flat", naive),
                           ("long_context", long)):
            if k["name"] in extra:
                k[key] = extra[k["name"]]
                for err in ("max_abs_err", "max_rel_err"):
                    k[err] = max(k[err], extra[k["name"]][err])
    emit({"kernels": [kernel] + train_kernels + [fused]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

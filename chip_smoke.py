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
  3 serve     qwen3-4b at full width, its depth cut to QWEN_CUT_DEPTH = 6
              of 36 layers (a serve_step is host-bound, its time a
              layer's times the depth), bf16, random parameters from a
              seeded torch.Generator, served through the serve CLI's own
              `serve_requests`: 8 slots, page_len 16, 16 synthetic
              requests of 64-192 tokens behind a 32-token shared prefix,
              32 generated tokens each (cache_len 272, 136 pages). Every
              launch counter is set to 0 just before and read just
              after; paged_attn must have launched 6 times per
              serve_step. The engine's `on_token` callback keeps each
              token's top-2 logits (for phase 15); its host seconds
              are in the line beside the ms per serve_step without them.
  2 kernels   (run after phase 3, so its launches stay out of phase 3's
              count) paged_attn against its plain PyTorch version on the
              card: a sweep of ragged tables, partial last pages, trash
              entries, dv < dvp on an aliased pool, head dims 3/12/16/
              64/128 (rows of 6, 24 and 32 bytes among them), bf16 and
              f32, MLA's latent widths (KV = 1, G = 128, dq = 576, dv =
              512 on an aliased pool, B = 2 and 8, an f32 query over bf16
              and over f32 pools, 4,096 tokens) and long GQA contexts
              (4,096 tokens at qwen3-4b's head layout, 32 splits at B =
              1; 4,096 tokens at B = 8 at the dense configs' layouts:
              KV = 36, G = 1, hd 64; KV = 40, G = 1; KV = 8, G = 8), two
              calls bitwise equal at every point; then at the
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
              5's settings (qwen3-4b at full width, its depth cut to
              SERVICE_DEPTH = 12 of 36 layers for the time limit (the
              full depth took 307-370 s), per_layer,
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
              ghost_norm / clip_reduce launches 49 each per executed
              step (4 linears x 12 blocks + the head), re-executions
              included (5 executed steps in (a), 5 in
              (b)); (c) the service CLI in subprocesses at --reduced width:
              `--fault-at post-ledger-append:3` exits 86, the resume exits
              0 with the crcs of an uninterrupted CLI run, a flipped byte
              in the newest shard falls back to step 2 and re-trains to the
              same crcs, and `--calib-steps 2` stops cleanly with
              status=budget_exhausted at step 2, epsilon within budget.

  13 moe/mla  serving of the MoE and MLA families through phase 3's
              `serve_model`, random parameters from seed 0, page_len 16,
              a 16-token shared prefix, 16 generated tokens a request:
              granite-moe-3b-a800m at full width and depth (32 layers of
              40 experts top-8, GQA KV = 8, G = 3, head dim 64, bf16,
              3.37 B parameters; 16 requests of 32-96 tokens, 8 slots),
              then deepseek-v3-671b at full width with its depth cut to
              5 layers (`dataclasses.replace(cfg, num_layers=5)`: the 3
              first_k_dense layers, 2 MoE layers of 256 experts, mtp
              kept; 27.3 B bf16 parameters, 54.6 GB; the whole model's
              1.34 TB fit no card; 8 requests of 32-64 tokens, 4 slots),
              its absorbed-form MLA decode calling paged_attn with KV =
              1, G = 128, dq = 576, dv = 512, an f32 query over the bf16
              latent pool passed as both pools. Gates as phase 3's:
              paged_attn launched 32 / 5 times a serve_step. Each
              path's line (tok/s, ms per dispatch and serve_step, peak
              GB, the depth cut), its profile of 3 decode steps, and
              paged_attn at its captured inputs with the most valid rows
              against the plain version (TOL, a bitwise repeat) with
              eager, graph, plain, library and bound times, kept in the
              kernels line under "moe_serve" and "mla_serve"; then phase
              4's card/CPU check on both reduced configs.

  14 moe/mla  the training half of the MoE and MLA families through the
     train    same `Trainer` (train_variant, phase 5's settings: B = 8, T =
              256, adam, epsilon 8, rate 1/16, remat on, 1 warm-up + 3
              timed steps a variant):
              (a) granite-moe-3b-a800m at full width and depth, flat
              dispatch, ghost_flat_bk and per_group_bk (2 supergroups):
              one backward and the BK epilogue (scale_contract over qkv,
              o, the router and the head; the experts' clipped sums in
              f32 a layer at a time), no fallback warning, ratios against
              phase 8's non_private, peak memory; per_group_bk's last
              epilogue's scale_contract inputs are kept;
              (b) granite by grouped dispatch (`moe_dispatch="grouped"`,
              `Trainer(cfg=...)`: 64 slots an (example, expert)),
              per_layer and non_private;
              (c) deepseek-v3-671b at full width, its depth cut to its
              MLA_TRAIN_DEPTH = 3 first_k_dense layers, mtp kept (4.29 B
              parameters: MLA training, the MTP loss, the head twice a
              step), per_layer and non_private, each step's mean
              threshold and clip fraction; per_layer's first step's
              clip_reduce inputs at its nine linear shapes are kept;
              launches per step of ghost_norm / clip_reduce /
              scale_contract / fused_norm_clip (`expected_launches`):
                granite ghost_flat_bk, per_group_bk  97 / 0 / 4 / 0
                granite grouped per_layer            65 / 65 / 0 / 32
                granite grouped non_private           0 / 97 / 0 / 0
                deepseek-v3 per_layer                31 / 31 / 0 / 0
                deepseek-v3 non_private               0 / 31 / 0 / 0
              (deepseek-v3: 7 linears x 3 layers, 8 in MTP, the head
              twice); granite BK and deepseek-v3 per_layer are profiled;
              (d) ghost_norm and clip_reduce at deepseek-v3's captured
              inputs (q_a, q_b, kv_a, kv_b, o, gate_up, down, the MTP
              projection 14336 -> 7168, the 129,280-wide head) and
              scale_contract at granite's BK epilogue's, with phase 6's
              tolerances, bitwise repeats, float64 errors (the ghost
              norms), eager, graph (ghost_norm), plain, library and bound
              times, under the "mla_train" and "moe_bk" keys of the
              kernels line;
              (e) phase 7's card/CPU check on deepseek-v3 reduced (MLA, a
              dense and a MoE layer with a shared expert, MTP) per_layer,
              granite reduced by grouped dispatch per_layer and granite
              reduced ghost_flat by BK (and against its twopass).

  15 dense/  the contiguous plane, batch mode and the remaining dense
     contig.  configs (qwen3-4b cut to QWEN_CUT_DEPTH = 6 layers in
              (a)-(c)):
              (a) phase 3's request set on the contiguous plane
              (`paging="off"`, cache_len 272, 8 slots): no paged_attn
              launch; its tokens equal phase 3's paged tokens up to ties;
              ms per serve_step and the cache bytes of both planes, and a
              profile of 3 decode steps;
              (b) `greedy_decode` on 4 ragged prompts of 16-48 tokens, 16
              generated: prefill "fused" bitwise equal to "loop", both
              equal to the contiguous engine's tokens up to ties;
              (c) qwen3-4b `variant="swa"` (a 4,096-token window) with
              cache_len 64 below prompt + gen (4 requests of 48-96
              tokens): `auto` keeps the contiguous plane, a ring of 64
              slots that wraps;
              (d) minicpm-2b at full width and depth (40 layers, MHA
              36 x 64, 3.01 B parameters, bf16) served paged (paged_attn
              at G = 1, 40 launches a serve_step) and contiguous, tokens
              equal up to ties; (e) qwen1.5-32b (KV = 40, G = 1, hd 128,
              QKV bias) and deepseek-67b (KV = 8, G = 8) at full width,
              their depth cut to DENSE_DEPTH = 4 layers (3.66 B and
              4.45 B parameters; 8 layers took the script to 1,052 s of
              its 1,200 on a slow host), served paged (4 launches a
              serve_step); 6 requests of 16-32
              tokens behind a 16-token prefix, 4 slots, 8 generated; at
              each path's captured input paged_attn is held against its
              plain version (TOL, a bitwise repeat) with eager, graph,
              plain, library and bound times, and so it is at B = 8 rows
              of 4,096 tokens (each row its own 256 pages, bf16) at each
              served head layout, qwen3-4b's G = 4 beside G = 1 (hd 64
              and 128) and G = 8 ("dense_serve" in the kernels line);
              (f) training through `Trainer` on phase 5's settings (1
              warm-up + 2 timed steps): minicpm-2b per_layer and
              non_private at full width and depth (ghost_norm /
              clip_reduce 161 / 161 and 0 / 161 a step: 4 linears x 40
              blocks + the 122,753-wide head), qwen1.5-32b per_layer at 4
              of its 64 layers (17 / 17); ghost_norm and clip_reduce at
              both models' captured linear shapes against their plain
              versions with phase 6's tolerances ("dense_train");
              (g) card against CPU: a per_layer clip of qwen1.5-32b
              reduced with a non-zero QKV bias (rtol 1e-3), and the
              tokens of qwen3-4b reduced swa on a wrapping 16-slot ring.
              A token divergence between two runs is a tie when one of
              the runs' top-2 logit gap at that token is within TIE_GAP:
              that run's choice was an argmax tie. Each part's line has
              its seconds.

 16 sharded   sharded training (`--mesh 2x2`: data 2, model 2) of
              qwen3-4b at full width, its depth cut to SHARDED_DEPTH = 4
              of 36 layers (four replicas and a one-process oracle share
              the card), B = 8 global, T = 256, per_layer, ghost_flat
              and per_group by BK, SHARDED_STEPS = 2 each: (a) the
              one-process oracle of each variant (microbatches = the data
              shards' batches), its memory freed; (b) four ranks spawned
              through the train CLI's `Trainer` (`launch.mesh.spawn`,
              worker `sharded_rank` of this script) over NCCL when the
              machine has a card per rank, else gloo with every rank on
              cuda:0 (the backend and the rank -> device map printed).
              Gates: rank 0's first-step grads, norms² and counts
              against the oracle's (SHARDED_GRAD_RTOL / _ATOL_FRAC, the
              reference's sharded tolerance on the norms², counts
              equal); every rank's thresholds and parameter digest equal
              after the steps; the collective log of every rank and step:
              no model-axis collective before per_group's factors,
              ghost_flat's one (4,) f32 flat_norm_psum, one grad_psum a
              leaf, the BK epilogue's waited after the next leaf's
              contraction; 17 ghost_norm and 17 clip_reduce (per_layer)
              or 17 ghost_norm and 5 scale_contract (BK) launches per
              rank and step; each kernel against its plain version at
              rank 0's recorded inputs (phase 6's tolerances), and
              scale_contract exactly zero on the stack slices whose
              factor rows are all zero (groups another model shard
              owns). ms per step by rank, beside the oracle's.

 17 DP-LoRA   (a) qwen3-4b at full width and depth with rank-8 adapters on
              qkv and o (`--lora-rank 8`, the base frozen) through the
              same `Trainer`, phase 5's settings, per_layer and
              ghost_flat by BK, 1 warm-up + 2 timed steps each: launches
              derived from the layout (`lora_pairs`: 2 ghost_norm and 2
              clip_reduce a pair, 144 + 144 a per_layer step; 144
              ghost_norm and 4 scale_contract a BK step; no
              fused_norm_clip), no fallback, the frozen base's crc32s
              unchanged, every adapter leaf moved; ms per step and peak
              memory, the ratio to phase 5's non_private; (b)
              ghost_norm and clip_reduce at the four adapter sides'
              captured inputs (x with s g Bᵀ: (B, T, din) and (B, T, 8);
              x A with s g: (B, T, 8) and (B, T, dout)) and
              scale_contract at the BK epilogue's four stacked sinks (S
              = 36), at r = 8 and cut to r = 4, against their plain
              versions (rtol 1e-4, atol 1e-4 of the largest magnitude),
              two calls bitwise, graph-replay and eager ms beside plain,
              library and bound ms ("lora" in each kernel's record);
              (c) card against CPU: one per_layer clip of qwen3-4b
              reduced and deepseek-v3 reduced (kv_b and o, MTP) in f32
              with adapters from one numpy tree (TRAIN_RTOL); (d) the
              training service on qwen3-4b (LORA_DEPTH = 2 of 36 layers),
              `--lora-rank 8`, 4 steps, a checkpoint and an adapter
              publish every 2; a multi-tenant engine at
              the same depth serves phase 3's 16 requests round-robin
              over the base, the step-2 publish and a seeded adapter,
              and an `AdapterWatcher` installs the step-4 publish
              mid-decode: installed crcs equal the manifests', every
              tenant's requests equal it served alone (in-flight ones
              on step 2, later ones on step 4, the base tenant the
              single-model engine), paged_attn once a layer a
              serve_step, one serve_step input signature; (e)
              deepseek-v3 at full width, its 3 dense layers, rank-8
              adapters on kv_b and o: 8 requests on 4 slots over the
              base and two seeded adapters, mixed equal to alone through
              paged_attn's latent branch.

Each kernel of the kernels' line carries max_abs_err and max_rel_err,
the latter relative to the largest magnitude of the plain result (the
scale of the checks' atol), the worst over its checks; its launches are
the sum over phases 5, 8, 11, 12, 14, 15, 16 and 17 (paged_attn's:
phases 3, 13, 15 and 17). A clock line follows each phase.

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
# qwen3-4b's layers in phase 3's serving (and phase 15's (a)-(c)), of 36:
# a serve_step is bound by the host (its small ops, a layer at a time),
# so a sixth of the depth keeps the whole run well inside its time limit
# on a slow host (12 layers took it to 1,067 s of 1,200); the width and
# every leaf stay
QWEN_CUT_DEPTH = 6

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
    # 4,096 tokens at the dense configs' head layouts: minicpm-2b (KV = 36,
    # G = 1, hd 64), qwen1.5-32b (KV = 40, G = 1), deepseek-67b (G = 8)
    ((8, 36, 1, 64, None, 300, 16, 256), SAME),
    ((8, 40, 1, 128, None, 300, 16, 256), SAME),
    ((8, 8, 8, 128, None, 300, 16, 256), SAME),
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


def serve_model(torch, gpu, phase, cfg, *, n_req, min_len, max_len, prefix,
                gen, slots, page_len, on_token=None, **extra):
    """Serve `n_req` synthetic requests (`min_len`-`max_len` tokens behind
    a `prefix`-token shared prefix, `gen` generated each) through the serve
    CLI's own `serve_requests` on random parameters from seed 0, with
    every launch counter set to 0 just before and read just after. Layer
    0's paged_attn inputs are captured every 16th serve_step (the pools
    are updated in place, so they are cloned; an aliased pool stays one
    tensor). `on_token` (a `Top2`) is the engine's per-token callback;
    the host seconds it took are in the line, beside the ms per
    serve_step without them. Gates: every request complete with
    in-vocabulary tokens, a prefix hit, and paged_attn launched once a
    layer a serve_step. Emits the phase's line (with `extra`) and returns
    (paged_attn launches, the capture with the most valid cache rows,
    model, params, engine, ms per serve_step)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import paged_attn as K
    from repro_torch.launch import serve
    from repro_torch.models.transformer import build_model

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = serve.build_requests(cfg.vocab_size, n_req, min_len=min_len,
                                max_len=max_len, shared_prefix=prefix,
                                seed=0)
    cache_len = -(-(prefix + max_len + gen + 8) // page_len) * page_len

    real = K.paged_attn
    calls, snaps = [0], []

    def recording(q, kpool, vpool, pt, pos, **kw):
        if calls[0] % (16 * cfg.num_layers) == 0:
            kp = kpool.clone()
            vp = kp if K._is_alias(kpool, vpool) else vpool.clone()
            snaps.append((q.clone(), kp, vp, pt.clone(), pos.clone(), kw))
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
            cache_len=cache_len, page_len=page_len, on_token=on_token)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        K.paged_attn = real
    s = eng.stats
    if sorted(done) != list(range(n_req)):
        raise RuntimeError(f"{cfg.name}: completed {sorted(done)} of "
                           f"{n_req} requests")
    for rid, c in done.items():
        if len(c.tokens) != gen or not all(0 <= t < cfg.vocab_size
                                           for t in c.tokens):
            raise RuntimeError(f"{cfg.name}: request {rid}: bad tokens "
                               f"{c.tokens}")
    if s["prefix_hits"] < 1:
        raise RuntimeError(f"{cfg.name}: prefix sharing never hit")
    if counts["paged_attn"] != cfg.num_layers * s["serve_steps"]:
        raise RuntimeError(
            f"{cfg.name}: paged_attn launched {counts['paged_attn']} times "
            f"for {s['serve_steps']} serve_steps of {cfg.num_layers} layers")
    prompt_toks = sum(len(r) for r in reqs)
    step_ms = 1e3 * wall / s["serve_steps"]
    if on_token is not None:
        if on_token.tokens != {rid: c.tokens for rid, c in done.items()}:
            raise RuntimeError(f"{cfg.name}: on_token saw other tokens")
        extra["top2_capture_s"] = on_token.seconds
        extra["ms_per_serve_step_less_capture"] = (
            1e3 * (wall - on_token.seconds) / s["serve_steps"])
    emit({"phase": phase, "gpu": gpu, "arch": cfg.name, **extra,
          "num_params": model.num_params, "dtype": str(cfg.dtype),
          "requests": n_req, "slots": slots, "page_len": page_len,
          "cache_len": cache_len, "num_pages": eng.num_pages,
          "cache_mb": eng.cache_bytes() / 2**20,
          "prompt_tokens": prompt_toks, "generated_tokens": n_req * gen,
          "init_params_s": init_s, "wall_s": wall,
          "generated_tok_per_s": n_req * gen / wall,
          "tok_per_s_incl_prefill": (prompt_toks + n_req * gen) / wall,
          "ms_per_decode_dispatch":
              1e3 * eng.seconds["decode"] / s["decode_dispatches"],
          "ms_per_prefill_dispatch":
              1e3 * eng.seconds["prefill"] / s["prefill_dispatches"],
          "ms_per_serve_step": step_ms,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": counts, "stats": s,
          "first_tokens": done[0].tokens[:8]})
    best = max(snaps, key=lambda sn: int(
        np.minimum(sn[4].cpu().numpy() + 1, sn[3].shape[1] * page_len)
        .sum()))
    return counts["paged_attn"], best, model, params, eng, step_ms


class Top2:
    """An engine's `on_token` callback: for every token emitted, the token
    and the top-2 values and indices of the logits row it was taken from
    (device tensors, read after the run), and the host seconds the
    capture took. A divergence between two runs is judged on them."""

    def __init__(self):
        self.tokens, self.rows, self.seconds = {}, {}, 0.0

    def __call__(self, rid, tok, row):
        import torch
        t0 = time.perf_counter()
        self.tokens.setdefault(rid, []).append(tok)
        self.rows.setdefault(rid, []).append(torch.topk(row.float(), 2))
        self.seconds += time.perf_counter() - t0

    def run(self) -> dict:
        """{"tokens": {rid: tokens}, "top2" / "top2_idx": {rid: (n, 2)
        array}}."""
        import torch
        return {"tokens": dict(self.tokens),
                **{key: {rid: torch.stack([getattr(t, f) for t in v])
                         .cpu().numpy() for rid, v in self.rows.items()}
                   for key, f in (("top2", "values"),
                                  ("top2_idx", "indices"))}}


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def compare_runs(label, a, b, bf16):
    """Two runs' tokens ({rid: tokens}, and {rid: (n, 2)} top-2 logits and
    their indices of each), equal up to ties: where a request's tokens
    first differ, that token must be an argmax tie. It is one when one
    run's top two logits are within TIE_GAP there (that run's choice was
    a tie), or, on bf16 logits (`bf16`), when the two runs' top two are
    the same two tokens in swapped order, each run's pair one bf16 step
    apart at most (a one-step rounding difference flipped them). Returns
    the summary with both gaps; raises on a divergence that is no tie."""
    identical, ties = 0, []
    for rid, ta in sorted(a["tokens"].items()):
        tb = b["tokens"][rid]
        if ta == tb:
            identical += 1
            continue
        i = next(k for k, (x, y) in enumerate(zip(ta, tb)) if x != y)
        va, vb = a["top2"][rid][i], b["top2"][rid][i]
        ia, ib = a["top2_idx"][rid][i], b["top2_idx"][rid][i]
        ga, gb = float(va[0] - va[1]), float(vb[0] - vb[1])
        step = bf16_step(float(max(va[0], vb[0])))
        swapped = (int(ia[0]) == ta[i] == int(ib[1])
                   and int(ib[0]) == tb[i] == int(ia[1]))
        one_step = bf16 and swapped and max(ga, gb) <= step
        ties.append({"rid": rid, "at": i, "gap_a": ga, "gap_b": gb,
                     "tokens": [ta[i], tb[i]], "swapped": swapped,
                     "bf16_step": step})
        if min(ga, gb) > TIE_GAP and not one_step:
            raise RuntimeError(
                f"{label}: request {rid} diverges at token {i} with top-2 "
                f"gaps {ga} / {gb} (tie gap {TIE_GAP}; top-2 tokens "
                f"{ia.tolist()} / {ib.tolist()}, bf16 step {step}): {ta} "
                f"vs {tb}")
    return {"requests": len(a["tokens"]), "identical": identical,
            "ties": ties}


# phase 3's request set and engine (phase 15 (a) serves it again on the
# contiguous plane)
MAIN_REQ = dict(n_req=16, min_len=64, max_len=192, prefix=32, gen=32,
                slots=8, page_len=16)


def phase_main_path(torch, gpu):
    """Phase 3. Returns (paged_attn launches, the capture with the most
    valid rows, the run's tokens and top-2 logits per request, cache bytes
    and ms per serve_step, for phase 15)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("qwen3-4b"),
                              num_layers=QWEN_CUT_DEPTH)
    top2 = Top2()
    launches, best, model, params, eng, step_ms = serve_model(
        torch, gpu, "main_path", cfg, **MAIN_REQ, on_token=top2,
        depth_cut={"num_layers": QWEN_CUT_DEPTH, "of": 36})
    profile_decode(torch, gpu, model, params, eng, step_ms)
    run = {**top2.run(), "cache_bytes": eng.cache_bytes(),
           "ms_per_serve_step": step_ms}
    return launches, best, run


def profile_decode(torch, gpu, model, params, eng, step_ms, steps=3,
                   **extra):
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
    emit({"phase": "profile", "gpu": gpu, **extra, "serve_steps": steps,
          "device_ms_per_serve_step": device_ms,
          "unprofiled_ms_per_serve_step": step_ms,
          "device_idle_share": 1.0 - device_ms / step_ms,
          "device_ops_per_serve_step": sum(r[2] for r in rows),
          # the split kernel and the combine
          "paged_attn_ms_per_step": sum(ms for k, ms, _ in rows
                                        if "paged_attn" in k),
          "top": [{"name": k[:80], "ms_per_step": ms, "calls_per_step": n}
                  for k, ms, n in rows[:12]]})


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
    # allocation and two launches), which a serving step pays once a layer
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


def phase_cuda_vs_cpu(torch, gpu, arch="qwen3-4b"):
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models.transformer import build_model

    cfg = get_config(arch, reduced=True)
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
    config; the first linear of a shape names it)."""
    out = {}
    for name, din, dout, _, _ in linear_leaves(cfg):
        out.setdefault((din, dout), name)
    return out


def linear_calls(cfg) -> dict:
    """Name of each linear shape (`linear_shapes`) -> its calls a step."""
    shapes = linear_shapes(cfg)
    out = {}
    for _, din, dout, _, _ in linear_leaves(cfg):
        name = shapes[(din, dout)]
        out[name] = out.get(name, 0) + 1
    return out


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
    """(name, din, dout, blocked, leaf) of every linear call a training
    step clips, `leaf` its parameter's path: each layer's attention
    projections (GQA: qkv and o, blocked when cfg.dp_blocks > 1; MLA: q_a
    and q_b or q, kv_a, kv_b, o), gate_up and down of each dense layer,
    the router (and a shared expert's gate_up and down) of each MoE layer,
    MTP's projection and block, the head (twice with MTP). The experts run
    no kernel."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    n_moe = cfg.num_layers - cfg.first_k_dense if cfg.num_experts else 0
    n_dense = cfg.num_layers - n_moe
    blocked = cfg.dp_blocks > 1
    if cfg.attention_kind == "mla":
        nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
        lr, qlr = cfg.kv_lora_rank, cfg.q_lora_rank
        attn = ([("q_a", d, qlr), ("q_b", qlr, h * (nope + rope))] if qlr
                else [("q", d, h * (nope + rope))])
        attn = [a + (False,) for a in attn + [
            ("kv_a", d, lr + rope), ("kv_b", lr, h * (nope + vd)),
            ("o", h * vd, d)]]
    else:
        attn = [("qkv", d, (h + 2 * kv) * hd, blocked),
                ("o", h * hd, d, blocked)]
    mlp = [("gate_up", d, 2 * cfg.d_ff, False),
           ("down", cfg.d_ff, d, False)]
    fs = cfg.moe_d_ff * cfg.num_shared_experts
    moe = [("router", d, cfg.num_experts, False)] + (
        [("gate_up", d, 2 * fs, False), ("down", fs, d, False)] if fs
        else [])

    def at(stack, items, sub):
        return [(n, di, do, bl, f"{stack}/{sub[n]}/{n}")
                for n, di, do, bl in items]

    attn_sub = {n: "attn" for n, *_ in attn}
    out = []
    for stack, n, block in (("dense_blocks", n_dense, attn + mlp),
                            ("moe_blocks", n_moe, attn + moe)):
        sub = {**attn_sub, "gate_up": "mlp", "down": "mlp", "router": "moe"}
        if stack == "moe_blocks":
            sub.update(gate_up="moe/shared", down="moe/shared")
        out += at(stack, block, sub) * n
    if cfg.mtp_depth:
        out += [("mtp_proj", 2 * d, d, False, "mtp/proj")]
        out += at("mtp/block", attn + mlp,
                  {**attn_sub, "gate_up": "mlp", "down": "mlp"})
    return out + [("head", d, cfg.vocab_size, False, "head")] * (
        2 if cfg.mtp_depth else 1)


def lora_pairs(cfg) -> list:
    """(stack, projection) of every adapter pair a DP-LoRA step clips, one
    entry a layer: qkv and o of each GQA layer, kv_b and o of each MLA
    one (`models.transformer.lora_tree`)."""
    n_moe = cfg.num_layers - cfg.first_k_dense if cfg.num_experts else 0
    projs = ("kv_b", "o") if cfg.attention_kind == "mla" else ("qkv", "o")
    return [(stack, p) for stack, n in (("dense_blocks",
                                         cfg.num_layers - n_moe),
                                        ("moe_blocks", n_moe))
            for _ in range(n) for p in projs]


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
    if cfg.lora_rank:
        # DP-LoRA: two ghost norms a pair (dA's and dB's), and two
        # contractions (or one scale_contract per stacked adapter leaf);
        # a frozen linear launches nothing
        pairs = lora_pairs(cfg)
        n = 2 * len(pairs)
        if label.endswith("_bk"):
            counts.update(ghost_norm=n, scale_contract=2 * len(set(pairs)))
        elif label == "non_private":
            counts["clip_reduce"] = n
        elif label == "naive_flat":
            counts["clip_reduce"] = n * (batch // microbatches)
        else:
            counts.update(ghost_norm=n, clip_reduce=n)
        return {k: v * microbatches for k, v in counts.items()}

    def add(*names):
        for name in names:
            counts[name] += 1

    leaves = linear_leaves(cfg)
    for _, din, dout, blocked, _ in leaves:
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
        # one call per stacked linear leaf
        counts["scale_contract"] = len({leaf[-1] for leaf in leaves})
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
                  kind=None, profile=True, cfg=None, extra=None,
                  timed=TRAIN_TIMED, check=None):
    """Train one variant through the CLI's `Trainer` (on `cfg` in place of
    the `--arch` config when given): TRAIN_WARMUP + `timed` steps with
    every launch counter set to 0 before and read after, then (with
    `profile`) one profiled step. `patches` are (step, module, attribute,
    replacement) swapped in for that step only (the input recorders).
    Checks finite losses, no BK fallback and the launches per step of
    `kind` (default: the label) at the run's batch and microbatches; emits
    the train (and train_profile) lines, with `extra` in the train line;
    records ms per step in `step_ms`, whose non_private and per_layer
    entries (B = 8) give the ratios. `check(trainer)`, called before the
    steps, returns a function called after them that raises on a failed
    gate and returns more of the line. Returns the launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    steps = TRAIN_WARMUP + timed
    t0 = time.perf_counter()
    trainer = train.Trainer(args, cfg=cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    after = check(trainer) if check is not None else None
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
    if after is not None:
        extra = {**(extra or {}), **after(trainer)}
    step_ms[label] = sum(r["ms"] for r in rec[TRAIN_WARMUP:]) / timed
    base, per_layer = step_ms.get("non_private"), step_ms["per_layer"]
    emit({"phase": "train", "gpu": gpu, "arch": trainer.cfg.name,
          "num_layers": trainer.cfg.num_layers,
          "moe_dispatch": trainer.cfg.moe_dispatch,
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
          "timed_steps": timed, "ms_per_step": step_ms[label],
          "ratio_vs_nonprivate": (step_ms[label] / base if base else None),
          "ratio_vs_per_layer": step_ms[label] / per_layer,
          "ms_per_example": step_ms[label] / batch,
          "ms_per_example_vs_per_layer_b8":
              step_ms[label] / batch / (per_layer / 8),
          "tokens_per_s": batch * trainer.args.seq
          / (step_ms[label] / 1e3),
          "steps": rec, "peak_memory_gb": peak, "launches": counts,
          "launches_per_step": per_step, **(extra or {})})
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
    train_cuda_vs_cpu(torch, gpu, cases, tokens, targets, trees)


def train_cuda_vs_cpu(torch, gpu, cases, tokens, targets, trees):
    """One `dp_clipped_gradients` (in `nmb` microbatches) of each case
    (label, mode, execution, config, fused route, microbatches, kwargs of
    numpy arrays) on the card (kernels) and on the CPU (plain versions),
    from the numpy parameter tree `trees[config.name]` and one numpy
    batch: loss, (K, B) norms and every clipped gradient leaf must agree
    (TRAIN_RTOL / TRAIN_ATOL_FRAC), a BK case with its twopass on the
    card too; the card must launch exactly the kernels of the route
    (`expected_launches`), the CPU none, and BK must not fall back."""
    from repro_torch import bridge
    from repro_torch.core.clipping import dp_clipped_gradients
    from repro_torch.core.dp_sgd import clipped_microbatches
    from repro_torch.kernels import backend, launch_counts, reset_launch_counts
    from repro_torch.kernels import fused_clip as FC
    from repro_torch.models.transformer import build_model

    b, t = tokens.shape
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
                  calls_per_step=None, **tags):
    """Training kernels against their plain versions at inputs a training
    path gave them (phase 6's tolerances and timing): `caps` maps a
    linear to its captured (a, g, factors), on the card or the host;
    `variants` maps a variant to (its linears, the kernels they ran);
    each linear runs once a layer (the head once), or
    `calls_per_step[linear]` times, times `repeats` a step (naive_flat:
    one backward per example). Returns name -> a kernels-line entry: the
    worst error, the kernel, plain, bound and library ms summed over each
    variant's step, and the per-call rows."""
    bw = bandwidth(gpu)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = {}
    for variant, (lnames, kernels) in variants.items():
        for lname in lnames:
            a, g, f = (x.cuda() for x in caps[lname])
            calls = repeats * (
                calls_per_step[lname] if calls_per_step is not None
                else 1 if lname == "head" else num_layers)
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
# qwen3-4b's layers in the service, of 36: the full width, the crash and
# the bitwise resume stay, a third of the depth keeps the whole script
# inside its time limit beside phase 16 (the full depth took 307-370 s)
SERVICE_DEPTH = 12
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
    import dataclasses
    import shutil
    from repro_torch.configs import get_config
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
    full = get_config("qwen3-4b")
    runtime = service.build_runtime(args, cfg=dataclasses.replace(
        full, num_layers=SERVICE_DEPTH))
    depth_cut = {"num_layers": SERVICE_DEPTH, "of": full.num_layers,
                 "why": "the script's time limit: phase 12 at full depth "
                        "took 307-370 s, and phase 16 needs its share"}
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
        "depth_cut": depth_cut,
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


# ---------------------------------------------------------------------------
# Phase 13: MoE and MLA serving.
# ---------------------------------------------------------------------------

MLA_DEPTH = 5  # deepseek-v3's layers on one card: first_k_dense 3 + 2 MoE
# (label, arch, layers kept (None: all), requests, min and max prompt
# tokens behind the shared prefix, slots)
SERVE13 = [("moe_serve", "granite-moe-3b-a800m", None, 16, 32, 96, 8),
           ("mla_serve", "deepseek-v3-671b", MLA_DEPTH, 8, 32, 64, 4)]
SERVE13_PREFIX, SERVE13_GEN, SERVE13_PAGE = 16, 16, 16
SERVE13_KEYS = ("point", "q", "kpool", "vpool_is_kpool", "dtype",
                "pool_dtype", "ms", "graph_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "max_abs_err", "max_rel_err",
                "host_us_per_call")


def phase_moe_mla_serve(torch, gpu):
    """Phase 13. Returns {label: the paged_attn entry's block}, each with
    its path's launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attn as K
    bw = bandwidth(gpu)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    blocks = {}
    for label, arch, depth, n_req, lo, hi, slots in SERVE13:
        cfg = get_config(arch)
        extra = {"label": label}
        if depth is not None:
            extra["depth_cut"] = {
                "num_layers": depth, "of": cfg.num_layers,
                "why": "671 B bf16 parameters (1.34 TB) fit no single "
                       "80 GB card; full width, first_k_dense dense "
                       "layers then MoE ones, mtp kept"}
            cfg = dataclasses.replace(cfg, num_layers=depth)
        launches, snap, model, params, eng, step_ms = serve_model(
            torch, gpu, "moe_mla_serve", cfg, n_req=n_req, min_len=lo,
            max_len=hi, prefix=SERVE13_PREFIX, gen=SERVE13_GEN, slots=slots,
            page_len=SERVE13_PAGE, **extra)
        profile_decode(torch, gpu, model, params, eng, step_ms, label=label)
        del model, params, eng
        gc.collect()
        torch.cuda.empty_cache()
        q, kp, vp, pt, pos, kw = snap
        row = paged_attn_times(torch, gpu, K, label, q, kp, vp, pt, pos,
                               kw["scale"], kw.get("dv") or vp.shape[-1],
                               bw, flush)
        blocks[label] = {**{k: row[k] for k in SERVE13_KEYS},
                         "launches": launches}
        del snap, q, kp, vp
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
        phase_cuda_vs_cpu(torch, gpu, arch)
    return blocks


# ---------------------------------------------------------------------------
# Phase 14: MoE and MLA training.
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v3-671b"
# deepseek-v3's layers in training on one card: its 3 first_k_dense
# layers (4.29 B parameters with embed, head and mtp). One MoE layer of
# 256 experts is 11.3 B parameters more, which no 80 GB card trains with
# Adam; the experts' training path runs on granite and in (e)
MLA_TRAIN_DEPTH = 3
# (label, --clipping, --execution, --group-count): granite's BK variants
MOE_BK = [("ghost_flat_bk", "ghost_flat", "bk", 2),
          ("per_group_bk", "per_group", "bk", 2)]
# granite's grouped dispatch and deepseek-v3's variants, per_layer first
# (the ratios divide by it)
PAIR = ("per_layer", "non_private")
# the variants phase 14 profiles (a profile costs 11-24 s of the limit)
PROFILED14 = ("ghost_flat_bk", "mla_per_layer")


def phase_moe_mla_train(torch, gpu, moe_ms):
    """Phase 14. Returns (launches by kernel over every variant's counted
    steps, the kernels-line blocks of ghost_norm and clip_reduce at
    deepseek-v3's captured shapes ("mla_train") and of scale_contract at
    granite's BK epilogue ("moe_bk"))."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.kernels import bk as SC
    from repro_torch.kernels import clip_reduce as CR
    from repro_torch.models.transformer import build_model

    launches = dict.fromkeys(TRAIN_KERNELS, 0)

    def count(counts):
        for k in launches:
            launches[k] += counts[k]

    # (a) BK on granite (flat dispatch); per_group_bk's last epilogue's
    # inputs kept by reference (nothing writes the sinks after it)
    cfg = get_config(MOE_ARCH)
    shapes = linear_shapes(cfg)
    sc_caps = {}
    real_sc, real_cr = SC.scale_contract, CR.clip_reduce

    def recording_sc(a, g, factors):
        sc_caps[shapes[(a.shape[-1], g.shape[-1])]] = (a, g, factors)
        return real_sc(a, g, factors)

    last = TRAIN_WARMUP + TRAIN_TIMED - 1
    for label, mode, execution, group_count in MOE_BK:
        patches = ([(last, SC, "scale_contract", recording_sc)]
                   if label == "per_group_bk" else [])
        count(train_variant(torch, gpu, label,
                            train_args(mode, execution, group_count,
                                       arch=MOE_ARCH), moe_ms, patches,
                            profile=label in PROFILED14))
    bk_leaves = sorted({shapes[(din, dout)]
                        for _, din, dout, _, _ in linear_leaves(cfg)})
    if sorted(sc_caps) != bk_leaves:
        raise RuntimeError(f"scale_contract: captured {sorted(sc_caps)} of "
                           f"the {MOE_ARCH} linears {bk_leaves}")
    moe_bk = captured_rows(torch, gpu, sc_caps, cfg.num_layers,
                           {"per_group_bk": (tuple(bk_leaves),
                                             ("scale_contract",))},
                           calls_per_step=dict.fromkeys(bk_leaves, 1),
                           arch=MOE_ARCH)
    del sc_caps
    gc.collect()
    torch.cuda.empty_cache()

    # (b) granite by grouped dispatch
    grouped = dataclasses.replace(cfg, moe_dispatch="grouped")
    grouped_ms = {}
    for label in PAIR:
        count(train_variant(torch, gpu, label, train_args(
            label, arch=MOE_ARCH), grouped_ms, cfg=grouped, profile=False))

    # (c) deepseek-v3 at full width, its depth cut; per_layer's first
    # step's clip_reduce inputs at each linear shape, on the host
    mla_cfg = dataclasses.replace(get_config(MLA_ARCH),
                                  num_layers=MLA_TRAIN_DEPTH)
    mla_shapes = linear_shapes(mla_cfg)
    mla_caps, mla_ms = {}, {}

    def recording_cr(a, g, factors, block_axis="out"):
        name = mla_shapes.get((a.shape[-1], g.shape[-1]))
        if name is not None and name not in mla_caps:
            mla_caps[name] = (a.cpu(), g.cpu(), factors.cpu())
        return real_cr(a, g, factors, block_axis)

    cut = {"depth_cut": {
        "num_layers": MLA_TRAIN_DEPTH, "of": get_config(MLA_ARCH).num_layers,
        "why": "full width, its first_k_dense dense layers and mtp; a MoE "
               "layer of 256 experts (11.3 B parameters) does not train "
               "with Adam on one 80 GB card"}}
    for label in PAIR:
        patches = ([(0, CR, "clip_reduce", recording_cr)]
                   if label == "per_layer" else [])
        count(train_variant(torch, gpu, label, train_args(
            label, arch=MLA_ARCH), mla_ms, patches, cfg=mla_cfg,
            profile=f"mla_{label}" in PROFILED14, extra=cut))
    if sorted(mla_caps) != sorted(mla_shapes.values()):
        raise RuntimeError(f"clip_reduce: captured {sorted(mla_caps)} of "
                           f"{sorted(mla_shapes.values())}")
    emit({"phase": "moe_mla_train_ratio", "gpu": gpu,
          "granite_bk_vs_nonprivate": {
              k: moe_ms[k] / moe_ms["non_private"] for k, *_ in MOE_BK},
          "granite_bk_vs_per_layer": {
              k: moe_ms[k] / moe_ms["per_layer"] for k, *_ in MOE_BK},
          "grouped_ms_per_step": grouped_ms,
          "grouped_ratio_vs_nonprivate":
              grouped_ms["per_layer"] / grouped_ms["non_private"],
          "grouped_vs_flat": {k: grouped_ms[k] / moe_ms[k] for k in PAIR},
          "mla_ms_per_step": mla_ms,
          "mla_ratio_vs_nonprivate":
              mla_ms["per_layer"] / mla_ms["non_private"]})

    # (d) ghost_norm and clip_reduce at deepseek-v3's captured shapes
    mla = captured_rows(torch, gpu, mla_caps, MLA_TRAIN_DEPTH,
                        {"per_layer": (tuple(mla_caps),
                                       ("ghost_norm", "clip_reduce"))},
                        calls_per_step=linear_calls(mla_cfg), arch=MLA_ARCH)
    del mla_caps
    gc.collect()
    torch.cuda.empty_cache()

    # (e) card vs CPU on the reduced configs
    small = {"mla": get_config(MLA_ARCH, reduced=True),
             "moe": get_config(MOE_ARCH, reduced=True)}
    small["grouped"] = dataclasses.replace(small["moe"],
                                           moe_dispatch="grouped")
    b, t = 4, 64
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, min(c.vocab_size for c in small.values()),
                          (b, t)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    targets[:, -1] = -1
    trees, thr = {}, {}
    for key, c in small.items():
        m = build_model(c, device="cpu")
        trees[c.name] = bridge.numpy_params(m.spec, seed=0)
        thr[key] = rng.uniform(0.05, 2.0, m.layout.num_groups).astype(
            np.float32)
    train_cuda_vs_cpu(torch, gpu, [
        ("mla_per_layer", "per_layer", "bk", small["mla"], True, 1,
         {"thresholds": thr["mla"]}),
        ("grouped_per_layer", "per_layer", "bk", small["grouped"], True, 1,
         {"thresholds": thr["grouped"]}),
        ("moe_ghost_flat", "ghost_flat", "bk", small["moe"], True, 1,
         {"flat_threshold": np.float32(0.5)})], tokens, targets, trees)
    return launches, mla, moe_bk


# ---------------------------------------------------------------------------
# Phase 15: the contiguous plane, batch mode and the remaining dense configs.
# ---------------------------------------------------------------------------

# (b) batch mode: ragged prompts (seed 1), generated tokens each
BATCH_REQ = dict(n=4, min_len=16, max_len=48, gen=16)
# (c) the sliding-window variant: prompt + gen runs past the ring's slots
# (4 requests, one admission: cut from 8 to fit the time limit)
SWA_REQ = dict(n=4, min_len=48, max_len=96, gen=16, slots=4, cache_len=64)
# (d), (e): (label, arch, layers kept (None: all)); one request set. (e)'s
# depth: 8 layers took the whole script to 1,052 s of its 1,200 (a slow
# host; phase 15 132 s), so it keeps 4
DENSE_DEPTH = 4
DENSE_SERVE = [("minicpm_serve", "minicpm-2b", None),
               ("qwen1_5_serve", "qwen1.5-32b", DENSE_DEPTH),
               ("deepseek_67b_serve", "deepseek-67b", DENSE_DEPTH)]
DENSE_REQ = dict(n_req=6, min_len=16, max_len=32, prefix=16, gen=8, slots=4,
                 page_len=16)
# (e) paged_attn at long contexts, at each served head layout: (label,
# KV, G, head_dim); B = 8 rows of LONG_PAGES pages of 16 (4,096 tokens),
# each row its own pages, every position full, bf16 q and pools
LONG_LAYOUTS = [("qwen3_4b_long", 8, 4, 128), ("minicpm_long", 36, 1, 64),
                ("qwen1_5_long", 40, 1, 128),
                ("deepseek_67b_long", 8, 8, 128)]
LONG_B, LONG_PAGES, LONG_PAGE_LEN = 8, 256, 16
# (f) qwen1.5-32b's layers in training on one card (35.2 B parameters in
# all: 70.4 GB of bf16 weights before gradients and moments)
QWEN15_TRAIN_DEPTH = 4
# (f)'s timed steps a variant, after one warm-up
DENSE_TRAIN_TIMED = 2


def long_inputs(torch, kv, g, hd, seed):
    """A long-context paged_attn input drawn on the card: q (LONG_B, kv,
    g, hd) and two pools of LONG_B x LONG_PAGES pages (+ the trash page),
    a table giving each row its own pages in a random order, every
    position full."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = LONG_B * LONG_PAGES

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q = draw(LONG_B, kv, g, hd)
    kp = draw(n + 1, LONG_PAGE_LEN, kv, hd)
    vp = draw(n + 1, LONG_PAGE_LEN, kv, hd)
    pt = torch.randperm(n, generator=gen, device="cuda").to(
        torch.int32).reshape(LONG_B, LONG_PAGES)
    pos = torch.full((LONG_B,), LONG_PAGES * LONG_PAGE_LEN - 1,
                     dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, pos


def serve_cache_len(req) -> int:
    """serve_model's cache_len for a request set (whole pages)."""
    return -(-(req["prefix"] + req["max_len"] + req["gen"] + 8)
             // req["page_len"]) * req["page_len"]


def engine_run(torch, model, params, reqs, *, gen, slots, cache_len,
               paging="off"):
    """Serve `reqs` through a DecodeEngine with a `Top2` callback and
    every launch counter at 0 before; every request must complete with
    `gen` in-vocabulary tokens. Returns (engine, {"tokens", "top2"},
    launches, ms per serve_step)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.engine import DecodeEngine
    top2 = Top2()
    eng = DecodeEngine(model, params, num_slots=slots, cache_len=cache_len,
                       paging=paging, on_token=top2)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r, max_new_tokens=gen)
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    vocab = model.cfg.vocab_size
    if sorted(done) != list(range(len(reqs))) or not all(
            len(c.tokens) == gen and all(0 <= t < vocab for t in c.tokens)
            for c in done.values()) or top2.tokens != {
                rid: c.tokens for rid, c in done.items()}:
        raise RuntimeError(f"{model.cfg.name}: incomplete or bad tokens")
    return eng, top2.run(), counts, 1e3 * wall / eng.stats["serve_steps"]


def greedy_top2(torch, model, params, prompts, lengths, gen, cache_len,
                prefill):
    """greedy_decode with the top-2 logits (and their indices) of the row
    each token came from: the first from the row's last prompt position,
    the others from the decode steps. Returns ((B, gen) tokens,
    {"tokens", "top2", "top2_idx"})."""
    import dataclasses
    from repro_torch.launch import serve
    calls = []

    def step(p, cache, batch):
        logits, cache = model.serve_step(p, cache, batch)
        calls.append(torch.topk(logits.float(), 2))
        return logits, cache

    toks = serve.greedy_decode(dataclasses.replace(model, serve_step=step),
                               params, prompts, gen, cache_len,
                               prefill=prefill, lengths=lengths)
    p = prompts.shape[1]
    run = {"tokens": {i: row for i, row in enumerate(toks.tolist())}}
    for key, f in (("top2", "values"), ("top2_idx", "indices")):
        got = torch.stack([getattr(c, f) for c in calls]).cpu().numpy()
        run[key] = {i: np.stack([got[int(n) - 1, i]]
                                + [got[p + j - 1, i] for j in range(1, gen)])
                    for i, n in enumerate(lengths.tolist())}
    return toks, run


def phase_dense(torch, gpu, main_run):
    """Phase 15. `main_run`: phase 3's tokens, top-2 logits, cache bytes
    and ms per serve_step. Returns (paged_attn launches of (d) and (e),
    its kernels-line block per path, the training kernels' launches of
    (f), their kernels-line blocks at (f)'s captured shapes)."""
    import dataclasses

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.kernels import clip_reduce as CR
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import paged_attn as K
    from repro_torch.launch import serve
    from repro_torch.launch.inputs import pad_ragged_prompts
    from repro_torch.models.transformer import build_model

    t_phase = t_part = time.perf_counter()
    # (a) phase 3's requests on the contiguous plane
    cfg = dataclasses.replace(get_config("qwen3-4b"),
                              num_layers=QWEN_CUT_DEPTH)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    req = MAIN_REQ
    reqs = serve.build_requests(cfg.vocab_size, req["n_req"],
                                min_len=req["min_len"],
                                max_len=req["max_len"],
                                shared_prefix=req["prefix"], seed=0)
    eng, run, counts, step_ms = engine_run(
        torch, model, params, reqs, gen=req["gen"], slots=req["slots"],
        cache_len=serve_cache_len(req))
    if eng.paged or counts["paged_attn"]:
        raise RuntimeError(f"contiguous plane: paged={eng.paged}, "
                           f"{counts['paged_attn']} paged_attn launches")
    emit({"phase": "dense_contiguous", "gpu": gpu, "part": "a",
          "arch": cfg.name, "num_layers": cfg.num_layers,
          "requests": len(reqs), "slots": req["slots"],
          "cache_len": serve_cache_len(req),
          "ms_per_serve_step": {"contiguous": step_ms,
                                "paged": main_run["ms_per_serve_step"]},
          "cache_bytes": {"contiguous": eng.cache_bytes(),
                          "paged": main_run["cache_bytes"]},
          "stats": eng.stats, "launches": counts,
          "vs_paged": compare_runs("contiguous vs paged", main_run, run,
                                   True),
          "seconds": time.perf_counter() - t_part})
    profile_decode(torch, gpu, model, params, eng, step_ms,
                   label="contiguous")
    del eng

    # (b) batch mode, fused and loop, against the engine
    t_part = time.perf_counter()
    b = BATCH_REQ
    breqs = serve.build_requests(cfg.vocab_size, b["n"], min_len=b["min_len"],
                                 max_len=b["max_len"], shared_prefix=0,
                                 seed=1)
    prompts, lengths = pad_ragged_prompts(breqs)
    prompts = torch.from_numpy(prompts).cuda()
    lengths = torch.from_numpy(lengths).cuda()
    cache_len = b["max_len"] + b["gen"] + 8
    times = {}
    reset_launch_counts()
    for prefill in ("fused", "loop"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, grun = greedy_top2(torch, model, params, prompts, lengths,
                                 b["gen"], cache_len, prefill)
        torch.cuda.synchronize()
        times[prefill] = time.perf_counter() - t0
        if prefill == "fused":
            fused, fused_run = toks, grun
    if not torch.equal(fused, toks):
        raise RuntimeError(f"batch mode: fused {fused.tolist()} != loop "
                           f"{toks.tolist()}")
    batch_launches = launch_counts()["paged_attn"]
    _, erun, counts, _ = engine_run(torch, model, params, breqs,
                                    gen=b["gen"], slots=b["n"],
                                    cache_len=cache_len)
    if batch_launches or counts["paged_attn"]:
        raise RuntimeError("batch mode launched paged_attn")
    emit({"phase": "dense_contiguous", "gpu": gpu, "part": "b",
          "arch": cfg.name, "prompt_lens": lengths.tolist(),
          "gen": b["gen"], "fused_s": times["fused"],
          "loop_s": times["loop"], "fused_equals_loop": True,
          "vs_engine": compare_runs("batch vs engine", fused_run, erun,
                                    True),
          "seconds": time.perf_counter() - t_part})

    # (c) the sliding-window variant: auto keeps it on the ring
    t_part = time.perf_counter()
    swa = dataclasses.replace(get_config("qwen3-4b", variant="swa"),
                              num_layers=QWEN_CUT_DEPTH)
    c = SWA_REQ
    creqs = serve.build_requests(cfg.vocab_size, c["n"], min_len=c["min_len"],
                                 max_len=c["max_len"], shared_prefix=0,
                                 seed=2)
    eng, _, counts, step_ms = engine_run(
        torch, build_model(swa), params, creqs, gen=c["gen"],
        slots=c["slots"], cache_len=c["cache_len"], paging="auto")
    ring = eng.cache["dense_blocks_k"].shape[2]
    wraps = sum(len(r) + c["gen"] > ring for r in creqs)
    if eng.paged or counts["paged_attn"] or ring != c["cache_len"] \
            or not wraps:
        raise RuntimeError(f"swa: paged={eng.paged}, ring {ring}, {wraps} "
                           f"requests past it, {counts['paged_attn']} "
                           f"paged_attn launches")
    emit({"phase": "dense_contiguous", "gpu": gpu, "part": "c",
          "arch": swa.name, "sliding_window": swa.sliding_window,
          "ring_slots": ring, "requests": len(creqs),
          "requests_past_the_ring": wraps, "ms_per_serve_step": step_ms,
          "cache_bytes": eng.cache_bytes(), "paged": eng.paged,
          "seconds": time.perf_counter() - t_part})
    del eng, model, params
    gc.collect()
    torch.cuda.empty_cache()

    # (d), (e) the dense configs on the paged plane; minicpm-2b on the
    # contiguous one too
    bw = bandwidth(gpu)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    blocks, paged_launches = {}, 0
    for label, arch, depth in DENSE_SERVE:
        t_part = time.perf_counter()
        dcfg = get_config(arch)
        extra = {"label": label}
        if depth is not None:
            extra["depth_cut"] = {
                "num_layers": depth, "of": dcfg.num_layers,
                "why": "full width; the whole model's bf16 weights (70.4 / "
                       "134.8 GB) fit no card, and 8 layers took the "
                       "script past 1,050 s of its 1,200 s limit"}
            dcfg = dataclasses.replace(dcfg, num_layers=depth)
        top2 = Top2()
        launches, snap, model, params, eng, step_ms = serve_model(
            torch, gpu, "dense_serve", dcfg, **DENSE_REQ, on_token=top2,
            **extra)
        paged_launches += launches
        if depth is None:
            reqs = serve.build_requests(
                dcfg.vocab_size, DENSE_REQ["n_req"],
                min_len=DENSE_REQ["min_len"], max_len=DENSE_REQ["max_len"],
                shared_prefix=DENSE_REQ["prefix"], seed=0)
            paged = top2.run()
            ceng, crun, counts, cms = engine_run(
                torch, model, params, reqs, gen=DENSE_REQ["gen"],
                slots=DENSE_REQ["slots"], cache_len=serve_cache_len(DENSE_REQ))
            if ceng.paged or counts["paged_attn"]:
                raise RuntimeError(f"{arch}: the contiguous plane launched "
                                   f"paged_attn")
            emit({"phase": "dense_contiguous", "gpu": gpu, "part": "d",
                  "arch": dcfg.name,
                  "ms_per_serve_step": {"contiguous": cms, "paged": step_ms},
                  "cache_bytes": {"contiguous": ceng.cache_bytes(),
                                  "paged": eng.cache_bytes()},
                  "vs_paged": compare_runs(f"{arch} contiguous vs paged",
                                           paged, crun, True),
                  "seconds": time.perf_counter() - t_part})
            del ceng
        del model, params, eng
        gc.collect()
        torch.cuda.empty_cache()
        q, kp, vp, pt, pos, kw = snap
        row = paged_attn_times(torch, gpu, K, label, q, kp, vp, pt, pos,
                               kw["scale"], vp.shape[-1], bw, flush)
        blocks[label] = {**{k: row[k] for k in SERVE13_KEYS},
                         "launches": launches}
        del snap, q, kp, vp
    # paged_attn at long contexts at each served head layout (qwen3-4b's
    # G = 4 beside G = 1 and G = 8): the split over pages and the ordered
    # combine at the bytes a long context reads
    t_part = time.perf_counter()
    for i, (label, kv, g, hd) in enumerate(LONG_LAYOUTS):
        q, kp, vp, pt, pos = long_inputs(torch, kv, g, hd, seed=i)
        row = paged_attn_times(torch, gpu, K, label, q, kp, vp, pt, pos,
                               1.0 / math.sqrt(hd), hd, bw, flush)
        blocks[label] = {**{k: row[k] for k in SERVE13_KEYS},
                         "plan": row["plan"], "tokens_per_row": int(
                             pt.shape[1] * kp.shape[1])}
        del q, kp, vp, pt, pos
    emit({"phase": "dense_serve_long_s", "gpu": gpu,
          "seconds": time.perf_counter() - t_part})
    del flush
    gc.collect()
    torch.cuda.empty_cache()

    # (f) training: minicpm-2b at full width and depth, qwen1.5-32b cut
    t_part = time.perf_counter()
    train_launches = dict.fromkeys(TRAIN_KERNELS, 0)
    dense = {}
    real_cr = CR.clip_reduce
    for arch, depth, labels in (("minicpm-2b", None, PAIR),
                                ("qwen1.5-32b", QWEN15_TRAIN_DEPTH,
                                 ("per_layer",))):
        tcfg = get_config(arch)
        extra = None
        if depth is not None:
            extra = {"depth_cut": {
                "num_layers": depth, "of": tcfg.num_layers,
                "why": "35.2 B parameters and their Adam state do not fit "
                       "one 80 GB card, and no mesh shards them: the "
                       "sharded engine replicates the parameters at "
                       "compute time, as the reference's"}}
            tcfg = dataclasses.replace(tcfg, num_layers=depth)
        shapes, caps, ms = linear_shapes(tcfg), {}, {}

        def recording_cr(a, g, factors, block_axis="out", shapes=shapes,
                         caps=caps):
            name = shapes.get((a.shape[-1], g.shape[-1]))
            if name is not None and name not in caps:
                caps[name] = (a.cpu(), g.cpu(), factors.cpu())
            return real_cr(a, g, factors, block_axis)

        for label in labels:
            patches = ([(0, CR, "clip_reduce", recording_cr)]
                       if label == "per_layer" else [])
            counts = train_variant(torch, gpu, label, train_args(
                label, arch=arch), ms, patches, cfg=tcfg, profile=False,
                extra=extra, timed=DENSE_TRAIN_TIMED)
            for k in train_launches:
                train_launches[k] += counts[k]
        if sorted(caps) != sorted(shapes.values()):
            raise RuntimeError(f"{arch}: clip_reduce captured {sorted(caps)}"
                               f" of {sorted(shapes.values())}")
        rows = captured_rows(torch, gpu, caps, tcfg.num_layers,
                             {"per_layer": (tuple(caps),
                                            ("ghost_norm", "clip_reduce"))},
                             calls_per_step=linear_calls(tcfg), arch=arch)
        for name, entry in rows.items():
            o = dense.setdefault(name, {"max_abs_err": 0.0,
                                        "max_rel_err": 0.0})
            o[arch] = entry
            for err in ("max_abs_err", "max_rel_err"):
                o[err] = max(o[err], entry[err])
        del caps
        gc.collect()
        torch.cuda.empty_cache()

    emit({"phase": "dense_train_s", "gpu": gpu,
          "seconds": time.perf_counter() - t_part})
    # (g) card against CPU: a training step of qwen1.5-32b reduced with a
    # non-zero QKV bias, and the ring of qwen3-4b reduced swa
    t_part = time.perf_counter()
    qcfg = get_config("qwen1.5-32b", reduced=True)
    qmodel = build_model(qcfg, device="cpu")
    tree = bridge.numpy_params(qmodel.spec, seed=0)
    rng = np.random.default_rng(0)
    qkv = tree["dense_blocks"]["attn"]["qkv"]
    qkv["b"] = (0.5 * rng.standard_normal(qkv["b"].shape)).astype(np.float32)
    tokens = rng.integers(0, qcfg.vocab_size, (4, 64)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    targets[:, -1] = -1
    thr = rng.uniform(0.05, 2.0, qmodel.layout.num_groups).astype(np.float32)
    train_cuda_vs_cpu(torch, gpu, [
        ("qwen1_5_per_layer", "per_layer", "bk", qcfg, True, 1,
         {"thresholds": thr})], tokens, targets, {qcfg.name: tree})
    scfg = get_config("qwen3-4b", reduced=True, variant="swa")
    stree = bridge.numpy_params(build_model(scfg, device="cpu").spec, seed=0)
    sreqs = serve.build_requests(scfg.vocab_size, 6, min_len=8, max_len=24,
                                 shared_prefix=0, seed=0)
    runs = {}
    for dev in ("cuda", "cpu"):
        smodel = build_model(scfg, device=dev)
        _, runs[dev], counts, _ = engine_run(
            torch, smodel, bridge.params_from_numpy(stree, dev), sreqs,
            gen=16, slots=3, cache_len=16, paging="auto")
        if counts["paged_attn"]:
            raise RuntimeError(f"swa ring on {dev} launched paged_attn")
    emit({"phase": "cuda_vs_cpu", "gpu": gpu, "arch": scfg.name,
          "ring_slots": 16, "requests": len(sreqs),
          "requests_past_the_ring": sum(len(r) + 16 > 16 for r in sreqs),
          **compare_runs("swa ring cuda vs cpu", runs["cpu"], runs["cuda"],
                         False),
          "seconds": time.perf_counter() - t_part})
    emit({"phase": "dense_contiguous_s", "gpu": gpu,
          "seconds": time.perf_counter() - t_phase})
    return paged_launches, blocks, train_launches, dense


# phase 16: sharded training on a 2x2 mesh of ranks (data 2, model 2)
SHARDED_MESH = (2, 2)
# qwen3-4b's layers there, of 36: four replicas of the model and its Adam
# state (the reference's sharded engine replicates the parameters at
# compute time) and a one-process oracle share one 80 GB card
SHARDED_DEPTH = 4
SHARDED_STEPS = 2
# label, mode, the kernels whose inputs rank 0 records
SHARDED_VARIANTS = [("per_layer", "per_layer", ("ghost_norm", "clip_reduce")),
                    ("ghost_flat_bk", "ghost_flat", ("scale_contract",)),
                    ("per_group_bk", "per_group", ("scale_contract",))]
# rank 0's first-step grads against the one-process step's: both sides sum
# the same bf16 per-shard clipped sums (the oracle's microbatches are the
# data shards' batches), so they differ where f32 sums in another order
# move a factor or a partial by an f32 step and the bf16 cast by one bf16
# step: rtol one bf16 step (2^-7), atol 1e-3 of the leaf's largest
# magnitude (an element that cancels); the norms² and counts hold to the
# reference's sharded tolerance (tests/sharded_checks.py:56) and exactly
SHARDED_GRAD_RTOL, SHARDED_GRAD_ATOL_FRAC = 2.0 ** -7, 1e-3
SHARDED_NORM_RTOL, SHARDED_NORM_ATOL = 2e-4, 2e-6
SHARDED_TIMEOUT_S = 600


def sharded_argv(mode, *, microbatches=1, mesh=None, backend=None):
    argv = ["--arch", "qwen3-4b", "--clipping", mode, "--execution", "bk",
            "--group-count", str(SHARDED_MESH[1]), "--epsilon", "8",
            "--steps", str(SHARDED_STEPS), "--batch", "8", "--seq", "256",
            "--docs", "64", "--microbatches", str(microbatches),
            "--optimizer", "adam", "--seed", "0"]
    if mesh:
        argv += ["--mesh", mesh, "--dist-backend", backend]
    return argv


def first_clip(keep: dict):
    """An `on_clip` hook (`make_dp_train_step`) that keeps the first
    step's clip result in `keep`, on the device until the step is timed:
    grads by path, norms², counts (before the noise, which is added to
    the grads in place)."""
    from repro_torch.core.spec import tree_leaves
    keep["armed"] = True

    def hook(res, counts):
        if keep.pop("armed", False):
            keep.update(grads={"/".join(p): g.detach().clone()
                               for p, g in tree_leaves(res.grads)},
                        norms=res.norms_sq.detach().clone(),
                        counts=counts.detach().clone())
    return hook


def on_host(keep: dict) -> dict:
    return {"grads": {k: g.cpu() for k, g in keep["grads"].items()},
            "norms": keep["norms"].cpu(), "counts": keep["counts"].cpu()}


def sharded_oracle(torch, label, mode, cfg):
    """The one-process run of a variant (microbatches = the data shards'
    batches): its first step's clip result (grads on the host, norms²,
    counts) and ms per step."""
    from repro_torch.launch import train
    args = train.build_train_parser().parse_args(sharded_argv(
        mode, microbatches=SHARDED_MESH[0]))
    keep: dict = {}
    trainer = train.Trainer(args, cfg=cfg, on_clip=first_clip(keep))
    ms = []
    for i in range(SHARDED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            rec = on_host(keep)
            keep.clear()
    rec["ms"] = ms
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def sharded_contract(entries: list, trace: list, num_leaves: int) -> dict:
    """The Sec. 4 contract read off one step's collective log and trace:
    the clip drivers' model-axis collectives before each microbatch's
    factors (the step entry's `weight_gather`s are weight traffic, as the
    reference classifies them, and are counted apart in `by_site`), the
    `flat_norm_psum`s, the `grad_psum`s and whether each BK one was
    waited after the next leaf's contraction."""
    marks = [i for i, e in enumerate(trace) if e == "factors"]
    ends = [i for i, e in enumerate(trace) if e.startswith("issue loss_psum")]
    before = 0
    for lo, hi in zip([0] + [i + 1 for i in ends[:-1]], marks):
        for e in trace[lo:hi]:
            if e.startswith("issue "):
                c = entries[int(e.split("#")[1])]
                before += "model" in c[1] and c[0] != "weight_gather"
    flat = [c for c in entries if c[0] == "flat_norm_psum"]
    grad = [i for i, c in enumerate(entries) if c[0] == "grad_psum"]
    contracts = [i for i, e in enumerate(trace) if e.startswith("contract ")]
    interleaved = None
    if contracts:
        interleaved = True
        for n, i in enumerate(grad):
            issue = trace.index(f"issue grad_psum#{i}")
            wait = trace.index(f"wait grad_psum#{i}")
            nxt = contracts[n + 1] if n + 1 < len(grad) else None
            if not (contracts[n] < issue and (nxt is None
                                              or issue < nxt < wait)):
                interleaved = False
    by_site: dict = {}
    for c in entries:
        k = f"{c[0]}@{','.join(c[1])}"
        by_site[k] = by_site.get(k, 0) + 1
    return {"by_site": by_site, "factor_marks": len(marks),
            "model_axis_before_factors": before,
            "flat_norm_psum": [list(c[2:4]) for c in flat],
            "grad_psum": len(grad), "leaves": num_leaves,
            "contractions": len(contracts),
            "interleaved_after_next_contraction": interleaved}


def params_digest(torch, tree, chunk: int = 1 << 24) -> str:
    """A digest of a tree's bits: per leaf the int64 sum and sum of
    squares of its 16- or 32-bit words, computed where the leaf lives,
    `chunk` words at a time."""
    import hashlib
    from repro_torch.core.spec import tree_leaves
    h = hashlib.sha256()
    for path, t in tree_leaves(tree):
        w = t.detach().contiguous().reshape(-1)
        w = w.view(torch.int16 if w.element_size() == 2 else torch.int32)
        total = sq = 0
        for lo in range(0, w.numel(), chunk):
            part = w[lo: lo + chunk].long()
            total += int(part.sum())
            sq += int((part * part).sum())
        h.update("/".join(path).encode())
        h.update(repr((total, sq)).encode())
    return h.hexdigest()


def input_recorder(name, real, caps):
    """`real` (a kernel's wrapper) that first keeps, on the host, the
    inputs of its first call at each (din, dout)."""
    def rec(a, g, *rest, **kw):  # ghost_norm takes no factors
        key = (name, a.shape[-1], g.shape[-1])
        if key not in caps:
            caps[key] = (a.detach().cpu(), g.detach().cpu(),
                         rest[0].detach().cpu() if rest else None)
        return real(a, g, *rest, **kw)
    return rec


def sharded_rank(runs: list, num_layers: int, out_dir: str) -> dict:
    """Phase 16 on one rank, in a child process of `launch.mesh.spawn`:
    each run (label, train CLI argv with --mesh, the kernels whose inputs
    rank 0 records) through `train.Trainer` on qwen3-4b cut to
    `num_layers`, its steps timed, with every launch counter set to 0
    before each step and read after. Rank 0 writes the first step's clip
    result (global grads, its norms², the counts; the Trainer's `on_clip`
    hook) and, of the runs that ask for it, the kernels' first inputs
    (their wrappers swapped for `input_recorder`s during that step, as
    `train_variant` records them) to `out_dir`. Returns per run: ms,
    launches and the collective contract per step, the thresholds and a
    params digest at the end, and this rank's device."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.spec import tree_leaves
    from repro_torch.kernels import bk as KB
    from repro_torch.kernels import clip_reduce as CR
    from repro_torch.kernels import ghost_norm as GN
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    wrappers = {"ghost_norm": GN, "clip_reduce": CR, "scale_contract": KB}
    mesh = None
    out = {}

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    for label, argv, capture in runs:
        args = train.build_train_parser().parse_args(argv)
        if mesh is None:
            mesh = train.setup_mesh(args)
        main = mesh.rank == 0
        cfg = dataclasses.replace(get_config(args.arch), num_layers=num_layers)
        keep: dict = {}
        caps: dict = {}
        patches = [(wrappers[n], n, input_recorder(
            n, getattr(wrappers[n], n), caps)) for n in capture if main]
        trainer = train.Trainer(args, cfg=cfg, mesh=mesh,
                                on_clip=first_clip(keep) if main else None)
        num_leaves = len(list(tree_leaves(trainer.params)))
        steps = []
        for i in range(args.steps):
            now = patches if i == 0 else []  # only the first step's
            swapped = [(m, a, getattr(m, a)) for m, a, _ in now]
            for m, a, fn in now:
                setattr(m, a, fn)
            try:
                mesh.reset_log()
                reset_launch_counts()
                sync()
                mesh.barrier()
                t0 = time.perf_counter()
                met = trainer.step()
                sync()
                ms = 1e3 * (time.perf_counter() - t0)
            finally:
                for m, a, fn in swapped:
                    setattr(m, a, fn)
            steps.append({
                "ms": ms, "launches": launch_counts(),
                "metrics": [float(x) for x in met],
                "contract": sharded_contract(
                    [tuple(c) for c in mesh.log], list(mesh.trace),
                    num_leaves)})
            if i == 0 and main:
                torch.save(on_host(keep),
                           os.path.join(out_dir, f"{label}_clip.pt"))
                keep.clear()
                if caps:
                    torch.save(caps, os.path.join(out_dir,
                                                  f"{label}_caps.pt"))
                    caps.clear()
        out[label] = {
            "steps": steps, "device": str(mesh.device),
            "thresholds": trainer.dp_state.qstate.thresholds.cpu().tolist(),
            "digest": params_digest(torch, trainer.global_params()),
            "coords": dict(mesh.coords)}
        del trainer
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def sharded_parity(torch, label, want, got_path, b_local):
    """Rank 0's first-step clip result against the one-process step's:
    (line, within tolerance)."""
    got = torch.load(got_path, weights_only=False)
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0, "unequal": 0,
             "elements": 0, "violations": 0}
    for name, w in want["grads"].items():
        g = got["grads"][name].cuda().float()
        w = w.cuda().float()
        err = (g - w).abs()
        top = float(w.abs().max())
        tol = SHARDED_GRAD_RTOL * w.abs() + SHARDED_GRAD_ATOL_FRAC * top
        worst["violations"] += int((err > tol).sum())
        worst["unequal"] += int((err > 0).sum())
        worst["elements"] += w.numel()
        worst["max_abs_err"] = max(worst["max_abs_err"], float(err.max()))
        worst["max_rel_err"] = max(worst["max_rel_err"],
                                   float(err.max()) / max(top, 1e-30))
        del g, w, err, tol
    n_got, n_want = got["norms"].float(), want["norms"][:, :b_local].float()
    norm_rel = float(((n_got - n_want).abs() / n_want.abs().clamp_min(
        1e-30)).max())
    norms_ok = bool(torch.allclose(n_got, n_want, rtol=SHARDED_NORM_RTOL,
                                   atol=SHARDED_NORM_ATOL))
    counts = got["counts"].tolist()
    want_counts = (None if want["counts"] is None
                   else want["counts"].tolist())
    counts_ok = want_counts is None or counts == want_counts
    ok = worst["violations"] == 0 and norms_ok and counts_ok
    return {"variant": label, "grads": worst, "norms_max_rel_err": norm_rel,
            "norms_bitwise": bool(torch.equal(n_got, n_want)),
            "counts": counts, "oracle_counts": want_counts,
            "tol": {"grads_rtol": SHARDED_GRAD_RTOL,
                    "grads_atol_of_max": SHARDED_GRAD_ATOL_FRAC,
                    "norms_rtol": SHARDED_NORM_RTOL,
                    "norms_atol": SHARDED_NORM_ATOL}}, ok


def sharded_kernel_checks(torch, gpu, caps_path, label):
    """Each recorded kernel input of rank 0 against the kernel's plain
    version (phase 6's tolerances); scale_contract's stack slices whose
    factor row is all zero (groups another model shard owns) must come
    back exactly zero. Returns rows."""
    caps = torch.load(caps_path, weights_only=False)
    impls = train_impls()
    rows = []
    for (name, din, dout), (a, g, f) in sorted(caps.items()):
        a, g = a.cuda(), g.cuda()
        f = None if f is None else f.cuda()
        kern, plain = impls[name]
        got, want = kern(a, g, f), plain(a, g, f)
        torch.cuda.synchronize()
        err, rel, ok = sum_check(torch, got, want)
        row = {"variant": label, "kernel": name, "a": list(a.shape),
               "g": list(g.shape), "dtype": str(a.dtype),
               "max_abs_err": err, "max_rel_err": rel, "ok": ok}
        if name == "scale_contract":
            zero = (f == 0).all(dim=-1)  # (S,) slices of unowned groups
            row["zero_factor_slices"] = int(zero.sum())
            row["zero_slices_exact"] = bool(
                int(torch.count_nonzero(got[zero])) == 0)
            ok = ok and row["zero_slices_exact"]
            row["ok"] = ok
        rows.append(row)
        if not ok:
            raise RuntimeError(f"phase 16: {name} disagrees with its plain "
                               f"version at rank 0's inputs: {row}")
        del a, g, f, got, want
    return rows


def phase_sharded(torch, gpu):
    """Phase 16. Returns the launches by kernel over every rank and step,
    and the kernels' worst errors at rank 0's inputs."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.perf_counter()
    full = get_config("qwen3-4b")
    cfg = dataclasses.replace(full, num_layers=SHARDED_DEPTH)
    depth_cut = {"num_layers": SHARDED_DEPTH, "of": full.num_layers,
                 "why": "four replicas of the model and its Adam state (the "
                        "sharded engine replicates parameters at compute "
                        "time, as the reference's) and a one-process oracle "
                        "share one 80 GB card"}
    d, m = SHARDED_MESH
    world = d * m
    # (a) the one-process oracle of each variant, then its memory freed
    t_part = time.perf_counter()
    oracle = {label: sharded_oracle(torch, label, mode, cfg)
              for label, mode, _ in SHARDED_VARIANTS}
    oracle_s = time.perf_counter() - t_part
    # (b) the mesh through the train CLI's Trainer: NCCL with a card per
    # rank, else gloo with every rank on cuda:0
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= world else "gloo"
    work = tempfile.mkdtemp(prefix="smoke_sharded_")
    runs = [(label, sharded_argv(mode, mesh=f"{d}x{m}", backend=backend),
             capture) for label, mode, capture in SHARDED_VARIANTS]
    t_part = time.perf_counter()
    try:
        ranks = mesh_lib.spawn(
            "chip_smoke:sharded_rank", world, backend=backend,
            device="cuda", timeout_s=SHARDED_TIMEOUT_S, store_dir=work,
            args=(runs, SHARDED_DEPTH, work), pg_timeout_s=300,
            extra_paths=(ROOT,))
        spawn_s = time.perf_counter() - t_part
        emit({"phase": "sharded_backend", "gpu": gpu, "backend": backend,
              "cards": cards, "world": world, "mesh": f"{d}x{m}",
              "devices": {r: res[runs[0][0]]["device"]
                          for r, res in enumerate(ranks)},
              "coords": {r: res[runs[0][0]]["coords"]
                         for r, res in enumerate(ranks)}})
        launches = dict.fromkeys(TRAIN_KERNELS, 0)
        kernels: dict = {}
        for label, mode, capture in SHARDED_VARIANTS:
            # clip-level parity at the first step
            line, ok = sharded_parity(torch, label, oracle[label],
                                      os.path.join(work, f"{label}_clip.pt"),
                                      8 // d)
            emit({"phase": "sharded_parity", "gpu": gpu, **line})
            if not ok:
                raise RuntimeError(f"phase 16: {label} misses the "
                                   f"one-process step: {line}")
            # every rank ends with the same thresholds and parameters
            thr = {tuple(res[label]["thresholds"]) for res in ranks}
            dig = {res[label]["digest"] for res in ranks}
            emit({"phase": "sharded_ranks_agree", "gpu": gpu,
                  "variant": label, "steps": SHARDED_STEPS,
                  "thresholds": ranks[0][label]["thresholds"][:4],
                  "num_thresholds": len(ranks[0][label]["thresholds"]),
                  "thresholds_equal": len(thr) == 1,
                  "params_digest": ranks[0][label]["digest"][:16],
                  "digests_equal": len(dig) == 1})
            if len(thr) != 1 or len(dig) != 1:
                raise RuntimeError(f"phase 16: {label}: ranks disagree "
                                   f"after {SHARDED_STEPS} steps")
            # the collective log: the Sec. 4 contract on every rank, step
            per_step = expected_launches(label, cfg, batch=8 // d)
            for r, res in enumerate(ranks):
                for s, step in enumerate(res[label]["steps"]):
                    c = step["contract"]
                    bad = []
                    # ghost_flat's one is its flat_norm_psum
                    if c["model_axis_before_factors"] != (
                            1 if mode == "ghost_flat" else 0):
                        bad.append("model-axis collectives before the "
                                   "factors")
                    if mode == "ghost_flat" and c["flat_norm_psum"] != [
                            ["float32", 8 // d]]:
                        bad.append("not one (B_local,) f32 flat_norm_psum")
                    if mode != "ghost_flat" and c["flat_norm_psum"]:
                        bad.append("a flat_norm_psum")
                    if c["grad_psum"] != c["leaves"]:
                        bad.append("not one grad_psum per leaf")
                    if mode != "per_layer" and not (
                            c["contractions"] == c["leaves"]
                            and c["interleaved_after_next_contraction"]):
                        bad.append("the epilogue's all-reduces not waited "
                                   "after the next contraction")
                    got = {k: step["launches"][k] for k in per_step}
                    if got != per_step:
                        bad.append(f"launches {got}, expected {per_step}")
                    if bad:
                        raise RuntimeError(f"phase 16: {label} rank {r} "
                                           f"step {s}: {bad}: {c}")
                    for k in launches:
                        launches[k] += step["launches"][k]
            c0 = ranks[0][label]["steps"][0]["contract"]
            emit({"phase": "sharded_collectives", "gpu": gpu,
                  "variant": label, "rank": 0, **c0,
                  "launches_per_rank_step": per_step,
                  "checked": f"{world} ranks x {SHARDED_STEPS} steps"})
            ms = [[step["ms"] for step in res[label]["steps"]]
                  for res in ranks]
            emit({"phase": "sharded_train", "gpu": gpu, "variant": label,
                  "arch": cfg.name, "depth_cut": depth_cut,
                  "backend": backend, "batch": 8, "seq": 256,
                  "ms_per_step_by_rank": ms,
                  "ms_per_step": [max(col) for col in zip(*ms)],
                  "oracle_ms_per_step": oracle[label]["ms"],
                  "losses": [step["metrics"][0]
                             for step in ranks[0][label]["steps"]]})
            if capture:
                for row in sharded_kernel_checks(
                        torch, gpu, os.path.join(work, f"{label}_caps.pt"),
                        label):
                    emit({"phase": "sharded_kernel_vs_plain", "gpu": gpu,
                          **row})
                    o = kernels.setdefault(row["kernel"], {
                        "max_abs_err": 0.0, "max_rel_err": 0.0, "shapes": 0})
                    o["max_abs_err"] = max(o["max_abs_err"],
                                           row["max_abs_err"])
                    o["max_rel_err"] = max(o["max_rel_err"],
                                           row["max_rel_err"])
                    o["shapes"] += 1
        for name in ("ghost_norm", "clip_reduce", "scale_contract"):
            if name not in kernels or not launches[name]:
                raise RuntimeError(f"phase 16: {name} was not launched and "
                                   f"checked on the sharded path")
            kernels[name]["launches"] = launches[name]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "sharded_s", "gpu": gpu, "backend": backend,
          "oracle_s": oracle_s, "spawn_s": spawn_s,
          "seconds": time.perf_counter() - t_phase})
    return launches, kernels


# ---------------------------------------------------------------------------
# Phase 17: DP-LoRA.
# ---------------------------------------------------------------------------

LORA_RANK = 8
# (label, --clipping, --execution, the variant whose launch table applies)
LORA_VARIANTS = [("lora_per_layer", "per_layer", "bk", "per_layer"),
                 ("lora_ghost_flat_bk", "ghost_flat", "bk", "ghost_flat_bk")]
LORA_TIMED = 2
# the adapters' kernels at the captured r, and at a narrower one (a bf16
# row of r = 4 is 8 bytes: staged loads, not TMA)
LORA_NARROW = 4
LORA_KERNELS = ("ghost_norm", "clip_reduce", "scale_contract")
# (d): qwen3-4b's layers in the service and its serving engine, of 36: at
# phase 3's 6 layers phase 17 took 101 s of its 90 s (the serving and the
# alone runs 44 s, host-bound a layer at a time); at 2 it took 59 s, and
# at 1 a slice of a one-layer stack is all the card would check
LORA_DEPTH = 2
LORA_SERVICE_ARGV = SERVICE_ARGV + ["--lora-rank", str(LORA_RANK)]
# (e): deepseek-v3's tenants at its 3 dense layers
LORA_MLA_REQ = dict(n_req=8, min_len=16, max_len=48, prefix=16, gen=8,
                    slots=4, page_len=16)


def lora_adapter(torch, spec, seed, scale=0.02):
    """A seeded adapter tree for a LoRA spec subtree, a and b both normal
    (a fresh adapter's b is zero): a delta that changes the tokens."""
    from repro_torch.core.spec import _walk
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out: dict = {}
    for path, p in _walk(spec):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (scale * torch.randn(
            tuple(p.shape), generator=gen, device="cuda")).to(p.dtype)
    return out


def lora_train(torch, gpu, qwen_ms):
    """(a): qwen3-4b at full width and depth with rank-8 adapters on qkv
    and o, per_layer and ghost_flat by BK through the train CLI's
    `Trainer` (phase 5's settings, 1 warm-up + LORA_TIMED steps). Gates:
    finite losses, the layout's launches, no BK fallback, the frozen
    base's crc32s unchanged after the steps, every adapter leaf moved.
    Returns (launches, the per_layer last step's clip_reduce inputs by
    adapter leaf, the BK last epilogue's scale_contract inputs)."""
    from repro_torch.checkpoint.store import tree_crcs, tree_flatten
    from repro_torch.kernels import bk as SC
    from repro_torch.kernels import clip_reduce as CR

    lms = {"per_layer": qwen_ms.get("per_layer", math.nan),
           "non_private": qwen_ms.get("non_private")}
    caps, sc_caps, base = {}, {}, {}
    real_cr, real_sc = CR.clip_reduce, SC.scale_contract

    def leaf_of(trainer):
        # (din, dout) of each adapter side -> its leaf: a <- (x, s g Bᵀ)
        # (din, r), b <- (x A, s g) (r, dout)
        cfg, out = trainer.cfg, {}
        d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim)
        for proj, din, dout in (("qkv", d, (h + 2 * kv) * hd),
                                ("o", h * hd, d)):
            out[(din, LORA_RANK)] = f"{proj}/a"
            out[(LORA_RANK, dout)] = f"{proj}/b"
        return out

    shapes = {}

    def recording_cr(a, g, factors, block_axis="out"):
        name = shapes.get((a.shape[-1], g.shape[-1]))
        if name is not None and name not in caps:
            caps[name] = (a.clone(), g.clone(), factors.clone())
        return real_cr(a, g, factors, block_axis)

    def recording_sc(a, g, factors):
        name = shapes.get((a.shape[-1], g.shape[-1]))
        if name is not None:
            sc_caps[name] = (a, g, factors)  # the sinks: never rewritten
        return real_sc(a, g, factors)

    def check(trainer):
        shapes.update(leaf_of(trainer))
        params = trainer.params
        frozen = {k: v for k, v in params.items() if k != "lora"}
        t0 = time.perf_counter()
        if not base:
            base["crcs"] = tree_crcs(frozen)
        before = tree_crcs(params["lora"])
        crc_s = time.perf_counter() - t0

        def after(trainer):
            t0 = time.perf_counter()
            now = tree_crcs({k: v for k, v in trainer.params.items()
                             if k != "lora"})
            moved = [x != y for x, y in zip(
                before, tree_crcs(trainer.params["lora"]))]
            if now != base["crcs"]:
                raise RuntimeError("DP-LoRA changed the frozen base: "
                                   f"{sum(x != y for x, y in zip(now, base['crcs']))} "
                                   "leaves differ")
            if not all(moved):
                raise RuntimeError(f"adapters unmoved: {moved}")
            n_lora = sum(t.numel() for t in tree_flatten(trainer.params
                                                         ["lora"]))
            return {"base_leaves": len(now), "base_crcs_unchanged": True,
                    "adapter_leaves_moved": len(moved),
                    "lora_params": n_lora, "lora_rank": LORA_RANK,
                    "crc_s": crc_s + time.perf_counter() - t0}

        return after

    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    last = TRAIN_WARMUP + LORA_TIMED - 1
    # the first step's adapters have b = 0 (so s g Bᵀ = 0): the inputs
    # come from the last step
    patches = {"lora_per_layer": [(last, CR, "clip_reduce", recording_cr)],
               "lora_ghost_flat_bk": [(last, SC, "scale_contract",
                                       recording_sc)]}
    for label, mode, execution, kind in LORA_VARIANTS:
        args = train_args(mode, execution)
        args.lora_rank = LORA_RANK
        args.steps = TRAIN_WARMUP + LORA_TIMED
        counts = train_variant(torch, gpu, label, args, lms,
                               patches[label], kind=kind, profile=False,
                               timed=LORA_TIMED, check=check)
        for k in launches:
            launches[k] += counts[k]
    want = sorted(shapes.values())
    for what, got in (("clip_reduce", caps), ("scale_contract", sc_caps)):
        if sorted(got) != want:
            raise RuntimeError(f"LoRA {what}: captured {sorted(got)} of "
                               f"the adapter leaves {want}")
    emit({"phase": "lora_train_ratio", "gpu": gpu,
          "ms_per_step": {k: lms[k] for k, *_ in LORA_VARIANTS},
          "ratio_vs_nonprivate": {
              k: (lms[k] / lms["non_private"] if lms["non_private"]
                  else None) for k, *_ in LORA_VARIANTS},
          "non_private_ms_phase5": lms["non_private"]})
    return launches, caps, sc_caps


def narrow(a, g, r):
    """The adapter side's operands with its rank-wide one cut to r."""
    if a.shape[-1] == LORA_RANK:
        return a[..., :r].contiguous(), g
    return a, g[..., :r].contiguous()


def lora_kernels(torch, gpu, caps, sc_caps, num_layers):
    """(b): ghost_norm and clip_reduce at each adapter side's captured
    inputs and scale_contract at the BK epilogue's stacked sinks, at r = 8
    and cut to r = LORA_NARROW: against the plain version (rtol 1e-4,
    atol 1e-4 of the largest magnitude), two calls bitwise, the time by
    CUDA graph replay (eager beside it), plain, library and bound ms.
    Returns name -> the kernels line's LoRA block."""
    bw = bandwidth(gpu)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    impl = train_impls()
    out = {}
    jobs = [(name, leaf, caps[leaf], num_layers)
            for leaf in sorted(caps) for name in ("ghost_norm",
                                                  "clip_reduce")]
    jobs += [("scale_contract", leaf, sc_caps[leaf], 1)
             for leaf in sorted(sc_caps)]
    for name, leaf, (a0, g0, f), calls in jobs:
        kern, plain = impl[name]
        for r in (LORA_RANK, LORA_NARROW):
            a, g = narrow(a0, g0, r)
            got, want = kern(a, g, f), plain(a, g, f)
            err, rel, ok = sum_check(torch, got, want)
            if not ok:
                raise RuntimeError(f"LoRA {name} disagrees at {leaf} r = "
                                   f"{r}: max abs err {err}")
            if not torch.equal(got, kern(a, g, f)):
                raise RuntimeError(f"LoRA {name}: two calls at {leaf} r = "
                                   f"{r} differ")
            del got, want
            iters = 3 if name == "scale_contract" else 10
            times = {
                "graph_ms": graph_ms(torch, lambda: kern(a, g, f), iters,
                                     flush),
                "ms": cuda_ms(torch, lambda: kern(a, g, f), iters, 1,
                              flush),
                "plain_ms": cuda_ms(torch, lambda: plain(a, g, f), 3, 1,
                                    flush),
                "library_ms": cuda_ms(torch, lambda: library_sum(
                    torch, name, a, g, f), 3, 1, flush)}
            times["bound_ms"], bound_by = sum_bound(name, a, g, bw)
            row = {"phase": "lora_kernels", "gpu": gpu, "kernel": name,
                   "leaf": leaf, "r": r, "a": list(a.shape),
                   "g": list(g.shape), "dtype": str(a.dtype),
                   "calls_per_step": calls, "max_abs_err": err,
                   "max_rel_err": rel, "bitwise_repeat": True,
                   "tol": {"rtol": SUM_RTOL, "atol_of_max": SUM_ATOL_FRAC},
                   **times, "bound_by": bound_by}
            emit(row)
            o = out.setdefault(name, {"max_abs_err": 0.0,
                                      "max_rel_err": 0.0, "per_step": {},
                                      "shapes": []})
            o["max_abs_err"] = max(o["max_abs_err"], err)
            o["max_rel_err"] = max(o["max_rel_err"], rel)
            step = o["per_step"].setdefault(
                f"r{r}", {**dict.fromkeys(times, 0.0), "calls": 0})
            for k in times:
                step[k] += calls * times[k]
            step["calls"] += calls
            o["shapes"].append({k: row[k] for k in (
                "leaf", "r", "a", "g", "calls_per_step", "max_abs_err",
                *times, "bound_by")})
            del a, g
    return out


def lora_cuda_vs_cpu(torch, gpu):
    """(c): qwen3-4b-reduced and deepseek-v3-reduced in f32 with rank-8
    adapters (a and b drawn, b non-zero) from one numpy tree each: one
    per_layer `dp_clipped_gradients(trainable_key="lora")` on the card
    (kernels) and on the CPU (plain versions) must agree in loss, norms²
    and every adapter gradient (TRAIN_RTOL, TRAIN_ATOL_FRAC); the card
    launches the layout's kernels, the CPU none."""
    import dataclasses

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.core.clipping import dp_clipped_gradients
    from repro_torch.kernels import backend, launch_counts, reset_launch_counts
    from repro_torch.models.transformer import build_model

    b, t = 4, 64
    for arch in ("qwen3-4b", "deepseek-v3-671b"):
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  lora_rank=LORA_RANK)
        rng = np.random.default_rng(0)
        tree = bridge.numpy_params(build_model(cfg, device="cpu").spec,
                                   seed=0)
        for stack in tree["lora"].values():
            for pair in stack.values():
                pair["b"] = (0.05 * rng.standard_normal(pair["b"].shape)
                             ).astype(np.float32)
        tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
        targets = np.roll(tokens, -1, 1)
        targets[:, -1] = -1
        res = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, device=dev)
            thr = torch.from_numpy(np.random.default_rng(1).uniform(
                0.05, 2.0, model.layout.num_groups).astype(np.float32)
            ).to(dev)
            params = bridge.train_params_from_numpy(tree, dev)
            batch = {"tokens": torch.from_numpy(tokens).to(dev),
                     "targets": torch.from_numpy(targets).to(dev)}
            reset_launch_counts()
            with backend.scoped("kernels"):
                out = dp_clipped_gradients(
                    model.loss_fn, params, batch, model.layout,
                    mode="per_layer", batch_size=b, thresholds=thr,
                    trainable_key="lora")
            if dev == "cuda":
                torch.cuda.synchronize()
            res[dev] = (out, {k: launch_counts()[k] for k in TRAIN_KERNELS})
        want_counts = expected_launches("per_layer", cfg)
        if res["cuda"][1] != want_counts or any(res["cpu"][1].values()):
            raise RuntimeError(f"{cfg.name} LoRA: launches cuda="
                               f"{res['cuda'][1]} cpu={res['cpu'][1]}, "
                               f"expected cuda={want_counts}")
        got, want = res["cuda"][0], res["cpu"][0]
        checks = {"loss": (got.loss, want.loss),
                  "norms_sq": (got.norms_sq, want.norms_sq)}
        for (name, x), (_, y) in zip(leaf_items(got.grads),
                                     leaf_items(want.grads)):
            checks["grad:" + name] = (x, y)
        errs, bad = {}, []
        for k, (x, y) in checks.items():
            x, y = x.detach().float().cpu(), y.detach().float().cpu()
            atol = TRAIN_ATOL_FRAC * float(y.abs().max())
            errs[k] = float((x - y).abs().max()
                            / y.abs().max().clamp_min(1e-30))
            if not torch.allclose(x, y, rtol=TRAIN_RTOL, atol=atol):
                bad.append(k)
        emit({"phase": "lora_cuda_vs_cpu", "gpu": gpu, "arch": cfg.name,
              "lora_rank": LORA_RANK, "mode": "per_layer", "batch": b,
              "seq": t, "groups": len(list(leaf_items(got.grads))) // 2,
              "max_err_over_max": errs,
              "tol": {"rtol": TRAIN_RTOL, "atol_of_max": TRAIN_ATOL_FRAC},
              "cuda_launches": res["cuda"][1]})
        if bad:
            raise RuntimeError(f"{cfg.name} LoRA card vs CPU: {bad}")


def leaf_items(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaf_items(tree[k], prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), tree[k]


def tenant_tokens(torch, model, base, reqs, owners, adapters, *, gen,
                  slots, cache_len, page_len, single=None):
    """Tokens of the requests `owners` maps to one tenant, served ALONE by
    a fresh engine: multi-tenant with that one adapter tree, or (`single`)
    the single-model engine."""
    from repro_torch.launch.engine import DecodeEngine
    kw = dict(num_slots=slots, cache_len=cache_len, page_len=page_len)
    if single:
        eng = DecodeEngine(model, base, **kw)
        rids = {eng.submit(reqs[i], max_new_tokens=gen): i for i in owners}
    else:
        eng = DecodeEngine(model, base, max_tenants=1, **kw)
        t = eng.add_tenant(adapters)
        rids = {eng.submit(reqs[i], max_new_tokens=gen, tenant=t): i
                for i in owners}
    done = eng.run()
    return {i: done[rid].tokens for rid, i in rids.items()}


def lora_service_serve(torch, gpu):
    """(d): the training service on qwen3-4b at full width, LORA_DEPTH of
    36 layers, rank-8 adapters, per_layer, 4 steps, a checkpoint and an
    adapter publish every 2 (steps 2 and 4). One multi-tenant engine at the
    same depth serves phase 3's 16 requests round-robin over the base
    tenant, the step-2 publish (loaded into the template, its installed
    crcs equal to the manifest's) and a seeded adapter; after the first
    pool step an `AdapterWatcher` installs the step-4 publish mid-decode
    (crcs equal to the manifest's). Before it, the single-model engine
    serves the same 16 requests at the same depth, timed beside it (the
    tenant plane's wall less the swap's poll, `swap_s`).
    Gates: the requests of each tenant equal that tenant served alone
    (the in-flight ones on the step-2 adapter, the later ones on step
    4's; the base tenant's the single-model engine's); paged_attn
    launched once a layer a serve_step; one adapter storage. Returns
    (training launches, the multi-tenant run's paged_attn launches)."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint.store import (load_checkpoint,
                                              manifest_crcs)
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve, service
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.swap import AdapterWatcher
    from repro_torch.models.transformer import unstack_blocks

    work = os.path.join(ROOT, "build", "smoke_lora")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()

    args = service.build_service_parser().parse_args(
        ["--service-dir", work, *LORA_SERVICE_ARGV])
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=LORA_DEPTH)
    reset_launch_counts()
    svc = service.TrainService(args, runtime=service.build_runtime(
        args, cfg=cfg))
    svc.run()
    runtime = svc.runtime
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    per_step = expected_launches("per_layer", runtime.cfg)
    counts = launch_counts()
    train_launches = {k: counts[k] for k in TRAIN_KERNELS}
    if train_launches != {k: 4 * v for k, v in per_step.items()}:
        raise RuntimeError(f"LoRA service launches {train_launches}, "
                           f"expected 4 x {per_step}")
    publish = svc.publish_dir
    published = sorted(int(d.split("_")[1]) for d in os.listdir(publish)
                       if d.startswith("step_"))
    if published != [2, 4]:
        raise RuntimeError(f"LoRA service published {published}")
    eps = {s: service_meta_eps(publish, s) for s in published}

    model = runtime.model
    base = unstack_blocks({k: v for k, v in svc.params.items()
                           if k != "lora"})
    del svc
    req = MAIN_REQ
    reqs = serve.build_requests(cfg.vocab_size, req["n_req"],
                                min_len=req["min_len"],
                                max_len=req["max_len"],
                                shared_prefix=req["prefix"], seed=0)
    page_len, slots, gen = req["page_len"], req["slots"], req["gen"]
    cache_len = -(-(req["prefix"] + req["max_len"] + gen + 8)
                  // page_len) * page_len
    eng = DecodeEngine(model, base, num_slots=slots, cache_len=cache_len,
                       page_len=page_len, max_tenants=4)
    v1 = load_checkpoint(publish, 2, {"lora": eng.adapter_template()},
                         verify=True)["lora"]
    other = lora_adapter(torch, model.spec["lora"], seed=5)
    t_base = eng.add_tenant(name="base")
    t_pub = eng.add_tenant(v1, name="published")
    t_rand = eng.add_tenant(other, name="seeded")
    if eng.adapter_crcs(t_pub) != manifest_crcs(publish, 2):
        raise RuntimeError("the step-2 adapter's crcs differ from its "
                           "manifest's")
    tids = (t_base, t_pub, t_rand)
    owner = {i: tids[i % 3] for i in range(len(reqs))}
    # the single-model engine on the same requests: its ms a serve_step
    # beside the tenant plane's, and the base tenant's tokens alone
    single = DecodeEngine(model, base, num_slots=slots, cache_len=cache_len,
                          page_len=page_len)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    srid = {single.submit(r, max_new_tokens=gen): i
            for i, r in enumerate(reqs)}
    sdone = single.run()
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    single_steps = single.stats["serve_steps"]
    single_pa = launch_counts()["paged_attn"]
    if single_pa != cfg.num_layers * single_steps:
        raise RuntimeError(f"single-model serving: paged_attn launched "
                           f"{single_pa} times for {single_steps} "
                           f"serve_steps")
    single_tokens = {i: sdone[rid].tokens for rid, i in srid.items()}
    del single, sdone
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rid_of = {eng.submit(r, max_new_tokens=gen, tenant=owner[i]): i
              for i, r in enumerate(reqs)}
    pub = [i for i in range(len(reqs)) if owner[i] == t_pub]
    for _ in range(64):  # until a request of the tenant decodes on step 2
        eng.step()
        if any(rid_of[rid] in pub for rid in eng.live_requests):
            break
    before = {rid_of[rid] for rid in eng.live_requests + list(
        eng.completions())}
    torch.cuda.synchronize()
    ts = time.perf_counter()
    swap = AdapterWatcher(eng, t_pub, publish).poll()
    swap_s = time.perf_counter() - ts
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - swap_s
    pa = launch_counts()["paged_attn"]
    st = eng.stats
    if swap is None or swap.step != 4:
        raise RuntimeError(f"the hot swap did not install step 4: {swap}")
    if eng.adapter_crcs(t_pub) != manifest_crcs(publish, 4):
        raise RuntimeError("the swapped adapter's crcs differ from step 4's "
                           "manifest")
    if pa != cfg.num_layers * st["serve_steps"]:
        raise RuntimeError(f"LoRA serving: paged_attn launched {pa} times "
                           f"for {st['serve_steps']} serve_steps of "
                           f"{cfg.num_layers} layers")
    if len(eng.adapter_storages) != 1:
        raise RuntimeError(f"the adapter buffer moved: "
                           f"{len(eng.adapter_storages)} storages")
    mixed = {i: done[rid].tokens for rid, i in rid_of.items()}
    v2 = load_checkpoint(publish, 4, {"lora": eng.adapter_template()},
                         verify=True)["lora"]
    base_idx = [i for i in mixed if owner[i] == t_base]
    diff = [i for i in base_idx if single_tokens[i] != mixed[i]]
    if diff:
        raise RuntimeError(f"LoRA serving base: requests {diff} mixed != "
                           f"the single-model engine's")
    groups = {"step2_inflight": ([i for i in pub if i in before], v1),
              "step4_after_swap": ([i for i in pub if i not in before], v2),
              "seeded": ([i for i in mixed if owner[i] == t_rand], other)}
    t1 = time.perf_counter()
    alone_eq = {"base": len(base_idx)}
    for label, (idx, ad) in groups.items():
        if not idx:
            raise RuntimeError(f"LoRA serving: no request in {label}")
        alone = tenant_tokens(torch, model, base, reqs, idx, ad, gen=gen,
                              slots=slots, cache_len=cache_len,
                              page_len=page_len)
        alone_eq[label] = len(idx)
        diff = [i for i in idx if alone[i] != mixed[i]]
        if diff:
            raise RuntimeError(f"LoRA serving {label}: requests {diff} "
                               f"mixed != alone")
    alone_s = time.perf_counter() - t1
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "lora_service_serve", "gpu": gpu, "arch": cfg.name,
          "depth_cut": {"num_layers": LORA_DEPTH, "of": 36},
          "lora_rank": LORA_RANK, "published_steps": published,
          "published_epsilon": eps, "train_s": train_s,
          "train_launches": train_launches,
          "tenants": {"base": len(base_idx),
                      "published": len(pub),
                      "seeded": len(groups["seeded"][0])},
          "swap": {"step": swap.step, "version": swap.version,
                   "inflight_requests": len(groups["step2_inflight"][0])},
          "crcs_equal_manifest": True, "alone_equal_mixed": alone_eq,
          "serve_wall_s": wall, "swap_s": swap_s, "alone_s": alone_s,
          "ms_per_serve_step": 1e3 * wall / st["serve_steps"],
          "serve_steps": st["serve_steps"], "paged_attn": pa,
          "single_model": {"serve_wall_s": single_wall,
                           "ms_per_serve_step":
                               1e3 * single_wall / single_steps,
                           "serve_steps": single_steps,
                           "paged_attn": single_pa},
          "adapter_bytes": eng.adapter_bytes(),
          "adapter_storages": len(eng.adapter_storages),
          "stats": st})
    del eng, base, model, runtime
    gc.collect()
    torch.cuda.empty_cache()
    return train_launches, pa


def service_meta_eps(directory, step):
    from repro_torch.checkpoint.store import load_manifest
    return load_manifest(directory, step)["meta"]["epsilon"]


def lora_mla_tenants(torch, gpu):
    """(e): deepseek-v3 at full width, its MLA_TRAIN_DEPTH dense layers,
    rank-8 adapters on kv_b and o: LORA_MLA_REQ's requests round-robin
    over the base and two seeded adapters, then each tenant alone. Gates:
    mixed equals alone (the base tenant the single-model engine), through
    paged_attn's latent branch once a layer a serve_step. Returns the
    paged_attn launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(get_config(MLA_ARCH),
                              num_layers=MLA_TRAIN_DEPTH,
                              lora_rank=LORA_RANK)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    base = {k: v for k, v in params.items() if k != "lora"}
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    r = LORA_MLA_REQ
    reqs = serve.build_requests(cfg.vocab_size, r["n_req"],
                                min_len=r["min_len"], max_len=r["max_len"],
                                shared_prefix=r["prefix"], seed=0)
    cache_len = -(-(r["prefix"] + r["max_len"] + r["gen"] + 8)
                  // r["page_len"]) * r["page_len"]
    kw = dict(gen=r["gen"], slots=r["slots"], cache_len=cache_len,
              page_len=r["page_len"])
    ads = [lora_adapter(torch, model.spec["lora"], seed=s) for s in (7, 8)]
    eng = DecodeEngine(model, base, num_slots=r["slots"],
                       cache_len=cache_len, page_len=r["page_len"],
                       max_tenants=3)
    tids = (eng.add_tenant(), eng.add_tenant(ads[0]), eng.add_tenant(ads[1]))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rid_of = {eng.submit(q, max_new_tokens=r["gen"], tenant=tids[i % 3]): i
              for i, q in enumerate(reqs)}
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pa = launch_counts()["paged_attn"]
    st = eng.stats
    if pa != cfg.num_layers * st["serve_steps"]:
        raise RuntimeError(f"MLA tenants: paged_attn launched {pa} times for "
                           f"{st['serve_steps']} serve_steps")
    mixed = {i: done[rid].tokens for rid, i in rid_of.items()}
    for k, ad in enumerate((None,) + tuple(ads)):
        idx = [i for i in mixed if i % 3 == k]
        alone = tenant_tokens(torch, model, base, reqs, idx, ad,
                              single=ad is None, **kw)
        diff = [i for i in idx if alone[i] != mixed[i]]
        if diff:
            raise RuntimeError(f"MLA tenant {k}: requests {diff} mixed != "
                               f"alone")
    emit({"phase": "lora_mla_tenants", "gpu": gpu, "arch": cfg.name,
          "depth_cut": {"num_layers": MLA_TRAIN_DEPTH, "of": 61},
          "lora_rank": LORA_RANK, "init_params_s": init_s,
          "requests": r["n_req"], "slots": r["slots"], "tenants": 3,
          "alone_equal_mixed": True, "serve_wall_s": wall,
          "ms_per_serve_step": 1e3 * wall / st["serve_steps"],
          "serve_steps": st["serve_steps"], "paged_attn": pa,
          "adapter_bytes": eng.adapter_bytes(),
          "adapter_storages": len(eng.adapter_storages),
          "first_tokens": {str(k): mixed[k][:4] for k in range(3)}})
    del eng, base, model
    gc.collect()
    torch.cuda.empty_cache()
    return pa


def phase_lora(torch, gpu, qwen_ms):
    """Phase 17. Returns (training kernels' launches over (a) and (d),
    paged_attn's over (d) and (e), name -> the kernels line's LoRA
    block)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    launches, caps, sc_caps = lora_train(torch, gpu, qwen_ms)
    parts = {"train": time.perf_counter() - t0}
    t = time.perf_counter()
    blocks = lora_kernels(torch, gpu, caps, sc_caps,
                          get_config("qwen3-4b").num_layers)
    del caps, sc_caps
    gc.collect()
    torch.cuda.empty_cache()
    parts["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    lora_cuda_vs_cpu(torch, gpu)
    parts["cuda_vs_cpu"] = time.perf_counter() - t
    t = time.perf_counter()
    svc_launches, pa = lora_service_serve(torch, gpu)
    parts["service_serve"] = time.perf_counter() - t
    for k in launches:
        launches[k] += svc_launches[k]
    t = time.perf_counter()
    pa += lora_mla_tenants(torch, gpu)
    parts["mla_tenants"] = time.perf_counter() - t
    emit({"phase": "lora", "gpu": gpu, "seconds": parts,
          "phase_s": time.perf_counter() - t0, "launches": launches,
          "paged_attn": pa})
    return launches, pa, blocks


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
    launches, snap, main_run = phase_main_path(torch, gpu)
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
    # phase 13: paged_attn on granite's and deepseek-v3's serving paths
    for label, block in phase_moe_mla_serve(torch, gpu).items():
        kernel[label] = block
        kernel["launches"] += block["launches"]
        for err in ("max_abs_err", "max_rel_err"):
            kernel[err] = max(kernel[err], block[err])
    clock("moe and mla serving")
    mm_launches, mla, moe_bk = phase_moe_mla_train(torch, gpu, moe_ms)
    clock("moe and mla training")
    # phase 15: the contiguous plane, batch mode, the dense configs
    d_launches, d_serve, d_train_launches, dense = phase_dense(torch, gpu,
                                                               main_run)
    kernel["dense_serve"] = d_serve
    kernel["launches"] += d_launches
    for block in d_serve.values():
        for err in ("max_abs_err", "max_rel_err"):
            kernel[err] = max(kernel[err], block[err])
    clock("dense and contiguous")
    # phase 16: sharded training on a 2x2 mesh of ranks
    gc.collect()
    torch.cuda.empty_cache()
    s_launches, sharded = phase_sharded(torch, gpu)
    clock("sharded training")
    # phase 17: DP-LoRA training, the kernels at the adapters' shapes,
    # the service's publish, multi-tenant serving with a hot swap
    gc.collect()
    torch.cuda.empty_cache()
    l_launches, l_paged, lora = phase_lora(torch, gpu, qwen_ms)
    kernel["launches"] += l_paged
    clock("dp-lora")
    # the training kernels' launches over every training path; the worst
    # error over every path's inputs, granite's, naive_flat's, the
    # T = 4096 path's, deepseek-v3's and granite's BK epilogue's times
    # beside qwen3-4b's
    for k in train_kernels + [fused]:
        k["launches"] = sum(run[k["name"]] for run in (
            train_launches, moe_launches, scale_launches, service_launches,
            mm_launches, d_train_launches, s_launches, l_launches))
        for key, extra in (("moe", moe), ("naive_flat", naive),
                           ("long_context", long), ("mla_train", mla),
                           ("moe_bk", moe_bk), ("dense_train", dense),
                           ("sharded", sharded), ("lora", lora)):
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

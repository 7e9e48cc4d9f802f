"""Paged-gather one-token GQA / MLA decode attention.

The counterpart of `repro.kernels.paged_attn` (the TPU kernel) and of
`repro.kernels.ref.paged_attn_ref` (its plain version). Shapes:

  q:     (B, KV, G, dq)   post-RoPE, unscaled query, G = heads per KV head
  kpool: (N, L, KV, dq)   one layer's physical page pool, contiguous
  vpool: (N, L, KV, dvp)  value pool; may be the same tensor as kpool, with
                          the value read truncated to `dv` (dv <= dvp)
  pt:    (B, P) int32     page table; every entry in [0, N) (unallocated
                          entries point at a trash page the mask discards)
  pos:   (B,)   int32     index of the newest written token, >= 0
  out:   (B, KV, G, dv)   float32

q is float32 or bfloat16; kpool and vpool share one of those types, which
need not be q's. dq <= 576 and dv <= 512 cover MLA's latent decode: the
reference hands its 3-D latent pool (N, L, kv_lora_rank + rope) to its
kernel as both pools (`src/repro/models/attention.py:573-575`, dq = 576,
dv = 512, an f32 query over a pool in the model's dtype); this port's
contract stays 4-D, so MLA's decode passes `latpool.unsqueeze(2)`, KV = 1,
as kpool and vpool alike.

`paged_attn` is the wrapper. A CPU tensor goes to `paged_attn_ref`; a CUDA
tensor goes to the hand-written kernel `csrc/paged_attn.cu` or raises.
There is no fallback from one to the other. `launches` counts the
wrapper's kernel calls (each launches the split kernel and its combine).
`plan` splits the work over the context from the shapes alone: the host
never reads `pos`, so a call can be captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_DQ = 576  # largest dq the kernel takes (MLA: kv_lora_rank 512 + rope 64)
MAX_DV = 512  # largest dv
MAX_SMEM = 232_448  # bytes of shared memory one Hopper block may use
SMS = 132  # streaming multiprocessors of an H100
WARPS = 4  # warps of a block; each owns `heads_per_warp` heads
TILE = 16  # cache rows per stage of the shared-memory ring
ROWS_SCORED = 16  # rows a warp scores at once
MIN_ROWS = 64  # fewest rows a split walks, unless the context is shorter
WAVES = 2  # blocks the plan aims at, in waves of the card
MAX_STAGES = 4
STAGE_BUDGET = 72 * 1024  # bytes of ring a plan takes beyond two stages
POOL_DTYPES = (torch.float32, torch.bfloat16)

launches = 0  # kernel calls since the last reset
_fn = None


class Plan(NamedTuple):
    rows: int            # logical rows per split, a multiple of page_len
    splits: int          # ceil(P * L / rows)
    heads_per_warp: int  # 1, or 2 where G > 4
    heads_per_block: int
    groups: int          # head groups per KV head: ceil(G / heads_per_block)
    stages: int          # tiles of TILE rows in the ring
    smem: int            # bytes of shared memory per block


def paged_attn_ref(q, kpool, vpool, pt, pos, *, scale: float,
                   dv: int | None = None) -> torch.Tensor:
    """Plain PyTorch version, line for line `repro.kernels.ref
    .paged_attn_ref`: gather k/v through the page table, then masked
    softmax attention in f32 with validity `logical index <= pos`."""
    b, kv, g, dq = q.shape
    page_len = kpool.shape[1]
    p_tab = pt.shape[1]
    s_log = p_tab * page_len
    idx = pt.long()
    k = kpool[idx].reshape(b, s_log, kv, dq)
    v = vpool[idx].reshape(b, s_log, kv, vpool.shape[-1])
    if dv is not None:
        v = v[..., :dv]
    # scale BEFORE the f32 cast, exactly as the reference's `attend` does
    qg = (q[:, None] * scale).float()                 # (B, 1, KV, G, dq)
    scores = torch.einsum("btkgd,bskd->btkgs", qg, k.float())
    valid = (torch.arange(s_log, dtype=torch.int32, device=q.device)[None, :]
             <= pos[:, None])
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkgs,bskd->btkgd", w, v.float())
    return out[:, 0]


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("paged_attn")
        fn = lib.paged_attn_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 7 + [ci] * 8 + [ctypes.c_float] + [ci] * 10
                       + [vp])
        fn.restype = ci
        _fn = fn
    return _fn


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def smem_bytes(heads_per_warp: int, stages: int, dq: int, dv: int,
               esize: int, alias: bool, rows: int) -> int:
    """Shared memory of one block, as csrc/paged_attn.cu lays it out: the
    warps' probability slices, the pool-row index of each of the split's
    `rows` rows, then `stages` tiles of TILE rows of K (and of V unless
    the pool is aliased) in the pool's type, each row padded to 16
    bytes."""
    row = _round16(dq * esize) + (0 if alias else _round16(dv * esize))
    return (4 * WARPS * ROWS_SCORED * heads_per_warp + _round16(4 * rows)
            + stages * TILE * row)


@functools.lru_cache(maxsize=1024)
def plan(b: int, kv: int, g: int, dq: int, dv: int, p_tab: int,
         page_len: int, dtype: torch.dtype, alias: bool = False) -> Plan:
    """How a call is split, from its shapes alone (`dtype` is the pools').

    Heads go 1 to a warp (4 warps to a block) where G <= 4, else 2: a
    wider G (MLA's 128) is cut into groups of 8, which read the same rows,
    mostly from L2 (two heads a warp keep MLA's 576-wide q and 512-wide
    accumulator in registers). The context is cut into splits of `rows`
    rows, a multiple of page_len and at least MIN_ROWS, so that (b, kv,
    group, split) blocks number about WAVES waves of the card's SMS; a
    block walks its tiles in order, so shorter splits are faster until
    the combine's share grows. The ring holds up to MAX_STAGES tiles,
    fewer where a split has fewer or a stage is wide."""
    hw = 1 if g <= WARPS else 2
    gh = min(g, WARPS * hw)
    groups = -(-g // gh)
    ctx = p_tab * page_len
    want = max(1, -(-WAVES * SMS // (b * kv * groups)))
    rows = max(-(-ctx // want), min(MIN_ROWS, ctx))
    rows = min(-(-rows // page_len) * page_len, ctx)
    splits = -(-ctx // rows)
    esize = 2 if dtype == torch.bfloat16 else 4
    stage = smem_bytes(hw, 1, dq, dv, esize, alias, rows) - smem_bytes(
        hw, 0, dq, dv, esize, alias, rows)
    stages = max(2, min(-(-rows // TILE), MAX_STAGES, STAGE_BUDGET // stage))
    return Plan(rows, splits, hw, gh, groups, stages,
                smem_bytes(hw, stages, dq, dv, esize, alias, rows))


def _vec(kpool, vpool, dq, dv) -> int:
    """Bytes each lane copies at once: the widest of 16 / 8 / 4 / 2 that
    divides the rows' byte widths and strides and the pools' addresses."""
    es = kpool.element_size()
    sizes = (dq * es, dv * es, vpool.shape[-1] * es, kpool.data_ptr(),
             vpool.data_ptr())
    vec = 16
    while vec > 2 and any(x % vec for x in sizes):
        vec //= 2
    return vec


def _check(q, kpool, vpool, pt, pos, dv):
    """Raises ValueError on an input the kernel does not take. A serving
    step calls this once a layer, so each rule is a plain comparison and
    a message is formatted only for a broken one."""
    def bad(msg):
        return ValueError(f"paged_attn: {msg}")

    if not (q.dim() == 4 and kpool.dim() == 4 and vpool.dim() == 4):
        raise bad("q, kpool and vpool must be 4-D (MLA: "
                  "latpool.unsqueeze(2))")
    b, kv, g, dq = q.shape
    n, page_len = kpool.shape[0], kpool.shape[1]
    if kpool.shape[2:] != (kv, dq):
        raise bad(f"kpool {tuple(kpool.shape)} does not match q "
                  f"{tuple(q.shape)}")
    if vpool.shape[:3] != (n, page_len, kv):
        raise bad(f"vpool {tuple(vpool.shape)} does not match kpool "
                  f"{tuple(kpool.shape)}")
    if not (pt.dim() == 2 and pt.shape[0] == b and pos.shape == (b,)):
        raise bad(f"pt {tuple(pt.shape)} / pos {tuple(pos.shape)} do not "
                  f"match batch {b}")
    if not (1 <= dq <= MAX_DQ and 1 <= dv <= min(MAX_DV, vpool.shape[-1])):
        raise bad(f"dq={dq}, dv={dv}, dvp={vpool.shape[-1]}: need dq <= "
                  f"{MAX_DQ} and dv <= min({MAX_DV}, dvp)")
    if q.dtype not in POOL_DTYPES or kpool.dtype not in POOL_DTYPES:
        raise bad(f"dtypes q {q.dtype} / pools {kpool.dtype} not supported "
                  f"(float32 or bfloat16)")
    if vpool.dtype != kpool.dtype:
        raise bad("kpool and vpool must share one dtype")
    if pt.dtype != torch.int32 or pos.dtype != torch.int32:
        raise bad("pt and pos must be int32")
    dev = q.get_device()
    if not (kpool.get_device() == vpool.get_device() == pt.get_device()
            == pos.get_device() == dev):
        raise bad("all inputs must be on one device")
    if not (q.is_contiguous() and kpool.is_contiguous()
            and vpool.is_contiguous() and pt.is_contiguous()
            and pos.is_contiguous()):
        raise bad("inputs must be contiguous (a layer's pool slice "
                  "cache[key][l] is)")
    if b * kv > 65_535:
        raise bad(f"B * KV = {b * kv} blocks exceed the grid")
    if n * page_len * kv >= 2**32:
        raise bad(f"{n * page_len * kv} pool rows do not fit the kernel's "
                  f"32-bit row index")


def _is_alias(kpool, vpool) -> bool:
    return (vpool.data_ptr() == kpool.data_ptr()
            and vpool.shape == kpool.shape)


def paged_attn(q, kpool, vpool, pt, pos, *, scale: float,
               dv: int | None = None) -> torch.Tensor:
    """Paged-gather decode attention (see module doc). Returns
    (B, KV, G, dv) float32."""
    if q.device.type == "cpu":
        return paged_attn_ref(q, kpool, vpool, pt, pos, scale=scale, dv=dv)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attn: no kernel for device {q.device}")
    if q.get_device() != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return paged_attn(q, kpool, vpool, pt, pos, scale=scale, dv=dv)
    dv = vpool.shape[-1] if dv is None else dv
    _check(q, kpool, vpool, pt, pos, dv)
    b, kv, g, dq = q.shape
    alias = _is_alias(kpool, vpool)
    pl = plan(b, kv, g, dq, dv, pt.shape[1], kpool.shape[1], kpool.dtype,
              alias)
    # one allocation: the output, then the splits' (acc, m, l) partials
    n_out = b * kv * g * dv
    buf = torch.empty(n_out + b * kv * g * pl.splits * (dv + 2),
                      dtype=torch.float32, device=q.device)
    out = buf[:n_out].view(b, kv, g, dv)
    rc = _kernel()(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                   pt.data_ptr(), pos.data_ptr(), buf.data_ptr() + 4 * n_out,
                   buf.data_ptr(), b, kv, g, dq, dv, vpool.shape[-1],
                   kpool.shape[1], pt.shape[1], float(scale),
                   int(q.dtype == torch.bfloat16),
                   int(kpool.dtype == torch.bfloat16), int(alias),
                   _vec(kpool, vpool, dq, dv), pl.rows, pl.splits,
                   pl.heads_per_warp, pl.heads_per_block, pl.stages, pl.smem,
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attn: kernel launch failed with CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return out

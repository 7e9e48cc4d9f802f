"""Paged-gather one-token GQA decode attention.

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

`paged_attn` is the wrapper. A CPU tensor goes to `paged_attn_ref`; a CUDA
tensor goes to the hand-written kernel `csrc/paged_attn.cu` or raises.
There is no fallback from one to the other. `launches` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_DIM = 256  # largest dq / dv the kernel takes
MAX_SMEM = 232_448  # bytes of shared memory one Hopper block may use

launches = 0  # kernel launches since the last reset
_fn = None


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
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                       ci, ctypes.c_float, ci, vp]
        fn.restype = ci
        _fn = fn
    return _fn


def smem_bytes(g: int, dq: int, dv: int, p_tab: int) -> int:
    """Shared memory of one block, as csrc/paged_attn.cu:smem_bytes
    computes it."""
    tile = 32
    return 4 * (p_tab + g * dq + tile * (dq + 1) + tile * dv + g * tile
                + 3 * g + g * dv)


def _check(q, kpool, vpool, pt, pos, dv):
    def need(ok, msg):
        if not ok:
            raise ValueError(f"paged_attn: {msg}")

    need(q.dim() == 4 and kpool.dim() == 4 and vpool.dim() == 4,
         "q, kpool and vpool must be 4-D")
    b, kv, g, dq = q.shape
    n, page_len = kpool.shape[0], kpool.shape[1]
    need(kpool.shape[2:] == (kv, dq),
         f"kpool {tuple(kpool.shape)} does not match q {tuple(q.shape)}")
    need(vpool.shape[:3] == (n, page_len, kv),
         f"vpool {tuple(vpool.shape)} does not match kpool "
         f"{tuple(kpool.shape)}")
    need(pt.dim() == 2 and pt.shape[0] == b and pos.shape == (b,),
         f"pt {tuple(pt.shape)} / pos {tuple(pos.shape)} do not match "
         f"batch {b}")
    need(1 <= dq <= MAX_DIM and 1 <= dv <= min(MAX_DIM, vpool.shape[-1]),
         f"dq={dq}, dv={dv}, dvp={vpool.shape[-1]}: need dq <= {MAX_DIM} "
         f"and dv <= min({MAX_DIM}, dvp)")
    need(q.dtype in (torch.float32, torch.bfloat16),
         f"dtype {q.dtype} not supported (float32 or bfloat16)")
    need(kpool.dtype == q.dtype and vpool.dtype == q.dtype,
         "q, kpool and vpool must share one dtype")
    need(pt.dtype == torch.int32 and pos.dtype == torch.int32,
         "pt and pos must be int32")
    dev = q.device
    need(all(t.device == dev for t in (kpool, vpool, pt, pos)),
         "all inputs must be on one device")
    need(all(t.is_contiguous() for t in (q, kpool, vpool, pt, pos)),
         "inputs must be contiguous (a layer's pool slice cache[key][l] is)")
    smem = smem_bytes(g, dq, dv, pt.shape[1])
    need(smem <= MAX_SMEM, f"needs {smem} B of shared memory per block, "
         f"more than {MAX_SMEM}")


def paged_attn(q, kpool, vpool, pt, pos, *, scale: float,
               dv: int | None = None) -> torch.Tensor:
    """Paged-gather decode attention (see module doc). Returns
    (B, KV, G, dv) float32."""
    if q.device.type == "cpu":
        return paged_attn_ref(q, kpool, vpool, pt, pos, scale=scale, dv=dv)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attn: no kernel for device {q.device}")
    dv = vpool.shape[-1] if dv is None else dv
    _check(q, kpool, vpool, pt, pos, dv)
    b, kv, g, dq = q.shape
    out = torch.empty((b, kv, g, dv), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                pt.data_ptr(), pos.data_ptr(), out.data_ptr(),
                b, kv, g, dq, dv, vpool.shape[-1], kpool.shape[1],
                pt.shape[1], float(scale), int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attn: kernel launch failed with CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return out

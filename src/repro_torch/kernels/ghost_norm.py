"""Per-example gradient norms² of a linear layer (the ghost-norm identity),
whole or per weight block.

The counterpart of `repro.kernels.ghost_norm.ghost_norm` and
`ghost_norm_blocked` (the TPU kernels) and of `repro.kernels.ref
.ghost_norm_ref` and `ghost_norm_blocked_ref` (their plain versions).
Shapes:

  a:   (B, T, din)  activations into the layer, float32 or bfloat16
  g:   (B, T, dout) cotangents of the layer output, the same dtype
  ghost_norm:         (B,)   float32, out[b] = <A_b A_bᵀ, G_b G_bᵀ>
                             = ||A_bᵀ G_b||²
  ghost_norm_blocked: (B, M) float32, the norms² of the M column
                             ('out') or row ('in') blocks of A_bᵀ G_b

`ghost_norm` and `ghost_norm_blocked` are the wrappers. A CPU tensor goes
to the plain version; a CUDA tensor goes to the hand-written kernel
(`csrc/ghost_norm.cu`, `csrc/ghost_norm_blocked.cu`) or raises. There is
no fallback from one to the other. `launches` and `blocked_launches`
count the wrappers' kernel calls (one per call, whatever the launches
inside it).

On the card (NVIDIA H100, sm_90a) the bytes bound both kernels: B T²
(din + dout) operations against 2 B T (din + dout) bf16 bytes, 64
operations per byte at T = 256, below the card's bf16 ridge of about
295. Both compute out[b, m] = <S_b S_bᵀ, X_b^m X_b^mᵀ> with a shared
operand S and M column blocks of X (`ghost_norm`: M = 1, S the narrower
of a and g, `shared_operands`).

* bfloat16 runs `csrc/gram_mma.cuh` on the tensor cores: 128 x 128 tiles
  (i <= j) of the grams by wgmma from a 4-stage ring of 64-feature boxes
  filled by TMA (plain loads where a block width is not a multiple of 8),
  in three phases. Phase 1 builds S's tiles over `shared_chunks` feature
  chunks into the workspace and sums them in chunk order; phase 2 builds
  X's tiles over `blocked_chunks` chunks per column block (never across a
  block boundary) and multiplies each into the reduced S tile in
  registers, one float per (b, m, tile, chunk), doubled off the diagonal;
  phase 3 sums each (b, m)'s floats in order. `plan` gives the counts and
  the workspace, from the shapes alone, as the C entry points compute
  them: two calls give the same bits, and the book-keeping and two-pass
  executions the same norms.
* float32 keeps the CUDA-core loop of `csrc/gram_tile.cuh`: one block per
  pair of 32-row tiles, a partial per (pair, m), summed in pair order.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.ghost import blocked_operands
from repro_torch.kernels import _build

# as csrc/gram_mma.cuh: rows per tile side, features per box, the blocks a
# phase aims at (one wave on 132 SMs), boxes per tensor-core chain (its
# sums are added in f32), floats of one f32 tile
ROWS, ATOM, WAVE, CHAIN = 128, 64, 132, 8
TILE_FLOATS = ROWS * ROWS
F32_TILE = 32  # rows per tile of the float32 path, as csrc/gram_tile.cuh

launches = 0  # ghost_norm kernel calls since the last reset
blocked_launches = 0  # ghost_norm_blocked kernel calls since the last reset
_fn = None
_fn_blocked = None


def ghost_norm_ref(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, line for line `repro.kernels.ref
    .ghost_norm_ref`: direct gram-identity evaluation in f32."""
    a32, g32 = a.float(), g.float()
    gram_a = torch.einsum("bti,bsi->bts", a32, a32)
    gram_g = torch.einsum("bto,bso->bts", g32, g32)
    return torch.sum(gram_a * gram_g, dim=(1, 2))


def ghost_norm_blocked_ref(a: torch.Tensor, g: torch.Tensor,
                           num_blocks: int,
                           block_axis: str = "out") -> torch.Tensor:
    """Plain PyTorch version, line for line `repro.kernels.ref
    .ghost_norm_blocked_ref`: (B, M) per-block norms² by direct per-block
    evaluation (it forms the per-example block gradients)."""
    a32, g32 = a.float(), g.float()
    b, t, din = a32.shape
    dout = g32.shape[-1]
    m = num_blocks
    if block_axis == "out":
        gb = g32.reshape(b, t, m, dout // m)
        pg = torch.einsum("bti,btmo->bmio", a32, gb)  # per-block grads
    else:
        ab = a32.reshape(b, t, m, din // m)
        pg = torch.einsum("btmi,bto->bmio", ab, g32)
    return torch.sum(pg * pg, dim=(2, 3))


class GramPlan(NamedTuple):
    """How one call of either kernel splits its work (see module doc)."""
    tiles: int           # 128 x 128 gram tiles (i <= j) per example
    shared_chunks: int   # feature chunks of S (phase 1)
    blocked_chunks: int  # feature chunks of each column block of X
    workspace: int       # floats of scratch, bfloat16 inputs
    f32_workspace: int   # floats of scratch, float32 inputs


def plan(b: int, t: int, ds: int, dx: int, m: int = 1) -> GramPlan:
    """The plan of a call on S (b, t, ds) and X (b, t, dx) in m column
    blocks, as csrc/gram_mma.cuh:make_plan: one wave of blocks per phase
    where the grid allows (one chunk of S from b * tiles >= 132 on, e.g.
    T = 1024 at B = 8), each chunk at least one 64-feature box."""
    nt = -(-t // ROWS)
    tiles = nt * (nt + 1) // 2
    jobs = b * tiles
    c1 = max(1, min(-(-ds // ATOM), WAVE // jobs))
    c2 = max(1, min(-(-(dx // m) // ATOM), WAVE // (jobs * m)))
    ws = jobs * TILE_FLOATS + (jobs * c1 * TILE_FLOATS if c1 > 1 else 0) \
        + jobs * m * c2
    nt32 = -(-t // F32_TILE)
    return GramPlan(tiles, c1, c2, ws, b * m * (nt32 * (nt32 + 1) // 2))


def chunk_bounds(width: int, chunks: int) -> list[tuple[int, int]]:
    """[lo, hi) feature ranges of the `chunks` chunks of a `width`-wide
    operand or column block: whole 64-feature boxes, split as evenly as
    integer division allows, as the kernel splits them."""
    n = -(-width // ATOM)
    return [(ATOM * (c * n // chunks), min(width, ATOM * ((c + 1) * n
                                                          // chunks)))
            for c in range(chunks)]


def shared_operands(a: torch.Tensor, g: torch.Tensor):
    """(S, X) of `ghost_norm`: the narrower of a and g is shared, so the
    wider one streams through phase 2 (ties: a)."""
    return (a, g) if a.shape[-1] <= g.shape[-1] else (g, a)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("ghost_norm").ghost_norm_launch
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, cl, vp, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        _fn = fn
    return _fn


def _kernel_blocked():
    global _fn_blocked
    if _fn_blocked is None:
        fn = _build.load("ghost_norm_blocked").ghost_norm_blocked_launch
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, cl, vp, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        _fn_blocked = fn
    return _fn_blocked


def _check(a, g, name="ghost_norm"):
    def need(ok, msg):
        if not ok:
            raise ValueError(f"{name}: {msg}")

    need(a.dim() == 3 and g.dim() == 3, "a and g must be 3-D (B, T, d)")
    need(a.shape[:2] == g.shape[:2],
         f"a {tuple(a.shape)} and g {tuple(g.shape)} differ in B or T")
    need(a.dtype in (torch.float32, torch.bfloat16),
         f"dtype {a.dtype} not supported (float32 or bfloat16)")
    need(g.dtype == a.dtype, "a and g must share one dtype")
    need(a.device == g.device, "a and g must be on one device")
    need(a.is_contiguous() and g.is_contiguous(), "inputs must be contiguous")
    need(min(a.shape) > 0 and g.shape[-1] > 0, "empty input")


def ghost_norm(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B,) float32 squared per-example gradient norms (see module doc)."""
    if a.device.type == "cpu":
        return ghost_norm_ref(a, g)
    if a.device.type != "cuda":
        raise ValueError(f"ghost_norm: no kernel for device {a.device}")
    _check(a, g)
    shared, other = shared_operands(a, g)
    b, t, ds = shared.shape
    dx = other.shape[-1]
    bf16 = a.dtype == torch.bfloat16
    p = plan(b, t, ds, dx)
    ws = torch.empty((p.workspace if bf16 else p.f32_workspace,),
                     dtype=torch.float32, device=a.device)
    out = torch.empty((b,), dtype=torch.float32, device=a.device)
    fn = _kernel()
    with torch.cuda.device(a.device):
        rc = fn(shared.data_ptr(), other.data_ptr(), ws.data_ptr(),
                ws.numel(), out.data_ptr(), b, t, ds, dx, int(bf16),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ghost_norm: kernel launch failed with CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return out


def ghost_norm_blocked(a: torch.Tensor, g: torch.Tensor, num_blocks: int, *,
                       block_axis: str = "out") -> torch.Tensor:
    """(B, M) float32 squared per-example norms of the M weight blocks
    (see module doc): block m of 'out' is columns [m dout/M, (m+1) dout/M)
    of W, block m of 'in' its rows [m din/M, (m+1) din/M)."""
    shared, blocked = blocked_operands(a, g, num_blocks, block_axis)
    if a.device.type == "cpu":
        return ghost_norm_blocked_ref(a, g, num_blocks, block_axis)
    if a.device.type != "cuda":
        raise ValueError(f"ghost_norm_blocked: no kernel for device "
                         f"{a.device}")
    _check(a, g, "ghost_norm_blocked")
    b, t, _ = a.shape
    m = num_blocks
    ds, dx = shared.shape[-1], blocked.shape[-1]
    bf16 = a.dtype == torch.bfloat16
    p = plan(b, t, ds, dx, m)
    ws = torch.empty((p.workspace if bf16 else p.f32_workspace,),
                     dtype=torch.float32, device=a.device)
    out = torch.empty((b, m), dtype=torch.float32, device=a.device)
    fn = _kernel_blocked()
    with torch.cuda.device(a.device):
        rc = fn(shared.data_ptr(), blocked.data_ptr(), ws.data_ptr(),
                ws.numel(), out.data_ptr(), b, t, ds, dx, m, int(bf16),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ghost_norm_blocked: kernel launch failed with "
                           f"CUDA error {rc}")
    global blocked_launches
    blocked_launches += 1
    return out

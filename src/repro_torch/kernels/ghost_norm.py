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
count the wrappers' kernel calls (one per call, though each kernel takes
two launches: tile pairs, then the sum of their partials).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ghost import blocked_operands
from repro_torch.kernels import _build

TILE = 32  # sequence rows per tile, as csrc/ghost_norm.cu:kTile

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


def num_pairs(t: int) -> int:
    """Tile pairs (i, j >= i) per example, as csrc/ghost_norm.cu:
    ghost_norm_num_pairs computes them."""
    nt = -(-t // TILE)
    return nt * (nt + 1) // 2


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("ghost_norm").ghost_norm_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        _fn = fn
    return _fn


def _kernel_blocked():
    global _fn_blocked
    if _fn_blocked is None:
        fn = _build.load("ghost_norm_blocked").ghost_norm_blocked_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
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
    b, t, din = a.shape
    dout = g.shape[-1]
    partial = torch.empty((b * num_pairs(t),), dtype=torch.float32,
                          device=a.device)
    out = torch.empty((b,), dtype=torch.float32, device=a.device)
    fn = _kernel()
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), g.data_ptr(), partial.data_ptr(),
                out.data_ptr(), b, t, din, dout,
                int(a.dtype == torch.bfloat16),
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
    partial = torch.empty((b * m * num_pairs(t),), dtype=torch.float32,
                          device=a.device)
    out = torch.empty((b, m), dtype=torch.float32, device=a.device)
    fn = _kernel_blocked()
    with torch.cuda.device(a.device):
        rc = fn(shared.data_ptr(), blocked.data_ptr(), partial.data_ptr(),
                out.data_ptr(), b, t, shared.shape[-1], blocked.shape[-1], m,
                int(a.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ghost_norm_blocked: kernel launch failed with "
                           f"CUDA error {rc}")
    global blocked_launches
    blocked_launches += 1
    return out

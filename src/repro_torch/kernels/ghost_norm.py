"""Per-example gradient norms² of a linear layer (the ghost-norm identity).

The counterpart of `repro.kernels.ghost_norm.ghost_norm` (the TPU kernel)
and of `repro.kernels.ref.ghost_norm_ref` (its plain version). Shapes:

  a:   (B, T, din)  activations into the layer, float32 or bfloat16
  g:   (B, T, dout) cotangents of the layer output, the same dtype
  out: (B,)         float32, out[b] = <A_b A_bᵀ, G_b G_bᵀ> = ||A_bᵀ G_b||²

`ghost_norm` is the wrapper. A CPU tensor goes to `ghost_norm_ref`; a CUDA
tensor goes to the hand-written kernel `csrc/ghost_norm.cu` or raises.
There is no fallback from one to the other. `launches` counts the
wrapper's kernel calls (one per call, though the kernel takes two
launches: tile pairs, then the per-example sum).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TILE = 32  # sequence rows per tile, as csrc/ghost_norm.cu:kTile

launches = 0  # kernel calls since the last reset
_fn = None


def ghost_norm_ref(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, line for line `repro.kernels.ref
    .ghost_norm_ref`: direct gram-identity evaluation in f32."""
    a32, g32 = a.float(), g.float()
    gram_a = torch.einsum("bti,bsi->bts", a32, a32)
    gram_g = torch.einsum("bto,bso->bts", g32, g32)
    return torch.sum(gram_a * gram_g, dim=(1, 2))


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


def _check(a, g):
    def need(ok, msg):
        if not ok:
            raise ValueError(f"ghost_norm: {msg}")

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

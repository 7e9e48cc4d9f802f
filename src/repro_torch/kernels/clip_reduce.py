"""Clipped, summed weight gradient of a linear layer: sum_b c_b A_bᵀ G_b.

The counterpart of `repro.kernels.clip_reduce.clip_reduce` (the TPU
kernel) and of `repro.kernels.ref.clip_reduce_ref` (its plain version).
Shapes:

  a:       (B, T, din)  activations into the layer, float32 or bfloat16
  g:       (B, T, dout) cotangents of the layer output, the same dtype
  factors: (B,)         float32 per-example clip factors, or
           (B, M)       per-block factors (per-shard clipping): output
                        (i, j) takes factors[b, j // (dout / M)] with
                        block_axis "out", factors[b, i // (din / M)] with
                        "in" -- the reference's `fold_block_factors` into
                        the blocked operand followed by `clip_reduce`
  out:     (din, dout)  float32

The factor is applied in float32: rounding it to bfloat16 could let a
clipped contribution exceed the sensitivity bound. `clip_reduce` is the
wrapper. A CPU tensor goes to `clip_reduce_ref`; a CUDA tensor goes to the
hand-written kernel `csrc/clip_reduce.cu` or raises. There is no fallback
from one to the other. The kernel dispatches on dtype: bfloat16 inputs
run on the tensor cores (`csrc/contract_mma.cuh`: wgmma, each example's
A_bᵀ G_b scaled by its factor in f32), float32 inputs on the CUDA cores
(`csrc/contract_tile.cuh`). Where a layer has few output tiles the
bfloat16 kernel splits the examples and sums the partial tiles, which the
wrapper allocates, in a fixed order. `launches` counts the calls that
launch the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ghost import fold_block_factors
from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset
_fns = None
BLOCK_AXES = ("out", "in")


def clip_reduce_ref(a: torch.Tensor, g: torch.Tensor, factors: torch.Tensor,
                    block_axis: str = "out") -> torch.Tensor:
    """Plain PyTorch version, line for line `repro.kernels.ref
    .clip_reduce_ref`: one f32 contraction with the factor applied to g;
    (B, M) factors are folded into the blocked operand first
    (`core.ghost.fold_block_factors`, the plain blocked path)."""
    if factors.dim() == 2:
        a32, gs = fold_block_factors(a, g, factors, block_axis)
        return torch.einsum("bti,bto->io", a32, gs)
    a32, g32 = a.float(), g.float()
    return torch.einsum("bti,bto->io", a32, g32 * factors[:, None, None])


def _kernel():
    """(launch, splits) entry points of the built library."""
    global _fns
    if _fns is None:
        lib = _build.load("clip_reduce")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn = lib.clip_reduce_launch
        fn.argtypes = [vp, vp, vp, vp, vp] + [ci] * 7 + [vp]
        fn.restype = ci
        splits = lib.clip_reduce_splits
        splits.argtypes = [ci] * 4
        splits.restype = ci
        _fns = fn, splits
    return _fns


def _check(a, g, factors, block_axis="out"):
    def need(ok, msg):
        if not ok:
            raise ValueError(f"clip_reduce: {msg}")

    need(a.dim() == 3 and g.dim() == 3, "a and g must be 3-D (B, T, d)")
    need(a.shape[:2] == g.shape[:2],
         f"a {tuple(a.shape)} and g {tuple(g.shape)} differ in B or T")
    need(factors.dim() in (1, 2) and factors.shape[0] == a.shape[0],
         f"factors {tuple(factors.shape)} must be ({a.shape[0]},) or "
         f"({a.shape[0]}, M)")
    need(block_axis in BLOCK_AXES,
         f"block_axis must be one of {BLOCK_AXES}, got {block_axis!r}")
    if factors.dim() == 2:
        m = factors.shape[1]
        width = a.shape[-1] if block_axis == "in" else g.shape[-1]
        need(m >= 1 and width % m == 0,
             f"M = {m} blocks must divide the {block_axis} axis ({width})")
    need(a.dtype in (torch.float32, torch.bfloat16),
         f"dtype {a.dtype} not supported (float32 or bfloat16)")
    need(g.dtype == a.dtype, "a and g must share one dtype")
    need(factors.dtype == torch.float32,
         "factors must be float32 (a rounded factor can break the "
         "sensitivity bound)")
    need(a.device == g.device == factors.device,
         "all inputs must be on one device")
    need(all(t.is_contiguous() for t in (a, g, factors)),
         "inputs must be contiguous")
    need(min(a.shape) > 0 and g.shape[-1] > 0 and factors.numel() > 0,
         "empty input")
    b, t, din = a.shape
    dout = g.shape[-1]
    need(b * t < 2**31 and -(-din // 64) < 2**16
         and -(-dout // 64) < 2**16,
         "B * T must fit in int32, din and dout in 65,535 tiles of 64")


def clip_reduce(a: torch.Tensor, g: torch.Tensor, factors: torch.Tensor,
                block_axis: str = "out") -> torch.Tensor:
    """(din, dout) float32 sum_b factors[b] A_bᵀ G_b, factors (B,) or
    per block (B, M) along `block_axis` (see module doc)."""
    if a.device.type == "cpu":
        return clip_reduce_ref(a, g, factors, block_axis)
    if a.device.type != "cuda":
        raise ValueError(f"clip_reduce: no kernel for device {a.device}")
    _check(a, g, factors, block_axis)
    b, t, din = a.shape
    dout = g.shape[-1]
    m = factors.shape[1] if factors.dim() == 2 else 1
    bf16 = int(a.dtype == torch.bfloat16)
    fn, splits_fn = _kernel()
    out = torch.empty((din, dout), dtype=torch.float32, device=a.device)
    splits = splits_fn(b, din, dout, bf16)
    part = (torch.empty((splits, din, dout), dtype=torch.float32,
                        device=a.device) if splits > 1 else out)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), g.data_ptr(), factors.data_ptr(),
                out.data_ptr(), part.data_ptr(), b, t, din, dout, m,
                int(block_axis == "in"), bf16,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"clip_reduce: kernel launch failed with CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return out

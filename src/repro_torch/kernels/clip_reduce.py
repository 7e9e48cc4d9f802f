"""Clipped, summed weight gradient of a linear layer: sum_b c_b A_bᵀ G_b.

The counterpart of `repro.kernels.clip_reduce.clip_reduce` (the TPU
kernel) and of `repro.kernels.ref.clip_reduce_ref` (its plain version).
Shapes:

  a:       (B, T, din)  activations into the layer, float32 or bfloat16
  g:       (B, T, dout) cotangents of the layer output, the same dtype
  factors: (B,)         float32 per-example clip factors
  out:     (din, dout)  float32

The factor multiplies g in float32: rounding it to bfloat16 could let a
clipped contribution exceed the sensitivity bound. `clip_reduce` is the
wrapper. A CPU tensor goes to `clip_reduce_ref`; a CUDA tensor goes to the
hand-written kernel `csrc/clip_reduce.cu` or raises. There is no fallback
from one to the other. `launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset
_fn = None


def clip_reduce_ref(a: torch.Tensor, g: torch.Tensor,
                    factors: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, line for line `repro.kernels.ref
    .clip_reduce_ref`: one f32 contraction with the factor applied to g."""
    a32, g32 = a.float(), g.float()
    return torch.einsum("bti,bto->io", a32, g32 * factors[:, None, None])


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("clip_reduce").clip_reduce_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        _fn = fn
    return _fn


def _check(a, g, factors):
    def need(ok, msg):
        if not ok:
            raise ValueError(f"clip_reduce: {msg}")

    need(a.dim() == 3 and g.dim() == 3, "a and g must be 3-D (B, T, d)")
    need(a.shape[:2] == g.shape[:2],
         f"a {tuple(a.shape)} and g {tuple(g.shape)} differ in B or T")
    need(factors.shape == (a.shape[0],),
         f"factors {tuple(factors.shape)} must be ({a.shape[0]},)")
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
    need(min(a.shape) > 0 and g.shape[-1] > 0, "empty input")
    need(a.shape[0] * a.shape[1] < 2**31 and -(-a.shape[-1] // 128) < 2**16,
         "B * T must fit in int32 and din in 65,535 tiles of 128")


def clip_reduce(a: torch.Tensor, g: torch.Tensor,
                factors: torch.Tensor) -> torch.Tensor:
    """(din, dout) float32 sum_b factors[b] A_bᵀ G_b (see module doc)."""
    if a.device.type == "cpu":
        return clip_reduce_ref(a, g, factors)
    if a.device.type != "cuda":
        raise ValueError(f"clip_reduce: no kernel for device {a.device}")
    _check(a, g, factors)
    b, t, din = a.shape
    dout = g.shape[-1]
    out = torch.empty((din, dout), dtype=torch.float32, device=a.device)
    fn = _kernel()
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), g.data_ptr(), factors.data_ptr(),
                out.data_ptr(), b, t, din, dout,
                int(a.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"clip_reduce: kernel launch failed with CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return out

"""The book-keeping (BK) epilogue's contraction: sum_i f[s,i] A[s,i]ᵀ G[s,i]
per stack slice, in one call over the cached residuals.

The counterpart of `repro.kernels.bk.scale_contract` (the TPU kernel) and
of `repro.kernels.ref.scale_contract_ref` (its plain version). Shapes:

  a:       (S, B, T, din)  activations cached by the BK capture pass,
                           float32 or bfloat16
  g:       (S, B, T, dout) output cotangents, the same dtype
  factors: (S, B)          float32 per-example clip factors
  out:     (S, din, dout)  float32

The 3-D form, a (B, T, din), g (B, T, dout), factors (B,), returns
(din, dout). The factor multiplies g in float32, as in `clip_reduce`.
`scale_contract` is the wrapper. A CPU tensor goes to
`scale_contract_ref`; a CUDA tensor goes to the hand-written kernel
`csrc/scale_contract.cu`, S slices in one launch, or raises. There is no
fallback from one to the other. The kernel dispatches on dtype as
`clip_reduce` does: bfloat16 on the tensor cores (`csrc/contract_mma.cuh`),
float32 on the CUDA cores (`csrc/contract_tile.cuh`), with the same split
over examples (partial tiles the wrapper allocates) where a slice has few
output tiles, so slice s sums in `clip_reduce`'s order. `launches` counts
the calls that launch the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.clip_reduce import clip_reduce_ref

launches = 0  # kernel launches since the last reset
_fns = None


def scale_contract_ref(a: torch.Tensor, g: torch.Tensor,
                       factors: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, line for line `repro.kernels.ref
    .scale_contract_ref`: one f32 contraction per stack slice with the
    factor applied to g."""
    if a.dim() == 3:
        return clip_reduce_ref(a, g, factors)
    a32, g32 = a.float(), g.float()
    gs = g32 * factors[:, :, None, None].float()
    return torch.einsum("sbti,sbto->sio", a32, gs)


def _kernel():
    """(launch, splits) entry points of the built library."""
    global _fns
    if _fns is None:
        lib = _build.load("scale_contract")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn = lib.scale_contract_launch
        fn.argtypes = [vp, vp, vp, vp, vp] + [ci] * 6 + [vp]
        fn.restype = ci
        splits = lib.scale_contract_splits
        splits.argtypes = [ci] * 4
        splits.restype = ci
        _fns = fn, splits
    return _fns


def _check(a, g, factors):
    def need(ok, msg):
        if not ok:
            raise ValueError(f"scale_contract: {msg}")

    need(a.dim() in (3, 4) and g.dim() == a.dim(),
         "a and g must both be 4-D (S, B, T, d) or both 3-D (B, T, d)")
    need(a.shape[:-1] == g.shape[:-1],
         f"a {tuple(a.shape)} and g {tuple(g.shape)} differ in S, B or T")
    need(factors.shape == a.shape[:-2],
         f"factors {tuple(factors.shape)} must be {tuple(a.shape[:-2])}")
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
    s = a.shape[0] if a.dim() == 4 else 1
    need(s * a.shape[-3] * a.shape[-2] < 2**31
         and s * min(a.shape[-3], 132) < 2**16
         and -(-a.shape[-1] // 64) < 2**16
         and -(-g.shape[-1] // 64) < 2**16,
         "S * B * T must fit in int32, S times the split in 65,535, din "
         "and dout in 65,535 tiles of 64")


def scale_contract(a: torch.Tensor, g: torch.Tensor,
                   factors: torch.Tensor) -> torch.Tensor:
    """(S, din, dout) float32 sum_b factors[s, b] A[s, b]ᵀ G[s, b] (see
    module doc); (din, dout) for the 3-D form."""
    if a.device.type == "cpu":
        return scale_contract_ref(a, g, factors)
    if a.device.type != "cuda":
        raise ValueError(f"scale_contract: no kernel for device {a.device}")
    _check(a, g, factors)
    squeeze = a.dim() == 3
    s, b, t, din = (1,) * squeeze + tuple(a.shape)
    dout = g.shape[-1]
    bf16 = int(a.dtype == torch.bfloat16)
    fn, splits_fn = _kernel()
    out = torch.empty((s, din, dout), dtype=torch.float32, device=a.device)
    splits = splits_fn(b, din, dout, bf16)
    part = (torch.empty((s * splits, din, dout), dtype=torch.float32,
                        device=a.device) if splits > 1 else out)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), g.data_ptr(), factors.data_ptr(),
                out.data_ptr(), part.data_ptr(), s, b, t, din, dout, bf16,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scale_contract: kernel launch failed with CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return out[0] if squeeze else out

"""One linear layer's whole clip in one call: the per-example norms², the
clip factors and the clipped, summed weight gradient.

The counterpart of `repro.kernels.fused_clip.fused_norm_clip` (the TPU
kernel) and of `repro.kernels.ref.fused_norm_clip_ref` (its plain
version). Shapes:

  a:     (B, T, din)  activations into the layer, float32 or bfloat16
  g:     (B, T, dout) cotangents of the layer output, the same dtype
  c:     (B,)         float32 encoded thresholds (`core.ghost.clip_factor`)
  extra: (B,) or None float32 norms² of co-grouped parameters (a bias),
                      added to the weight's before the factor
  out:   (n (B,), dW (din, dout)), both float32, with

      n_b = ||A_bᵀ G_b||²                  (the WEIGHT part only)
      dW  = sum_b f_b A_bᵀ G_b,  f_b = clip_factor(c_b, n_b + extra_b)

`fused_norm_clip` is the wrapper. A CPU tensor goes to
`fused_norm_clip_ref`; a CUDA tensor goes to the hand-written kernel
`csrc/fused_norm_clip.cu` or raises. There is no fallback from one to the
other. `launches` counts the wrapper's kernel calls (one per call, though
the kernel takes two launches: per-example tiles, then the weighted sum).
The per-example tiles pass between the two launches through a (B, din,
dout) f32 workspace the wrapper allocates, so a call's memory grows with
B: 2 MB at an MoE router with B = 8, but 4.3 GB at the route rule's
1024 x 1024 limit with B = 1024, where the composed route (and the TPU
kernel) need one (din, dout) f32 output whatever B (ROADMAP A.15).

`fits` is the reference engine's route rule (`PallasBackend._fused_fits`
with its default `bt` and `vmem_limit_bytes`), copied so that both
packages send the same layers to this kernel: the TPU kernel keeps an
untiled (din, dout) f32 accumulator and its output in VMEM.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ghost import clip_factor
from repro_torch.kernels import _build
from repro_torch.kernels.clip_reduce import clip_reduce_ref
from repro_torch.kernels.ghost_norm import ghost_norm_ref

TILE = 64  # rows and columns of an output tile, as csrc/fused_norm_clip.cu
MAX_BATCH = 12288  # the factors of one call fit 48 KB of shared memory
FIT_BT = 256  # the reference engine's sequence tile (EngineConfig.bt)
FIT_LIMIT_BYTES = 12 << 20  # its VMEM guard (EngineConfig.vmem_limit_bytes)

launches = 0  # fused_norm_clip kernel calls since the last reset
_fn = None


def padded_dims(din: int, dout: int) -> tuple[int, int]:
    """The TPU kernel's feature padding (f32 sublane / lane tiles), a copy
    of `repro.kernels.fused_clip.padded_dims`: the route rule reads it."""
    dip = -(-din // 8) * 8
    djp = -(-dout // 128) * 128 if dout > 128 else dout
    return dip, djp


def fits(din: int, dout: int) -> bool:
    """Whether the reference engine routes a (din, dout) linear to its
    fused kernel: the TPU working set, two (din, dout) f32 buffers and
    four sequence blocks, within its 12 MiB guard."""
    dip, djp = padded_dims(din, dout)
    need = 4 * (2 * dip * djp + 2 * FIT_BT * (dip + djp))
    return need <= FIT_LIMIT_BYTES


def fused_norm_clip_ref(a: torch.Tensor, g: torch.Tensor, c: torch.Tensor,
                        extra_norms_sq: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, line for line `repro.kernels.ref
    .fused_norm_clip_ref`: the gram norm, the factor, the f32 contraction."""
    n = ghost_norm_ref(a, g)
    total = n if extra_norms_sq is None else n + extra_norms_sq
    f = clip_factor(c, total)
    return n, clip_reduce_ref(a, g, f)


def num_tiles(din: int, dout: int) -> int:
    """Output tiles of one example, as csrc/fused_norm_clip.cu counts them."""
    return -(-din // TILE) * -(-dout // TILE)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("fused_norm_clip").fused_norm_clip_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       vp]
        fn.restype = ci
        _fn = fn
    return _fn


def _check(a, g, c, extra):
    def need(ok, msg):
        if not ok:
            raise ValueError(f"fused_norm_clip: {msg}")

    need(a.dim() == 3 and g.dim() == 3, "a and g must be 3-D (B, T, d)")
    need(a.shape[:2] == g.shape[:2],
         f"a {tuple(a.shape)} and g {tuple(g.shape)} differ in B or T")
    vecs = [c] + ([] if extra is None else [extra])
    for name, v in zip(("c", "extra_norms_sq"), vecs):
        need(v.shape == (a.shape[0],),
             f"{name} {tuple(v.shape)} must be ({a.shape[0]},)")
        need(v.dtype == torch.float32, f"{name} must be float32")
    need(a.dtype in (torch.float32, torch.bfloat16),
         f"dtype {a.dtype} not supported (float32 or bfloat16)")
    need(g.dtype == a.dtype, "a and g must share one dtype")
    need(all(t.device == a.device for t in [g] + vecs),
         "all inputs must be on one device")
    need(all(t.is_contiguous() for t in [a, g] + vecs),
         "inputs must be contiguous")
    need(min(a.shape) > 0 and g.shape[-1] > 0, "empty input")
    need(a.shape[0] <= MAX_BATCH and -(-a.shape[-1] // TILE) < 2**16,
         f"B must be at most {MAX_BATCH} and din at most 65,535 tiles of "
         f"{TILE}")


def fused_norm_clip(a: torch.Tensor, g: torch.Tensor, c: torch.Tensor,
                    extra_norms_sq: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n (B,), dW (din, dout)) float32 (see module doc)."""
    if a.device.type == "cpu":
        return fused_norm_clip_ref(a, g, c, extra_norms_sq)
    if a.device.type != "cuda":
        raise ValueError(f"fused_norm_clip: no kernel for device {a.device}")
    _check(a, g, c, extra_norms_sq)
    b, t, din = a.shape
    dout = g.shape[-1]
    f32 = dict(dtype=torch.float32, device=a.device)
    # per-example tiles A_bᵀ G_b and their sums of squares, between the
    # two launches
    work = torch.empty((b, din, dout), **f32)
    partial = torch.empty((b * num_tiles(din, dout),), **f32)
    n = torch.empty((b,), **f32)
    dw = torch.empty((din, dout), **f32)
    extra = 0 if extra_norms_sq is None else extra_norms_sq.data_ptr()
    fn = _kernel()
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), g.data_ptr(), c.data_ptr(), extra,
                work.data_ptr(), partial.data_ptr(), n.data_ptr(),
                dw.data_ptr(), b, t, din, dout,
                int(a.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_norm_clip: kernel launch failed with CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return n, dw

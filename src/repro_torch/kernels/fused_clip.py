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
other. `launches` counts the wrapper's kernel calls: one launch a call.

The kernel is one cooperative launch of `plan(...).grid` blocks, all
co-resident: each owns a 128 (din) x 64 (dout) output tile and one of
`splits` contiguous ranges of examples, and walks its examples one a
round, each example's A_bᵀ G_b kept in registers (bf16 on the tensor
cores, f32 on the CUDA cores) until a grid barrier has made every tile's
sum of squares, and so n_b and f_b, known; then it adds f_b A_bᵀ G_b to
its tile. The splits' tiles are summed in split order at the end. The
plan depends on the shapes and the SM count alone, so every sum has a
fixed order: two calls give the same bits.

Memory: the call's scratch is `plan(...).scratch` floats, the splits'
tiles (splits din dout, none with one split) and two rounds of partial
sums of squares (2 splits tiles), whatever B, as the TPU kernel's one
(din, dout) accumulator does not grow with B. At the route rule's
1024 x 1024 limit a call has two splits, 8 MB of scratch beside its 4 MB
dW, at any B (the first version of this kernel took a (B, din, dout)
workspace, 4.3 GB at B = 1024). The grid barrier is one int64 arrival
count a device (`_barrier`), zeroed once and never reset, so a CUDA
graph replays a call; two calls on one device must not overlap (on two
streams). A layer with more output tiles than fit on the card at two
blocks a SM (none that `fits` passes) raises.

`fits` is the reference engine's route rule (`PallasBackend._fused_fits`
with its default `bt` and `vmem_limit_bytes`), copied so that both
packages send the same layers to this kernel: the TPU kernel keeps an
untiled (din, dout) f32 accumulator and its output in VMEM. It is the
static route of the `kernels` engine and the static fallback of `auto`;
under `auto` the measured choice between this kernel, the composed pair
and the plain path lives in the autotune table (`kernels.autotune`,
candidate `fused` of op `linear_clip`). `takes` says whether a call of a
(din, dout) layer fits the card at all.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.ghost import clip_factor
from repro_torch.kernels import _build
from repro_torch.kernels.clip_reduce import clip_reduce_ref
from repro_torch.kernels.ghost_norm import ghost_norm_ref

# as csrc/fused_norm_clip.cu: an output tile's din rows and dout columns,
# co-resident blocks a SM, the most tiles a call takes, sequence rows a
# stage (bfloat16, float32)
TILE_M, TILE_N, OCC, MAX_TILES = 128, 64, 2, 2 * 132
ROWS = {torch.bfloat16: 64, torch.float32: 32}
FIT_BT = 256  # the reference engine's sequence tile (EngineConfig.bt)
FIT_LIMIT_BYTES = 12 << 20  # its VMEM guard (EngineConfig.vmem_limit_bytes)

launches = 0  # fused_norm_clip kernel calls since the last reset
_fn = None
_barriers: dict[int, torch.Tensor] = {}  # device index -> grid barrier


def padded_dims(din: int, dout: int) -> tuple[int, int]:
    """The TPU kernel's feature padding (f32 sublane / lane tiles), a copy
    of `repro.kernels.fused_clip.padded_dims`: the route rule reads it."""
    dip = -(-din // 8) * 8
    djp = -(-dout // 128) * 128 if dout > 128 else dout
    return dip, djp


def fits(din: int, dout: int) -> bool:
    """Whether the reference engine routes a (din, dout) linear to its
    fused kernel: the TPU working set, two (din, dout) f32 buffers and
    four sequence blocks, within its 12 MiB guard. The static rule of
    both `kernels` and `auto`; `auto` follows a measured table where it
    has one (see module doc)."""
    dip, djp = padded_dims(din, dout)
    need = 4 * (2 * dip * djp + 2 * FIT_BT * (dip + djp))
    return need <= FIT_LIMIT_BYTES


def takes(din: int, dout: int, device: torch.device) -> bool:
    """Whether a (din, dout) call fits on `device`: every output tile
    co-resident (`plan_fits`; the batch does not matter). Always on the
    CPU, whose plain version has no such limit."""
    if device.type != "cuda":
        return True
    tiles = -(-din // TILE_M) * -(-dout // TILE_N)
    return tiles <= min(MAX_TILES, OCC * sm_count(device))


def fused_norm_clip_ref(a: torch.Tensor, g: torch.Tensor, c: torch.Tensor,
                        extra_norms_sq: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, line for line `repro.kernels.ref
    .fused_norm_clip_ref`: the gram norm, the factor, the f32 contraction."""
    n = ghost_norm_ref(a, g)
    total = n if extra_norms_sq is None else n + extra_norms_sq
    f = clip_factor(c, total)
    return n, clip_reduce_ref(a, g, f)


class FusedPlan(NamedTuple):
    """How one kernel call splits its work (see module doc)."""
    tiles_m: int   # 128-row din tiles
    tiles_n: int   # 64-column dout tiles
    tiles: int     # output tiles, tiles_m * tiles_n
    splits: int    # ranges of examples: split s takes [s B // splits,
                   # (s + 1) B // splits)
    rounds: int    # examples of the largest split, a grid barrier each
    rows: int      # sequence rows a stage
    chunks: int    # stages an example
    grid: int      # blocks, tiles * splits, all co-resident
    scratch: int   # floats: the splits' tiles and two rounds of partials


def plan(b: int, t: int, din: int, dout: int, dtype: torch.dtype,
         sm_count: int) -> FusedPlan:
    """The plan of a call, as csrc/fused_norm_clip.cu:make_plan: as many
    splits of the examples as OCC blocks a SM allow (at most B), so a
    layer with few tiles still fills the card; a round an example."""
    tiles_m, tiles_n = -(-din // TILE_M), -(-dout // TILE_N)
    tiles = tiles_m * tiles_n
    splits = max(1, min(b, OCC * sm_count // tiles))
    rows = ROWS[dtype]
    scratch = (splits * din * dout if splits > 1 else 0) + 2 * splits * tiles
    return FusedPlan(tiles_m, tiles_n, tiles, splits, -(-b // splits), rows,
                     -(-t // rows), tiles * splits, scratch)


def plan_fits(p: FusedPlan, sm_count: int) -> bool:
    """Whether every block of the plan is co-resident at OCC a SM (and
    its tiles' partials fit the kernel's shared memory)."""
    return p.tiles <= min(MAX_TILES, OCC * sm_count)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("fused_norm_clip").fused_norm_clip_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [ci] * 6 + [vp]
        fn.restype = ci
        _fn = fn
    return _fn


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _barrier(device: torch.device) -> torch.Tensor:
    """The device's grid-barrier count, zeroed once at the first call."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    bar = _barriers.get(idx)
    if bar is None:
        bar = torch.zeros(1, dtype=torch.int64, device=f"cuda:{idx}")
        _barriers[idx] = bar
    return bar


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
    need(a.shape[0] * a.shape[1] < 2**31, "B * T must fit in int32")


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
    sms = sm_count(a.device)
    p = plan(b, t, din, dout, a.dtype, sms)
    if not plan_fits(p, sms):
        raise ValueError(f"fused_norm_clip: {p.tiles} output tiles of "
                         f"{TILE_M} x {TILE_N} do not fit the card at "
                         f"{OCC} blocks on each of its {sms} SMs")
    f32 = dict(dtype=torch.float32, device=a.device)
    scratch = torch.empty((p.scratch,), **f32)
    n = torch.empty((b,), **f32)
    dw = torch.empty((din, dout), **f32)
    extra = 0 if extra_norms_sq is None else extra_norms_sq.data_ptr()
    fn = _kernel()
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), g.data_ptr(), c.data_ptr(), extra,
                scratch.data_ptr(), _barrier(a.device).data_ptr(),
                n.data_ptr(), dw.data_ptr(), b, t, din, dout,
                int(a.dtype == torch.bfloat16), sms,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_norm_clip: kernel launch failed with CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return n, dw

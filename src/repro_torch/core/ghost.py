"""Per-example gradient norms WITHOUT materializing per-example gradients.

The counterpart of `repro.core.ghost`: the plain PyTorch paths of the
paper's fused per-layer clipping (Sec. 3.1), built on the ghost-norm
identity. For a linear layer y = x @ W with per-example activations
A_i (T x d_in) and output cotangents G_i (T x d_out),

    || A_i^T G_i ||_F^2  =  < A_i A_i^T ,  G_i G_i^T >        (gram path)

costs O(T^2 (d_in + d_out)) and never forms the (d_in x d_out) per-example
matrix; when T^2 > d_in * d_out the outer path (materialize the
per-example grad transiently) is cheaper, and `linear_norms_sq` picks by
the same cost model and memory cap as the reference. Every norm and every
clipped sum accumulates in float32.

The blocked functions give the norms² and clipped sums of a weight split
into M column ('out') or row ('in') blocks, each its own clipping group
(per-shard clipping, `core.dp_layers.dp_linear_blocked`). The policy knobs
(`outer_max_elems`, `gram_chunk`) are arguments with the reference's
defaults; the reference's module-global `configure()` is not ported: the
engine (`repro_torch.kernels.backend`) carries them per scope.
"""
from __future__ import annotations

import math

import torch

ACC_DTYPE = torch.float32

DEFAULT_OUTER_MAX_ELEMS = 1 << 22  # per-example materialized grad cap
DEFAULT_GRAM_CHUNK = 1024  # row-block size for the chunked gram path

_EPS = 1e-12


def _as3d(x: torch.Tensor) -> torch.Tensor:
    """(B, d) -> (B, 1, d); (B, T, d) unchanged; higher ranks folded into T."""
    if x.dim() == 2:
        return x[:, None, :]
    if x.dim() == 3:
        return x
    return x.reshape(x.shape[0], -1, x.shape[-1])


def gram_path_cost(t: int, din: int, dout: int) -> int:
    return t * t * (din + dout + 1)


def outer_path_cost(t: int, din: int, dout: int) -> int:
    return t * din * dout + din * dout


def clip_factor(c: torch.Tensor, norms_sq: torch.Tensor) -> torch.Tensor:
    """Per-example clip factor from encoded thresholds (f32):

        c > 0     -> min(1, c / ||g_i||)   (clip to threshold)
        c == +inf -> 1                     (no clipping)
        c < 0     -> |c|                   (direct scale, two-pass modes)
    """
    c = c.float()
    n = norms_sq.float()
    clipped = torch.clamp(c * torch.rsqrt(n + _EPS), max=1.0)
    factor = torch.where(torch.isinf(c), torch.ones_like(c), clipped)
    return torch.where(c < 0, -c, factor)


def factor_without_norms(c: torch.Tensor) -> torch.Tensor:
    """The factor of encodings that do not read the norm: 1 for +inf, |c|
    for c < 0. A finite c > 0 needs norms: it gives NaN here, so a caller
    that skipped the norms for one poisons its gradient visibly instead of
    skipping the clip (checked on the device, without a host sync)."""
    c = c.float()
    nan = torch.full_like(c, float("nan"))
    factor = torch.where(torch.isinf(c) & (c > 0), torch.ones_like(c), nan)
    return torch.where(c < 0, -c, factor)


def linear_norms_sq(a: torch.Tensor, g: torch.Tensor, *,
                    force_path: str | None = None,
                    outer_max_elems: int | None = None,
                    gram_chunk: int | None = None) -> torch.Tensor:
    """(B,) squared Frobenius norms of per-example grads A_i^T G_i.

    a: (B, T, d_in) or (B, d_in); g: (B, T, d_out) or (B, d_out).
    force_path: 'gram' | 'gram_chunked' | 'outer' | None (auto: the
    cheaper of gram and outer by flops, outer only while d_in * d_out <=
    outer_max_elems, gram chunked into (B, chunk, T) row blocks when
    T > gram_chunk)."""
    outer_cap = (DEFAULT_OUTER_MAX_ELEMS if outer_max_elems is None
                 else outer_max_elems)
    chunk = DEFAULT_GRAM_CHUNK if gram_chunk is None else gram_chunk
    a3, g3 = _as3d(a).to(ACC_DTYPE), _as3d(g).to(ACC_DTYPE)
    b, t, din = a3.shape
    dout = g3.shape[-1]
    if t == 1:
        # rank-1: ||a_i g_i^T||_F^2 = ||a_i||^2 ||g_i||^2
        return (torch.sum(a3 * a3, dim=(1, 2))
                * torch.sum(g3 * g3, dim=(1, 2)))
    path = force_path
    if path is None:
        outer_ok = din * dout <= outer_cap
        if outer_ok and (outer_path_cost(t, din, dout)
                         < gram_path_cost(t, din, dout)):
            path = "outer"
        elif t > chunk:
            path = "gram_chunked"
        else:
            path = "gram"
    if path == "gram":
        gram_a = torch.einsum("bti,bsi->bts", a3, a3)
        gram_g = torch.einsum("bto,bso->bts", g3, g3)
        return torch.sum(gram_a * gram_g, dim=(1, 2))
    if path == "gram_chunked":
        acc = torch.zeros((b,), dtype=ACC_DTYPE, device=a3.device)
        for s in range(0, t, chunk):  # zero padding contributes nothing
            ga = torch.einsum("bci,bti->bct", a3[:, s:s + chunk], a3)
            gg = torch.einsum("bco,bto->bct", g3[:, s:s + chunk], g3)
            acc = acc + torch.sum(ga * gg, dim=(1, 2))
        return acc
    if path == "outer":
        pg = torch.einsum("bti,bto->bio", a3, g3)
        return torch.sum(pg * pg, dim=(1, 2))
    raise ValueError(f"unknown path {path!r}")


def blocked_operands(a: torch.Tensor, g: torch.Tensor, num_blocks: int,
                     block_axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(shared, blocked) operands of a blocked linear: (a, g) for 'out'
    (column blocks of W are column blocks of g), (g, a) for 'in' (row
    blocks of W are column blocks of a). Raises the reference's
    ValueErrors for a width that M does not divide and for a bad axis."""
    m = num_blocks
    if m < 1:
        raise ValueError(f"num_blocks must be >= 1, got {m}")
    if block_axis == "out":
        if g.shape[-1] % m:
            raise ValueError(f"dout={g.shape[-1]} not divisible by "
                             f"num_blocks={m}")
        return a, g
    if block_axis == "in":
        if a.shape[-1] % m:
            raise ValueError(f"din={a.shape[-1]} not divisible by "
                             f"num_blocks={m}")
        return g, a
    raise ValueError(f"block_axis must be 'out' or 'in', got {block_axis!r}")


def linear_norms_sq_blocked(a: torch.Tensor, g: torch.Tensor,
                            num_blocks: int, *,
                            block_axis: str = "out") -> torch.Tensor:
    """(B, M) squared norms of per-example grads of M weight blocks.

    block_axis='out': block m is columns [m dout/M, (m+1) dout/M) of W
    (column parallel); 'in': rows [m din/M, (m+1) din/M) (row parallel).
    Each block is its own clipping group, so no norm crosses blocks:
    n[b, m] = <S_b S_bᵀ, X_b^m X_b^mᵀ> with S the shared operand and X^m
    the block's columns of the other (`blocked_operands`)."""
    s3, x3 = blocked_operands(_as3d(a).to(ACC_DTYPE),
                              _as3d(g).to(ACC_DTYPE), num_blocks, block_axis)
    b, t, _ = s3.shape
    xb = x3.reshape(b, t, num_blocks, -1)
    gram_s = torch.einsum("bti,bsi->bts", s3, s3)
    gram_xb = torch.einsum("btmo,bsmo->bmts", xb, xb)
    return torch.einsum("bts,bmts->bm", gram_s, gram_xb)


def bias_norms_sq(g: torch.Tensor) -> torch.Tensor:
    """(B,) squared norms of per-example bias grads sum_t g_t."""
    s = torch.sum(_as3d(g).to(ACC_DTYPE), dim=1)
    return torch.sum(s * s, dim=-1)


def embed_norms_sq(ids: torch.Tensor, g: torch.Tensor, *,
                   gram_chunk: int | None = None) -> torch.Tensor:
    """(B,) squared norms of per-example embedding grads (collision-exact).

    Repeated tokens within an example add into one table row, so

        ||grad_i||^2 = sum_{t,t'} 1[ids_t == ids_t'] <g_t, g_t'>.
    """
    chunk = DEFAULT_GRAM_CHUNK if gram_chunk is None else gram_chunk
    ids2 = ids.reshape(ids.shape[0], -1)
    g3 = _as3d(g).to(ACC_DTYPE)
    b, t, _ = g3.shape
    if t <= chunk:
        eq = (ids2[:, :, None] == ids2[:, None, :]).to(ACC_DTYPE)
        gram_g = torch.einsum("btd,bsd->bts", g3, g3)
        return torch.sum(eq * gram_g, dim=(1, 2))
    acc = torch.zeros((b,), dtype=ACC_DTYPE, device=g3.device)
    for s in range(0, t, chunk):  # row blocks against the full sequence
        gram = torch.einsum("bcd,btd->bct", g3[:, s:s + chunk], g3)
        eq = (ids2[:, s:s + chunk, None] == ids2[:, None, :]).to(ACC_DTYPE)
        acc = acc + torch.sum(gram * eq, dim=(1, 2))
    return acc


def scale_norms_sq(xhat: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B,) squared norms for an elementwise-scale parameter y = s * xhat:
    the per-example grad sum_t (g ⊙ xhat)_t is a (d,)-vector."""
    s = torch.sum(_as3d(g * xhat).to(ACC_DTYPE), dim=1)
    return torch.sum(s * s, dim=-1)


def vector_norms_sq(per_example_grad: torch.Tensor) -> torch.Tensor:
    """(B,) norms² of grads already materialized per example (B, ...)."""
    g = per_example_grad.to(ACC_DTYPE)
    return torch.sum(g * g, dim=tuple(range(1, g.dim())))


# ---------------------------------------------------------------------------
# Fused clipped sums (f32: a bf16 factor or sum could let a clipped
# contribution exceed the sensitivity bound; callers cast the result).
# ---------------------------------------------------------------------------


def clipped_sum_linear(a: torch.Tensor, g: torch.Tensor,
                       factors: torch.Tensor) -> torch.Tensor:
    """sum_i c_i A_i^T G_i as one scaled f32 contraction. factors: (B,)."""
    a3, g3 = _as3d(a).to(ACC_DTYPE), _as3d(g).to(ACC_DTYPE)
    gs = g3 * factors[:, None, None].to(ACC_DTYPE)
    return torch.einsum("bti,bto->io", a3, gs)


def fold_block_factors(a3: torch.Tensor, g3: torch.Tensor,
                       factors: torch.Tensor, block_axis: str = "out"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold per-block clip factors (B, M) into the blocked operand.

    Returns (a3, g3) in f32 with the factor absorbed into the tensor whose
    feature axis is blocked; shared by the plain path below and
    `kernels.clip_reduce.clip_reduce_ref` (the kernel applies the factors
    in its f32 epilogue instead). The f32 fold keeps the factors
    unquantized (sensitivity bound)."""
    a3, g3 = a3.to(ACC_DTYPE), g3.to(ACC_DTYPE)
    b, t, din = a3.shape
    dout = g3.shape[-1]
    m = factors.shape[-1]
    f = factors[:, None, :, None].to(ACC_DTYPE)
    if block_axis == "out":
        g3 = (g3.reshape(b, t, m, dout // m) * f).reshape(b, t, dout)
    else:
        a3 = (a3.reshape(b, t, m, din // m) * f).reshape(b, t, din)
    return a3, g3


def clipped_sum_linear_blocked(a: torch.Tensor, g: torch.Tensor,
                               factors: torch.Tensor, *,
                               block_axis: str = "out") -> torch.Tensor:
    """sum_i A_iᵀ diag-blocked(c_i) G_i; factors: (B, M) per block."""
    a3, g3 = fold_block_factors(_as3d(a), _as3d(g), factors, block_axis)
    return torch.einsum("bti,bto->io", a3, g3)


def clipped_sum_bias(g: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    g3 = _as3d(g).to(ACC_DTYPE)
    return torch.einsum("bto,b->o", g3, factors.to(ACC_DTYPE))


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(num_segments, ...) f32 sums of the rows of `values` (N, ...) by
    `ids` (N,): the reference's `jax.ops.segment_sum` and `.at[ids].add`,
    in an order that the data alone fixes, so a CUDA run repeats its bits
    (`index_add_` adds with float atomics there). The rows are sorted
    stably by id; a segmented scan of log2(N) elementwise passes sums each
    id's run into its last row (pass k adds the row 2^k back where it has
    the same id); those rows are written to their ids, each once."""
    flat = ids.reshape(-1).long()
    n = flat.shape[0]
    x = values.reshape((n, math.prod(values.shape[1:]))).to(ACC_DTYPE)
    out = torch.zeros((num_segments, x.shape[1]), dtype=ACC_DTYPE,
                      device=x.device)
    if n == 0:
        return out.reshape((num_segments,) + values.shape[1:])
    order = torch.sort(flat, stable=True).indices
    seg, x = flat[order], x[order]
    k = 1
    while k < n:
        same = (seg[k:] == seg[:-k])[:, None]
        x = torch.cat([x[:k], torch.where(same, x[k:] + x[:-k], x[k:])])
        k *= 2
    last = torch.ones(n, dtype=torch.bool, device=x.device)
    last[:-1] = seg[1:] != seg[:-1]
    out[seg[last]] = x[last]
    return out.reshape((num_segments,) + values.shape[1:])


def clipped_sum_embed(ids: torch.Tensor, g: torch.Tensor,
                      factors: torch.Tensor, vocab: int) -> torch.Tensor:
    ids2 = ids.reshape(ids.shape[0], -1)
    g3 = _as3d(g).to(ACC_DTYPE)
    gs = (g3 * factors[:, None, None].to(ACC_DTYPE)).reshape(-1, g3.shape[-1])
    return segment_sum(gs, ids2, vocab)


def clipped_sum_scale(xhat: torch.Tensor, g: torch.Tensor,
                      factors: torch.Tensor) -> torch.Tensor:
    gx = _as3d(g * xhat).to(ACC_DTYPE)
    return torch.einsum("btd,b->d", gx, factors.to(ACC_DTYPE))


def expert_clipped_sum(x32: torch.Tensor, g32: torch.Tensor,
                       seg: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(E, din, dout) f32: sum over slots of f[e, ex(s)] x_s g_sᵀ, an empty
    slot (seg = B) weighing 0. x32 (E, C, din), g32 (E, C, dout), seg (E,
    C), f (E, B). The BK epilogue calls it one layer at a time."""
    fpad = torch.cat([f, torch.zeros_like(f[:, :1])], dim=1)
    fslot = torch.gather(fpad, 1, seg)[..., None]  # (E, C, 1)
    return torch.bmm((x32 * fslot).transpose(1, 2), g32)


def grouped_clipped_sum(x32: torch.Tensor, g32: torch.Tensor,
                        f: torch.Tensor) -> torch.Tensor:
    """(E, din, dout) f32: sum over examples and their slots of f[e, b]
    x_s g_sᵀ. x32 (B, E, C, din), g32 (B, E, C, dout), f (E, B). The BK
    epilogue calls it one layer at a time."""
    return torch.einsum("becd,becf->edf", x32, g32 * f.T[:, :, None, None])

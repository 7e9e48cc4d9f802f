"""Ghost-op backend engine: pluggable dispatch for the fused-clipping ops.

The counterpart of `repro.kernels.backend`. Every backward of the DP
primitives (`repro_torch.core.dp_layers`) resolves its ghost ops through
the engine returned by `active()`. Two backends are registered:

  plain    the plain PyTorch paths of `repro_torch.core.ghost` (gram /
           gram_chunked / outer by the cost model); the counterpart of the
           reference's `xla` backend and the oracle of the other.
  kernels  the hand-written Hopper kernels for the linear-layer hot path
           (`kernels/ghost_norm.py`, `kernels/clip_reduce.py`), its
           blocked form and the BK epilogue (`kernels/bk.py`); the
           counterpart of `pallas`. Each wrapper runs its plain version
           for a CPU tensor and its CUDA kernel for a CUDA tensor. Ops
           with no kernel inherit the plain implementations, as
           `PallasBackend` inherits the xla ones.

Backend selection matrix (op x backend):

  op                        plain                  kernels (CPU tensor)
  ------------------------- ---------------------- --------------------------
  linear_norms_sq           gram/outer/chunked     ghost_norm (ghost_norm_ref)
  clipped_sum_linear        einsum                 clip_reduce (clip_reduce_ref)
  linear_clip (norm+clip)   composed               fused_norm_clip
                                                   (fused_norm_clip_ref) where
                                                   the route rule passes, else
                                                   composed: ghost_norm, then
                                                   clip_reduce
  linear_norms_sq_blocked   blocked grams          ghost_norm_blocked
                                                   (ghost_norm_blocked_ref)
  clipped_sum_linear_blocked                       clip_reduce with (B, M)
                            f32 fold + einsum      factors (clip_reduce_ref:
                                                   the fold + einsum)
  bias/embed/scale/vector   einsum/index_add       = plain (no kernel)
  clipped_sum_bias/embed/.. einsum/index_add       = plain (no kernel)
  scale_contract (BK)       einsum per slice       scale_contract
                                                   (scale_contract_ref)

`KernelsBackend.linear_clip` takes the fused route when the norms are
asked for and `fused_clip.fits(din, dout)` passes: the reference
engine's rule (`PallasBackend._fused_fits`), its 12 MiB guard and
`bt = 256` arithmetic kept as they are so that both packages send the
same layers to the fused kernel (the router of an MoE layer, the linears
of the reduced configs). The card has no VMEM; a route rule
measured on Hopper belongs to the measured table of ROADMAP A.11, with
`auto`. Without norms (`non_private`, a direct-scale pass) the factor
needs no norm and `clip_reduce` alone runs.

The engine is SCOPED: `with backend.scoped("kernels"): ...` pushes an
engine for the dynamic extent of the block (a `contextvars` stack, so
threads and tasks each see their own); outside any scope it is `plain`.
The reference's tunables (outer-path cap, gram chunk, tile sizes,
`prefer_fused`) stay at their defaults here: no caller of the port sets
them, so the fused route is always allowed. The one setting an engine
carries is `capture_residuals`, the reference's
`EngineConfig.capture_residuals`: the book-keeping capture pass
(`repro_torch.core.bk.capture_clipped`) scopes it on, and the DP
primitives refuse a BK channel from a forward run outside it (a capture
pass returns no parameter gradients and must never pass for a gradient
pass). The epilogue's `scale_contract` runs outside it.
"""
from __future__ import annotations

import contextlib
import contextvars

from repro_torch.core import ghost
from repro_torch.core.ghost import clip_factor, factor_without_norms
from repro_torch.kernels import bk as bk_mod
from repro_torch.kernels import clip_reduce as clip_reduce_mod
from repro_torch.kernels import fused_clip as fused_clip_mod
from repro_torch.kernels import ghost_norm as ghost_norm_mod

__all__ = [
    "Backend", "PlainBackend", "KernelsBackend", "register_backend",
    "backends", "make_engine", "active", "scoped", "clip_factor",
]

_REGISTRY: dict[str, type["Backend"]] = {}


def register_backend(name: str):
    """Class decorator: register a Backend under `name`."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


class Backend:
    """The full ghost-op surface. Base implementations are the plain
    paths; subclasses override the ops they run as kernels."""

    name = "base"

    def __init__(self, *, capture_residuals: bool = False):
        self.capture_residuals = capture_residuals

    # -- norms² ------------------------------------------------------------
    def linear_norms_sq(self, a, g):
        return ghost.linear_norms_sq(a, g)

    def linear_norms_sq_blocked(self, a, g, num_blocks, *,
                                block_axis="out"):
        return ghost.linear_norms_sq_blocked(a, g, num_blocks,
                                             block_axis=block_axis)

    def bias_norms_sq(self, g):
        return ghost.bias_norms_sq(g)

    def embed_norms_sq(self, ids, g):
        return ghost.embed_norms_sq(ids, g)

    def scale_norms_sq(self, xhat, g):
        return ghost.scale_norms_sq(xhat, g)

    def vector_norms_sq(self, per_example_grad):
        return ghost.vector_norms_sq(per_example_grad)

    # -- fused clipped sums ------------------------------------------------
    def clipped_sum_linear(self, a, g, factors):
        return ghost.clipped_sum_linear(a, g, factors)

    def clipped_sum_linear_blocked(self, a, g, factors, *,
                                   block_axis="out"):
        """sum_i A_iᵀ diag-blocked(c_i) G_i in f32; factors: (B, M)."""
        return ghost.clipped_sum_linear_blocked(a, g, factors,
                                                block_axis=block_axis)

    def clipped_sum_bias(self, g, factors):
        return ghost.clipped_sum_bias(g, factors)

    def clipped_sum_embed(self, ids, g, factors, vocab):
        return ghost.clipped_sum_embed(ids, g, factors, vocab)

    def clipped_sum_scale(self, xhat, g, factors):
        return ghost.clipped_sum_scale(xhat, g, factors)

    # -- norm + clip + reduce ----------------------------------------------
    def linear_clip(self, a, g, c, extra_norms_sq=None, *, norms=True):
        """One linear layer's whole backward clip: (n_total, f, dW).

        n_total includes `extra_norms_sq` (co-grouped params, e.g. bias);
        f = clip_factor(c, n_total); dW = sum_i f_i A_iᵀ G_i in f32. With
        `norms=False` (no threshold gradient was asked for) the norms are
        skipped and n_total is None: f comes from `factor_without_norms`,
        so `c` must be +inf or a direct scale.
        """
        if not norms:
            f = factor_without_norms(c)
            return None, f, self.clipped_sum_linear(a, g, f)
        n = self.linear_norms_sq(a, g)
        if extra_norms_sq is not None:
            n = n + extra_norms_sq
        f = clip_factor(c, n)
        return n, f, self.clipped_sum_linear(a, g, f)

    # -- BK epilogue: scaled contraction over cached residuals -------------
    def scale_contract(self, a, g, factors):
        """sum_i f[s,i] A[s,i]ᵀ G[s,i] per stack slice (core.bk).

        a: (S, B, T, din); g: (S, B, T, dout); factors: (S, B) ->
        (S, din, dout) f32. Accepts the unstacked 3-D form too.
        """
        return bk_mod.scale_contract_ref(a, g, factors)


@register_backend("plain")
class PlainBackend(Backend):
    """Plain PyTorch paths (repro_torch.core.ghost): the oracle."""


@register_backend("kernels")
class KernelsBackend(Backend):
    """The ghost_norm and clip_reduce kernels for the linear hot path, or
    fused_norm_clip where the route rule passes; ghost_norm_blocked for
    blocked linears, scale_contract for the BK epilogue; the plain paths
    for the cheap ops (bias/embed/scale/vector)."""

    def linear_clip(self, a, g, c, extra_norms_sq=None, *, norms=True):
        a3, g3 = ghost._as3d(a), ghost._as3d(g)
        if not (norms and fused_clip_mod.fits(a3.shape[-1], g3.shape[-1])):
            return super().linear_clip(a3, g3, c, extra_norms_sq,
                                       norms=norms)
        extra = (None if extra_norms_sq is None
                 else extra_norms_sq.float().contiguous())
        n_w, dw = fused_clip_mod.fused_norm_clip(
            a3.contiguous(), g3.contiguous(), c.float().contiguous(), extra)
        n = n_w if extra is None else n_w + extra
        return n, clip_factor(c, n), dw

    def linear_norms_sq(self, a, g):
        a3, g3 = ghost._as3d(a), ghost._as3d(g)
        return ghost_norm_mod.ghost_norm(a3.contiguous(), g3.contiguous())

    def linear_norms_sq_blocked(self, a, g, num_blocks, *,
                                block_axis="out"):
        a3, g3 = ghost._as3d(a), ghost._as3d(g)
        return ghost_norm_mod.ghost_norm_blocked(
            a3.contiguous(), g3.contiguous(), num_blocks,
            block_axis=block_axis)

    def clipped_sum_linear(self, a, g, factors):
        a3, g3 = ghost._as3d(a), ghost._as3d(g)
        return clip_reduce_mod.clip_reduce(
            a3.contiguous(), g3.contiguous(), factors.float().contiguous())

    def clipped_sum_linear_blocked(self, a, g, factors, *,
                                   block_axis="out"):
        # the per-block factors go into clip_reduce's f32 epilogue: the
        # reference's pallas engine folds them into an f32 copy of the
        # blocked operand first, the same function
        a3, g3 = ghost._as3d(a), ghost._as3d(g)
        return clip_reduce_mod.clip_reduce(
            a3.contiguous(), g3.contiguous(), factors.float().contiguous(),
            block_axis)

    def scale_contract(self, a, g, factors):
        return bk_mod.scale_contract(a.contiguous(), g.contiguous(),
                                     factors.float().contiguous())


# ---------------------------------------------------------------------------
# Scoped engine resolution.
# ---------------------------------------------------------------------------

_DEFAULT = PlainBackend()
_STACK: contextvars.ContextVar[tuple[Backend, ...]] = contextvars.ContextVar(
    "ghost_backend_stack", default=())


def make_engine(backend: str, *, capture_residuals: bool = False
                ) -> Backend:
    """The registered backend named `backend`."""
    try:
        cls = _REGISTRY[backend]
    except KeyError:
        raise ValueError(f"unknown ghost backend {backend!r}; "
                         f"registered: {backends()}") from None
    return cls(capture_residuals=capture_residuals)


def active() -> Backend:
    """The engine in effect (innermost `scoped`, else `plain`)."""
    stack = _STACK.get()
    return stack[-1] if stack else _DEFAULT


@contextlib.contextmanager
def scoped(backend: str | None = None, *, capture_residuals: bool = False):
    """Push the engine `backend` (default: the active engine's backend)
    for the dynamic extent of the block."""
    eng = make_engine(active().name if backend is None else backend,
                      capture_residuals=capture_residuals)
    token = _STACK.set(_STACK.get() + (eng,))
    try:
        yield eng
    finally:
        _STACK.reset(token)

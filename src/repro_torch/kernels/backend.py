"""Ghost-op backend engine: pluggable dispatch for the fused-clipping ops.

The counterpart of `repro.kernels.backend`. Every backward of the DP
primitives (`repro_torch.core.dp_layers`) and every paged decode
(`models.attention`) resolves its ghost ops through the engine returned by
`active()`. Three backends are registered:

  plain    the plain PyTorch paths of `repro_torch.core.ghost` (gram /
           gram_chunked / outer by the cost model) and `paged_attn_ref`,
           on the CPU and on the card alike; the counterpart of the
           reference's `xla` backend and the oracle of the others.
  kernels  the hand-written Hopper kernels for the linear-layer hot path
           (`kernels/ghost_norm.py`, `kernels/clip_reduce.py`,
           `kernels/fused_clip.py`), its blocked form, the BK epilogue
           (`kernels/bk.py`) and the paged decode (`kernels/paged_attn.py`);
           the counterpart of `pallas`. Each wrapper runs its plain version
           for a CPU tensor and its CUDA kernel for a CUDA tensor. Ops
           with no kernel inherit the plain implementations, as
           `PallasBackend` inherits the xla ones.
  auto     per op and shape, the measured argmin of the installed autotune
           table (`kernels.autotune`) where it has measured the bucket,
           else the static model (`choose_op`): `plain` for a CPU tensor,
           on the card `kernels` for every op, the fused route where
           `fused_clip.fits` passes. So `auto` with no table, or with
           `autotune=False`, launches exactly what `kernels` launches on
           the card. A failed build or launch raises under `auto` as under
           `kernels`: it never turns into the plain path.

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
  bias/embed/scale/vector   einsum/segment_sum     = plain (no kernel)
  clipped_sum_bias/embed/.. einsum/segment_sum     = plain (no kernel)
  scale_contract (BK)       einsum per slice       scale_contract
                                                   (scale_contract_ref)
  paged_attn (decode)       paged_attn_ref         paged_attn (paged_attn_ref)

Under `auto` each op is one table op: `norms` (linear_norms_sq and its
blocked form), `clip_sum` (clipped_sum_linear and its blocked form),
`linear_clip`, `scale_contract` and `paged_attn`, each choosing between
the candidates `plain` and `kernels`; `linear_clip` also has `fused` (the
one `fused_norm_clip` launch; there `kernels` is the composed pair).
`candidate(op, name)` is the implementation of each, what the sweep
times and what `auto` runs.

`KernelsBackend.linear_clip` takes the fused route when the norms are
asked for and `fused_clip.fits(din, dout)` passes: the reference
engine's rule (`PallasBackend._fused_fits`), its 12 MiB guard and
`bt = 256` arithmetic kept as they are so that both packages send the
same layers to the fused kernel (the router of an MoE layer, the linears
of the reduced configs). The card has no VMEM: under `auto` a measured
table decides the route instead. Without norms (`non_private`, a
direct-scale pass) the factor needs no norm and `clip_reduce` alone runs.

The engine is SCOPED: `with backend.scoped("kernels"): ...` pushes an
engine for the dynamic extent of the block (a `contextvars` stack, so
threads and tasks each see their own); outside any scope it is `plain`,
so a training entry point scopes its engine explicitly, except that the
paged decode runs its kernel there on a CUDA tensor: a server that
scopes nothing serves the card through the kernel, and only an explicit
`plain` engine runs `paged_attn_ref` on the card. The reference's tunables
(outer-path cap, gram chunk, tile sizes, `prefer_fused`) stay at their
defaults here: no caller of the port sets them, so the fused route is
always allowed. An engine carries two settings of the reference's
`EngineConfig`: `autotune` (False: `auto` ignores any installed table)
and `capture_residuals`: the book-keeping capture pass
(`repro_torch.core.bk.capture_clipped`) scopes it on, and the DP
primitives refuse a BK channel from a forward run outside it (a capture
pass returns no parameter gradients and must never pass for a gradient
pass). The epilogue's `scale_contract` runs outside it.

Every engine counts its op calls in `OP_CALLS` (the outermost call only:
`linear_clip`'s own norms and clipped sum are not counted again), and
`linear_clip` also under `linear_clip[fits]` where the norms are asked
for and `fused_clip.fits` passes, and `linear_clip[no_norms]` where they
are not: what the `kernels` engine would launch for the same calls
(`repro_torch.analysis.graph.kernel_launches`). The dry run reads them
off a traced step.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import threading

import torch

from repro_torch.core import ghost
from repro_torch.core.ghost import clip_factor, factor_without_norms
from repro_torch.kernels import autotune as autotune_mod
from repro_torch.kernels import bk as bk_mod
from repro_torch.kernels import clip_reduce as clip_reduce_mod
from repro_torch.kernels import fused_clip as fused_clip_mod
from repro_torch.kernels import ghost_norm as ghost_norm_mod
from repro_torch.kernels import paged_attn as paged_attn_mod

__all__ = [
    "Backend", "PlainBackend", "KernelsBackend", "AutoBackend",
    "register_backend", "backends", "make_engine", "active", "scoped",
    "clip_factor", "choose_linear_path", "choose_op", "candidate",
    "OPS", "OP_CALLS", "reset_op_calls",
]

_REGISTRY: dict[str, type["Backend"]] = {}

# the engine ops (`Backend` methods) that `OP_CALLS` counts
OPS = ("linear_norms_sq", "linear_norms_sq_blocked", "bias_norms_sq",
       "embed_norms_sq", "scale_norms_sq", "vector_norms_sq",
       "clipped_sum_linear", "clipped_sum_linear_blocked",
       "clipped_sum_bias", "clipped_sum_embed", "clipped_sum_scale",
       "linear_clip", "scale_contract", "paged_attn")
OP_CALLS: collections.Counter = collections.Counter()
_NESTED = threading.local()


def reset_op_calls() -> None:
    OP_CALLS.clear()


def _counted(name: str, fn):
    """`fn`, counting its outermost calls in OP_CALLS."""

    @functools.wraps(fn)
    def op(self, *args, **kwargs):
        depth = getattr(_NESTED, "depth", 0)
        if not depth:
            OP_CALLS[name] += 1
            if name == "linear_clip":
                if not kwargs.get("norms", True):
                    OP_CALLS["linear_clip[no_norms]"] += 1
                elif fused_clip_mod.fits(args[0].shape[-1],
                                         args[1].shape[-1]):
                    OP_CALLS["linear_clip[fits]"] += 1
        _NESTED.depth = depth + 1
        try:
            return fn(self, *args, **kwargs)
        finally:
            _NESTED.depth = depth

    return op


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

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for op in OPS:
            if op in cls.__dict__:
                setattr(cls, op, _counted(op, cls.__dict__[op]))

    def __init__(self, *, capture_residuals: bool = False,
                 autotune: bool = True):
        self.capture_residuals = capture_residuals
        self.autotune = autotune

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

    # -- paged decode attention (launch.engine's paged plane) --------------
    def paged_impl(self, *, t=None, din=None, dout=None,
                   device=None) -> str:
        """Which implementation `paged_attn` resolves to: 'plain' or
        'kernels'. `auto` decides from the shape hints (t = logical
        context, din = query dim, dout = value dim); the fixed backends
        ignore them."""
        return "plain"

    def paged_attn(self, q, kpool, vpool, pt, pos, *, scale, dv=None):
        """One-token attention through a page table (kernels/paged_attn.py
        shapes). Base = its plain version, on any device."""
        return paged_attn_mod.paged_attn_ref(q, kpool, vpool, pt, pos,
                                             scale=scale, dv=dv)


for _op in OPS:
    setattr(Backend, _op, _counted(_op, Backend.__dict__[_op]))


@register_backend("plain")
class PlainBackend(Backend):
    """Plain PyTorch paths (repro_torch.core.ghost): the oracle."""


class _UnscopedBackend(PlainBackend):
    """The engine outside any scope: the plain ghost ops, but the paged
    decode through the kernel's wrapper (its CUDA kernel for a CUDA
    tensor, its plain version for a CPU one), so a server that scopes no
    engine never serves the card through `paged_attn_ref`. Only an
    explicit `plain` engine does that."""

    def paged_impl(self, *, t=None, din=None, dout=None,
                   device=None) -> str:
        return "kernels" if _on_gpu(device) else "plain"

    def paged_attn(self, q, kpool, vpool, pt, pos, *, scale, dv=None):
        return paged_attn_mod.paged_attn(q, kpool, vpool, pt, pos,
                                         scale=scale, dv=dv)


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
        return self.fused_linear_clip(a3, g3, c, extra_norms_sq)

    def fused_linear_clip(self, a, g, c, extra_norms_sq=None):
        """`linear_clip` with norms by one `fused_norm_clip` launch."""
        a3, g3 = ghost._as3d(a), ghost._as3d(g)
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

    def paged_impl(self, *, t=None, din=None, dout=None,
                   device=None) -> str:
        return "kernels"

    def paged_attn(self, q, kpool, vpool, pt, pos, *, scale, dv=None):
        return paged_attn_mod.paged_attn(q, kpool, vpool, pt, pos,
                                         scale=scale, dv=dv)


def _on_gpu(device=None) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def choose_linear_path(t: int, din: int, dout: int, *,
                       on_gpu: bool | None = None) -> str:
    """The STATIC model's decision for one ghost op of a linear: 'plain'
    or 'kernels'. The fallback for the buckets the autotune table has not
    measured (`choose_op` is the full decision). Off the card the plain
    path (the counterpart of the reference's off-TPU `xla`); on it the
    kernels at every shape: each beat its plain version at every shape
    the smoke run timed. `on_gpu` None: whether a CUDA device exists."""
    return "kernels" if (_on_gpu() if on_gpu is None else on_gpu) \
        else "plain"


def choose_op(op: str, t: int, din: int, dout: int, *,
              autotune: bool = True, on_gpu: bool | None = None,
              table: "autotune_mod.AutotuneTable | None" = None) -> str:
    """The auto backend's FULL decision for one engine op: the measured
    argmin of the autotune table where this (op, shape bucket) has a
    measurement, on the card and off it (`plain` only where it beats every
    other candidate by `autotune.PLAIN_MARGIN`), else the static model;
    for `linear_clip` on the card that is `fused` where `fused_clip.fits`
    passes (the `kernels` engine's route). op is one of `autotune.OPS`;
    `table=None` consults the installed table
    (`autotune.installed_table()`); `autotune=False` ignores any."""
    if autotune:
        tab = (table if table is not None
               else autotune_mod.installed_table())
        if tab is not None:
            measured = tab.best(op, t, din, dout,
                                plain_margin=autotune_mod.PLAIN_MARGIN)
            if measured is not None:
                return measured
    path = choose_linear_path(t, din, dout, on_gpu=on_gpu)
    if op == "linear_clip" and path == "kernels" and \
            fused_clip_mod.fits(din, dout):
        return autotune_mod.FUSED
    return path


_OP_METHOD = {"norms": "linear_norms_sq", "clip_sum": "clipped_sum_linear",
              "scale_contract": "scale_contract",
              "paged_attn": "paged_attn"}


def _candidate(plain: "Backend", kernels: "KernelsBackend", op: str,
               name: str):
    if name not in autotune_mod.candidates(op):
        raise ValueError(f"unknown candidate {name!r} of {op!r}")
    if op == "linear_clip":
        if name == "plain":
            return plain.linear_clip
        if name == autotune_mod.FUSED:
            return kernels.fused_linear_clip
        # the composed pair ghost_norm + clip_reduce, never the fused route
        return functools.partial(Backend.linear_clip, kernels)
    return getattr(plain if name == "plain" else kernels, _OP_METHOD[op])


def candidate(op: str, name: str):
    """The implementation of candidate `name` of table op `op` (the
    arguments of its engine method): what the sweep times and `auto`
    runs."""
    return _candidate(PlainBackend(), KernelsBackend(), op, name)


@register_backend("auto")
class AutoBackend(Backend):
    """Per op and shape bucket: the installed table's measured argmin,
    else the static model (`choose_op`), between the plain and kernels
    engines (and the fused route of `linear_clip`)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._plain = PlainBackend(**kw)
        self._kernels = KernelsBackend(**kw)

    def choice(self, op: str, a, g) -> str:
        """The candidate `op` takes for operands a (B, T, din) and g
        (B, T, dout) (or their (B, din) / (B, dout) forms)."""
        a3, g3 = ghost._as3d(a), ghost._as3d(g)
        return choose_op(op, a3.shape[1], a3.shape[-1], g3.shape[-1],
                         autotune=self.autotune, on_gpu=a3.is_cuda)

    def _engine(self, op: str, a, g) -> Backend:
        return (self._kernels if self.choice(op, a, g) == "kernels"
                else self._plain)

    # the blocked ops run the same kernels as the unblocked ones, so they
    # share the "norms" / "clip_sum" buckets
    def linear_norms_sq(self, a, g):
        return self._engine("norms", a, g).linear_norms_sq(a, g)

    def linear_norms_sq_blocked(self, a, g, num_blocks, *,
                                block_axis="out"):
        return self._engine("norms", a, g).linear_norms_sq_blocked(
            a, g, num_blocks, block_axis=block_axis)

    def clipped_sum_linear(self, a, g, factors):
        return self._engine("clip_sum", a, g).clipped_sum_linear(
            a, g, factors)

    def clipped_sum_linear_blocked(self, a, g, factors, *,
                                   block_axis="out"):
        return self._engine("clip_sum", a, g).clipped_sum_linear_blocked(
            a, g, factors, block_axis=block_axis)

    def linear_clip(self, a, g, c, extra_norms_sq=None, *, norms=True):
        if not norms:  # the factor needs no norm: a clip_sum alone
            return super().linear_clip(a, g, c, extra_norms_sq, norms=False)
        a3, g3 = ghost._as3d(a), ghost._as3d(g)
        name = self.choice("linear_clip", a3, g3)
        if name == autotune_mod.FUSED and not fused_clip_mod.takes(
                a3.shape[-1], g3.shape[-1], a3.device):
            # a bucket-mate of a measured shape with more output tiles
            # than the card holds at once
            name = "kernels"
        return _candidate(self._plain, self._kernels, "linear_clip",
                          name)(a3, g3, c, extra_norms_sq)

    def scale_contract(self, a, g, factors):
        # (S, B, T, d) or the unstacked (B, T, d): T is dim -2 of both
        name = choose_op("scale_contract", a.shape[-2], a.shape[-1],
                         g.shape[-1], autotune=self.autotune,
                         on_gpu=a.is_cuda)
        eng = self._kernels if name == "kernels" else self._plain
        return eng.scale_contract(a, g, factors)

    def paged_impl(self, *, t=None, din=None, dout=None,
                   device=None) -> str:
        """With shape hints this consults the table as every other op
        does; without, the static rule (the kernel on the card)."""
        on_gpu = _on_gpu(device)
        if t is not None:
            return choose_op("paged_attn", t, din or 0, dout or 0,
                             autotune=self.autotune, on_gpu=on_gpu)
        return "kernels" if on_gpu else "plain"

    def paged_attn(self, q, kpool, vpool, pt, pos, *, scale, dv=None):
        t, din, dout = autotune_mod.paged_attn_dims(
            q, pt, kpool.shape[1], dv if dv is not None else vpool.shape[-1])
        impl = self.paged_impl(t=t, din=din, dout=dout, device=q.device)
        eng = self._kernels if impl == "kernels" else self._plain
        return eng.paged_attn(q, kpool, vpool, pt, pos, scale=scale, dv=dv)


# ---------------------------------------------------------------------------
# Scoped engine resolution.
# ---------------------------------------------------------------------------

_DEFAULT = _UnscopedBackend()
_STACK: contextvars.ContextVar[tuple[Backend, ...]] = contextvars.ContextVar(
    "ghost_backend_stack", default=())


def make_engine(backend: str, *, capture_residuals: bool = False,
                autotune: bool = True) -> Backend:
    """The registered backend named `backend`."""
    try:
        cls = _REGISTRY[backend]
    except KeyError:
        raise ValueError(f"unknown ghost backend {backend!r}; "
                         f"registered: {backends()}") from None
    return cls(capture_residuals=capture_residuals, autotune=autotune)


def active() -> Backend:
    """The engine in effect (innermost `scoped`, else `plain` with the
    paged decode's kernel on the card)."""
    stack = _STACK.get()
    return stack[-1] if stack else _DEFAULT


@contextlib.contextmanager
def scoped(backend: str | None = None, *, capture_residuals: bool = False,
           autotune: bool | None = None):
    """Push the engine `backend` (default: the active engine's backend)
    for the dynamic extent of the block; `autotune` None keeps the active
    engine's setting."""
    outer = active()
    eng = make_engine(outer.name if backend is None else backend,
                      capture_residuals=capture_residuals,
                      autotune=outer.autotune if autotune is None
                      else autotune)
    token = _STACK.set(_STACK.get() + (eng,))
    try:
        yield eng
    finally:
        _STACK.reset(token)

"""Cost, collective and pass analysis of a traced step: the counterpart of
the names of `repro.analysis.hlo` that the dry run reads (`analyze_hlo`,
`backward_passes`, `classify_collectives`, `summarize_axis_rows`,
`filter_model_norm_rows`; the reference's `launch/hlo_analysis.py`
re-exports them).

Torch has no HLO. The dry run (`launch.dryrun`) runs the port's real step
eagerly, on meta tensors (shapes and dtypes, no memory), and
`analyze_step` reads it while it runs, through one dispatch mode
(`StepMeter`):

  flops         FlopCounterMode's formulas, which count the matmul-like
                ops only (mm, bmm, addmm, baddbmm, convolutions,
                attention), where HLO counts every op;
  bytes         the sum of every aten op's operand and result bytes, views
                excluded: an UNFUSED upper bound (`BYTES_KIND`), where
                XLA counts a fusion's boundary only;
  transcendentals  None: no faithful count;
  peak_bytes    the peak of the live storages' bytes, the inputs counted
                from the start, as MemTracker counts them: what the
                caching allocator would hold, the stand-in for XLA's temp
                bytes;
  collectives   from the mesh's collective log (`launch.mesh.Mesh.log`),
                each entry under its HLO kind name with its result bytes
                (an all-gather's result is its group's pieces);
  op_calls      the ghost-op engine's calls per op
                (`kernels.backend.OP_CALLS`), from which
                `kernel_launches` predicts what the `kernels` engine
                would launch for the same step;
  linear_calls  the DP linears' forwards and backwards
                (`core.dp_layers.LINEAR_CALLS`), read by
                `backward_passes`;
  dynamic_shapes  the ops whose output shape depends on values
                (`dynamic_shape`: nonzero, masked_select, unique, a
                boolean index, repeat_interleave by a tensor), each
                recorded before it runs, so that a meta trace that then
                fails still reports it (the static audit's
                HLO-SHAPE-STABLE, `analysis.rules`).

A row of `classify_collectives` takes its axes from the process group the
collective ran over (the log's entry), not from parsed replica groups.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import dp_layers
from repro_torch.kernels import backend

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
BYTES_KIND = "unfused_upper_bound"


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0  # unfused upper bound (BYTES_KIND)
    transcendentals: float | None = None
    collectives: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int | None = None
    op_calls: dict = dataclasses.field(default_factory=dict)
    linear_calls: dict = dataclasses.field(default_factory=dict)
    dynamic_shapes: list = dataclasses.field(default_factory=list)


def leaf_tensors(tree) -> list[torch.Tensor]:
    """The tensors among the leaves of `tree` (dicts, lists, tuples)."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_CUDA_BLOCK = 512  # the caching allocator's smallest block, bytes

# overloads whose output shape depends on their inputs' values
_DYNAMIC = ("nonzero.default", "masked_select.default", "_unique.default",
            "_unique2.default", "unique_dim.default",
            "unique_consecutive.default", "unique_dim_consecutive.default",
            "repeat_interleave.Tensor", "repeat_interleave.self_Tensor",
            "argwhere.default")


def dynamic_shape(func, args) -> bool:
    """Whether `func(*args)`'s output shape depends on values: the
    `_DYNAMIC` overloads and an index by a boolean tensor. (An int
    `repeat_interleave` reaches the dispatcher as expand and view ops.)"""
    name = func.__name__
    if name in _DYNAMIC:
        return True
    if name == "index.Tensor" and len(args) > 1:
        return any(isinstance(i, torch.Tensor)
                   and i.dtype in (torch.bool, torch.uint8)
                   for i in args[1] if i is not None)
    return False


class StepMeter(TorchDispatchMode):
    """One dispatch mode that reads a step as it runs: flops by
    FlopCounterMode's formulas (`torch.utils.flop_counter.flop_registry`,
    matmul-like ops only), every non-view op's operand and result bytes,
    and the bytes of the live storages with their peak: each storage an
    op makes counts from its creation until it is freed (rounded up to
    the caching allocator's 512-byte blocks for `device` cuda), as
    MemTracker counts them; `track` adds tensors made before."""

    def __init__(self, device="cpu"):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self._round = torch.device(device).type == "cuda"
        self._live: dict[int, tuple[Any, int]] = {}  # id -> (ref, bytes)
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.dynamic_shapes: list[tuple[str, str]] = []

    def _freed(self, key: int, nbytes: int):
        def done(_ref):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= nbytes
        return done

    def track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            if self._round:
                n = -(-n // _CUDA_BLOCK) * _CUDA_BLOCK
            self._live[key] = (weakref.ref(st, self._freed(key, n)), n)
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if dynamic_shape(func, args):
            self.dynamic_shapes.append((func.__name__, str(
                [tuple(t.shape) for t in leaf_tensors(args)])))
        out = func(*args, **kwargs)
        formula = self._formulas.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view:
            made = leaf_tensors(out)
            self.bytes += sum(map(_nbytes, leaf_tensors((args, kwargs))))
            self.bytes += sum(map(_nbytes, made))
            self.track(made)
        return out


def collective_bytes(mesh, entry, kind: str) -> int:
    """Result bytes of one logged collective: an all-gather returns its
    group's pieces, the others a tensor of the logged one's size."""
    if entry.dtype == "object":
        return 0
    size = getattr(torch, entry.dtype).itemsize * entry.numel
    if kind == "all-gather":
        size *= math.prod(mesh.shape[a] for a in entry.axes)
    return size


def classify_collectives(mesh) -> list[dict]:
    """Per (kind, axes, site) rows of `mesh`'s collective log: [{kind,
    site, axes, count, bytes}], the largest bytes first (the host's object
    broadcast has no HLO kind and is left out)."""
    rows: dict[tuple, dict] = {}
    for entry, kind in zip(mesh.log, mesh.kinds):
        if kind not in COLLECTIVES:
            continue
        slot = rows.setdefault((kind, tuple(entry.axes), entry.site),
                               {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += collective_bytes(mesh, entry, kind)
    out = [{"kind": k[0], "axes": k[1], "site": k[2], **v}
           for k, v in rows.items()]
    out.sort(key=lambda r: -r["bytes"])
    return out


def summarize_axis_rows(rows: list[dict]) -> dict:
    """`classify_collectives` rows summed by the axes they span:
    {'model' | 'data' | 'data+model' | ... | 'intra': {count, bytes}}."""
    out: dict[str, dict] = {}
    for r in rows:
        key = "+".join(r["axes"]) or "intra"
        slot = out.setdefault(key, {"count": 0, "bytes": 0})
        slot["count"] += r["count"]
        slot["bytes"] += r["bytes"]
    return out


def filter_model_norm_rows(rows: list[dict], *,
                           model_axis: str = "model") -> list[dict]:
    """Rows that cross the model axis AND carry norms (a site naming
    'norm'): per-device clipping gives [], flat clipping its (B,)
    flat_norm_psum."""
    return [r for r in rows
            if model_axis in r["axes"] and "norm" in r["site"].lower()]


def collectives_by_kind(rows: list[dict]) -> dict:
    """{kind: {count, bytes}} for each HLO kind, and total_bytes."""
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for r in rows:
        out[r["kind"]]["count"] += r["count"]
        out[r["kind"]]["bytes"] += r["bytes"]
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def analyze_step(fn: Callable, *args, mesh=None, device="cpu"
                 ) -> tuple[Totals, Any]:
    """Run `fn(*args)` under a `StepMeter` and read it: (Totals, fn's
    result). The engine's op calls, the linears' calls and `mesh`'s
    collective log are reset first; every tensor of `args` counts toward
    the memory from the start, so `peak_bytes` includes the inputs.
    `device`: the device whose allocator the peak models (cuda rounds
    each storage to 512 bytes). Run it on meta tensors (the dry run's) to
    allocate nothing, or on real tensors to read the same counts. An
    exception `fn` raises carries the Totals read up to it
    (`partial_totals`)."""
    backend.reset_op_calls()
    dp_layers.LINEAR_CALLS.clear()
    if mesh is not None:
        mesh.reset_log()
    meter = StepMeter(device)
    meter.track(leaf_tensors(args))

    def read() -> Totals:
        return Totals(flops=float(meter.flops), bytes=float(meter.bytes),
                      peak_bytes=int(meter.peak_bytes),
                      op_calls=dict(backend.OP_CALLS),
                      linear_calls=dict(dp_layers.LINEAR_CALLS),
                      dynamic_shapes=list(meter.dynamic_shapes))

    try:
        with meter:
            out = fn(*args)
    except Exception as e:
        # what was read up to the failure (a data-dependent shape cannot
        # run on meta tensors): the audit reports it
        e.partial_totals = read()
        raise
    totals = read()
    if mesh is not None:
        totals.collectives = collectives_by_kind(classify_collectives(mesh))
    return totals, out


def backward_passes(linear_calls: dict, loss_calls: int,
                    microbatches: int) -> int | float:
    """Full backward traversals of the model a microbatch, counted in the
    traced step: the DP linears' backwards over (their graph-joining
    forwards a loss evaluation) x microbatches. 1 under bk, per_layer and
    non_private, 2 under twopass; a non-integer where a linear's backward
    was skipped."""
    per_pass = linear_calls.get("forward", 0) / max(loss_calls, 1)
    if not per_pass:
        return 0
    passes = linear_calls.get("backward", 0) / per_pass / microbatches
    return int(passes) if passes == int(passes) else passes


def kernel_launches(op_calls: dict) -> dict[str, int]:
    """What the `kernels` engine launches for these engine op calls (one
    launch a wrapper call): `linear_clip` fused where it fits
    (`linear_clip[fits]`), a clip_reduce alone without norms
    (`linear_clip[no_norms]`), else ghost_norm then clip_reduce."""
    c = lambda k: int(op_calls.get(k, 0))  # noqa: E731
    fits, no_norms = c("linear_clip[fits]"), c("linear_clip[no_norms]")
    composed = c("linear_clip") - fits - no_norms
    return {"ghost_norm": c("linear_norms_sq") + composed,
            "ghost_norm_blocked": c("linear_norms_sq_blocked"),
            "clip_reduce": (c("clipped_sum_linear")
                            + c("clipped_sum_linear_blocked")
                            + composed + no_norms),
            "fused_norm_clip": fits,
            "scale_contract": c("scale_contract"),
            "paged_attn": c("paged_attn")}

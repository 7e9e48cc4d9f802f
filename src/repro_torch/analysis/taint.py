"""Taint pass over a traced train step: prove clip -> noise -> update.

The counterpart of `repro.analysis.jaxpr_taint`. The DP guarantee of
every clipping mode is a DATAFLOW property of the train step: every path
from a batch-derived value to a trainable parameter's update must pass
through a per-example clip-factor multiply, and exactly one Gaussian
draw, from a generator seeded with a leaf-specific part, must join each
leaf's gradient before the optimizer consumes it.

Torch has no jaxpr. The pass runs the port's REAL step once on meta
tensors (as the dry run does, `launch.dryrun`) under one dispatch mode,
`TaintMode`, which sees every aten op the step runs, its backward
included, and carries a taint per STORAGE: the port writes its grads,
its noise and its optimizer in place and through slice views
(`core/dp_sgd.py:_noise_leaf`'s `part.copy_`, `optim/optimizers.py`),
so an in-place op joins the old taint of the storage it writes with the
new one.

Taint lattice (the reference's, monotone):

  raw      value depends on the batch without an intervening clip factor
  clipped  batch-derived but absorbed through a clip-factor multiply
  factor   value produced under the `dp_clip_factor` scope
  draws    set of noise-draw ids that reached this value
  key      the seed parts of the generator a draw came from (None: the
           value is no draw)

The clipping engine marks its semantics with `core.scopes.named_scope`:
`dp_clip_factor` around the factor computations (`core.ghost.clip_factor`,
`core.clipping.group_clip_factors` / `flat_clip_factors`) and
`dp_noise_add:<leaf>` around each leaf's draw and add
(`core.dp_sgd.add_noise_to_grads`). The scope stack is thread-local, so a
DP primitive's backward marks its factor on the thread it runs on.

Rules of the walk:
  * only multiplicative ops absorb (mul, div, mm / bmm / dot products,
    convolutions; addmm-like ops absorb their product and join their
    additive operand): a raw operand multiplied by a factor or clipped
    operand is clipped, a raw value joined additively stays raw;
  * an op under `dp_clip_factor` yields factor data (the norms it reads
    are consumed there);
  * scatter-like ops ignore their index operand (`index_add`,
    `index_put` with accumulate, `scatter`, `scatter_add`,
    `scatter_reduce`, `embedding_dense_backward`): the indices choose
    WHERE a clipped update lands, as in the reference;
  * an op that selects by an index, condition or mask operand (`index`,
    `gather`, `index_select`, `where`, `masked_fill`, an overwriting
    `index_put`) drops that operand's taint when what it selects from is
    clipped or factor data, and joins it otherwise: the port's fixed-order
    `core.ghost.segment_sum` sorts clipped rows by raw ids (the
    reference's is one scatter-add), while `table[ids]` stays raw;
  * every other op joins all its inputs into all its outputs, which can
    only create false positives.

Noise and keys. The port's noise keys are host-side generator seeds
(`dp_sgd.generator(device, seed, step, stable_hash(path))`). A draw is a
`dp_sgd.standard_normal` call under a `dp_noise_add:<leaf>` scope,
identified by (leaf, rows, call): a leaf drawn slice by slice along its
first axis is one draw per row range. `audited_draws` makes the draws
shape-only and records each generator's seed parts.

The pass runs the `plain` engine, as the reference pins `backend="xla"`:
a hand-written kernel writes its output through ctypes, not through the
dispatcher, so no mode can see the factor it applies. The kernels are
held to their plain versions on the card (`chip_smoke.py`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import ERROR, Finding
from repro_torch.core import scopes
from repro_torch.core.scopes import CLIP_SCOPE
from repro_torch.core.spec import tree_leaves

_NOISE_LEAF = re.compile(re.escape(scopes.NOISE_SCOPE) + r"([^/]+)")

# ops whose result a clip-factor operand scales rather than adds to
_MULTIPLICATIVE = frozenset({
    "mul", "div", "mm", "bmm", "matmul", "dot", "vdot", "mv", "outer",
    "_scaled_mm", "convolution", "_convolution", "conv1d", "conv2d",
    "conv3d", "einsum", "tensordot",
})
# input + product: the first operand adds, the next two multiply
_ADD_PRODUCT = frozenset({"addmm", "baddbmm", "addbmm", "addmv", "addr"})
# the index operand routes, it does not contribute magnitude
_SCATTER = frozenset({
    "index_add", "scatter", "scatter_add", "scatter_reduce",
    "embedding_dense_backward",
})
_INDEX_PUT = frozenset({"index_put", "_index_put_impl"})
# operands that select or route rather than carry magnitude
_ROUTING = frozenset({"index", "indices", "condition", "mask"})


@dataclasses.dataclass(frozen=True)
class Taint:
    raw: bool = False
    clipped: bool = False
    factor: bool = False
    draws: frozenset = frozenset()
    key: frozenset | None = None  # a draw's seed parts; None = no draw

    def join(self, other: "Taint") -> "Taint":
        if self == other:
            return self
        if self.key is None and other.key is None:
            key = None
        else:
            key = (self.key or frozenset()) | (other.key or frozenset())
        return Taint(self.raw or other.raw, self.clipped or other.clipped,
                     self.factor or other.factor, self.draws | other.draws,
                     key)


CLEAN = Taint()
RAW = Taint(raw=True)


@dataclasses.dataclass(frozen=True)
class DrawSite:
    draw_id: tuple  # (leaf, first row, row stop, call)
    leaf: str | None  # the dp_noise_add leaf, None outside its scope
    parts: tuple  # the seed parts of the draw's generator
    rows: tuple  # (start, stop) along the leaf's first axis
    scope: str


def _join_all(taints) -> Taint:
    out = CLEAN
    for t in taints:
        out = out.join(t)
    return out


def _absorb(taints: list[Taint]) -> Taint:
    joined = _join_all(taints)
    if joined.raw and any(t.factor or t.clipped for t in taints):
        return dataclasses.replace(joined, raw=False, clipped=True)
    return joined


def _tensors(value) -> list[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [v for v in value if isinstance(v, torch.Tensor)]
    return []


def _base_name(func) -> str:
    """'aten::mul_' -> 'mul' (in-place and out variants share the rule)."""
    name = func._schema.name.split("::")[-1]
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


class TaintMode(TorchDispatchMode):
    """A dispatch mode that carries a `Taint` per storage through every
    op it sees (the module docstring's rules) and records the noise
    draws (`draw`)."""

    def __init__(self):
        super().__init__()
        self._taint: dict[int, tuple[Any, Taint]] = {}  # id -> (ref, taint)
        self.draws: dict[tuple, DrawSite] = {}
        self.ops = 0

    # -- storage-keyed taint ------------------------------------------------
    @staticmethod
    def _storage(t: torch.Tensor):
        try:
            return t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None

    def read(self, t: torch.Tensor) -> Taint:
        st = self._storage(t)
        if st is None:
            return CLEAN
        slot = self._taint.get(id(st))
        return CLEAN if slot is None else slot[1]

    def write(self, t: torch.Tensor, taint: Taint, *, join: bool = False
              ) -> None:
        st = self._storage(t)
        if st is None:
            return
        key = id(st)
        slot = self._taint.get(key)
        if slot is not None:
            if join:
                taint = slot[1].join(taint)
            self._taint[key] = (slot[0], taint)
            return
        if taint == CLEAN:
            return

        def freed(_ref, key=key):
            self._taint.pop(key, None)
        self._taint[key] = (weakref.ref(st, freed), taint)

    def taint_tree(self, tree, taint: Taint) -> None:
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self.write(t, taint)

    # -- the draws ------------------------------------------------------------
    def draw(self, z: torch.Tensor, rows: slice, parts: tuple) -> None:
        """Record `z` as a noise draw of rows `rows` from a generator
        seeded with `parts`, if a `dp_noise_add:<leaf>` scope is open."""
        scope = scopes.current()
        m = _NOISE_LEAF.search(scope)
        if m is None:
            return
        leaf = m.group(1)
        draw_id = (leaf, rows.start, rows.stop, len(self.draws))
        self.draws[draw_id] = DrawSite(draw_id, leaf, tuple(parts),
                                       (rows.start, rows.stop), scope)
        self.write(z, Taint(draws=frozenset({draw_id}),
                            key=frozenset(enumerate(parts))))

    # -- one op ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        name = _base_name(func)
        data: list[Taint] = []
        route: list[Taint] = []
        written: list[torch.Tensor] = []
        keys = set()
        for i, arg in enumerate(func._schema.arguments):
            if i < len(args):
                value = args[i]
            elif arg.name in kwargs:
                value = kwargs[arg.name]
            else:
                continue
            ts = _tensors(value)
            if not ts:
                continue
            taints = [self.read(t) for t in ts]
            (route if arg.name in _ROUTING else data).extend(taints)
            for t in ts:
                st = self._storage(t)
                if st is not None:
                    keys.add(id(st))
            if arg.alias_info is not None and arg.alias_info.is_write:
                written.extend(ts)
        scatter = name in _SCATTER or (
            name in _INDEX_PUT and bool(
                kwargs.get("accumulate", args[3] if len(args) > 3
                           else False)))
        if scatter:
            new = _join_all(data)
        elif route:
            new = _join_all(data)
            if not (new.clipped or new.factor):
                new = new.join(_join_all(route))
        elif name in _MULTIPLICATIVE:
            new = _absorb(data)
        elif name in _ADD_PRODUCT and len(data) >= 3:
            new = data[0].join(_absorb(data[1:3])).join(_join_all(data[3:]))
        else:
            new = _join_all(data)
        if CLIP_SCOPE in scopes.current():
            # everything made under the marker IS factor data: the norms
            # feeding it are consumed here, not leaked onward as raw
            new = dataclasses.replace(new, raw=False, factor=True)

        out = func(*args, **kwargs)

        for t in written:
            self.write(t, new, join=True)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = self._storage(t)
                # an input's storage (a view, or the written self) joins
                self.write(t, new, join=st is not None and id(st) in keys)
        return out


@contextlib.contextmanager
def audited_draws(mode: TaintMode):
    """The step's random draws made shape-only on the meta device, as the
    dry run's `shape_only_draws`, and recorded: each noise draw's
    generator seed parts (`dp_sgd.generator`, `dp_sgd.standard_normal`)
    and the count release (`quantile.count_noise`, no noise draw)."""
    from repro_torch.core import dp_sgd, quantile

    class _Generator:
        def __init__(self, parts):
            self.parts = parts

    def noise(path, shape, rows, gen):
        z = torch.empty(tuple(shape), dtype=torch.float32, device="meta")
        mode.draw(z, rows, gen.parts)
        return z

    saved = (dp_sgd.generator, dp_sgd.standard_normal, quantile.count_noise)
    dp_sgd.generator = lambda device, *parts: _Generator(parts)
    dp_sgd.standard_normal = noise
    quantile.count_noise = lambda shape, gen: torch.empty(
        tuple(shape), dtype=torch.float32, device="meta")
    try:
        yield
    finally:
        dp_sgd.generator, dp_sgd.standard_normal, quantile.count_noise = \
            saved


# ---------------------------------------------------------------------------
# Driver: run the step under the mode, check the per-leaf invariants.
# ---------------------------------------------------------------------------


def leaf_name(path) -> str:
    """The reference's dotted leaf name (`jaxpr_taint._leaf_name`)."""
    return ".".join(str(p) for p in path)


@dataclasses.dataclass
class TaintResult:
    out: Any  # the step's result
    findings: list  # [Finding]
    leaves: list  # the audited (trainable) leaves' names, in tree order
    draws: dict  # draw id -> DrawSite
    ops: int  # aten ops the mode saw


def trace_step(step_fn: Callable, args: tuple, *, private: bool = True,
               trainable_key: str | None = None) -> TaintResult:
    """Run `step_fn(*args)` once under a `TaintMode` and check its
    result. `args` = (params, opt_state, dp_state, batch, seed) on the
    meta device: the batch's leaves are raw, the rest clean. The sinks
    are the trainable leaves of the params the step returns (the input
    params' own storages where it writes in place)."""
    mode = TaintMode()
    mode.taint_tree(args[3], RAW)
    with audited_draws(mode), mode:
        out = step_fn(*args)
    params = out[0] if trainable_key is None else out[0][trainable_key]
    prefix = () if trainable_key is None else (trainable_key,)
    sinks = [(leaf_name(p), t) for p, t in tree_leaves(params, prefix)]
    findings: list[Finding] = []
    if private:
        for name, t in sinks:
            findings.extend(_leaf_findings(mode, name, t))
        base = (args[4], getattr(args[2], "step", None))
        findings.extend(_key_lineage(mode, base))
    return TaintResult(out, findings, [n for n, _ in sinks], mode.draws,
                       mode.ops)


def audit_train_step(step_fn: Callable, args: tuple, *, private: bool = True,
                     trainable_key: str | None = None) -> list[Finding]:
    """Taint-check one train step (the reference's signature). Returns
    findings (empty = proven green).

    Rules:
      JAXPR-CLIP-PATH   a trainable leaf's new value depends on the batch
                        WITHOUT passing a `dp_clip_factor` multiply
      JAXPR-NOISE-ONCE  the draws reaching a trainable leaf are not one
                        draw of its own covering each row once
      JAXPR-KEY-LINEAGE a draw's generator has no part beyond the step's
                        base seed, or two leaves' generators share their
                        seed parts
    """
    return trace_step(step_fn, args, private=private,
                      trainable_key=trainable_key).findings


def _leaf_findings(mode: TaintMode, leaf: str, t: torch.Tensor
                   ) -> list[Finding]:
    taint = mode.read(t)
    out = []
    if taint.raw:
        out.append(Finding(
            "JAXPR-CLIP-PATH", ERROR,
            "batch-derived gradient reaches the parameter update "
            "without passing a dp_clip_factor multiply", leaf))
    sites = [mode.draws[d] for d in taint.draws]
    own = [s for s in sites if s.leaf == leaf]
    foreign = {s.leaf for s in sites if s.leaf != leaf}
    n_rows = t.shape[0] if t.dim() else 1
    cover = [0] * n_rows
    for s in own:
        for r in range(s.rows[0], min(s.rows[1], n_rows)):
            cover[r] += 1
    if foreign or set(cover) != {1}:
        top = max(cover) if cover else 0
        ndraws = (top if top != 1 else min(cover)) + len(foreign)
        out.append(Finding(
            "JAXPR-NOISE-ONCE", ERROR,
            f"{ndraws} noise draws reach this leaf's update "
            f"(exactly 1 required)", leaf))
    return out


def _key_lineage(mode: TaintMode, base: tuple) -> list[Finding]:
    findings = []
    by_sig: dict[tuple, DrawSite] = {}
    for site in mode.draws.values():
        parts = site.parts
        own = parts[len(base):] if parts[:len(base)] == base else parts
        if not own:
            findings.append(Finding(
                "JAXPR-KEY-LINEAGE", ERROR,
                "noise draw consumes a key with no leaf-specific fold "
                "(base key reused verbatim)", site.leaf or site.scope))
            continue
        other = by_sig.get(parts)
        if other is not None and other.leaf != site.leaf:
            findings.append(Finding(
                "JAXPR-KEY-LINEAGE", ERROR,
                f"leaves {other.leaf!r} and {site.leaf!r} fold to an "
                f"IDENTICAL key signature — their noise draws are "
                f"correlated, breaking the Gaussian-mechanism sensitivity "
                f"bound", f"{other.leaf} ~ {site.leaf}"))
        else:
            by_sig.setdefault(parts, site)
    # dedupe repeated pairs (a leaf drawn slice by slice collides per row)
    seen, out = set(), []
    for f in findings:
        k = (f.rule, f.location)
        if k in seen:
            continue
        seen.add(k)
        out.append(f)
    return out

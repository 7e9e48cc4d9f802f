"""Measured kernel autotuning: an empirical table behind the `auto` backend.

The counterpart of `repro.kernels.autotune`. The static model of
`repro_torch.kernels.backend.choose_linear_path` answers `kernels` for
every ghost op on the card (each kernel beat its plain version at every
shape the smoke run measured) and takes the fused route where the
reference engine's TPU rule (`fused_clip.fits`) passes. That rule is VMEM
arithmetic, and the card has no VMEM: at granite's router the fused
kernel is the faster route, at 1024 x 1024 with B = 1024 the slower one.
This module makes the `auto` decision empirical:

  * a one-time per-(op, shape-bucket, candidate) timing sweep (`sweep()`
    / ``python -m repro_torch.kernels.autotune --sweep``) times each
    candidate on seeded data at one shape and records the median µs of a
    call over `ITERS` calls, eager, as the step calls it: warm-up calls,
    then `torch.cuda.synchronize()` around each timed call;
  * the results persist to a versioned JSON table keyed by the
    **topology stamp** (torch and CUDA versions, the device's name,
    capability and count, and a digest of every kernel source under
    `csrc/`, as `_build` hashes them), with a crc32 over the canonical
    payload. A table written for another card, another build of the
    kernels, another schema version, or a torn or corrupt file loads as
    an EMPTY table (a clean miss, never a crash), so a redesigned kernel
    is never routed by the old kernel's times; the next sweep rebuilds
    the file;
  * `backend.choose_op` consults the *installed* table: the measured
    argmin wins on the card and on the CPU, and the static model decides
    the buckets the table has not measured. Where the argmin is `plain`,
    it takes a hand-written kernel off the path only if it beats the
    fastest other candidate by more than `PLAIN_MARGIN` (`best(...,
    plain_margin=)`): an eager call of tens of µs is mostly host work,
    and one noisy reading must not route a bucket to the plain version.

The candidates of an op are `plain` and `kernels` (the reference's `xla`
and `pallas`); `linear_clip` has a third, `fused`, the one
`fused_norm_clip` launch, and there `kernels` is the composed pair
`ghost_norm` + `clip_reduce`. On the card the sweep's data is bfloat16,
the models' type (float32 on the CPU).

Shapes are bucketed to the next power of two per dimension, so one
measurement covers the whole bucket; entries carry their provenance
(``"measured"`` beats ``"model"``: a model-seeded row never overwrites a
measured one).

Installation is EXPLICIT: library code never reads the filesystem behind
your back. The entry points (train, serve and service CLIs) call
`install_default()` under their ``--autotune`` flag; tests scope a
synthetic table with `use_table(...)`. An engine made with
`autotune=False` ignores any installed table.
"""
from __future__ import annotations

import argparse
import contextlib
import contextvars
import dataclasses
import json
import math
import os
import statistics
import time
import zlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import repo_cache_root

TABLE_VERSION = 1

# every engine op the auto backend dispatches on
OPS = ("norms", "clip_sum", "linear_clip", "scale_contract", "paged_attn")

_BACKEND_CHOICES = ("plain", "kernels")
FUSED = "fused"  # linear_clip's one fused_norm_clip launch
# how much faster than every other candidate `plain` must be measured
# before `choose_op` leaves the kernels for it
PLAIN_MARGIN = 0.15


def candidates(op: str) -> tuple[str, ...]:
    """The implementations `auto` chooses between for `op`."""
    return _BACKEND_CHOICES + ((FUSED,) if op == "linear_clip" else ())


# ---------------------------------------------------------------------------
# Topology stamp + cache locations.
# ---------------------------------------------------------------------------


def device_kind() -> str:
    """The card's name (`cpu` without one)."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def topology_stamp() -> dict:
    """What a timing measurement is conditioned on. Tables keyed on this
    stamp never carry measurements across cards, device counts, torch or
    CUDA versions, or builds of the kernels."""
    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": device_kind(),
        "capability": ("{}.{}".format(*torch.cuda.get_device_capability(0))
                       if cuda else None),
        "device_count": torch.cuda.device_count() if cuda else 0,
        "kernel_sources": _build.source_digest(),
    }


def stamp_crc(stamp: dict | None = None) -> str:
    blob = json.dumps(stamp or topology_stamp(), sort_keys=True)
    return f"{zlib.crc32(blob.encode()):08x}"


def default_path(cache_root: str | None = None,
                 stamp: dict | None = None) -> str:
    """One table file per topology: autotune/table-<stamp-crc>.json."""
    return os.path.join(repo_cache_root(cache_root), "autotune",
                        f"table-{stamp_crc(stamp)}.json")


# ---------------------------------------------------------------------------
# Shape bucketing.
# ---------------------------------------------------------------------------


def bucket_dim(n: int) -> int:
    """Next power of two (0 stays 0): one measurement covers the bucket."""
    n = int(n)
    if n <= 0:
        return 0
    return 1 << (n - 1).bit_length()


def bucket_key(op: str, t: int, din: int, dout: int) -> str:
    return f"{op}|t{bucket_dim(t)}|i{bucket_dim(din)}|o{bucket_dim(dout)}"


# ---------------------------------------------------------------------------
# The table.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AutotuneTable:
    """Bucketed (op, shape) -> {candidate: {us, source}} timings for ONE
    topology. `best()` is the measured argmin; buckets it has never seen
    return None, so the caller falls back to the static model."""

    topology: dict = dataclasses.field(default_factory=topology_stamp)
    entries: dict = dataclasses.field(default_factory=dict)
    path: str | None = None
    stale_reason: str | None = None  # why a load came back empty

    def record(self, op: str, t: int, din: int, dout: int, backend: str,
               us: float, *, source: str = "measured") -> bool:
        """Record one timing; a measured entry is never overwritten by a
        model-seeded one. Returns True if the entry was stored."""
        if backend not in candidates(op):
            raise ValueError(f"unknown candidate {backend!r} for {op}; "
                             f"expected one of {candidates(op)}")
        if not (us > 0.0) or math.isinf(us):
            raise ValueError(f"bad timing {us!r} for {op}")
        key = bucket_key(op, t, din, dout)
        slot = self.entries.setdefault(key, {})
        prev = slot.get(backend)
        if prev is not None and prev.get("source") == "measured" \
                and source != "measured":
            return False
        slot[backend] = {"us": float(us), "source": source}
        return True

    def lookup(self, op: str, t: int, din: int, dout: int) -> dict | None:
        return self.entries.get(bucket_key(op, t, din, dout))

    def best(self, op: str, t: int, din: int, dout: int, *,
             plain_margin: float = 0.0) -> str | None:
        """Measured argmin for this bucket, or None if unmeasured.
        Measured rows win outright; model-seeded rows only decide a bucket
        with no measurement at all. With `plain_margin` > 0 an argmin of
        `plain` stands only if the fastest other candidate takes more
        than (1 + plain_margin) times its µs; else that candidate wins."""
        slot = self.lookup(op, t, din, dout)
        if not slot:
            return None
        measured = {b: v for b, v in slot.items()
                    if v.get("source") == "measured"}
        pool = measured or slot
        win = min(pool, key=lambda b: pool[b]["us"])
        rivals = [b for b in pool if b != "plain"]
        if win == "plain" and plain_margin > 0 and rivals:
            rival = min(rivals, key=lambda b: pool[b]["us"])
            if pool[rival]["us"] <= pool["plain"]["us"] * (1 + plain_margin):
                return rival
        return win

    def __len__(self) -> int:
        return len(self.entries)

    # -- persistence -------------------------------------------------------

    def _payload(self) -> dict:
        return {"version": TABLE_VERSION, "topology": self.topology,
                "entries": self.entries}

    def save(self, path: str | None = None) -> str:
        """Atomic, checksummed write (a temporary file, fsync, then
        os.replace), so a killed writer leaves the old table or the new
        one, never a torn file that parses."""
        path = path or self.path or default_path(stamp=self.topology)
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = self._payload()
        blob = json.dumps(payload, sort_keys=True)
        doc = {"crc32": zlib.crc32(blob.encode()), **payload}
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return path


def load(path: str | None = None, *,
         topology: dict | None = None) -> AutotuneTable:
    """Load a table; NEVER raises. A missing, unparseable, truncated,
    checksum-mismatched, other-version or other-topology file comes back
    as an empty table (its `stale_reason` says why): the auto backend
    then follows the static model, and the next sweep rebuilds the
    file."""
    topo = topology or topology_stamp()
    path = path or default_path(stamp=topo)
    fresh = AutotuneTable(topology=topo, path=path)
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        fresh.stale_reason = "missing"
        return fresh
    except (OSError, ValueError) as e:
        fresh.stale_reason = f"unreadable: {type(e).__name__}"
        return fresh
    if not isinstance(doc, dict):
        fresh.stale_reason = "malformed"
        return fresh
    if doc.get("version") != TABLE_VERSION:
        fresh.stale_reason = f"version {doc.get('version')!r}"
        return fresh
    payload = {"version": doc.get("version"), "topology": doc.get("topology"),
               "entries": doc.get("entries")}
    blob = json.dumps(payload, sort_keys=True)
    if zlib.crc32(blob.encode()) != doc.get("crc32"):
        fresh.stale_reason = "crc mismatch"
        return fresh
    if doc.get("topology") != topo:
        fresh.stale_reason = "topology mismatch"
        return fresh
    if not isinstance(doc.get("entries"), dict):
        fresh.stale_reason = "malformed entries"
        return fresh
    return AutotuneTable(topology=topo, entries=doc["entries"], path=path)


# ---------------------------------------------------------------------------
# The installed table (what the auto backend consults).
# ---------------------------------------------------------------------------

# a context-local override (tests, nested scopes) over a process-wide install
_OVERRIDE: contextvars.ContextVar[AutotuneTable | None] = \
    contextvars.ContextVar("autotune_table_override", default=None)
_INSTALLED: AutotuneTable | None = None


def installed_table() -> AutotuneTable | None:
    ov = _OVERRIDE.get()
    if ov is not None:
        return ov
    return _INSTALLED


def install(table: AutotuneTable | None) -> AutotuneTable | None:
    """Process-wide install (entry points); None uninstalls."""
    global _INSTALLED
    _INSTALLED = table
    return table


def install_default(cache_root: str | None = None) -> AutotuneTable:
    """Load the table for this topology from the cache root and install
    it. An empty, stale or corrupt file installs an empty table: `auto`
    then follows the static model until a sweep runs."""
    return install(load(default_path(cache_root)))


@contextlib.contextmanager
def use_table(table: AutotuneTable | None):
    """Scope a table for the dynamic extent of the block."""
    token = _OVERRIDE.set(table)
    try:
        yield table
    finally:
        _OVERRIDE.reset(token)


# ---------------------------------------------------------------------------
# The measured sweep.
# ---------------------------------------------------------------------------

# (B, T, din, dout) buckets measured by default; --full adds the larger
SWEEP_SHAPES_QUICK = ((4, 128, 128, 128), (4, 256, 256, 256))
SWEEP_SHAPES_FULL = ((4, 512, 256, 256), (8, 1024, 512, 512),
                     (8, 2048, 1024, 1024))
# calls a candidate makes before its timed ones, and its timed calls: the
# median of 21 stands through a burst of up to 10 slow calls
WARMUP, ITERS = 3, 21
# the widest query and value rows the paged_attn kernel takes (MLA's)
PAGED_MAX_DQ, PAGED_MAX_DV = 576, 512


def _device_and_dtype(device, dtype):
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return device, dtype


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_us(fn, args, device, *, warmup: int = WARMUP,
               iters: int = ITERS) -> float:
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e6


def _normal(gen, shape, device, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


def _op_data(op: str, shape, device, dtype):
    """Representative operands for one op at one (B, T, din, dout)."""
    b, t, din, dout = shape
    gen = torch.Generator(device=device).manual_seed(0)
    a = _normal(gen, (b, t, din), device, dtype)
    g = _normal(gen, (b, t, dout), device, dtype, 0.1)
    f = torch.rand((b,), generator=gen, device=device)
    c = torch.full((b,), 0.5, device=device)
    if op == "norms":
        return (a, g)
    if op == "clip_sum":
        return (a, g, f)
    if op == "linear_clip":
        return (a, g, c)
    if op == "scale_contract":
        # S = 2 stacked residuals (the BK epilogue's layout)
        return (torch.stack([a, a * 0.5]), torch.stack([g, g * 2.0]),
                torch.stack([f, f]))
    if op == "paged_attn":
        return paged_attn_data(shape, device=device, dtype=dtype)
    raise ValueError(f"unknown op {op!r}; expected one of {OPS}")


def paged_attn_data(shape, *, page_len: int = 16, kv: int = 2, grp: int = 2,
                    device="cpu", dtype=torch.float32):
    """Decode-attention operands whose table key maps t -> logical context
    and (din, dout) -> (query head dim, value head dim), the dims capped at
    the widths the kernel takes (PAGED_MAX_DQ, PAGED_MAX_DV)."""
    b, t, din, dout = shape
    dq, dv = min(din, PAGED_MAX_DQ), min(dout, PAGED_MAX_DV)
    t = max(t, page_len)
    p_tab = -(-t // page_len)
    n_pages = b * p_tab + 1  # + the trash page
    gen = torch.Generator(device=device).manual_seed(3)
    q = _normal(gen, (b, kv, grp, dq), device, dtype)
    kpool = _normal(gen, (n_pages, page_len, kv, dq), device, dtype)
    vpool = _normal(gen, (n_pages, page_len, kv, dv), device, dtype)
    pt = (torch.arange(b * p_tab, dtype=torch.int32, device=device)
          .reshape(b, p_tab) + 1)
    pos = torch.full((b,), t - 1, dtype=torch.int32, device=device)
    return (q, kpool, vpool, pt, pos)


def paged_attn_dims(q, pt, page_len: int, dv: int) -> tuple[int, int, int]:
    """(t, din, dout) table coordinates for a paged_attn call."""
    return int(pt.shape[1]) * int(page_len), int(q.shape[-1]), int(dv)


def table_dims(op: str, shape, *, page_len: int = 16
               ) -> tuple[int, int, int]:
    """(t, din, dout) table coordinates of the sweep's data for `op` at
    (B, T, din, dout): the shape's own, but for paged_attn the logical
    context of `paged_attn_data`'s whole pages and its capped dims."""
    _, t, din, dout = shape
    if op != "paged_attn":
        return t, din, dout
    return (-(-max(t, page_len) // page_len) * page_len,
            min(din, PAGED_MAX_DQ), min(dout, PAGED_MAX_DV))


def _op_fn(op: str, name: str, args):
    from repro_torch.kernels import backend as KB
    fn = KB.candidate(op, name)
    if op == "paged_attn":
        scale = 1.0 / math.sqrt(args[0].shape[-1])
        return lambda *a: fn(*a, scale=scale)
    return fn


def measure_op(op: str, shape, *, backends=None, warmup: int = WARMUP,
               iters: int = ITERS, device=None,
               dtype=None) -> dict[str, float]:
    """Median µs of a call per candidate for one (op, shape). A candidate
    that refuses the shape (a ValueError from its checks: the fused
    kernel past the card's tiles, paged_attn past its widths) is skipped;
    a failed build or launch raises."""
    device, dtype = _device_and_dtype(device, dtype)
    args = _op_data(op, shape, device, dtype)
    out: dict[str, float] = {}
    for name in backends or candidates(op):
        try:
            out[name] = _median_us(_op_fn(op, name, args), args, device,
                                   warmup=warmup, iters=iters)
        except ValueError:
            continue
    return out


def sweep(*, ops=OPS, shapes=None, table: AutotuneTable | None = None,
          quick: bool = True, save: bool = True,
          cache_root: str | None = None, progress=None, device=None,
          dtype=None) -> AutotuneTable:
    """The one-time timing sweep: measure every (op, shape, candidate)
    and record the results. Idempotent: a rerun refreshes them."""
    device, dtype = _device_and_dtype(device, dtype)
    if shapes is None:
        shapes = (SWEEP_SHAPES_QUICK if quick
                  else SWEEP_SHAPES_QUICK + SWEEP_SHAPES_FULL)
    if table is None:
        table = load(default_path(cache_root))
    for shape in shapes:
        for op in ops:
            timings = measure_op(op, shape, device=device, dtype=dtype)
            for name, us in timings.items():
                table.record(op, *table_dims(op, shape), name, us)
            if progress is not None:
                progress(op, shape, timings)
    if save:
        table.save()
    return table


def seed_from_records(records, table: AutotuneTable | None = None,
                      *, source: str = "measured") -> AutotuneTable:
    """Seed the table from benchmark-style records ({name:
    kernel_<op>_<candidate>, backend, t, din, dout, us_per_call}). Rows
    with no timing or an unknown op or candidate are ignored."""
    if table is None:
        table = load()
    for rec in records:
        name = rec.get("name", "")
        backend_name = rec.get("backend")
        us = rec.get("us_per_call")
        if not us or not name.startswith("kernel_") \
                or not name.endswith(f"_{backend_name}"):
            continue
        op = name[len("kernel_"):-(len(backend_name) + 1)]
        if op not in OPS or backend_name not in candidates(op):
            continue
        table.record(op, rec["t"], rec["din"], rec["dout"],
                     backend_name, float(us), source=source)
    return table


# ---------------------------------------------------------------------------
# CLI: pre-warm a machine's table / inspect it.
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="measured kernel autotuner (see module docstring)")
    ap.add_argument("--sweep", action="store_true",
                    help="run the timing sweep and persist the table")
    ap.add_argument("--full", action="store_true",
                    help="sweep the larger shapes too")
    ap.add_argument("--show", action="store_true",
                    help="print the persisted table for this topology")
    ap.add_argument("--cache-dir", default=None,
                    help="cache root (default <repo>/.cache or "
                         "$REPRO_CACHE_DIR)")
    args = ap.parse_args(argv)
    path = default_path(args.cache_dir)
    if args.sweep:
        def progress(op, shape, timings):
            t = {k: f"{v:.0f}us" for k, v in timings.items()}
            print(f"# {op} {shape}: {t}", flush=True)
        table = sweep(quick=not args.full, cache_root=args.cache_dir,
                      progress=progress)
        print(f"# wrote {table.path} ({len(table)} buckets)")
    if args.show or not args.sweep:
        table = load(path)
        print(json.dumps({"path": path, "topology": table.topology,
                          "stale_reason": table.stale_reason,
                          "buckets": table.entries}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Checkpoints: the reference's sharded store, format leaf for leaf.

Layout:  <dir>/step_<N:08d>/manifest.msgpack   (codec, treedef, num_shards,
                                                leaves, step, meta)
         <dir>/step_<N:08d>/shard_<i:04d>.bin.zst   (leaf bytes, one zstd
         frame; .bin.zz, one zlib stream, where zstandard is not installed:
         the manifest's "codec" field is authoritative)

The counterpart of `repro.checkpoint.store`: each store reads the other's
checkpoints. Leaves go in `jax.tree_util.tree_flatten`'s order (dicts by
sorted key, NamedTuples and tuples in field order, None an empty subtree),
packed into shards of at most `shard_bytes` (a larger leaf fills a shard
of its own), each leaf's raw bytes with a crc32 in the manifest: bfloat16
as its 16-bit pattern, Python ints and floats of the port's states as the
0-d int32 / float32 leaves the reference writes, read back into the
template's Python type. `treedef` is None (the reference's is advisory).

Crash safety, as the reference: a step is staged in a `tmp-` sibling, each
file and the directory fsynced, and published by one `os.replace` (a
re-publish swaps the old directory aside first), so a step directory
exists complete or not at all; `verify_checkpoint` and
`load_checkpoint(verify=True)` check every crc; `load_latest_checkpoint`
walks back past a step that fails them.

Speed at full width (a qwen3-4b state is 26.5 GB): shards stream one at a
time with the next one's device-to-host copies, checksums and compression
in flight, in 16 MiB pieces over a thread pool (zlib, zstd and crc32
release the interpreter lock). A zlib shard is one stream of pieces
deflated apart and joined by sync flushes, with Huffman coding only:
string matching finds next to nothing in float weights and is the slow
part of zlib's levels; the entropy coding of the exponent bytes saves
about a fifth (PERF.md §6, PR 21). A zstd shard is one frame from zstd's
own worker threads. A stream inflates on one core, so a load decompresses
as many shards at a time as there are cores, and takes at least the time
of its largest shard (a whole leaf: 3.6 GB for qwen3-4b's gate_up).
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import re
import shutil
import struct
import warnings
import zlib

import numpy as np
import torch

from repro_torch.checkpoint.packer import packb, unpackb

try:
    import zstandard as zstd
except ImportError:  # no zstandard on the machine: the zlib codec
    zstd = None

_CODEC_ERRORS = (zlib.error,) + ((zstd.ZstdError,) if zstd else ())

_SHARD_BYTES = 256 * 1024 * 1024
_PIECE = 16 * 1024 * 1024  # unit of the parallel copies, crcs and deflate
_SHARD_SUFFIX = {"zstd": ".bin.zst", "zlib": ".bin.zz"}
_ZLIB_HEADER = b"\x78\x01"  # deflate, 32 KiB window, "fastest" level

_DTYPES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
           torch.float32: "float32", torch.float64: "float64",
           torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
           torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}


class CheckpointCorrupt(ValueError):
    """A checkpoint step failed checksum / structural verification."""


def _workers() -> int:
    return max(1, os.cpu_count() or 1)


# ---------------------------------------------------------------------------
# The tree: jax.tree_util's leaf order over the port's containers.
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree) -> list:
    """Leaves in `jax.tree_util.tree_flatten`'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """`template`'s structure over `leaves` (an iterator, consumed in
    `tree_flatten` order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


class _Leaf:
    """One leaf's raw bytes as the store writes them, readable in pieces
    (a device tensor is copied to the host a piece at a time)."""

    def __init__(self, x):
        if isinstance(x, torch.Tensor):
            if x.dtype not in _DTYPES:
                raise TypeError(f"no checkpoint dtype for {x.dtype}")
            self.dtype, self.shape = _DTYPES[x.dtype], list(x.shape)
            self._bytes = x.detach().contiguous().reshape(-1).view(
                torch.uint8)
        else:
            if isinstance(x, bool) or not isinstance(
                    x, (int, float, np.ndarray, np.generic)):
                raise TypeError(f"cannot checkpoint a leaf of type "
                                f"{type(x).__name__}")
            arr = (np.asarray(x, np.int32) if isinstance(x, int) else
                   np.asarray(x, np.float32) if isinstance(x, float) else
                   np.ascontiguousarray(x))
            if isinstance(x, int) and int(arr) != x:
                raise OverflowError(f"{x} does not fit the int32 leaf")
            self.dtype, self.shape = str(arr.dtype), list(arr.shape)
            self._bytes = arr.reshape(-1).view(np.uint8)
        self.nbytes = int(self._bytes.shape[0])

    def read(self, start: int, stop: int) -> np.ndarray:
        part = self._bytes[start:stop]
        if isinstance(part, torch.Tensor):
            return part.cpu().numpy()
        return part


def _pieces(nbytes: int):
    return [(s, min(s + _PIECE, nbytes)) for s in range(0, nbytes, _PIECE)
            ] or [(0, 0)]


# ---------------------------------------------------------------------------
# Checksums (crc32_combine, as zlib's, so pieces checksum in parallel).
# ---------------------------------------------------------------------------

_POLY = 0xEDB88320


def _multmodp(a: int, b: int) -> int:
    """a * b modulo the crc32 polynomial (reflected bit order)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if not a & (m - 1):
                return p
        m >>= 1
        b = (b >> 1) ^ _POLY if b & 1 else b >> 1


def _x2n_table() -> list[int]:
    p, out = 1 << 30, []  # x^1
    for _ in range(32):
        out.append(p)
        p = _multmodp(p, p)
    return out


_X2N = _x2n_table()


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32 of A + B from crc32(A), crc32(B) and len(B)."""
    p, k, n = 1 << 31, 3, len2  # x^(8 * len2)
    while n:
        if n & 1:
            p = _multmodp(_X2N[k & 31], p)
        n >>= 1
        k += 1
    return _multmodp(p, crc1) ^ crc2


def _adler32_combine(a1: int, a2: int, len2: int) -> int:
    base = 65521
    lo = ((a1 & 0xFFFF) + (a2 & 0xFFFF) - 1) % base
    hi = ((a1 >> 16) + (a2 >> 16) + len2 * ((a1 & 0xFFFF) - 1)) % base
    return lo | (hi << 16)


def _combined_crc(parts) -> int:
    """crc32 of the concatenation of parts given as (crc, length)."""
    crc = 0
    for c, n in parts:
        crc = crc32_combine(crc, c, n)
    return crc


def leaf_crc32(leaf, pool: cf.Executor | None = None) -> int:
    """crc32 over the exact raw bytes `save_checkpoint` checksums for a
    leaf (bfloat16 as its 16-bit pattern, a Python int / float as int32 /
    float32): live state compares bitwise with a manifest
    (`manifest_crcs`) without a checkpoint written."""
    src = _Leaf(leaf)

    def crc(span):
        return zlib.crc32(src.read(*span)), span[1] - span[0]

    if pool is None:
        with cf.ThreadPoolExecutor(_workers()) as own:
            return _combined_crc(own.map(crc, _pieces(src.nbytes)))
    return _combined_crc(pool.map(crc, _pieces(src.nbytes)))


def tree_crcs(tree) -> list[int]:
    """Per-leaf crc32 of a tree, in flatten order (`manifest_crcs`'s)."""
    with cf.ThreadPoolExecutor(_workers()) as pool:
        return [leaf_crc32(x, pool) for x in tree_flatten(tree)]


# ---------------------------------------------------------------------------
# Codecs.
# ---------------------------------------------------------------------------


def _deflate_piece(raw: np.ndarray, last: bool) -> tuple[bytes, int]:
    """One piece of a zlib shard (raw deflate, Huffman coding only) and
    its adler32."""
    c = zlib.compressobj(1, zlib.DEFLATED, -15, 8, zlib.Z_HUFFMAN_ONLY)
    out = c.compress(raw) + c.flush(zlib.Z_FINISH if last
                                    else zlib.Z_SYNC_FLUSH)
    return out, zlib.adler32(raw)


def _decompressor(codec: str):
    if codec == "zstd":
        if zstd is None:
            raise ModuleNotFoundError(
                "checkpoint was written with zstd but zstandard is not "
                "installed")
        # a (de)compressor object is not thread-safe: one per call
        return lambda blob: zstd.ZstdDecompressor().decompress(blob)
    if codec == "zlib":
        return zlib.decompress
    raise ValueError(f"unknown checkpoint codec {codec!r}")


# ---------------------------------------------------------------------------
# Save.
# ---------------------------------------------------------------------------


def _fsync_write(path: str, parts) -> None:
    with open(path, "wb") as f:
        for part in parts:
            f.write(part)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _plan_shards(leaves: list[_Leaf], shard_bytes: int) -> list[list[int]]:
    """Leaf indices per shard, by the reference's rule: a leaf opens a
    new shard when it would overflow a non-empty one."""
    shards: list[list[int]] = [[]]
    cur = 0
    for i, leaf in enumerate(leaves):
        if cur + leaf.nbytes > shard_bytes and shards[-1]:
            shards.append([])
            cur = 0
        shards[-1].append(i)
        cur += leaf.nbytes
    return shards


def _submit_shard(pool, leaves, members, codec):
    """Futures of a shard's pieces, in order: (leaf, piece length, crc,
    payload), the payload deflated (zlib) or raw (zstd: one frame a
    shard)."""
    spans = [(i, s) for i in members for s in _pieces(leaves[i].nbytes)]

    def work(k):
        i, span = spans[k]
        raw = leaves[i].read(*span)
        crc = zlib.crc32(raw)
        if codec == "zlib":
            payload = _deflate_piece(raw, k == len(spans) - 1)
        else:
            payload = raw
        return i, span[1] - span[0], crc, payload

    return [pool.submit(work, k) for k in range(len(spans))]


def _shard_file(results, codec) -> tuple[list, dict[int, list]]:
    """(the shard file's parts, crc pieces per leaf) from its pieces'
    results."""
    crcs: dict[int, list] = {}
    for i, n, crc, _ in results:
        crcs.setdefault(i, []).append((crc, n))
    if codec == "zlib":
        adler, body = 1, []
        for _, n, _, (deflated, a) in results:
            adler = _adler32_combine(adler, a, n)
            body.append(deflated)
        return [_ZLIB_HEADER, *body, struct.pack(">I", adler)], crcs
    raw = b"".join(memoryview(p) for *_, p in results)
    comp = zstd.ZstdCompressor(level=3, threads=_workers()).compress(raw)
    return [comp], crcs


def save_checkpoint(directory: str, step: int, tree, *,
                    shard_bytes: int = _SHARD_BYTES,
                    meta: dict | None = None, fault_hook=None) -> str:
    """Atomically persist `tree` as `<directory>/step_<step:08d>`.

    Everything is staged under `tmp-step_<step:08d>-<pid>`, fsynced, and
    published by one `os.replace`. `meta` (a manifest-packable dict) rides
    in the manifest: the training service stores the sampler state, the
    ledger length and the epsilon spent there. `fault_hook(stage)` is the
    fault-injection seam: "pre-stage", "pre-rename", "post-rename". The
    codec is zstd where zstandard is installed, else zlib."""
    codec = "zstd" if zstd is not None else "zlib"
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    stage = os.path.join(directory, f"tmp-step_{step:08d}-{os.getpid()}")
    if fault_hook is not None:
        fault_hook("pre-stage")
    if os.path.isdir(stage):  # leftover from a crashed save: rebuild
        shutil.rmtree(stage)
    os.makedirs(stage)
    leaves = [_Leaf(x) for x in tree_flatten(tree)]
    shards = _plan_shards(leaves, shard_bytes)
    crcs: dict[int, list] = {}
    suffix = _SHARD_SUFFIX[codec]
    with cf.ThreadPoolExecutor(_workers()) as pool:
        ahead = _submit_shard(pool, leaves, shards[0], codec)
        for s in range(len(shards)):
            results = [f.result() for f in ahead]
            # the next shard's copies and compression run while this one
            # is written: two shards in flight at most
            ahead = (_submit_shard(pool, leaves, shards[s + 1], codec)
                     if s + 1 < len(shards) else [])
            parts, shard_crcs = _shard_file(results, codec)
            del results
            crcs.update(shard_crcs)
            _fsync_write(os.path.join(stage, f"shard_{s:04d}{suffix}"),
                         parts)
    metas = [None] * len(leaves)
    for s, members in enumerate(shards):
        for i in members:
            metas[i] = {"shape": leaves[i].shape, "dtype": leaves[i].dtype,
                        "shard": s, "bytes": leaves[i].nbytes,
                        "crc32": _combined_crc(crcs[i])}
    manifest = {"codec": codec, "treedef": None, "num_shards": len(shards),
                "leaves": metas, "step": step, "meta": meta}
    _fsync_write(os.path.join(stage, "manifest.msgpack"), [packb(manifest)])
    _fsync_dir(stage)
    if fault_hook is not None:
        fault_hook("pre-rename")
    if os.path.isdir(final):
        # re-publishing an existing step: shunt the old directory aside
        # atomically so `final` is free for the atomic replace; a complete
        # version of the step exists at every instant
        trash = os.path.join(directory, f"tmp-old_{step:08d}-{os.getpid()}")
        if os.path.isdir(trash):
            shutil.rmtree(trash)
        os.replace(final, trash)
        os.replace(stage, final)
        shutil.rmtree(trash)
    else:
        os.replace(stage, final)
    _fsync_dir(directory)
    if fault_hook is not None:
        fault_hook("post-rename")
    return final


# ---------------------------------------------------------------------------
# Load and verify.
# ---------------------------------------------------------------------------


def load_manifest(directory: str, step: int) -> dict:
    """Read a step's manifest (shapes, codec, checksums, and `meta`)."""
    path = os.path.join(directory, f"step_{step:08d}", "manifest.msgpack")
    with open(path, "rb") as f:
        blob = f.read()
    try:
        manifest = unpackb(blob)
    except (ValueError, struct.error, IndexError) as e:
        raise CheckpointCorrupt(f"{path}: unreadable manifest: {e}") from e
    if not isinstance(manifest, dict):
        raise CheckpointCorrupt(f"{path}: the manifest is not a map")
    return manifest


def _leaf_views(path: str, manifest: dict, pool: cf.Executor, verify: bool):
    """Yield (leaf index, leaf meta, its raw bytes as a uint8 array), a
    shard's leaves as soon as it is ready. Each shard is read, decompressed
    and its leaves' lengths and (with `verify`) crcs checked by one task of
    the pool, the largest files first: inflating a stream is serial, so
    the shards run side by side and the largest sets the pace."""
    codec = manifest.get("codec", "zstd")
    decompress = _decompressor(codec)
    suffix = _SHARD_SUFFIX[codec]
    metas = manifest["leaves"]
    by_shard: dict[int, list] = {}
    for li, m in enumerate(metas):
        by_shard.setdefault(m["shard"], []).append(li)
    files = [os.path.join(path, f"shard_{s:04d}{suffix}")
             for s in range(manifest["num_shards"])]

    def read(s):
        with open(files[s], "rb") as f:
            blob = f.read()
        try:
            data = decompress(blob)
        except _CODEC_ERRORS as e:  # torn or rotted data
            raise CheckpointCorrupt(
                f"{path}: shard {s} failed to decompress: {e}") from e
        del blob
        buf, off, views = np.frombuffer(data, np.uint8), 0, []
        for li in by_shard.get(s, []):
            m = metas[li]
            raw = buf[off: off + m["bytes"]]
            off += m["bytes"]
            if raw.shape[0] != m["bytes"]:
                raise CheckpointCorrupt(
                    f"{path}: shard {s} truncated at leaf {li} (wanted "
                    f"{m['bytes']} bytes, got {raw.shape[0]})")
            if verify and "crc32" in m and zlib.crc32(raw) != m["crc32"]:
                raise CheckpointCorrupt(
                    f"{path}: leaf {li} crc mismatch (torn write?)")
            views.append((li, m, raw))
        return views

    order = sorted(range(len(files)), key=lambda s: -os.path.getsize(files[s]))
    # a set, so that a consumed future (and its shard's bytes) is released
    futs = {pool.submit(read, s) for s in order}
    try:
        for fut in cf.as_completed(futs):
            futs.discard(fut)
            yield from fut.result()
    finally:  # a corrupt shard stops the read: drop the queued ones
        for fut in futs:
            fut.cancel()


def verify_checkpoint(directory: str, step: int) -> bool:
    """True iff the manifest reads, every shard decompresses and every leaf
    crc32 matches (a checkpoint without crcs verifies structurally)."""
    path = os.path.join(directory, f"step_{step:08d}")
    try:
        manifest = load_manifest(directory, step)
        with cf.ThreadPoolExecutor(_workers()) as pool:
            for _ in _leaf_views(path, manifest, pool, verify=True):
                pass
        return True
    except (OSError, CheckpointCorrupt, KeyError, TypeError, IndexError):
        return False


def _restore_leaf(tmpl, m: dict, raw: np.ndarray, device):
    """One leaf in the template leaf's type: a tensor on `device` (None:
    the template's) with the template's requires_grad, a numpy array, or
    a Python int / float."""
    shape = tuple(m["shape"])
    if isinstance(tmpl, torch.Tensor):
        want = _DTYPES.get(tmpl.dtype)
        if m["dtype"] != want or shape != tuple(tmpl.shape):
            raise ValueError(f"checkpoint leaf {m['dtype']}{list(shape)} "
                             f"does not fit the template's "
                             f"{want}{list(tmpl.shape)}")
        with warnings.catch_warnings():  # read-only bytes: copied below
            warnings.filterwarnings("ignore", message=".*not writable.*")
            t = torch.from_numpy(raw)
        t = t.view(tmpl.dtype).reshape(shape).to(
            tmpl.device if device is None else device, copy=True)
        return t.requires_grad_(tmpl.requires_grad)
    if isinstance(tmpl, (int, float)) and not isinstance(tmpl, bool):
        want = "int32" if isinstance(tmpl, int) else "float32"
        if m["dtype"] != want or shape != ():
            raise ValueError(f"checkpoint leaf {m['dtype']}{list(shape)} "
                             f"does not fit a Python {type(tmpl).__name__}")
        return type(tmpl)(raw.view(np.dtype(want))[0])
    arr = np.asarray(tmpl)
    if m["dtype"] != str(arr.dtype) or shape != arr.shape:
        raise ValueError(f"checkpoint leaf {m['dtype']}{list(shape)} does "
                         f"not fit the template's {arr.dtype}{list(arr.shape)}")
    return raw.view(arr.dtype).reshape(shape).copy()


def _flat_shardings(template, shardings) -> list:
    """One target placement (or None) per leaf of `template`, in
    `tree_flatten` order: `shardings` mirrors the template, a None or a
    placement standing for every leaf of the subtree where it sits."""
    if shardings is None or not isinstance(shardings, (dict, tuple, list)):
        return [shardings] * len(tree_flatten(template))
    if isinstance(template, dict):
        return [x for k in sorted(template)
                for x in _flat_shardings(template[k], shardings.get(k))]
    return [x for t, sh in zip(template, shardings)
            for x in _flat_shardings(t, sh)]


def load_checkpoint(directory: str, step: int, template, *,
                    verify: bool = False, device=None, shardings=None):
    """Restore into the structure of `template`, each leaf in the type,
    dtype and shape of the template's (a mismatch raises ValueError), a
    tensor on `device` or, by default, the template leaf's device (a
    template on the meta device takes no memory). `verify` checks every
    leaf's crc32 before it is used: a torn shard or bit rot raises
    `CheckpointCorrupt`.

    shardings: target placements (`launch.sharding.Placement`) mirroring
    `template`, None for a leaf or subtree kept whole. The files hold
    global leaves (rank 0 writes the gathered ones); a leaf with a
    placement is restored and then cut to this rank's slice, as the
    reference's `load_checkpoint(shardings=)` puts each leaf with its
    target sharding (the resume path of `launch.train --mesh`)."""
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = load_manifest(directory, step)
    tmpl = tree_flatten(template)
    if len(tmpl) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"template expects {len(tmpl)}")
    places = _flat_shardings(template, shardings)
    out = [None] * len(tmpl)
    with cf.ThreadPoolExecutor(_workers()) as pool:
        for li, m, raw in _leaf_views(path, manifest, pool, verify):
            leaf = _restore_leaf(tmpl[li], m, raw, device)
            if places[li] is not None:
                leaf = places[li].shard(leaf).requires_grad_(
                    tmpl[li].requires_grad)
            out[li] = leaf
    return tree_unflatten(template, out)


def manifest_crcs(directory: str, step: int) -> list[int] | None:
    """Per-leaf crc32 list of a step's manifest (flatten order), or None
    when the checkpoint predates checksums."""
    leaves = load_manifest(directory, step)["leaves"]
    if any("crc32" not in m for m in leaves):
        return None
    return [m["crc32"] for m in leaves]


def all_steps(directory: str) -> list[int]:
    """All step numbers present (complete or not), descending."""
    if not os.path.isdir(directory):
        return []
    return sorted((int(m.group(1)) for d in os.listdir(directory)
                   if (m := re.match(r"step_(\d+)$", d))), reverse=True)


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[0] if steps else None


def latest_verified_step(directory: str) -> int | None:
    """Newest step whose shards all pass checksum verification."""
    for step in all_steps(directory):
        if verify_checkpoint(directory, step):
            return step
    return None


def load_latest_checkpoint(directory: str, template, *, device=None,
                           shardings=None):
    """Load the newest checkpoint that verifies; skip corrupt steps.

    Returns (step, tree, manifest) or None when no step verifies. Each
    step is read once, its crcs checked as it loads: a torn or bit-rotted
    step falls back to the next older one. `device` and `shardings` as
    `load_checkpoint`."""
    for step in all_steps(directory):
        try:
            tree = load_checkpoint(directory, step, template, verify=True,
                                   device=device, shardings=shardings)
        except (CheckpointCorrupt, OSError, KeyError, IndexError):
            continue
        return step, tree, load_manifest(directory, step)
    return None

"""Persistent build cache of the kernels: the startup cache of the CLIs.

The counterpart of `repro.launch.compile_cache`. What JAX's persistent
compilation cache keeps for the reference (compiled XLA executables) is,
for the port, the `nvcc` build of each kernel source (`kernels._build`):
a library `<name>-<hash>.so` whose name hashes its source, the shared
headers and the compiler flags, so a changed kernel is a clean miss,
never a stale hit. A cold start runs nvcc once per source (17 s for the
slowest, paged_attn); a warm start loads the libraries and runs none.
`enable(root)` points `_build` at `<root>/compile` (the default root is
`<repo>/.cache`, `REPRO_CACHE_DIR` or `--cache-dir` override it; without
`enable` the kernels build in the same default directory). On top of
that this module adds:

  * an integrity sweep with the crc32 discipline of the checkpoint store:
    ``manifest.json`` records a checksum per library; at `enable()` a
    corrupt or truncated library is deleted, so its next use rebuilds
    it (and only it), and a new library of an earlier process is adopted
    once it passes the adoption check (a whole ELF file: `_whole_elf`).
    A manifest written under another toolchain (torch, CUDA or nvcc
    version) wipes the libraries wholesale. The manifest itself is
    checksummed and rebuilt from the files if torn.
  * a ``programs.json`` index mapping a SEMANTIC key, (entry point,
    model config, mesh, backend, execution, clipping mode, torch
    version), to run counts, so an operator can see which programs a
    warm-up covered (`warmed_programs()`).

The entry points call `enable()` under their ``--cache`` flag (train,
serve, service) and `record_program()` once their model is built.
Everything here is best-effort: cache trouble degrades to a cold build,
never to a crashed worker and never to the plain path.
"""
from __future__ import annotations

import functools
import json
import os
import struct
import subprocess
import warnings
import zlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import repo_cache_root

MANIFEST_VERSION = 1
_MANIFEST = "manifest.json"
_PROGRAMS = "programs.json"
_LIBRARY = ".so"

_ENABLED_DIR: str | None = None
_LAST_SWEEP: dict | None = None


def cache_root(override: str | None = None) -> str:
    return repo_cache_root(override)


def compile_dir(root: str | None = None) -> str:
    return os.path.join(cache_root(root), "compile")


def program_key(**parts) -> str:
    """Stable id for one program's semantic coordinates."""
    blob = json.dumps({k: str(v) for k, v in sorted(parts.items())},
                      sort_keys=True)
    return f"{zlib.crc32(blob.encode()):08x}"


@functools.cache
def _nvcc_version() -> str | None:
    try:
        out = subprocess.run([_build._nvcc(), "--version"],
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None  # no toolkit: nothing can be built here either
    return out.strip().splitlines()[-1] if out.strip() else None


def toolchain_stamp() -> dict:
    """What a library was built by: libraries of another toolchain are
    dead weight (their names do not hash it)."""
    return {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "nvcc_version": _nvcc_version()}


# ---------------------------------------------------------------------------
# Integrity sweep (crc32 manifest over the libraries).
# ---------------------------------------------------------------------------


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def _whole_elf(path: str) -> bool:
    """Is this file a whole 64-bit ELF object: the magic, and its section
    header table (at the end of what nvcc writes) inside the file? A
    truncated or garbage library fails; `_build` publishes by rename, so
    only damage after the write gets here."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(64)
            size = os.fstat(fh.fileno()).st_size
    except OSError:
        return False
    if len(head) < 64 or head[:5] != b"\x7fELF\x02":
        return False
    shoff, = struct.unpack_from("<Q", head, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", head, 0x3A)
    return 0 < shoff and shoff + shentsize * shnum <= size


def _atomic_json(path: str, doc: dict) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _load_manifest(dirpath: str) -> dict | None:
    """The entries dict, None if the manifest is missing, torn or of
    another schema (the caller rebuilds it from the files), or
    {"__stale_toolchain__": True}."""
    path = os.path.join(dirpath, _MANIFEST)
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("version") != MANIFEST_VERSION:
        return None
    payload = {"version": doc.get("version"),
               "toolchain": doc.get("toolchain"),
               "entries": doc.get("entries")}
    blob = json.dumps(payload, sort_keys=True)
    if zlib.crc32(blob.encode()) != doc.get("crc32"):
        return None
    if doc.get("toolchain") != toolchain_stamp():
        return {"__stale_toolchain__": True}
    if not isinstance(doc.get("entries"), dict):
        return None
    return doc["entries"]


def _save_manifest(dirpath: str, entries: dict) -> None:
    payload = {"version": MANIFEST_VERSION, "toolchain": toolchain_stamp(),
               "entries": entries}
    blob = json.dumps(payload, sort_keys=True)
    _atomic_json(os.path.join(dirpath, _MANIFEST),
                 {"crc32": zlib.crc32(blob.encode()), **payload})


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def sweep(dirpath: str) -> dict:
    """Verify every library against the manifest: delete a corrupt or
    truncated one (its next use rebuilds it), adopt one written by an
    earlier process, drop the records of vanished files. Returns {kept,
    adopted, dropped_corrupt, dropped_missing, wiped_stale_toolchain}."""
    os.makedirs(dirpath, exist_ok=True)
    manifest = _load_manifest(dirpath)
    stats = {"kept": 0, "adopted": 0, "dropped_corrupt": 0,
             "dropped_missing": 0, "wiped_stale_toolchain": 0}
    if manifest is not None and manifest.get("__stale_toolchain__"):
        # another toolchain built these: reclaim them rather than verify
        for name in os.listdir(dirpath):
            if name.endswith(_LIBRARY):
                _unlink(os.path.join(dirpath, name))
                stats["wiped_stale_toolchain"] += 1
        manifest = {}
    if manifest is None:
        manifest = {}  # torn or missing: rebuilt by adoption below
    entries: dict = {}
    corrupt: set[str] = set()
    for name in sorted(os.listdir(dirpath)):
        if not name.endswith(_LIBRARY):
            continue
        path = os.path.join(dirpath, name)
        try:
            crc = _file_crc(path)
        except OSError:
            stats["dropped_missing"] += 1
            continue
        known = manifest.get(name)
        if known is None and _whole_elf(path):
            # adoption is the integrity gate; the crc covers bit rot after
            entries[name] = crc
            stats["adopted"] += 1
        elif known is not None and known == crc:
            entries[name] = crc
            stats["kept"] += 1
        else:
            # bit rot, a torn write or garbage: the next load rebuilds it
            _unlink(path)
            stats["dropped_corrupt"] += 1
            corrupt.add(name)
    stats["dropped_missing"] += sum(1 for n in manifest
                                    if n.endswith(_LIBRARY)
                                    and n not in entries
                                    and n not in corrupt)
    _save_manifest(dirpath, entries)
    return stats


# ---------------------------------------------------------------------------
# Enable / disable.
# ---------------------------------------------------------------------------


def enable(root: str | None = None, *, quiet: bool = True) -> str | None:
    """Sweep `<root>/compile` and build and load the kernels there.
    Idempotent; best-effort (returns None and leaves `_build` where it
    was on any failure: a worker never dies over cache trouble)."""
    global _ENABLED_DIR, _LAST_SWEEP
    try:
        dirpath = compile_dir(root)
        _LAST_SWEEP = sweep(dirpath)
        _build.set_build_dir(dirpath)
        _ENABLED_DIR = dirpath
        return dirpath
    except Exception as e:  # noqa: BLE001 - degrade to a cold build
        if not quiet:
            warnings.warn(f"compile cache disabled: {type(e).__name__}: {e}")
        _ENABLED_DIR = _LAST_SWEEP = None
        return None


def disable() -> None:
    """Back to `_build`'s default directory, unswept (tests)."""
    global _ENABLED_DIR, _LAST_SWEEP
    _build.set_build_dir(None)
    _ENABLED_DIR = _LAST_SWEEP = None


def enabled_dir() -> str | None:
    return _ENABLED_DIR


def last_sweep() -> dict | None:
    """The stats of `enable()`'s sweep (None when not enabled)."""
    return _LAST_SWEEP


# ---------------------------------------------------------------------------
# Semantic program index.
# ---------------------------------------------------------------------------


def record_program(parts: dict, *, root: str | None = None) -> str | None:
    """Note that a program with these semantic coordinates ran under the
    cache under `root` (default: the enabled cache, else the default
    root); returns its key. Best-effort."""
    try:
        dirpath = (compile_dir(root) if root is not None
                   else _ENABLED_DIR or compile_dir())
        os.makedirs(dirpath, exist_ok=True)
        key = program_key(**parts)
        path = os.path.join(dirpath, _PROGRAMS)
        try:
            with open(path) as fh:
                doc = json.load(fh)
            if not isinstance(doc, dict):
                doc = {}
        except (OSError, ValueError):
            doc = {}
        row = doc.get(key) or {"parts": {k: str(v) for k, v in
                                         sorted(parts.items())}, "runs": 0}
        row["runs"] = int(row.get("runs", 0)) + 1
        doc[key] = row
        _atomic_json(path, doc)
        return key
    except Exception:  # noqa: BLE001 - the index is observability only
        return None


def warmed_programs(root: str | None = None) -> dict:
    """The semantic index: which (entry, config, mesh, backend, ...)
    programs this cache has seen, and how often."""
    try:
        with open(os.path.join(compile_dir(root), _PROGRAMS)) as fh:
            doc = json.load(fh)
        return doc if isinstance(doc, dict) else {}
    except (OSError, ValueError):
        return {}

"""Paged KV-cache data plane: page pool, page tables, prefix sharing.

The contiguous decode cache gives every slot `cache_len` rows up front, so
HBM scales as slots x max-context and one long request strands capacity the
pool could be serving. This module is the HOST-side bookkeeping of the
vLLM-style fix: a fixed physical pool of `(num_pages, page_len, ...)` KV
blocks, per-slot int32 page tables mapping logical pages -> physical pages,
and refcounted pages so requests sharing a common prefix (system prompt)
map the SAME physical pages.

Sharing is full-page granularity (vLLM block-hash style): only whole pages
whose `page_len` tokens match byte-for-byte are shared, so the first
divergent write always lands on a page boundary and "copy-on-write" never
copies — a fork is just: map the shared prefix pages (+refcount), allocate
private pages from the fork point on. The shared pages are never written
by any holder (every holder's write position starts past them), and since
keys are stored post-RoPE at absolute positions the shared K/V state is
bitwise identical to what the forker would have computed itself.

Tiered eviction: registered prefixes whose pages are otherwise idle can be
spilled to a HOST-memory tier (the engine fetches the page bytes and calls
`PrefixStore.spill`), freeing device pages; a later prefix hit against a
host-tier entry is re-admitted by uploading into freshly allocated pages.
The roundtrip is a bitwise copy, so a request resuming on re-admitted
pages decodes token-for-token identically.

Device arrays never appear here — `launch.engine.DecodeEngine` owns the
pool tensors and executes the fetch/upload plans; everything in this
module is numpy/host state, unit-testable without a model. It is a copy
of `repro.launch.pages`; the port's engine keeps spilled pages as CPU
tensors in `Prefix.host_data` (numpy has no bfloat16).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PagePool", "PrefixStore", "Prefix", "pages_needed"]


def pages_needed(tokens: int, page_len: int) -> int:
    """Physical pages required to hold `tokens` cache rows."""
    return -(-tokens // page_len)


class PagePool:
    """Free-list allocator over `num_pages` physical pages with refcounts.

    A page is FREE (on the free list, rc == 0) or HELD (rc >= 1). Holders
    are slot page-table mappings and prefix-registry entries; each holds
    one reference. `decref` returns pages whose count hit zero to the free
    list. The pool knows nothing about what a page stores.
    """

    def __init__(self, num_pages: int, page_len: int):
        if num_pages < 1:
            raise ValueError("num_pages must be >= 1")
        if page_len < 1:
            raise ValueError("page_len must be >= 1")
        self.num_pages = num_pages
        self.page_len = page_len
        # LIFO free list: recently freed pages are reused first (their old
        # contents are dead, masked by the kpos validity algebra anyway)
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._rc = np.zeros((num_pages,), np.int64)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Take `n` pages (rc=1 each); None if the pool can't cover it."""
        if n < 0:
            raise ValueError("alloc of negative page count")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._rc[pages] += 1
        return pages

    def incref(self, pages) -> None:
        for p in pages:
            if self._rc[p] <= 0:
                raise ValueError(f"incref of free page {p}")
            self._rc[p] += 1

    def decref(self, pages) -> list[int]:
        """Drop one reference per page; returns the pages freed by this."""
        freed = []
        for p in pages:
            if self._rc[p] <= 0:
                raise ValueError(f"decref of free page {p}")
            self._rc[p] -= 1
            if self._rc[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def refcount(self, page: int) -> int:
        return int(self._rc[page])


@dataclasses.dataclass(eq=False)  # identity semantics: entries hold arrays
class Prefix:
    """One registered shareable prefix: `len(pages)` FULL pages covering
    `tokens` (`len(pages) * page_len` token ids). Device tier: `pages` are
    live pool page ids (one registry reference each). Host tier: `pages`
    is empty and `host_data` maps cache keys -> numpy page payloads of
    shape (n_layers, n_pages, page_len, ...)."""

    tokens: np.ndarray
    pages: list[int]
    tier: str  # "device" | "host"
    host_data: dict[str, np.ndarray] | None = None
    last_use: int = 0
    # namespace baked into every lookup key: the multi-tenant engine scopes
    # prefixes to (tenant, adapter version) — KV bytes depend on the
    # adapter, so sharing across tenants (or across a hot swap) would
    # replay the WRONG cache
    ns: bytes = b""

    @property
    def n_pages(self) -> int:
        if self.tier == "device":
            return len(self.pages)
        first = next(iter(self.host_data.values()))
        return first.shape[1]


class PrefixStore:
    """Full-page prefix registry with a device tier and a host spill tier.

    Keys are the raw bytes of the first `j * page_len` prompt tokens for
    every j up to the entry's page count, so a probe hits the LONGEST
    registered full-page prefix of a new prompt. Registering holds one
    pool reference per device page; `evict_lru` hands the coldest device
    entry back to the caller, who fetches the page bytes, calls `spill`
    (moving the entry to the host tier) and decrefs the pages.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_len = pool.page_len
        # key -> (entry, j): key covers entry.tokens[: j * page_len]
        self._dev: dict[bytes, tuple[Prefix, int]] = {}
        self._host: dict[bytes, tuple[Prefix, int]] = {}
        self._dev_entries: list[Prefix] = []
        self._clock = 0

    # -- keys ----------------------------------------------------------

    def _key(self, tokens: np.ndarray, j: int, ns: bytes = b"") -> bytes:
        return ns + np.ascontiguousarray(
            tokens[: j * self.page_len], dtype=np.int32).tobytes()

    def _touch(self, entry: Prefix) -> None:
        self._clock += 1
        entry.last_use = self._clock

    # -- probe ---------------------------------------------------------

    def probe(self, prompt: np.ndarray, ns: bytes = b""):
        """Longest full-page prefix hit for `prompt` in namespace `ns`,
        or None.

        Returns (entry, j, tier). j < pages_needed(len(prompt)) strictly:
        at least one prompt token is always left for the tail prefill (the
        true-last-token logits must come from a freshly processed token),
        hence the (len - 1) below. Device hits win ties over host hits.
        """
        j_max = (len(prompt) - 1) // self.page_len
        for j in range(j_max, 0, -1):
            key = self._key(np.asarray(prompt), j, ns)
            for tier, table in (("device", self._dev), ("host", self._host)):
                got = table.get(key)
                if got is not None:
                    entry, _ = got
                    self._touch(entry)
                    return entry, j, tier
        return None

    # -- register ------------------------------------------------------

    def register(self, prompt: np.ndarray, pages: list[int],
                 ns: bytes = b"") -> bool:
        """Register `pages` (the slot's first full pages) as a device-tier
        shareable prefix; increfs each page. Dedupes: if the full key is
        already registered (either tier) nothing happens and False is
        returned — the caller keeps sole ownership of its pages."""
        j = len(pages)
        if j == 0:
            return False
        tokens = np.asarray(prompt, np.int32)[: j * self.page_len].copy()
        if len(tokens) != j * self.page_len:
            raise ValueError("register needs j full pages of tokens")
        full_key = self._key(tokens, j, ns)
        if full_key in self._dev or full_key in self._host:
            return False
        entry = Prefix(tokens=tokens, pages=list(pages), tier="device",
                       ns=ns)
        self.pool.incref(entry.pages)
        self._touch(entry)
        self._dev_entries.append(entry)
        for i in range(1, j + 1):
            self._dev.setdefault(self._key(tokens, i, ns), (entry, i))
        return True

    # -- eviction / tiering --------------------------------------------

    def evict_lru(self) -> Prefix | None:
        """Unlink and return the coldest device-tier entry (its pages keep
        their registry reference until the caller calls `spill` or
        `drop`). None if the device tier is empty."""
        if not self._dev_entries:
            return None
        entry = min(self._dev_entries, key=lambda e: e.last_use)
        self._dev_entries.remove(entry)
        for i in range(1, len(entry.pages) + 1):
            key = self._key(entry.tokens, i, entry.ns)
            if self._dev.get(key, (None, 0))[0] is entry:
                del self._dev[key]
        return entry

    def spill(self, entry: Prefix, host_data: dict[str, np.ndarray]) -> list[int]:
        """Move an evicted entry to the host tier. `host_data` holds the
        fetched page payloads. Returns the pages freed by dropping the
        registry references (the caller removes them from its tables)."""
        freed = self.pool.decref(entry.pages)
        entry.tier = "host"
        entry.host_data = host_data
        entry.pages = []
        j = len(entry.tokens) // self.page_len
        for i in range(1, j + 1):
            self._host.setdefault(self._key(entry.tokens, i, entry.ns),
                                  (entry, i))
        return freed

    def drop(self, entry: Prefix) -> list[int]:
        """Discard an evicted entry without spilling (host tier disabled)."""
        return self.pool.decref(entry.pages)

    def readmit(self, entry: Prefix, pages: list[int]) -> None:
        """Promote a host-tier entry back to the device tier on `pages`
        (freshly allocated by the caller, who also uploaded the payloads).
        The alloc reference becomes the registry reference."""
        j = len(entry.tokens) // self.page_len
        for i in range(1, j + 1):
            key = self._key(entry.tokens, i, entry.ns)
            if self._host.get(key, (None, 0))[0] is entry:
                del self._host[key]
        entry.tier = "device"
        entry.host_data = None
        entry.pages = list(pages)
        self._touch(entry)
        self._dev_entries.append(entry)
        for i in range(1, j + 1):
            self._dev.setdefault(self._key(entry.tokens, i, entry.ns),
                                 (entry, i))

    # -- introspection -------------------------------------------------

    @property
    def num_device_entries(self) -> int:
        return len(self._dev_entries)

    @property
    def num_host_entries(self) -> int:
        return len({id(e) for e, _ in self._host.values()})

    def evictable_pages(self) -> int:
        """Pages the device tier could free if every entry were spilled:
        pages whose only reference is the registry's."""
        seen: set[int] = set()
        n = 0
        for e in self._dev_entries:
            for p in e.pages:
                if p not in seen and self.pool.refcount(p) == 1:
                    seen.add(p)
                    n += 1
        return n

"""Continuous-batching decode engine over a fixed slot pool.

The counterpart of `repro.launch.engine.DecodeEngine`. Three device
operations, none of whose shapes depend on the traffic:

  admission  chunked prefill: a Python loop over `prefill_chunk` prompt
      positions per dispatch, calling `serve_step` once per position.
      Only the slots being admitted are active; every other slot is
      frozen (its writes go to the trash page, or rewrite its own bits on
      the contiguous plane; its position stays). Each admitted slot's
      true-last-token logits land in an (S, V) f32 buffer whose argmax
      is its first output token. Co-admission is skew-capped as in the
      reference.
  decode     one `serve_step` advances every live slot by one greedy
      token; retired and free slots ride along masked.
  recycle    resets the recycled slots: `pos` to their start offset
      (past any shared prefix), a contiguous cache's slot rows to zero
      along `cache_slot_axes`; page pools pass through untouched and the
      host page table is written to `pt` afterwards.

Two cache data planes:

  contiguous (`paging="off"`; the ring of a sliding-window config): every
      slot owns `cache_len` rows (the window's, for a ring) up front.
  paged: a fixed physical pool of `(num_pages, page_len, ...)` KV pages
      plus per-slot int32 page tables (launch.pages). Admission reserves
      every page a request will touch, retirement returns pages to the
      free list, full pages of completed prompts register in a prefix
      store that later requests map physically, and cold prefixes spill
      to host memory under pressure and come back bit for bit on a later
      hit.

`paging="auto"` (the default) pages where the model can (full attention,
no ring window) and `cache_len` is a multiple of `page_len`, and keeps the
contiguous plane otherwise; `"on"` raises where it cannot page; `"off"`
keeps the contiguous plane. A full-attention request must fit
`cache_len`; a ring-window one may run past it.

The caches are updated in place (models.attention). Retirement and the
queue are host-side numpy bookkeeping. Output is token for token that of
the reference engine on the same parameters, up to argmax ties.

    engine = DecodeEngine(model, params, num_slots=8, cache_len=128)
    rid = engine.submit(prompt_tokens, max_new_tokens=32)
    done = engine.run()          # {rid: Completion}

Multi-tenant serving (`max_tenants=T`): one frozen base model and many
privately fine-tuned DP-LoRA adapters (the paper's Sec. 5.3 recipe).
The adapters of every live tenant lie in ONE tenant-stacked buffer per
leaf, (n, T, ...), allocated once (`core.lora.stacked_adapter_zeros`);
each pool slot carries an int adapter-slot id, and every dispatch applies
each row's own adapter (`core.lora.stacked_lora_delta`). The ids and the
buffer are data: onboarding a tenant, hot-swapping an adapter
(`update_adapter`, the target of `launch.swap.AdapterWatcher`) and
retiring a tenant are `copy_` writes into the allocated buffer and host
table updates, and `serve_step` is given the same adapter storage
throughout (`adapter_storages` records it, after each write into the
buffer: the counterpart of the reference's `trace_counts`). The rows' slot
ids are a (num_slots,) tensor made anew at each admission, so a CUDA graph
of the step would need them written in place first. It works on both
planes.

  * `add_tenant` fills a free adapter slot; when all T are held the
    tenant WAITS (FIFO) and its requests hold the queue until a slot
    frees (`adapter_slot_deferrals`).
  * `update_adapter` is blue/green: with requests of the tenant in
    flight, the new version lands in a spare slot and only new admissions
    route to it; the old slot drains with its requests (each keeps its
    version to the last token) and frees at the last retirement. With no
    spare slot, or nothing in flight, the write is in place.
  * `remove_tenant` refuses new submits, drains the tenant's queued and
    in-flight requests, then recycles its slot to the waiters.

Prefix sharing on the paged plane is namespaced by (tenant, adapter
version): the KV bytes depend on the adapter, so a prefix never crosses
tenants or survives a swap.

    eng = DecodeEngine(model, base_params, num_slots=8, cache_len=128,
                       max_tenants=4)
    alice = eng.add_tenant(adapter_tree, name="alice")
    rid = eng.submit(prompt_tokens, max_new_tokens=32, tenant=alice)
    eng.update_adapter(alice, new_tree)   # hot swap, in place
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import leaf_crc32, tree_flatten
from repro_torch.core.lora import (stacked_adapter_zeros,
                                   stacked_slot_update)
from repro_torch.launch.pages import PagePool, PrefixStore, pages_needed


@dataclasses.dataclass
class Completion:
    """One finished request."""

    rid: int
    prompt_len: int
    tokens: list[int]
    finish_reason: str  # "eos" | "length"


class DecodeEngine:
    """Slot-pool continuous-batching greedy decoder (see module doc)."""

    STATS_DOC = {
        "prefill_dispatches": "chunked-prefill dispatches run at admission "
                              "(one per prefill_chunk positions per "
                              "co-admitted batch)",
        "decode_dispatches": "pool-wide decode dispatches (one per "
                             "`step()` with any live slot)",
        "serve_steps": "calls of the model's serve_step (prefill_chunk per "
                       "prefill dispatch, one per decode dispatch)",
        "tokens_out": "tokens emitted across all requests",
        "requests_done": "requests retired (EOS or length)",
        "prefill_pad_chunks_saved": "padded prefill chunks avoided by the "
                                    "admission skew cap",
        "live_slot_steps": "sum over steps of live slots advanced",
        "peak_live_slots": "max live slots in any one decode dispatch",
        "pages_in_use": "pool pages currently held (paged plane)",
        "peak_pages_in_use": "high-water mark of pages_in_use",
        "prefix_hits": "admissions that mapped a registered shared prefix "
                       "instead of recomputing it",
        "shared_pages": "physical pages mapped from shared prefixes "
                        "(cumulative over admissions)",
        "evicted_pages": "pages freed by spilling/dropping cold prefixes "
                         "under pool pressure",
        "readmitted_pages": "host-tier prefix pages uploaded back to the "
                            "device pool on a later hit",
        "admission_deferrals": "admissions deferred because the page pool "
                               "could not cover the request's full "
                               "reservation (FIFO: the head blocks)",
        "tenants_admitted": "tenants granted an adapter slot (multi-"
                            "tenant mode)",
        "adapter_swaps": "hot swaps installed via update_adapter "
                         "(blue/green or in-place)",
        "adapter_slot_deferrals": "admissions deferred because the "
                                  "request's tenant is still waiting for "
                                  "an adapter slot (FIFO, like page "
                                  "reservation deferral)",
    }

    def __init__(self, model, params, *, num_slots: int, cache_len: int,
                 prefill_chunk: int = 8, eos_id: int | None = None,
                 paging: str = "auto", page_len: int = 16,
                 num_pages: int | None = None, host_spill: bool = True,
                 prefill_skew_chunks: int = 1, on_token=None,
                 max_tenants: int | None = None):
        """num_slots: pool width S, the batch of every dispatch.
        cache_len: per-slot logical context horizon in tokens, a multiple
        of page_len for the paged plane. prefill_chunk: prompt positions
        per admission dispatch. eos_id: retire-on-token (None: length
        only). paging: 'auto', 'on' or 'off' (module doc). page_len /
        num_pages / host_spill: the page pool (default num_pages: slots x
        cache pages). prefill_skew_chunks: co-admission skew cap in
        chunks. on_token: None, or a callable (rid, token, logits) called
        as each token is emitted, with the (V,) device row of logits the
        token is the argmax of (a view, valid until the next dispatch).
        max_tenants: None serves the single model in `params`; an int T
        is multi-tenant mode (module doc): the model must be built with
        `lora_rank > 0` (its adapter spec sizes the tenant-stacked
        buffer), `params` holds the frozen base, and every `submit`
        names a tenant of `add_tenant`. T bounds the adapters resident at
        once, not the tenants ever onboarded.
        The engine runs on the device of `params`."""
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if paging not in ("auto", "on", "off"):
            raise ValueError("paging must be 'auto', 'on' or 'off'")
        if page_len < 1:
            raise ValueError("page_len must be >= 1")
        if prefill_skew_chunks < 0:
            raise ValueError("prefill_skew_chunks must be >= 0")
        self.model, self.params = model, params
        self.device = params["embed"]["w"].device
        self.num_slots, self.cache_len = num_slots, cache_len
        self.eos_id = eos_id
        self._on_token = on_token
        self._chunk = prefill_chunk
        self._skew = prefill_skew_chunks
        cfg = model.cfg
        # a full (non-ring) attention cache bounds the horizon; a ring
        # window carries only the window
        self._bounded = (cfg.attention_kind == "mla"
                         or cfg.sliding_window is None)
        can_page = self._bounded and cache_len % page_len == 0
        if paging == "on" and not can_page:
            raise ValueError(
                "paging='on' needs a full-attention model family and "
                "cache_len divisible by page_len (ring-window caches "
                "bypass paging)")
        self.paged = can_page if paging == "auto" else paging == "on"
        self.page_len = page_len

        if self.paged:
            ptab = cache_len // page_len
            self.num_pages = (num_slots * ptab if num_pages is None
                              else int(num_pages))
            if self.num_pages < 1:
                raise ValueError("num_pages must be >= 1")
            self.cache = model.init_paged_cache(
                num_slots, cache_len, num_pages=self.num_pages,
                page_len=page_len)
            self._pool = PagePool(self.num_pages, page_len)
            self._prefix = PrefixStore(self._pool)
            self._host_spill = host_spill
            # host mirror of cache["pt"]; trash page index = num_pages
            self._table = np.full((num_slots, ptab), self.num_pages,
                                  np.int32)
            self._row_pages: list[list[int]] = [[] for _ in range(num_slots)]
        else:
            self.num_pages = None
            self.cache = model.init_cache(num_slots, cache_len)
        self._axes = model.cache_slot_axes(self.cache)
        self._pool_keys = [k for k, ax in self._axes.items() if ax is None]
        self._last = torch.zeros((num_slots, cfg.vocab_size),
                                 dtype=torch.float32, device=self.device)

        # ---- host-side slot table ----
        self._rid = np.full((num_slots,), -1, np.int64)
        self._live = np.zeros((num_slots,), bool)
        self._gen = np.zeros((num_slots,), np.int64)
        self._max = np.zeros((num_slots,), np.int64)
        self._tok = np.zeros((num_slots,), np.int32)  # last emitted token
        self._start = np.zeros((num_slots,), np.int32)  # pos at admission
        self._queue: collections.deque = collections.deque()
        self._out: dict[int, list[int]] = {}
        self._plen: dict[int, int] = {}
        self._done: dict[int, Completion] = {}
        self._next_rid = 0
        self.stats = {k: 0 for k in self.STATS_DOC}
        # host seconds spent in each phase; every phase ends in a copy to
        # the host, so these include the device time
        self.seconds = {"prefill": 0.0, "decode": 0.0}

        # ---- multi-tenant adapter plane ----
        self.multi_tenant = max_tenants is not None
        # per pool slot: the adapter-slot id riding every dispatch, the
        # owning tenant and its prefix namespace
        self._tid = np.zeros((num_slots,), np.int32)
        # its device copy, refreshed at admission (a host-to-device copy
        # every serve_step would wait for the device each time)
        self._tid_dev = torch.as_tensor(self._tid, device=self.device)
        self._slot_tid = np.full((num_slots,), -1, np.int64)
        self._slot_ns: list[bytes] = [b""] * num_slots
        # the distinct adapter storages (each leaf's data_ptr and shape)
        # serve_step is given, recorded where the buffer is written: one
        # entry for the life of an engine
        self.adapter_storages: set = set()
        self._serve_params = params
        self.max_tenants = None
        if self.multi_tenant:
            if max_tenants < 1:
                raise ValueError("max_tenants must be >= 1")
            spec_lora = model.spec.get("lora")
            if not spec_lora:
                raise ValueError(
                    "multi-tenant serving needs a model built with "
                    "lora_rank > 0 (the adapter spec sizes the "
                    "tenant-stacked buffer)")
            self.max_tenants = int(max_tenants)
            self._adapters = stacked_adapter_zeros(
                spec_lora, self.max_tenants, device=self.device)
            self._tenants: dict[int, dict] = {}
            self._next_tid = 0
            self._aslot_free: list[int] = list(range(self.max_tenants))
            self._aslot_rc = np.zeros((self.max_tenants,), np.int64)
            self._draining: set[int] = set()
            self._waiting: collections.deque = collections.deque()
            self._serve_params = {**params, "lora_stack": self._adapters}
            self._record_storage()

    # ------------------------------------------------------------------
    # Public surface.
    # ------------------------------------------------------------------

    def cache_bytes(self) -> int:
        """Device bytes held by the decode cache: on the paged plane every
        stack's pools (k/v or MLA's latent), the tables and pos; on the
        contiguous one every stack's per-slot caches and pos."""
        return int(sum(v.numel() * v.element_size()
                       for v in self.cache.values()))

    @property
    def num_pending(self) -> int:
        return len(self._queue)

    @property
    def num_live(self) -> int:
        return int(self._live.sum())

    @property
    def live_requests(self) -> list[int]:
        """Ids of the requests decoding in the pool now (admitted, not
        retired)."""
        return [int(r) for r in self._rid[self._live]]

    def completions(self) -> dict[int, Completion]:
        return dict(self._done)

    def submit(self, prompt, max_new_tokens: int,
               tenant: int | None = None) -> int:
        """Enqueue one request (1-D int token ids, >= 1 token); admitted
        into a free slot at the next `step()` (FIFO). Returns its id.
        tenant: required in multi-tenant mode (an `add_tenant` id that is
        not retiring), refused otherwise."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError(
                "empty prompt: seed requests with at least one (BOS) token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self._bounded and prompt.size + max_new_tokens > self.cache_len:
            raise ValueError(
                f"request needs {prompt.size}+{max_new_tokens} cache slots "
                f"but the pool was sized with cache_len={self.cache_len}")
        if self.paged:
            need = pages_needed(prompt.size + max_new_tokens, self.page_len)
            if need > self.num_pages:
                raise ValueError(
                    f"request needs {need} pages but the page pool holds "
                    f"only num_pages={self.num_pages}")
        if self.multi_tenant:
            t = self._tenant(tenant)
            if t["retiring"]:
                raise ValueError(f"tenant {tenant} is retiring: no new "
                                 f"requests accepted")
            t["queued"] += 1
            t["stats"]["requests_submitted"] += 1
        elif tenant is not None:
            raise ValueError("tenant= requires a multi-tenant engine "
                             "(max_tenants=)")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, prompt, int(max_new_tokens), tenant))
        return rid

    # ------------------------------------------------------------------
    # Multi-tenant surface.
    # ------------------------------------------------------------------

    @property
    def num_free_adapter_slots(self) -> int:
        """Adapter slots not held by a live or draining tenant version."""
        self._require_mt()
        return len(self._aslot_free)

    def adapter_bytes(self) -> int:
        """Device bytes held by the tenant-stacked adapter buffer."""
        self._require_mt()
        return int(sum(v.numel() * v.element_size()
                       for v in tree_flatten(self._adapters)))

    def add_tenant(self, adapters=None, *, name: str | None = None) -> int:
        """Onboard a tenant; returns its id (stable for its lifetime,
        independent of adapter slots). adapters: the tenant's trained
        adapter tree (the `lora` subtree of a fine-tune, leaves (n, d_in,
        r) / (n, r, d_out) as `adapter_template()`), or None for the base
        model. With a free adapter slot it is installed at once (a copy
        into the buffer); otherwise the tenant WAITS, FIFO, and its
        requests hold the queue until a retiring tenant's slot frees."""
        self._require_mt()
        tid = self._next_tid
        self._next_tid += 1
        self._tenants[tid] = {
            "tid": tid, "name": name or f"tenant-{tid}", "aslot": None,
            "version": 0, "retiring": False, "removed": False,
            "queued": 0, "inflight": 0, "pending_tree": adapters,
            "stats": {"requests_submitted": 0, "requests_done": 0,
                      "tokens_out": 0, "swaps": 0}}
        self._waiting.append(tid)
        self._assign_adapter_slots()
        return tid

    def update_adapter(self, tid: int, adapters) -> None:
        """Hot-swap a tenant's adapter (`launch.swap` calls it with a
        published, crc-verified tree). Blue/green: while the tenant has
        requests in flight on the old version, the new one goes into a
        SPARE adapter slot and only new admissions route to it; the old
        slot drains and frees at its last request's retirement. With no
        request in flight (or no spare slot) the write is in place. Either
        way it is a copy into the allocated buffer, and the paged prefix
        namespace rolls over with the version."""
        t = self._tenant(tid)
        if t["retiring"]:
            raise ValueError(f"tenant {tid} is retiring: cannot swap")
        if t["aslot"] is None:
            t["pending_tree"] = adapters  # not installed yet: restage
        elif self._aslot_rc[t["aslot"]] > 0 and self._aslot_free:
            old = t["aslot"]
            new = self._aslot_free.pop(0)
            stacked_slot_update(self._adapters, new, adapters)
            t["aslot"] = new
            self._draining.add(old)  # frees when its last request retires
        else:
            stacked_slot_update(self._adapters, t["aslot"], adapters)
        self._record_storage()
        t["version"] += 1
        t["stats"]["swaps"] += 1
        self.stats["adapter_swaps"] += 1

    def remove_tenant(self, tid: int) -> None:
        """Retire a tenant: new submits are refused at once; its queued
        and in-flight requests drain on its current version, and its
        adapter slot returns to the free list (waking FIFO waiters) at
        the last one's retirement. Idempotent."""
        t = self._tenant(tid, allow_removed=True)
        if t["retiring"]:
            return
        t["retiring"] = True
        self._maybe_release(tid)

    def tenant_stats(self, tid: int) -> dict:
        """Per-tenant counters (requests_submitted, requests_done,
        tokens_out, swaps) and lifecycle: state ('waiting' | 'active' |
        'retiring' | 'removed'), version, adapter_slot, queued, inflight,
        name."""
        t = self._tenant(tid, allow_removed=True)
        state = ("removed" if t["removed"] else
                 "retiring" if t["retiring"] else
                 "active" if t["aslot"] is not None else "waiting")
        return dict(t["stats"], state=state, version=t["version"],
                    adapter_slot=t["aslot"], queued=t["queued"],
                    inflight=t["inflight"], name=t["name"])

    def tenants(self) -> list[int]:
        """Ids of the tenants not removed yet, in onboarding order."""
        self._require_mt()
        return [tid for tid, t in self._tenants.items() if not t["removed"]]

    def adapter_template(self) -> dict:
        """A zero per-tenant adapter tree on the engine's device, leaves
        (n, ...) (the stacked buffer without the tenant axis): the
        `load_checkpoint` template of a published adapter (`launch.swap`).
        Its leaves flatten in the published manifest's order."""
        self._require_mt()

        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return torch.zeros(tree.shape[:1] + tree.shape[2:],
                               dtype=tree.dtype, device=tree.device)

        return zeros(self._adapters)

    def adapter_crcs(self, tid: int) -> list[int]:
        """crc32 of every adapter leaf INSTALLED on the device for `tid`,
        in flatten order, over the raw bytes a checkpoint manifest
        checksums: the bitwise check of a hot swap, read back from the
        live buffer (`launch.swap` compares it with the manifest)."""
        t = self._tenant(tid)
        if t["aslot"] is None:
            raise ValueError(f"tenant {tid} has no installed adapter yet")
        return [leaf_crc32(leaf[:, t["aslot"]])
                for leaf in tree_flatten(self._adapters)]

    def _require_mt(self):
        if not self.multi_tenant:
            raise ValueError("this engine was built single-model; pass "
                             "max_tenants= for multi-tenant serving")

    def _tenant(self, tid, allow_removed: bool = False) -> dict:
        self._require_mt()
        t = self._tenants.get(tid)
        if t is None:
            raise ValueError(f"unknown tenant id {tid!r}")
        if t["removed"] and not allow_removed:
            raise ValueError(f"tenant {tid} was removed")
        return t

    def _assign_adapter_slots(self) -> None:
        """FIFO: hand freed adapter slots to waiting tenants."""
        while self._waiting and self._aslot_free:
            tid = self._waiting.popleft()
            t = self._tenants[tid]
            if t["removed"] or t["aslot"] is not None:
                continue
            aslot = self._aslot_free.pop(0)
            stacked_slot_update(self._adapters, aslot,
                                t.pop("pending_tree", None))
            self._record_storage()
            t["aslot"] = aslot
            self.stats["tenants_admitted"] += 1

    def _maybe_release(self, tid: int) -> None:
        """A retiring tenant with nothing queued or in flight: recycle."""
        t = self._tenants[tid]
        if (not t["retiring"] or t["removed"] or t["queued"]
                or t["inflight"]):
            return
        t["removed"] = True
        if t["aslot"] is not None:
            # inflight == 0: no pool slot pins this adapter slot
            self._aslot_free.append(t["aslot"])
            t["aslot"] = None
        self._assign_adapter_slots()

    def _prefix_ns(self, tid) -> bytes:
        """Prefix-store namespace: KV that depends on an adapter never
        crosses a tenant or an adapter version."""
        if not self.multi_tenant:
            return b""
        t = self._tenants[tid]
        return f"{tid}:{t['version']}|".encode()

    def _record_storage(self) -> None:
        """Note the adapter buffer's storage after a write into it."""
        self.adapter_storages.add(tuple(
            (t.data_ptr(), tuple(t.shape))
            for t in tree_flatten(self._adapters)))

    def _serve(self, token, active):
        """One serve_step over the pool (with the rows' adapter-slot ids
        in multi-tenant mode)."""
        batch = {"token": token, "active": active}
        if self.multi_tenant:
            batch["tenant"] = self._tid_dev
        return self.model.serve_step(self._serve_params, self.cache, batch)

    def step(self) -> int:
        """Admit whatever fits into free slots (chunked prefill), then one
        pool-wide decode dispatch advancing every live slot. Returns the
        number of live slots advanced."""
        self._admit()
        live_idx = np.nonzero(self._live)[0]
        if live_idx.size == 0:
            return 0
        t0 = time.perf_counter()
        tok = torch.as_tensor(self._tok, device=self.device)
        live = torch.as_tensor(self._live, device=self.device)
        logits, self.cache = self._serve(tok[:, None], live)
        nxt = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        nxt = torch.where(live, nxt, tok).cpu().numpy()
        self.seconds["decode"] += time.perf_counter() - t0
        self.stats["serve_steps"] += 1
        self.stats["decode_dispatches"] += 1
        self.stats["live_slot_steps"] += int(live_idx.size)
        self.stats["peak_live_slots"] = max(self.stats["peak_live_slots"],
                                            int(live_idx.size))
        for slot in live_idx:
            self._emit(int(slot), int(nxt[slot]), logits)
        return int(live_idx.size)

    def run(self, max_steps: int | None = None) -> dict[int, Completion]:
        """Drive until the queue and the pool drain, or until `max_steps`
        pool steps; returns the completions so far (keyed by request id).
        An unbounded run raises RuntimeError if the queue head can never
        be admitted (a tenant waiting for an adapter slot no drain will
        free, or a page reservation nothing live can release); a bounded
        run returns at `max_steps` instead, which is how a caller pumps
        the pool while waiting on an external action (a `remove_tenant`,
        a hot swap)."""
        steps = 0
        while self._queue or self._live.any():
            if max_steps is not None and steps >= max_steps:
                break
            before = len(self._queue)
            advanced = self.step()
            steps += 1
            if (max_steps is None and advanced == 0
                    and not self._live.any()
                    and len(self._queue) == before and self._queue):
                raise RuntimeError(
                    f"engine stalled with {len(self._queue)} queued "
                    f"request(s) and no live slots: the queue head cannot "
                    f"be admitted (waiting tenant without a free adapter "
                    f"slot, or an unsatisfiable page reservation)")
        return dict(self._done)

    # ------------------------------------------------------------------
    # Paged data plane (host side; device tensors live in self.cache).
    # ------------------------------------------------------------------

    def _alloc_evicting(self, n: int) -> list[int] | None:
        """Allocate `n` pages, spilling cold registered prefixes to the
        host tier (or dropping them when host_spill=False) until the pool
        can cover it. None if even a fully evicted device tier cannot."""
        got = self._pool.alloc(n)
        while got is None:
            entry = self._prefix.evict_lru()
            if entry is None:
                return None
            if self._host_spill:
                idx = torch.as_tensor(entry.pages, dtype=torch.long,
                                      device=self.device)
                data = {k: self.cache[k][:, idx].cpu()
                        for k in self._pool_keys}
                freed = self._prefix.spill(entry, data)
            else:
                freed = self._prefix.drop(entry)
            self.stats["evicted_pages"] += len(freed)
            got = self._pool.alloc(n)
        return got

    def _plan_pages(self, prompt, max_new: int, hit):
        """Reserve every page the request will ever touch (shared prefix
        + private tail through the last generated token). Returns (shared
        page count j, page row) or None when the pool can't cover it yet
        (the caller defers the request)."""
        need_total = pages_needed(prompt.size + max_new, self.page_len)
        if hit is None:
            priv = self._alloc_evicting(need_total)
            if priv is None:
                return None
            return 0, priv
        entry, j, tier = hit
        if tier == "host":
            n_up = entry.n_pages
            up = self._alloc_evicting(n_up)
            if up is None:
                return None
            priv = self._alloc_evicting(need_total - j)
            if priv is None:
                self._pool.decref(up)
                return None
            idx = torch.as_tensor(up, dtype=torch.long, device=self.device)
            for k in self._pool_keys:
                self.cache[k][:, idx] = entry.host_data[k].to(self.device)
            self._prefix.readmit(entry, up)  # alloc ref -> registry ref
            shared = list(up[:j])
            self._pool.incref(shared)        # the slot's own reference
            self.stats["readmitted_pages"] += n_up
        else:
            shared = list(entry.pages[:j])
            self._pool.incref(shared)
            priv = self._alloc_evicting(need_total - j)
            if priv is None:
                self._pool.decref(shared)
                return None
        self.stats["prefix_hits"] += 1
        self.stats["shared_pages"] += j
        return j, shared + priv

    # ------------------------------------------------------------------
    # Internals.
    # ------------------------------------------------------------------

    def _admit(self):
        """Move queued requests into free slots (FIFO, a blocked request
        blocks everything behind it): recycle the slots, then
        length-masked chunked prefill of all admitted slots together.
        Gates: the skew cap, on the paged plane the page reservation, and
        in multi-tenant mode the tenant's adapter slot (a tenant still
        waiting for one defers its request, FIFO)."""
        free = [s for s in range(self.num_slots) if not self._live[s]]
        batch = []  # (slot, rid, prompt, tail, max_new)
        ch_lo = ch_hi = 0
        while free and self._queue:
            rid, prompt, max_new, tenant = self._queue[0]
            ns = self._prefix_ns(tenant)
            if self.multi_tenant:
                t = self._tenants[tenant]
                if t["aslot"] is None:
                    self.stats["adapter_slot_deferrals"] += 1
                    break
            hit = self._prefix.probe(prompt, ns) if self.paged else None
            j = hit[1] if hit is not None else 0
            ch = -(-(prompt.size - j * self.page_len) // self._chunk)
            if batch:
                lo, hi = min(ch_lo, ch), max(ch_hi, ch)
                if hi - lo > self._skew:
                    self.stats["prefill_pad_chunks_saved"] += (
                        len(batch) * max(0, ch - ch_hi)
                        + max(0, ch_lo - ch))
                    break
            if self.paged:
                plan = self._plan_pages(prompt, max_new, hit)
                if plan is None:
                    self.stats["admission_deferrals"] += 1
                    break
                j, row = plan
            self._queue.popleft()
            slot = free.pop(0)
            if self.multi_tenant:
                # pin the tenant's CURRENT adapter slot to this pool slot:
                # a blue/green swap mid-request moves the tenant to a new
                # slot, and this request keeps decoding on the old one
                aslot = t["aslot"]
                self._tid[slot] = aslot
                self._slot_tid[slot] = tenant
                self._aslot_rc[aslot] += 1
                t["queued"] -= 1
                t["inflight"] += 1
            self._slot_ns[slot] = ns
            ch_lo, ch_hi = (ch, ch) if not batch else (min(ch_lo, ch),
                                                       max(ch_hi, ch))
            if self.paged:
                self._table[slot, :] = self.num_pages
                self._table[slot, : len(row)] = row
                self._row_pages[slot] = row
            self._start[slot] = j * self.page_len
            batch.append((slot, rid, prompt, prompt[j * self.page_len:],
                          max_new))
        if not batch:
            return
        t0 = time.perf_counter()
        mask = np.zeros((self.num_slots,), bool)
        for slot, _, _, _, _ in batch:
            mask[slot] = True
        dev = self.device
        self._reset(mask)
        if self.multi_tenant:
            self._tid_dev = torch.as_tensor(self._tid, device=dev)
        if self.paged:  # the host table is authoritative for pt
            self.cache["pt"] = torch.as_tensor(self._table, device=dev)

        c = self._chunk
        pmax = max(t.size for _, _, _, t, _ in batch)
        padded = -(-pmax // c) * c
        toks = np.zeros((self.num_slots, padded), np.int32)
        valid = np.zeros((self.num_slots, padded), bool)
        for slot, _, _, tail, _ in batch:
            toks[slot, : tail.size] = tail
            valid[slot, : tail.size] = True
        toks_d = torch.as_tensor(toks, device=dev)
        valid_d = torch.as_tensor(valid, device=dev)
        last = self._last
        for c0 in range(0, padded, c):
            for t in range(c0, c0 + c):
                act = valid_d[:, t]
                logits, self.cache = self._serve(toks_d[:, t:t + 1], act)
                last = torch.where(act[:, None], logits.float(), last)
                self.stats["serve_steps"] += 1
            self.stats["prefill_dispatches"] += 1
        self._last = last
        first = torch.argmax(last, dim=-1).to(torch.int32).cpu().numpy()
        self.seconds["prefill"] += time.perf_counter() - t0
        for slot, rid, prompt, _, max_new in batch:
            self._rid[slot] = rid
            self._live[slot] = True
            self._gen[slot] = 0
            self._max[slot] = max_new
            self._out[rid] = []
            self._plen[rid] = int(prompt.size)
            if self.paged:
                # every full page of the (now fully cached) prompt becomes
                # shareable, so requests admitted mid-flight can hit it
                j_reg = prompt.size // self.page_len
                if j_reg:
                    self._prefix.register(prompt,
                                          self._row_pages[slot][:j_reg],
                                          self._slot_ns[slot])
            # the first output token falls out of the prefill itself
            self._emit(slot, int(first[slot]), last)
        if self.paged:
            used = self._pool.num_used
            self.stats["pages_in_use"] = used
            self.stats["peak_pages_in_use"] = max(
                self.stats["peak_pages_in_use"], used)

    def _reset(self, mask):
        """Recycle the slots of the host mask: `pos` restarts at the
        slot's start (past a shared prefix), a per-slot cache's rows are
        zeroed in place along their slot axis; page pools pass through
        (`pt` is written by the caller)."""
        dev = self.device
        self.cache["pos"] = torch.where(
            torch.as_tensor(mask, device=dev),
            torch.as_tensor(self._start, device=dev), self.cache["pos"])
        if self.paged:
            return
        idx = torch.as_tensor(np.nonzero(mask)[0], device=dev)
        for k, ax in self._axes.items():
            if ax is not None and k != "pos":
                self.cache[k].index_fill_(ax, idx, 0)

    def _emit(self, slot: int, tok: int, logits):
        """Append `tok`, the argmax of row `slot` of `logits`, to the
        slot's request; retire it on eos or at its length."""
        rid = int(self._rid[slot])
        if self._on_token is not None:
            self._on_token(rid, tok, logits[slot])
        self._out[rid].append(tok)
        self._gen[slot] += 1
        self._tok[slot] = tok
        self.stats["tokens_out"] += 1
        if self.multi_tenant:
            self._tenants[self._slot_tid[slot]]["stats"]["tokens_out"] += 1
        if self.eos_id is not None and tok == self.eos_id:
            self._retire(slot, "eos")
        elif self._gen[slot] >= self._max[slot]:
            self._retire(slot, "length")

    def _retire(self, slot: int, reason: str):
        rid = int(self._rid[slot])
        self._done[rid] = Completion(rid=rid, prompt_len=self._plen.pop(rid),
                                     tokens=self._out.pop(rid),
                                     finish_reason=reason)
        self._live[slot] = False
        self._rid[slot] = -1
        self.stats["requests_done"] += 1
        if self.multi_tenant:
            tid = int(self._slot_tid[slot])
            aslot = int(self._tid[slot])
            t = self._tenants[tid]
            t["inflight"] -= 1
            t["stats"]["requests_done"] += 1
            self._aslot_rc[aslot] -= 1
            if self._aslot_rc[aslot] == 0 and aslot in self._draining:
                # the last request on a superseded version: its slot
                # returns to the pool (and may wake a FIFO waiter)
                self._draining.discard(aslot)
                self._aslot_free.append(aslot)
                self._assign_adapter_slots()
            self._slot_tid[slot] = -1
            self._maybe_release(tid)
        self._slot_ns[slot] = b""
        if self.paged:
            # O(table) recycle: pages go back to the free list (or stay
            # alive under their prefix-registry / co-sharing references);
            # nothing on the device is touched
            self._pool.decref(self._row_pages[slot])
            self._row_pages[slot] = []
            self._table[slot, :] = self.num_pages
            self.stats["pages_in_use"] = self._pool.num_used

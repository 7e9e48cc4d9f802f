"""Continuous-batching decode engine over a fixed slot pool.

The counterpart of `repro.launch.engine.DecodeEngine` without the
multi-tenant plane (ROADMAP.md A.10). Three device operations, none of
whose shapes depend on the traffic:

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
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

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
    }

    def __init__(self, model, params, *, num_slots: int, cache_len: int,
                 prefill_chunk: int = 8, eos_id: int | None = None,
                 paging: str = "auto", page_len: int = 16,
                 num_pages: int | None = None, host_spill: bool = True,
                 prefill_skew_chunks: int = 1, on_token=None):
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

    # ------------------------------------------------------------------
    # Public surface.
    # ------------------------------------------------------------------

    def cache_bytes(self) -> int:
        """Device bytes held by the decode cache: on the paged plane every
        stack's pools (k/v or MLA's latent), the tables and pos; on the
        contiguous one every stack's per-slot caches and pos."""
        return int(sum(v.numel() * v.element_size()
                       for v in self.cache.values()))

    def submit(self, prompt, max_new_tokens: int) -> int:
        """Enqueue one request (1-D int token ids, >= 1 token); admitted
        into a free slot at the next `step()` (FIFO). Returns its id."""
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
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, prompt, int(max_new_tokens)))
        return rid

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
        logits, self.cache = self.model.serve_step(
            self.params, self.cache, {"token": tok[:, None], "active": live})
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
        be admitted."""
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
                    f"request(s) and no live slots: the queue head's page "
                    f"reservation cannot be satisfied")
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
        Gates: the skew cap and, on the paged plane, the page
        reservation."""
        free = [s for s in range(self.num_slots) if not self._live[s]]
        batch = []  # (slot, rid, prompt, tail, max_new)
        ch_lo = ch_hi = 0
        while free and self._queue:
            rid, prompt, max_new = self._queue[0]
            hit = self._prefix.probe(prompt) if self.paged else None
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
                logits, self.cache = self.model.serve_step(
                    self.params, self.cache,
                    {"token": toks_d[:, t:t + 1], "active": act})
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
                                          self._row_pages[slot][:j_reg])
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
        if self.paged:
            # O(table) recycle: pages go back to the free list (or stay
            # alive under their prefix-registry / co-sharing references);
            # nothing on the device is touched
            self._pool.decref(self._row_pages[slot])
            self._row_pages[slot] = []
            self._table[slot, :] = self.num_pages
            self.stats["pages_in_use"] = self._pool.num_used

"""PagedSlotEngine: the slot engine over a page pool and a prefix cache,
the port of ``serve/paging/engine.py`` (``--serve.paged``).

The decode cache becomes a pool [num_pages, page_size, nk, Dh] per layer
(int8 with f32 scales under ``kv_cache_quant="int8"``), slots hold page
tables ([num_slots, max_pages] int32 on the host, one device copy that
only a prefill or a release refreshes), and the model's paged decode
branch writes through the tables and gathers each slot's pages back into
the dense layout before the same attend.

What paging buys: a slot reserves pages for its own trajectory (prompt
plus budget, rounded up to pages), not a dense ``max_len`` row; and the
radix prefix cache attaches a request's longest cached prefix (shared
system prompts, few-shot headers, multi-turn ``session`` conversations)
to refcounted pages, so prefill runs only on the uncached tail. A hit
attaches the original pages: the bytes recomputation would produce.

Mechanics, as in JAX:

- **reserve-at-admit**: every page a request can touch is allocated
  (after the prefix attach, after LRU eviction under pressure) before
  its prefill runs, so the decode step never allocates;
- **copy-on-write**: a match that ends mid-page on a shared page copies
  that page (every leaf of every layer) to a fresh one before the tail
  overwrites it;
- **freed slots ride harmlessly**: a freed slot's table resets to the
  write-off page 0 (``pool.GARBAGE_PAGE``);
- **quarantine composes**: ``poison_slot`` NaN-fills only the slot's
  PRIVATE pages (shared prefix pages survive through their refcounts),
  and a slot that was poisoned or flagged non-finite retains nothing on
  release: its private pages are scrubbed to zero before they return to
  the free list, so poison never reaches a later request through a
  masked column.

The speculative verify writes and reads through the tables like the
decode step; ``verify_fallback_slots`` adds one guard: a fallback
re-feed never dips below a slot's ``private_start`` into shared prefix
pages. JAX's ``prefix_hit`` and ``page_evict`` observe events are
counters in ``paging_stats()`` here. ``swap_params`` is the dense
engine's: the model shares the caller's tensors, and the swap copies
into them in place.

Under tensor parallelism the pool's head axis is cut like the dense
cache's (``KVCache.zeros`` at the rank's heads), so ``page_bytes`` is
per device, and ``page_bytes_estimate`` takes the width. The pool, the
radix tree and the tables are the chief's: it sends the tables it
decided with each step and verify (``_tables_arg``) and each prefill's
table row, and the page copies and fills run on every rank
(``@replicated``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    local_ranks)
from tensorflow_distributed_tpu_torch.serve.buckets import pick_bucket
from tensorflow_distributed_tpu_torch.serve.engine import (
    SlotDecodeEngine, replicated)
from tensorflow_distributed_tpu_torch.serve.paging.pool import (
    GARBAGE_PAGE, PagePool)
from tensorflow_distributed_tpu_torch.serve.paging.radix import RadixCache


def _paged_model(model, page_size: int, num_pages: int):
    """``model`` with the paged cache layout, sharing its parameters
    (the same tensors, not a copy): only the config's page fields
    differ."""
    pcfg = dataclasses.replace(model.cfg, kv_page_size=int(page_size),
                               kv_num_pages=int(num_pages))
    with torch.device("meta"):
        paged = type(model)(pcfg, model.ring, model.tp,
                            vocab_shards=model.vocab_shards, ep=model.ep)
    paged.load_state_dict(model.state_dict(), assign=True)
    return paged.eval()


class PagedSlotEngine(SlotDecodeEngine):
    """The slot engine over a page pool (see the module docstring).
    ``page_size``: tokens a page (must divide the model's max_len);
    ``num_pages``: the pool, the write-off page included (0 = twice the
    dense worst case, half serving and half prefix cache); ``radix``:
    False pages without the prefix cache."""

    #: serve/scheduler.py keys the admission context and retention on it.
    paged = True

    def __init__(self, model, num_slots: int, page_size: int = 16,
                 num_pages: int = 0, radix: bool = True, **kw):
        cfg = model.cfg
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if cfg.max_len % page_size:
            raise ValueError(
                f"page_size {page_size} must divide the model's max_len "
                f"{cfg.max_len} (serve/run.py rounds --seq-len up for you)")
        max_pages = cfg.max_len // page_size
        if num_pages <= 0:
            num_pages = 1 + 2 * num_slots * max_pages
        if num_pages < 1 + max_pages:
            raise ValueError(
                f"num_pages {num_pages} cannot hold even one full-depth "
                f"request ({max_pages} pages + the write-off page)")
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        self.pool = PagePool(num_pages, page_size)
        self.radix: Optional[RadixCache] = (RadixCache(self.pool)
                                            if radix else None)
        self.tables = np.zeros((num_slots, max_pages), np.int32)
        self.page_count = np.zeros((num_slots,), np.int32)
        # The first position each slot may write (the matched prefix):
        # a verify-fallback re-feed must never dip below it into shared
        # pages (verify_fallback_slots).
        self.private_start = np.zeros((num_slots,), np.int32)
        # The tables' device copy; None after a prefill or a release
        # changed them.
        self._tables_dev: Optional[torch.Tensor] = None
        self.prompt_tokens = 0
        self.prefix_hit_tokens = 0
        self.prefix_hits = 0
        self.prefill_tokens_computed = 0
        self.prefill_tokens_dense = 0
        self.cow_copies = 0
        self.page_evictions = 0
        # Slots drilled by poison_slot, and slots the device flagged
        # non-finite: their release retains nothing and scrubs their
        # private pages.
        self._poisoned: set = set()
        self._flagged: set = set()
        # Peak distinct pages held by live slots (a shared prefix page
        # counted once): the serving working set a memory budget must
        # cover; cached pages are evictable and sit outside it.
        self.slot_pages_peak = 0
        super().__init__(_paged_model(model, page_size, num_pages),
                         num_slots, **kw)

    # -- the engine's hooks ------------------------------------------------

    def _page_table(self) -> torch.Tensor:
        """The page tables on the device, uploaded again only after a
        prefill or a release changed them: a decode step or a verify
        pays no host-to-device copy of the tables."""
        if self._tables_dev is None:
            self._tables_dev = self._h2d(self.tables).long()
        return self._tables_dev

    def _tables_arg(self) -> Optional[np.ndarray]:
        if self.channel is None or self._tables_dev is not None:
            return None
        return self.tables.copy()

    def _set_tables(self, tables: Optional[np.ndarray]) -> None:
        if tables is not None:
            self.tables[:] = tables
            self._tables_dev = None

    def _slot_table(self, slot: int) -> np.ndarray:
        return self.tables[slot:slot + 1].copy()

    def _prefill_forward(self, padded: torch.Tensor, start: int, slot: int,
                         table: np.ndarray) -> torch.Tensor:
        """The tail at positions ``start ..`` written through the slot's
        page table row ``table`` into the pool (the scatter is the
        insert); cached pages to its left are attended, never
        recomputed."""
        positions = start + torch.arange(padded.shape[1],
                                         device=self.device)[None]
        return self.model(padded, decode=True, positions=positions,
                          cache=self.cache, page_table=self._h2d(table))

    # -- accounting --------------------------------------------------------

    def page_bytes(self) -> int:
        """Device bytes of one page summed over the pool's leaves (the
        scales of an int8 pool included) on ONE device: under tensor
        parallelism every leaf is cut on its head axis, 1/tp_width of
        the whole page's bytes a device."""
        return sum(t[0].numel() * t.element_size()
                   for t in self.cache.leaves()) // local_ranks(
                       getattr(self.model, "tp", None))

    def cache_bytes_per_slot(self) -> int:
        """Worst-case bytes a slot (a full-depth request holds
        ``max_pages`` pages), comparable to the dense engine's number;
        ``paging_stats()`` carries the measured occupancy."""
        return self.page_bytes() * self.max_pages

    def pages_for(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages a request's whole trajectory reserves at admission."""
        horizon = min(prompt_len + max(1, max_new_tokens), self.max_len)
        return -(-horizon // self.page_size)

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Worst-case admission check (prefix hits only lower the need):
        the pool, after evicting every reclaimable cached page, covers
        the reservation plus the one page a copy-on-write may take when
        a cached match ends mid-page (attached pages stop being
        evictable, so without it a tight pool could pass here and run
        out inside prefill). The scheduler defers while this is False
        and live slots will free pages; False with an idle engine means
        the pool is too small."""
        need = self.pages_for(prompt_len, max_new_tokens)
        if self.radix is not None and self.radix.cached_pages > 0:
            need += 1
        if need <= self.pool.free_count:
            return True
        avail = self.pool.free_count + (
            self.radix.reclaimable_pages if self.radix is not None else 0)
        return need <= avail

    def paging_stats(self) -> dict:
        """The pool and prefix-cache view folded into the serve
        summary."""
        out = {
            "page_size": self.page_size,
            "num_pages": self.pool.capacity,
            "page_bytes": self.page_bytes(),
            "pages_per_max_len": self.max_pages,
            **self.pool.stats(),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prompt_tokens": self.prompt_tokens,
            "prefix_hit_rate": round(
                self.prefix_hit_tokens / max(1, self.prompt_tokens), 4),
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_tokens_dense": self.prefill_tokens_dense,
            "cow_copies": self.cow_copies,
            "page_evictions": self.page_evictions,
            "slot_pages_peak": self.slot_pages_peak,
        }
        if self.radix is not None:
            out["cached_pages"] = self.radix.cached_pages
            out["sessions"] = self.radix.sessions_live
        return out

    # -- allocation and admission ------------------------------------------

    def _acquire(self, n: int) -> List[int]:
        """``n`` fresh pages, evicting LRU cached entries under
        pressure."""
        if n <= 0:
            return []
        while (self.pool.free_count < n and self.radix is not None
               and self.radix.evict_one()):
            self.page_evictions += 1
        return self.pool.alloc(n)

    @torch.no_grad()
    def prefill(self, prompt, slot: int, max_new_tokens: int = 0,
                session: str = "") -> int:
        """Admit a request: the longest cached prefix attached (radix or
        session, capped at ``len(prompt) - 1`` so that one tail token
        runs), a shared partial page copied on write, the whole
        trajectory's pages reserved, then a bucketed prefill of only the
        uncached tail. Returns the first generated token."""
        prompt = self._admission(prompt, slot)
        plen = len(prompt)
        ps = self.page_size
        need_total = self.pages_for(plen, max_new_tokens)
        pages, m = [], 0
        if self.radix is not None:
            pages, m, _ = self.radix.lookup(session, prompt, cap=plen - 1)
        fresh = self._acquire(need_total - len(pages))
        if m % ps and pages:
            # The tail's first write lands in the match's last page:
            # shared -> copy it; sole-owned (a consumed session's tail)
            # -> write in place.
            li = m // ps
            if self.pool.ref[pages[li]] > 1:
                dst = self._acquire(1)[0]
                self._copy_page(int(pages[li]), dst)
                self.pool.release([pages[li]])
                pages[li] = dst
                self.cow_copies += 1
        table = [int(p) for p in pages] + fresh
        self.tables[slot, :] = GARBAGE_PAGE
        self.tables[slot, :len(table)] = table
        self.page_count[slot] = len(table)
        self.private_start[slot] = m
        self._tables_dev = None
        with self._span(f"prefill_b{pick_bucket(plen - m, self.buckets)}",
                        slot=slot, prompt_len=plen):
            first, bucket = self._prefill_tail(prompt[m:], m, slot)
        self._activate(slot, first, plen)
        live = {int(p) for s in range(self.num_slots) if self.active[s]
                for p in self.tables[s, :int(self.page_count[s])]}
        self.slot_pages_peak = max(self.slot_pages_peak, len(live))
        self.prompt_tokens += plen
        self.prefill_tokens_computed += bucket
        self.prefill_tokens_dense += (pick_bucket(plen, self.buckets)
                                      if plen <= max(self.buckets) else plen)
        if m:
            self.prefix_hits += 1
            self.prefix_hit_tokens += m
        return first

    # -- release and retention ---------------------------------------------

    def release(self, slot: int, tokens=None, session: str = "") -> None:
        """Free a slot. With ``tokens`` (the request's prompt and emitted
        tokens) the written prefix is retained: its full blocks in the
        radix tree, and all of it (the partial tail page included) under
        ``session`` when set. A slot that was poisoned or flagged
        non-finite retains nothing: its private pages are scrubbed to zero
        first; its shared pages are never written."""
        n = int(self.page_count[slot])
        ids = [int(p) for p in self.tables[slot, :n]]
        if slot in self._poisoned or slot in self._flagged:
            self._fill(self._private_pages(slot), 0.0, False)
        elif tokens is not None and self.radix is not None and ids:
            written = int(self.pos[slot])
            toks = [int(t) for t in tokens][:written]
            if toks:
                cover = -(-len(toks) // self.page_size)
                self.radix.insert(toks, ids)
                if session:
                    self.radix.session_store(session, toks, ids[:cover])
        self.pool.release(ids)
        self.tables[slot, :] = GARBAGE_PAGE
        self.page_count[slot] = 0
        self.private_start[slot] = 0
        self._poisoned.discard(slot)
        self._flagged.discard(slot)
        self._tables_dev = None
        super().free(slot)

    def free(self, slot: int) -> None:
        """A plain free (no retention)."""
        self.release(slot)

    # -- fire drills -------------------------------------------------------

    def _private_pages(self, slot: int) -> List[int]:
        """The slot's pages that no one else holds (refcount 1)."""
        n = int(self.page_count[slot])
        return [int(p) for p in self.tables[slot, :n]
                if self.pool.ref[p] == 1]

    @replicated
    def _copy_page(self, src: int, dst: int) -> None:
        self.cache.copy_page(src, dst)

    @replicated
    def _fill(self, pages: List[int], value: float,
              floats_only: bool) -> None:
        """``_fill_pages`` on every rank."""
        self._fill_pages(pages, value, floats_only)

    @torch.no_grad()
    def _fill_pages(self, pages: List[int], value: float,
                    floats_only: bool) -> None:
        """Fill the listed pages of the pool's leaves with ``value``:
        every leaf (the quarantine scrub: int8 K and V too), or only the
        float ones (the poison)."""
        if not pages:
            return
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        for t in self.cache.leaves():
            if t.is_floating_point() or not floats_only:
                t.index_fill_(0, idx, value)

    def take_bad_slots(self):
        out = super().take_bad_slots()
        self._flagged.update(out)
        return out

    def poison_slot(self, slot: int) -> None:
        """The slot_nan drill, paged: NaN-fill the float leaves of the
        slot's PRIVATE pages only (shared prefix pages must survive the
        quarantine). An admitted slot always owns at least its tail page,
        so the poison reaches a position its next step attends."""
        self._check_slot(slot)
        priv = self._private_pages(slot)
        if not priv:
            raise ValueError(
                f"slot_nan: slot {slot} holds no private pages "
                f"(is it admitted?)")
        self._fill(priv, float("nan"), True)
        self._poisoned.add(slot)

    # -- speculation -------------------------------------------------------

    def verify_fallback_slots(self):
        """The dense engine's, plus the paged guard: a fallback re-feed
        writes positions ``pos - k .. pos``, and where that dips below a
        slot's first private position (it would rewrite a shared prefix
        page) the whole batch takes the plain step instead."""
        out = super().verify_fallback_slots()
        if not out:
            return out
        k = self.spec_tokens
        for s in out:
            if self.pos[s] - k < self.private_start[s]:
                return None
        return out

    def _warm_drills(self) -> None:
        """Poison, then scrub, the write-off page (the warmup zeroes the
        pool after)."""
        self._fill_pages([GARBAGE_PAGE], float("nan"), floats_only=True)
        self._fill_pages([GARBAGE_PAGE], 0.0, floats_only=False)

    def _warm_prefills(self) -> None:
        """Each bucket's paged prefill against the write-off page (warmup
        allocates nothing, so the pool and the tables stay a fresh
        engine's)."""
        table = torch.zeros((1, self.max_pages), dtype=torch.long,
                            device=self.device)
        for b in self.buckets:
            zeros = torch.zeros((1, b), dtype=torch.long, device=self.device)
            self.model(zeros, decode=True, positions=zeros, cache=self.cache,
                       page_table=table)


# -- sizing the pool (serve/run.py) -------------------------------------------

def page_bytes_estimate(cfg, page_size: int, tp: int = 1) -> int:
    """Bytes one page will take on one device, from the model config
    alone, so that ``--serve.num-pages`` can be sized before any cache
    exists: K and V rows in the cache dtype, plus the f32 per-(token,
    head) scales under int8, divided by the tensor-parallel width ``tp``
    (the pool's head axis is cut over it). JAX's estimate to the byte;
    equals the built engine's :meth:`PagedSlotEngine.page_bytes`."""
    nk = cfg.n_kv_heads or cfg.n_heads
    dh = cfg.d_model // cfg.n_heads
    if cfg.kv_cache_quant == "int8":
        per_tok = 2 * nk * dh + 2 * nk * 4   # int8 rows + f32 scales
    else:
        itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
        per_tok = 2 * nk * dh * itemsize
    return int(page_size) * int(cfg.n_layers) * int(per_tok) \
        // max(1, int(tp))


def auto_num_pages(*, num_slots: int, need_pages: int, page_bytes: int,
                   budget_bytes: int = 0, reserved_bytes: int = 0,
                   observed_peak: int = 0):
    """The ``--serve.num-pages`` default: ``(num_pages, rationale
    lines)``, as JAX sizes it:

    - the serving reservation ``S = num_slots * need_pages`` (every slot
      holding a worst-case trajectory of ``need_pages`` pages);
    - the prefix cache's headroom: ``observed_peak`` (a previous run's
      measured ``slot_pages_peak``, the distinct pages its live slots
      held, read by serve/run.py from the standing
      ``--observe.export-path`` snapshot) when there is one, else ``S``;
    - the pool: 1 write-off page + S + the headroom, never below ``2 +
      S`` (one copy-on-write page above the reservation);
    - an ``hbm_budget_gb`` cap bounds it at ``(budget - reserved) /
      page_bytes`` (``reserved``: the parameters' bytes on the card),
      never below that floor.
    """
    serving = int(num_slots) * int(need_pages)
    floor = 2 + serving
    headroom = int(observed_peak) if observed_peak else serving
    pool = 1 + serving + headroom
    lines = [
        f"serving reservation: {num_slots} slots x {need_pages} "
        f"pages = {serving} pages",
        ("prefix-cache headroom: observed slot_pages_peak "
         f"{observed_peak}" if observed_peak else
         f"prefix-cache headroom: {serving} pages (no observed "
         f"slot_pages_peak — worst case)"),
    ]
    if budget_bytes:
        avail = max(0, int(budget_bytes) - int(reserved_bytes))
        cap = avail // max(1, int(page_bytes))
        lines.append(
            f"hbm budget: ({budget_bytes} - {reserved_bytes} "
            f"reserved) / {page_bytes} B/page = {cap} pages")
        pool = min(pool, cap)
    pool = max(pool, floor)
    lines.append(f"num_pages = {pool} (floor {floor})")
    return pool, lines

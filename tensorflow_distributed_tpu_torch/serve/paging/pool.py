"""Page-pool allocator: host-side bookkeeping for the paged KV cache,
the port's own copy of ``serve/paging/pool.py``.

Pure stdlib + numpy. The pool owns nothing on the device: it hands out
PAGE IDS, and the engine's forwards read and write the ``[num_pages,
page_size, ...]`` cache tensors through per-slot page tables built from
those ids. Its allocations, refcounts and errors equal the JAX pool's
call for call (tests/test_torch_paging.py replays both).

Invariants:

- page 0 is the **write-off page**: permanently referenced, never
  allocated, never exposed to an unmasked attention column. Freed
  slots keep riding the static-shape decode step (their page tables
  reset to all-zeros), so their garbage writes land here — the paged
  equivalent of the dense engine's "freed slots write their own row
  harmlessly".
- every other page is either FREE (refcount 0, on the free list) or
  referenced (refcount = slots holding it + radix nodes + sessions).
- ``release`` of a page the caller does not hold (double free) and
  ``alloc`` beyond capacity raise loudly — allocator corruption must
  never become silent KV corruption.
- allocation order is deterministic (FIFO free list), so a seeded run
  allocates, evicts, and copies the same pages every time.
"""

from __future__ import annotations

import collections
from typing import Iterable, List

import numpy as np

#: The write-off page id (see module docstring).
GARBAGE_PAGE = 0


class PoolExhausted(RuntimeError):
    """alloc() asked for more pages than the pool has free — after
    LRU eviction of every reclaimable cached page (the engine evicts
    BEFORE allocating). The run is misconfigured: the pool cannot hold
    the concurrent working set (raise --serve.num-pages, or lower
    --serve.num-slots / the per-request budget)."""


class PagePool:
    """Refcounted fixed-size page allocator (host side only)."""

    def __init__(self, num_pages: int, page_size: int):
        if page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {page_size}")
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the write-off "
                f"page), got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.ref = np.zeros((num_pages,), np.int32)
        self.ref[GARBAGE_PAGE] = 1          # permanently reserved
        self._free: collections.deque = collections.deque(
            range(1, num_pages))
        self.peak_in_use = 0
        self.allocs = 0

    # -- accounting --------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Referenced pages, write-off page excluded."""
        return self.num_pages - 1 - len(self._free)

    @property
    def capacity(self) -> int:
        """Allocatable pages (write-off page excluded)."""
        return self.num_pages - 1

    # -- alloc / refcounts -------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Hand out ``n`` fresh pages (refcount 0 -> 1), FIFO order."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free of "
                f"{self.capacity} (pool too small for the concurrent "
                f"working set — raise --serve.num-pages)")
        out = [self._free.popleft() for _ in range(n)]
        for p in out:
            if self.ref[p] != 0:
                raise RuntimeError(
                    f"free-list page {p} has refcount {self.ref[p]} "
                    f"(allocator corruption)")
            self.ref[p] = 1
        self.allocs += n
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return out

    def retain(self, pids: Iterable[int]) -> None:
        """Add one reference per listed page (a second slot, a radix
        node, a session adopting it)."""
        for p in pids:
            p = int(p)
            if not 0 < p < self.num_pages:
                raise ValueError(f"retain of invalid page {p}")
            if self.ref[p] <= 0:
                raise RuntimeError(
                    f"retain of unreferenced page {p} (use alloc)")
            self.ref[p] += 1

    def release(self, pids: Iterable[int]) -> int:
        """Drop one reference per listed page; pages reaching 0 return
        to the free list. Returns how many were freed. Double frees
        raise (refcount below zero = allocator corruption)."""
        freed = 0
        for p in pids:
            p = int(p)
            if p == GARBAGE_PAGE:
                continue                    # tables pad with page 0
            if not 0 < p < self.num_pages or self.ref[p] <= 0:
                raise RuntimeError(
                    f"double free of page {p} (refcount "
                    f"{self.ref[p] if 0 <= p < self.num_pages else '?'}"
                    f")")
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self._free.append(p)
                freed += 1
        return freed

    def stats(self) -> dict:
        return {
            "num_pages": self.capacity,
            "page_size": self.page_size,
            "pages_in_use": self.pages_in_use,
            "pages_peak": self.peak_in_use,
            "pool_occupancy": round(
                self.pages_in_use / max(1, self.capacity), 4),
        }

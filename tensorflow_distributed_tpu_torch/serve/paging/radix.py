"""Radix prefix cache + multi-turn sessions over the page pool: the
port's own copy of ``serve/paging/radix.py`` (the same algorithm, so its
matches, returns and eviction order equal the JAX cache's).

A radix tree over token ids at PAGE granularity: each edge is one full
page's worth of token ids (a ``page_size``-tuple), each node holds the
page whose KV encodes exactly those tokens in that left context. A new
request walks its prompt block by block and attaches the longest
matched chain of pages — prefill then runs only on the uncached tail.
Page-granular matching keeps the correctness story trivial: a cached
page is reused only when EVERY token to its left matches, so the KV
bytes are exactly what recomputation would produce (attention at a
position reads only tokens at or before it).

**Sessions** extend matching past full pages: a finished request tagged
with a ``session`` id retains ALL its pages — the partial tail page
included — keyed by the conversation's token sequence. A follow-up
turn whose prompt extends the conversation re-attaches everything,
including mid-page, and the engine copy-on-writes the partial page if
anything else still references it.

**Eviction**: cached entries (radix leaves and sessions) hold pool
references like any slot. Under pool pressure the engine asks for LRU
eviction, preferring entries whose release actually frees pages (a
cached page also attached to a live slot frees nothing yet). All host
bookkeeping, deterministic (a monotone touch clock, FIFO ties).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from tensorflow_distributed_tpu_torch.serve.paging.pool import PagePool


class _Node:
    __slots__ = ("children", "page", "lru", "parent", "block")

    def __init__(self, page: Optional[int], parent, block):
        self.children: Dict[tuple, "_Node"] = {}
        self.page = page
        self.lru = 0
        self.parent = parent
        self.block = block


class _Session:
    __slots__ = ("tokens", "pages", "lru")

    def __init__(self, tokens: List[int], pages: List[int], lru: int):
        self.tokens = tokens
        self.pages = pages
        self.lru = lru


class RadixCache:
    """Host-side prefix cache; every page it holds carries one pool
    reference until evicted."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root = _Node(None, None, None)
        self._sessions: Dict[str, _Session] = {}
        self._clock = 0
        self._nodes = 0
        self.evictions = 0
        self.hits = 0
        self.hit_tokens = 0
        self.lookups = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- lookup ------------------------------------------------------------

    def lookup(self, session: str, prompt: Sequence[int], cap: int
               ) -> Tuple[List[int], int, str]:
        """Longest cached prefix of ``prompt``, at most ``cap`` tokens
        (the engine caps at ``len(prompt) - 1``: at least one tail
        token must run so the first-token logits exist). Returns
        ``(pages, matched, source)`` — the caller OWNS one reference
        per returned page (session pages transfer theirs; radix pages
        are retained here) and must release them.

        A matching session (its recorded conversation is a prefix of
        ``prompt``) wins over the radix walk — it is at least as long
        (the radix holds only its full blocks) and carries the partial
        tail page. The session entry is consumed by the match (its
        references transfer to the slot); the finishing turn re-stores
        it. A session whose conversation is NOT a prefix of the new
        prompt has diverged and is dropped."""
        self.lookups += 1
        ps = self.page_size
        prompt = [int(t) for t in prompt]
        cap = max(0, min(cap, len(prompt)))
        if session and session in self._sessions:
            ent = self._sessions[session]
            n = len(ent.tokens)
            if n and n <= len(prompt) and ent.tokens == prompt[:n]:
                m = min(n, cap)
                keep = -(-m // ps) if m else 0
                pages = ent.pages[:keep]
                # Transfer: the session's refs on the kept pages move
                # to the caller; refs on the surplus are dropped.
                self.pool.release(ent.pages[keep:])
                del self._sessions[session]
                if m:
                    self.hits += 1
                    self.hit_tokens += m
                    return pages, m, "session"
                self.pool.release(pages)
                return [], 0, ""
            # Diverged conversation: the cached turn is stale.
            self.pool.release(ent.pages)
            del self._sessions[session]
        pages: List[int] = []
        node = self._root
        # Walk every full block of the PROMPT; the cap clamps after —
        # a fully-cached prompt then matches cap = plen - 1 tokens
        # mid-page, and the engine copy-on-writes that shared partial
        # page before the one-token tail overwrites it.
        for i in range(len(prompt) // ps):
            child = node.children.get(tuple(prompt[i * ps:(i + 1) * ps]))
            if child is None:
                break
            child.lru = self._tick()
            pages.append(child.page)
            node = child
        if not pages:
            return [], 0, ""
        self.pool.retain(pages)
        m = min(len(pages) * ps, cap)
        keep = -(-m // ps)
        if keep < len(pages):                # cap landed mid-chain
            self.pool.release(pages[keep:])
            pages = pages[:keep]
        self.hits += 1
        self.hit_tokens += m
        return pages, m, "radix"

    # -- insert / retention ------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]
               ) -> int:
        """Adopt the full-block prefix of ``tokens`` into the tree:
        ``pages[i]`` encodes tokens ``[i*ps, (i+1)*ps)``. Blocks
        already cached keep their EXISTING page (the offered duplicate
        stays the caller's to release); new blocks retain the offered
        page. Returns how many pages were adopted."""
        ps = self.page_size
        tokens = [int(t) for t in tokens]
        node, adopted = self._root, 0
        for i in range(len(tokens) // ps):
            block = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(block)
            if child is None:
                if i >= len(pages):
                    break
                child = _Node(int(pages[i]), node, block)
                self.pool.retain([child.page])
                node.children[block] = child
                self._nodes += 1
                adopted += 1
            child.lru = self._tick()
            node = child
        return adopted

    def session_store(self, session: str, tokens: Sequence[int],
                      pages: Sequence[int]) -> None:
        """Retain a finished turn's full KV (partial tail page
        included) under its session id, replacing any stale entry."""
        if not session:
            return
        old = self._sessions.pop(session, None)
        if old is not None:
            self.pool.release(old.pages)
        pages = [int(p) for p in pages]
        self.pool.retain(pages)
        self._sessions[session] = _Session(
            [int(t) for t in tokens], pages, self._tick())

    # -- eviction ----------------------------------------------------------

    def _leaves(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            kids = list(node.children.values())
            if not kids and node is not self._root:
                out.append(node)
            stack.extend(kids)
        return out

    @property
    def reclaimable_pages(self) -> int:
        """Pages whose ONLY reference is this cache — what eviction
        could return to the pool right now (the engine's can_admit
        headroom)."""
        seen = set()
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if self.pool.ref[node.page] == 1:
                seen.add(node.page)
            stack.extend(node.children.values())
        for ent in self._sessions.values():
            for p in ent.pages:
                if self.pool.ref[p] == 1:
                    seen.add(p)
        return len(seen)

    @property
    def cached_pages(self) -> int:
        return self._nodes + sum(len(e.pages)
                                 for e in self._sessions.values())

    @property
    def sessions_live(self) -> int:
        return len(self._sessions)

    def evict_one(self) -> bool:
        """Evict the least-recently-used cached entry (one radix leaf
        or one whole session), preferring entries whose release frees
        at least one page. Returns False when nothing is evictable."""
        cands: List[Tuple[Tuple[int, int], str, object]] = []
        for node in self._leaves():
            frees = int(self.pool.ref[node.page] == 1)
            cands.append(((1 - frees, node.lru), "node", node))
        for sid, ent in self._sessions.items():
            frees = int(any(self.pool.ref[p] == 1 for p in ent.pages))
            cands.append(((1 - frees, ent.lru), "session", sid))
        if not cands:
            return False
        _, kind, obj = min(cands, key=lambda c: c[0])
        if kind == "node":
            node = obj
            self.pool.release([node.page])
            del node.parent.children[node.block]
            self._nodes -= 1
        else:
            ent = self._sessions.pop(obj)
            self.pool.release(ent.pages)
        self.evictions += 1
        return True

    def stats(self) -> dict:
        return {
            "prefix_hits": self.hits,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_lookups": self.lookups,
            "cached_pages": self.cached_pages,
            "sessions": self.sessions_live,
            "page_evictions": self.evictions,
        }

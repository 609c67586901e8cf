"""Block-granular KV page allocator and refcounted prefix cache — a copy of
``repro/serving/kv_pages.py`` (pure Python and numpy), kept in the port so
that it imports nothing of the JAX package.  Names, error texts and the
block hashing are the reference's, so one sequence of operations gives the
same page ids, refcounts, ``audit()`` and ``hit_rate()`` in both copies.

- :class:`PagePool` — a fixed pool of ``num_pages`` KV pages of
  ``page_size`` tokens each.  Page ids are ``1..num_pages``; id 0 is the
  *null page*, a trash row in the device pool tensors that dead batch rows
  write into and no one ever reads (``kv_valid`` masks it).  Pages are
  refcounted so the prefix cache can share them across requests; a
  *reservation* counter implements conservative admission: a request
  reserves its worst-case page need up front, which guarantees that
  on-demand allocation during decode can never fail (see
  :meth:`PagePool.alloc`).
- :class:`PrefixCache` — chain-hash of *full* prompt token blocks → page
  id.  A request whose prompt shares a cached prefix prefills only its
  suffix and increfs the shared pages.  Only whole pages are ever shared
  and decode always writes at positions >= the prompt length, so shared
  pages are immutable — copy-on-write semantics without ever copying.

Thread discipline: both classes are caller-synchronized (the engine holds
its lock around every call); they keep no locks of their own.
"""
from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np


class PoolExhausted(RuntimeError):
    """Allocation asked for more pages than are free (after eviction).

    Under conservative reservation accounting this is unreachable for
    reserved work — seeing it means a caller allocated without reserving.
    """


class PagePool:
    """Fixed free-list pool of refcounted KV pages (ids ``1..num_pages``)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1:
            raise ValueError(f"pool needs at least one page, got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list: freshly freed pages are reused first (their pool
        # rows are warm); pop() order on a fresh pool is 1, 2, 3, ...
        self._free: List[int] = list(range(self.num_pages, 0, -1))
        self._ref: Dict[int, int] = {}
        self._reserved = 0

    # -- accounting -----------------------------------------------------------
    def free_pages(self) -> int:
        return len(self._free)

    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def reserved_pages(self) -> int:
        return self._reserved

    def utilization(self) -> float:
        return self.used_pages() / self.num_pages

    # -- reservation (admission) ----------------------------------------------
    def reserve(self, n: int) -> bool:
        """Reserve worst-case capacity for one request at admission.

        Returns False (refuse: QUEUE_SATURATED) when granting ``n`` more
        pages could over-commit the pool.  Reservations ignore prefix
        sharing, so actual usage never exceeds the reserved total — which
        is the invariant that makes mid-decode :meth:`alloc` infallible.
        """
        if n < 0:
            raise ValueError(f"cannot reserve {n} pages")
        if self._reserved + n > self.num_pages:
            return False
        self._reserved += n
        return True

    def unreserve(self, n: int) -> None:
        if n > self._reserved:
            raise AssertionError(
                f"unreserve({n}) exceeds outstanding reservation "
                f"{self._reserved}")
        self._reserved -= n

    # -- allocation / refcounts -----------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages off the free list (each born with refcount 1)."""
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"({self.used_pages()}/{self.num_pages} used, "
                f"{self._reserved} reserved)")
        pages = [self._free.pop() for _ in range(n)]
        for pid in pages:
            self._ref[pid] = 1
        return pages

    def incref(self, pid: int) -> int:
        if pid not in self._ref:
            raise AssertionError(f"incref of unallocated page {pid}")
        self._ref[pid] += 1
        return self._ref[pid]

    def decref(self, pid: int) -> int:
        """Drop one reference; a page at zero returns to the free list."""
        if pid not in self._ref:
            raise AssertionError(f"double free of page {pid}")
        c = self._ref[pid] - 1
        if c == 0:
            del self._ref[pid]
            self._free.append(pid)
        else:
            self._ref[pid] = c
        return c

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    # -- audit ----------------------------------------------------------------
    def audit(self) -> Dict[str, int]:
        """Leak/consistency audit: free + used must cover the pool exactly,
        every allocated page must hold a positive refcount, and the free
        list must never contain duplicates or allocated ids."""
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise AssertionError("free list contains duplicate pages")
        if free_set & set(self._ref):
            raise AssertionError("page simultaneously free and allocated")
        if len(self._free) + len(self._ref) != self.num_pages:
            raise AssertionError(
                f"page leak: {len(self._free)} free + {len(self._ref)} "
                f"allocated != {self.num_pages} pool pages")
        if any(c < 1 for c in self._ref.values()):
            raise AssertionError("allocated page with non-positive refcount")
        return {"pool_pages": self.num_pages, "used": self.used_pages(),
                "free": self.free_pages(), "reserved": self._reserved}


def _block_keys(prompt: np.ndarray, page_size: int, n_blocks: int
                ) -> List[bytes]:
    """Chain digests of the first ``n_blocks`` full token blocks.

    Each key commits to the whole prefix up to its block (``h_i =
    H(h_{i-1} || tokens_i)``), so equal keys imply token-identical
    prefixes — divergent suffixes can never alias a shared page.
    """
    keys: List[bytes] = []
    h = b"kv-prefix-v1"
    tokens = np.ascontiguousarray(np.asarray(prompt, np.int32))
    for i in range(n_blocks):
        block = tokens[i * page_size:(i + 1) * page_size]
        h = hashlib.blake2b(h + block.tobytes(), digest_size=16).digest()
        keys.append(h)
    return keys


class PrefixCache:
    """LRU map of prompt-prefix block hashes → shared, refcounted pages.

    The cache holds one reference on every registered page; live requests
    that hit hold their own.  Evicting an entry drops only the cache's
    reference, so pages shared with in-flight requests survive until those
    requests finish.  Evicting a mid-chain entry leaves later blocks of
    the same prefix unreachable for future lookups (the chain walk stops
    at the first miss); they age out of the LRU in turn.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._entries: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self.hits = 0            # lookups that matched >= 1 block
        self.misses = 0
        self.hit_tokens = 0      # prompt tokens served from shared pages
        self.lookup_tokens = 0   # prompt tokens presented to lookup

    def __len__(self) -> int:
        return len(self._entries)

    def hit_rate(self) -> float:
        """Fraction of presented prompt tokens served from shared pages."""
        if self.lookup_tokens == 0:
            return 0.0
        return self.hit_tokens / self.lookup_tokens

    # -- lookup / insert ------------------------------------------------------
    def lookup(self, prompt: np.ndarray, page_size: int
               ) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``prompt`` in whole blocks.

        Returns ``(n_blocks, page_ids)`` with one reference taken on each
        returned page for the caller (released via ``PagePool.decref`` at
        request finish).  At least one suffix token is always left
        un-cached so the suffix prefill has a token to predict from.
        """
        limit = max(len(prompt) - 1, 0) // page_size
        self.lookup_tokens += len(prompt)
        pages: List[int] = []
        for key in _block_keys(prompt, page_size, limit):
            pid = self._entries.get(key)
            if pid is None:
                break
            self._entries.move_to_end(key)
            pages.append(pid)
        for pid in pages:
            self.pool.incref(pid)
        if pages:
            self.hits += 1
            self.hit_tokens += len(pages) * page_size
        else:
            self.misses += 1
        return len(pages), pages

    def probe(self, prompt: np.ndarray, page_size: int) -> int:
        """Tokens a lookup would serve from cache — no refs, no LRU touch
        (admission pricing must not mutate cache state)."""
        limit = max(len(prompt) - 1, 0) // page_size
        n = 0
        for key in _block_keys(prompt, page_size, limit):
            if key not in self._entries:
                break
            n += 1
        return n * page_size

    def insert(self, prompt: np.ndarray, pages: List[int], page_size: int
               ) -> int:
        """Register every full block of a just-prefilled prompt.

        ``pages`` is the request's page list in block order (shared prefix
        + freshly written pages).  Each newly registered page gains the
        cache's reference.  Partial trailing pages are never registered —
        that is what keeps every shared page immutable.  Returns the
        number of blocks newly registered.
        """
        n_full = len(prompt) // page_size
        added = 0
        for i, key in enumerate(_block_keys(prompt, page_size, n_full)):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            pid = pages[i]
            self.pool.incref(pid)
            self._entries[key] = pid
            added += 1
        return added

    # -- eviction -------------------------------------------------------------
    def evict_one(self) -> bool:
        """Drop the least-recently-used entry (cache reference only).

        Returns False when the cache is empty.  The freed page only
        returns to the pool if no live request still shares it.
        """
        if not self._entries:
            return False
        _, pid = self._entries.popitem(last=False)
        self.pool.decref(pid)
        return True

    def flush(self) -> None:
        while self.evict_one():
            pass

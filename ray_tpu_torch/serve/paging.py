"""Host-side page allocator and paged prefix index for the decode engine
(copy of ``ray_tpu/serve/paging.py``; host-side numpy, no device code).

The paging half of the engine's memory story (``serve/decode.py`` owns
the device tensors; ``models/llama_decode.py`` owns the paged attention
math). Two pieces:

* ``PageAllocator``: a refcounted free-list over device pool page ids.
  A page is handed out with refcount 1; sharing (prefix splices, prefix-
  index pins) increfs it; ``free`` decrefs and recycles at zero. Pages
  with refcount > 1 are never written by construction: sharing is
  full-page-aligned and sequence writes are append-only past the shared
  region, which is the copy-on-write discipline without ever needing
  the copy.
* ``PagedPrefixIndex``: a vLLM-style hash-chained prefix cache, one
  entry per page-aligned prefix length, keyed by the hash of ALL tokens
  up to that page's end, each pinning exactly ONE pool page. Inserting a
  completed prompt is zero-copy: the slot's own pages are increfed and
  recorded, with no device traffic at all. A hit splices page ids into
  the new request's block table; eviction unpins page-granular TAIL
  segments (leaf entries first), so a long cached prefix shrinks
  gracefully instead of vanishing whole.

Single-threaded by design: every caller runs on the engine's decode
loop thread (admission, finish, eviction, reclaim). Cross-thread readers
(stats) only see int counters.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.serve.prefix_cache import prefix_hash

SCRATCH_PAGE = 0  # reserved pool page for pad writes; never allocated


class PageAllocator:
    """Refcounted free-list over pool page ids ``1..pages`` (id 0 is the
    scratch page the paged model functions use for pad writes)."""

    def __init__(self, pages: int):
        if pages < 1:
            raise ValueError(f"need at least one pool page, got {pages}")
        self.pages = int(pages)
        # LIFO free list: recently-freed pages are re-used first (their
        # junk contents are provably dead: the device work that freed
        # them was enqueued before any work that re-reads them, and one
        # stream runs it in order).
        self._free_ids: List[int] = list(range(self.pages, 0, -1))
        self._ref: Dict[int, int] = {}

    # ------------------------------------------------------------ alloc

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages with refcount 1 each, or None (all-or-nothing —
        a partial grant would leave the caller holding pages it cannot
        use but must remember to free)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if len(self._free_ids) < n:
            return None
        out = [self._free_ids.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def incref(self, page: int) -> None:
        self._ref[page] += 1  # KeyError on a free page = caller bug

    def free(self, pages: Iterable[int]) -> None:
        """Drop one reference per page; refcount 0 recycles the page."""
        for p in pages:
            r = self._ref[p] - 1
            if r == 0:
                del self._ref[p]
                self._free_ids.append(p)
            else:
                self._ref[p] = r

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    # ------------------------------------------------------------ stats

    @property
    def free_count(self) -> int:
        return len(self._free_ids)

    @property
    def in_use(self) -> int:
        return self.pages - len(self._free_ids)

    def stats(self) -> Dict[str, int]:
        return {"pages_total": self.pages,
                "pages_free": len(self._free_ids),
                "pages_in_use": self.in_use}


class _PageEntry:
    __slots__ = ("key", "page", "tokens", "length", "parent", "children",
                 "last_used")

    def __init__(self, key: str, page: int, tokens: np.ndarray,
                 length: int, parent: Optional[str]):
        self.key = key          # prefix_hash(tokens[:length])
        self.page = page        # the ONE pool page this entry pins
        self.tokens = tokens    # full prefix tokens, (length,)
        self.length = length    # page-aligned prefix length
        self.parent = parent    # key of the (length - T) entry, if any
        self.children = 0       # longer entries chaining through this one
        self.last_used = 0


class PagedPrefixIndex:
    """Hash-chained page-granular prefix cache over a ``PageAllocator``.

    One entry per page-aligned prefix length: the entry for length
    ``i*T`` is keyed by ``prefix_hash(tokens[:i*T])`` and pins the page
    holding positions ``(i-1)*T .. i*T-1``. ``match`` walks the chain
    page by page and hands back the page ids ALREADY INCREFED for the
    caller's block table (the caller owns one reference per page and
    releases by freeing them with its slot: there is no separate release
    step, unlike the contiguous cache's entry pins). ``insert`` pins a
    completed slot's own pages (zero-copy). Eviction drops LEAF entries (no longer
    chain through them) in LRU order, freeing tail pages first."""

    def __init__(self, allocator: PageAllocator, page_tokens: int,
                 max_pages: int, min_tokens: int = 16):
        self._alloc = allocator
        self.page_tokens = int(page_tokens)
        self.max_pages = max(1, int(max_pages))
        self.min_tokens = max(1, int(min_tokens))
        self._by_key: Dict[str, _PageEntry] = {}
        self._clock = 0
        self.queries = 0
        self.hits = 0
        self.tokens_matched = 0
        self.inserts = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._by_key)

    @property
    def pinned_pages(self) -> int:
        return len(self._by_key)

    def pinned_page_ids(self) -> List[int]:
        """Snapshot of the pool pages this index pins (stats use)."""
        return [ent.page for ent in list(self._by_key.values())]

    # ----------------------------------------------------------- match

    def match(self, tokens) -> Optional[Tuple[List[int], int]]:
        """Longest page-aligned cached prefix: ``(page_ids,
        matched_len)`` with every page already increfed for the caller,
        or None. Capped at ``len(tokens) - 1`` so at least one real
        suffix token remains to produce next-token logits."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        self.queries += 1
        T = self.page_tokens
        limit = (len(toks) - 1) // T
        pages: List[int] = []
        self._clock += 1
        depth = 0
        while depth < limit:
            end = (depth + 1) * T
            ent = self._by_key.get(prefix_hash(toks[:end]))
            if ent is None or not np.array_equal(ent.tokens[:end],
                                                 toks[:end]):
                break  # hash miss (or collision: verify the raw tokens)
            ent.last_used = self._clock
            pages.append(ent.page)
            depth += 1
        matched = depth * T
        if matched < self.min_tokens or not pages:
            return None
        for p in pages:
            self._alloc.incref(p)
        self.hits += 1
        self.tokens_matched += matched
        return pages, matched

    # ---------------------------------------------------------- insert

    def insert(self, tokens, slot_pages: List[int],
               matched_len: int = 0) -> int:
        """Offer a completed prompt's resident pages to the index.
        ``slot_pages[i]`` must back positions ``i*T .. (i+1)*T - 1`` of
        ``tokens``. Pins (increfs) the pages of every NEW entry — zero
        device copies. Returns the number of entries created.

        The insert length is the largest power of two <= the prompt
        length (>= max(min_tokens, T)): the same grid the router's
        affinity hashes probe, kept so hot prefixes dedup across
        replicas. ``matched_len`` gating as in the contiguous prefix
        cache: skip unless coverage at least doubles (per-request random
        suffixes must not thrash the index)."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        T = self.page_tokens
        ins_len = 1
        while ins_len * 2 <= len(toks):
            ins_len *= 2
        if ins_len < max(self.min_tokens, T) or matched_len * 2 >= ins_len:
            return 0
        created = 0
        parent: Optional[str] = None
        self._clock += 1
        for i in range(ins_len // T):
            end = (i + 1) * T
            key = prefix_hash(toks[:end])
            ent = self._by_key.get(key)
            if ent is not None:
                ent.last_used = self._clock  # dedup: refresh recency
                parent = key
                continue
            page = slot_pages[i]
            ent = _PageEntry(key, page, np.array(toks[:end], np.int32),
                             end, parent)
            self._alloc.incref(page)
            if parent is not None:
                self._by_key[parent].children += 1
            ent.last_used = self._clock
            self._by_key[key] = ent
            created += 1
            parent = key
        if created:
            self.inserts += 1
            over = self.pinned_pages - self.max_pages
            if over > 0:
                self.reclaim(over, only_free=False)
        return created

    # --------------------------------------------------------- eviction

    def reclaim(self, n_pages: int, only_free: bool = True) -> int:
        """Unpin up to ``n_pages`` pages, LRU leaf entries first (tail
        segments of a chain shrink before its head — a shortened prefix
        is still a valid, shorter prefix). ``only_free`` restricts to
        pages this index holds the LAST reference to (the allocation-
        pressure path: unpinning a page a live slot still borrows frees
        nothing). Returns pages actually unpinned."""
        done = 0
        while done < n_pages:
            victim: Optional[_PageEntry] = None
            for ent in self._by_key.values():
                if ent.children:
                    continue
                if only_free and self._alloc.refcount(ent.page) != 1:
                    continue
                if victim is None or ent.last_used < victim.last_used:
                    victim = ent
            if victim is None:
                break
            self._evict(victim)
            done += 1
        return done

    def _evict(self, ent: _PageEntry) -> None:
        del self._by_key[ent.key]
        if ent.parent is not None:
            parent = self._by_key.get(ent.parent)
            if parent is not None:
                parent.children -= 1
        self._alloc.free((ent.page,))
        self.evictions += 1

    # ------------------------------------------------------------ stats

    def hashes(self) -> List[str]:
        """Entry hashes at power-of-two lengths — the router's affinity
        grid (``candidate_hashes`` probes pow2 leading buckets, so only
        those chain links are discoverable from a raw prompt). Called
        from the replica stats thread while the decode thread mutates
        the dict: list() snapshots atomically under the GIL."""
        return [ent.key for ent in list(self._by_key.values())
                if ent.length & (ent.length - 1) == 0]

    def stats(self) -> Dict[str, float]:
        return {
            "entries": len(self._by_key),
            "pinned_pages": self.pinned_pages,
            "queries": self.queries,
            "hits": self.hits,
            "hit_rate": round(self.hits / self.queries, 4)
            if self.queries else 0.0,
            "prefill_tokens_saved": self.tokens_matched,
            "inserts": self.inserts,
            "evictions": self.evictions,
        }

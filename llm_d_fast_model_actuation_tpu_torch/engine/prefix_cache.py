"""Automatic prefix caching: page-aligned KV reuse across requests.

(The port's own copy of the JAX package's host-only
``engine/prefix_cache.py``; the port imports nothing of that package.)

The reference's engine ships this as vLLM's "automatic prefix caching":
requests sharing a prompt prefix (few-shot headers, system prompts, chat
history) skip prefill compute and KV writes for the shared part. Here it
is page-native: the unit of sharing is one full KV page (`page_size`
tokens), identified by the HASH CHAIN of its token content —
``h_i = H(h_{i-1}, tokens_of_page_i)`` — so a page is only ever matched
under the exact same prefix that produced it.

Ownership model (host-side, like the allocator it extends):
  * an index entry holds ONE reference to its page; every sequence whose
    page table includes the page holds one more;
  * retiring a sequence drops its references — pages that remain only
    cache-referenced stay resident (warm) and join the LRU;
  * allocation pressure evicts LRU **leaf** entries (no cached children)
    and returns their pages to the allocator; parents become leaves as
    children go, so chains unwind from the tail and an entry reachable
    from the index can never lose an ancestor before its descendants.

Safety: a shared page is never written again — suffix prefill scatters
only positions past the cached prefix, and generated tokens land in later
pages (only FULL prompt pages are registered; a page that would also
receive generated tokens is never cached).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def _chunk_hash(parent: str, tokens: Sequence[int]) -> str:
    h = hashlib.sha256()
    h.update(parent.encode())
    h.update(b":")
    h.update(",".join(str(t) for t in tokens).encode())
    return h.hexdigest()


@dataclass
class _Entry:
    chain_hash: str
    page_id: int
    parent_hash: str  #: "" for the first page of a prompt
    children: int = 0
    last_used: int = 0


@dataclass
class PrefixCache:
    page_size: int
    #: page_id -> total reference count (index + live sequences)
    _refs: Dict[int, int] = field(default_factory=dict)
    _by_hash: Dict[str, _Entry] = field(default_factory=dict)
    _clock: int = 0
    #: monotonic mutation counter: bumps on register/evict (contents
    #: changed), so blocked-admission memos can't be fooled by refcount
    #: churn that returns sizes to their prior values
    version: int = 0
    #: tokens served from cache instead of prefill (observability)
    hit_tokens: int = 0
    lookups: int = 0
    hits: int = 0

    # -- matching ------------------------------------------------------------

    def match(
        self, prompt: Sequence[int]
    ) -> Tuple[List[int], int, List[str]]:
        """Longest cached page chain for `prompt`. PURE: no stats, no LRU
        bumps — a matched request can still fail admission (OutOfPages)
        and retry every engine step; only `commit` (called once admission
        succeeded) records the hit.

        Returns (shared_page_ids, cached_token_count, chain_hashes); the
        hashes feed `commit`/`register` so the chain is hashed once, not
        three times. Never matches the whole prompt — at least one token
        must remain to prefill (the query that produces the first sampled
        logits).
        """
        ps = self.page_size
        full_pages = (len(prompt) - 1) // ps  # leave >= 1 token to prefill
        pages: List[int] = []
        hashes: List[str] = []
        parent = ""
        for i in range(full_pages):
            h = _chunk_hash(parent, prompt[i * ps : (i + 1) * ps])
            e = self._by_hash.get(h)
            if e is None:
                break
            pages.append(e.page_id)
            hashes.append(h)
            parent = h
        return pages, len(pages) * ps, hashes

    def commit(self, hashes: Sequence[str]) -> None:
        """Record an admitted hit: stats + LRU recency for the matched
        chain entries (`hashes` from the `match` that admitted)."""
        self.lookups += 1
        if not hashes:
            return
        self.hits += 1
        self.hit_tokens += len(hashes) * self.page_size
        self._clock += 1
        for h in hashes:
            e = self._by_hash.get(h)
            if e is None:
                break
            e.last_used = self._clock

    def acquire(self, page_ids: Sequence[int]) -> None:
        """A sequence starts referencing shared pages."""
        for p in page_ids:
            self._refs[p] = self._refs.get(p, 0) + 1

    # -- registration --------------------------------------------------------

    def register(
        self,
        prompt: Sequence[int],
        page_ids: Sequence[int],
        shared_count: int,
        known_hashes: Sequence[str] = (),
    ) -> None:
        """Insert this sequence's FULL prompt pages into the index.

        `page_ids` is the sequence's page-table order (shared prefix pages
        first); the first `shared_count` pages are already cached (their
        chain hashes may be passed via `known_hashes` to skip re-hashing).
        Pages receiving generated tokens later (anything past the last
        full prompt page) are never registered.
        """
        ps = self.page_size
        full_pages = len(prompt) // ps
        parent = ""
        self._clock += 1
        inserted = False
        for i in range(full_pages):
            if i < len(known_hashes):
                h = known_hashes[i]
            else:
                h = _chunk_hash(parent, prompt[i * ps : (i + 1) * ps])
            e = self._by_hash.get(h)
            if e is None:
                if i < shared_count:
                    # ancestor chain was evicted between match and register
                    # (can't happen single-threaded, but stay defensive):
                    # stop rather than re-register a shared page
                    break
                e = _Entry(
                    chain_hash=h,
                    page_id=page_ids[i],
                    parent_hash=parent,
                    last_used=self._clock,
                )
                self._by_hash[h] = e
                self._refs[page_ids[i]] = self._refs.get(page_ids[i], 0) + 1
                if parent:
                    self._by_hash[parent].children += 1
                inserted = True
            else:
                e.last_used = self._clock
            parent = h
        if inserted:
            self.version += 1

    # -- release / eviction --------------------------------------------------

    def release(self, page_ids: Sequence[int]) -> List[int]:
        """A sequence stops referencing pages. Returns the page ids whose
        refcount reached zero — the caller frees those in its allocator
        (pages still index-referenced stay resident)."""
        freed: List[int] = []
        for p in page_ids:
            n = self._refs.get(p)
            if n is None:
                freed.append(p)  # never cache-tracked: plain page
                continue
            if n <= 1:
                del self._refs[p]
                freed.append(p)
            else:
                self._refs[p] = n - 1
        return freed

    def evict(self, want_pages: int) -> List[int]:
        """Drop up to `want_pages` LRU leaf entries whose pages are only
        cache-referenced; returns the page ids now free for reuse.

        One scan builds the initial leaf heap; parents that become leaves
        as their children go are pushed lazily, so an m-page eviction over
        an n-entry index is O(n + m log n), not O(n*m)."""
        import heapq

        freed: List[int] = []
        heap = [
            (e.last_used, e.chain_hash)
            for e in self._by_hash.values()
            if e.children == 0 and self._refs.get(e.page_id, 0) == 1
        ]
        heapq.heapify(heap)
        while heap and len(freed) < want_pages:
            _, h = heapq.heappop(heap)
            e = self._by_hash.get(h)
            # stale heap entries: re-check eligibility at pop time
            if (
                e is None
                or e.children != 0
                or self._refs.get(e.page_id, 0) != 1
            ):
                continue
            del self._by_hash[h]
            del self._refs[e.page_id]
            freed.append(e.page_id)
            if e.parent_hash:
                parent = self._by_hash.get(e.parent_hash)
                if parent is not None:
                    parent.children -= 1
                    if (
                        parent.children == 0
                        and self._refs.get(parent.page_id, 0) == 1
                    ):
                        heapq.heappush(
                            heap, (parent.last_used, parent.chain_hash)
                        )
        if freed:
            self.version += 1
        return freed

    def clear(self) -> List[int]:
        """Drop the whole index (KV content is gone — e.g. a level-2 sleep
        zeroed the pool): returns every page the index alone was keeping
        resident, for the caller's allocator. Call with no live sequences."""
        freed: List[int] = []
        for e in self._by_hash.values():
            n = self._refs.get(e.page_id, 0)
            if n <= 1:
                self._refs.pop(e.page_id, None)
                freed.append(e.page_id)
            else:  # a live holder remains (defensive; callers retire first)
                self._refs[e.page_id] = n - 1
        self._by_hash.clear()
        self.version += 1
        return freed

    # -- introspection -------------------------------------------------------

    def resident_pages(self) -> int:
        return len(self._by_hash)

    def stats(self) -> Dict[str, int]:
        return {
            "resident_pages": self.resident_pages(),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
        }

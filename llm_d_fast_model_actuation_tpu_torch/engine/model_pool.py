"""Tiered host-side model pool: LRU registry of slept models over a
content-addressed chunk store.

Port of ``llm_d_fast_model_actuation_tpu/engine/model_pool.py``
(``HostModelPool``; the co-resident ``ResidentSetLedger`` waits for the
co-resident variants). The hot-swap path (``POST /v1/swap``) lets N models
time-share one card: the model swapped out goes to sleep (level 1, its
state in pinned host memory) and is *pooled* here, keyed by model id and
bounded by a host byte budget. A later swap back is a host -> card
restore: no checkpoint read, no re-capture.

Two tiers, content-addressed:

  * **Host memory** — a pooled entry's weight leaves that carry content
    digests are *interned* into a :class:`~.chunk_store.ChunkStore`: two
    fine-tunes of one base hold their common tensors once (refcounted),
    and ``bytes_used`` is the real deduped residency, a running counter.
  * **Local disk** — an evicted entry leaves a *manifest* (flat key ->
    digest) while its last-reference chunks spill to disk. A later swap
    to the evicted model rebuilds its weights from the tiers
    (:meth:`take_staged`); any unresolvable chunk makes the whole rebuild
    a miss.

Under ``--sleep-quant`` a pooled model holds int8 or fp8 payloads
(``models/quant.py``): the server interns them under their transfer
digests, a digest space of their own, so a quantized sibling dedupes
against another quantized sibling and never against the full-precision
tensor it approximates, and ``bytes_used`` counts payload bytes.

The pool stores opaque runtime entries (the server's model-runtime
bundle, or a prefetch's :class:`PrefetchedWeights`); the caller frees an
evicted entry (the server destroys its engine). LRU order is by swap-out recency. An internal mutex makes every
operation safe to call from any thread.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from .chunk_store import ChunkStore, aligned_digests, flatten_state, map_leaves, unflatten_tree

#: ceiling on remembered manifests of evicted entries
MAX_MANIFESTS = 64


@dataclass
class PrefetchedWeights:
    """A pool entry staged by a prefetch (``POST /v1/prefetch``), the
    reference's ``_PrefetchedWeights``: a model's weights as a host tree in
    the port's layout and dtype (pinned on the card's host), with their
    digests and ``nbytes``, and no engine, no device state and no graphs.
    A swap to it reads no checkpoint: it builds the engine from the tree.
    Its digested leaves are interned like a slept runtime's, so a
    prefetched sibling of a pooled model holds only the leaves that
    differ; evicting it drops references."""

    model_id: str
    params_host: Optional[Dict[str, Any]]
    nbytes: int
    #: flat weight key -> content digest (None for a quantized staging:
    #: its payloads intern under transfer digests instead)
    digests: Optional[Dict[str, str]] = None
    #: staged under ``--sleep-quant``: per leaf of ``params_host`` (in
    #: ``flatten_state`` order), a ``models/quant.py:TransferQuant`` for a
    #: payload or None; None when the staging is full precision
    quant_metas: Optional[List[Any]] = None
    #: the staged representation: "off" (full precision), "int8" or "fp8"
    quant_mode: str = "off"


@dataclass
class PoolEntry:
    model_id: str
    runtime: Any  #: opaque bundle (engine + sleeper + tokenizer + ...)
    nbytes: int  #: nominal host bytes the slept state occupies (pre-dedup)
    stored_at: float = field(default_factory=time.monotonic)
    #: digests whose chunk-store references this entry holds (interned)
    chunk_digests: List[str] = field(default_factory=list)
    #: flat weight key -> digest: the manifest an eviction leaves behind
    weight_digests: Optional[Dict[str, str]] = None
    #: bytes this entry adds OUTSIDE the chunk store (the KV pool, and
    #: everything when not interned)
    resident_bytes: int = 0


class HostModelPool:
    """Tiered LRU registry of slept models under a host byte budget.

    ``budget_bytes <= 0`` disables pooling: every :meth:`put` returns its
    own entry as evicted, so the caller frees it and the next swap-in is a
    cold build. ``chunks`` (a ChunkStore) enables the content-addressed
    tiers; without it the pool is a flat LRU."""

    def __init__(self, budget_bytes: int = 0, chunks: Optional[ChunkStore] = None) -> None:
        self.budget_bytes = int(budget_bytes)
        self.chunks = chunks
        self._mu = threading.Lock()
        self._entries: "OrderedDict[str, PoolEntry]" = OrderedDict()
        #: manifests of evicted entries: key -> (weight_digests, nbytes)
        self._manifests: "OrderedDict[str, Tuple[Dict[str, str], int]]" = OrderedDict()
        #: running non-interned residency
        self._resident_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.staged_hits = 0
        self.staged_misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._entries

    @property
    def bytes_used(self) -> int:
        """Actual (deduped) host residency: running counters only."""
        base = self._resident_bytes
        if self.chunks is not None:
            base += self.chunks.host_bytes
        return base

    def models(self) -> List[str]:
        """Pooled model ids, LRU first."""
        with self._mu:
            return list(self._entries)

    def entries(self) -> List[PoolEntry]:
        """The pooled entries, LRU first."""
        with self._mu:
            return list(self._entries.values())

    # -- interning ------------------------------------------------------------

    def intern_tree(
        self, tree: Any, digests: Optional[Dict[str, str]], prefix: str = "params"
    ) -> Tuple[Any, List[str], int]:
        """Replace digested host tensors of ``tree`` with canonical
        chunk-store tensors (dedup across pooled variants). Returns
        ``(interned_tree, held_digests, interned_nominal_bytes)``, the
        latter two for :meth:`put`. A disabled store (or no digests)
        returns the tree untouched."""
        if self.chunks is None or not digests or self.budget_bytes <= 0:
            return tree, [], 0
        leaves = flatten_state(tree)
        held: List[str] = []
        nominal = 0
        out = list(leaves)
        for i, (leaf, d) in enumerate(zip(leaves, aligned_digests(tree, digests, prefix=prefix))):
            if d is None or not isinstance(leaf, torch.Tensor) or leaf.device.type != "cpu":
                continue
            out[i], _added = self.chunks.intern(d, leaf)
            held.append(d)
            nominal += leaf.numel() * leaf.element_size()
        return map_leaves(tree, out), held, nominal

    def _release_refs(self, entry: PoolEntry, spill: bool) -> None:
        if self.chunks is None:
            return
        for d in entry.chunk_digests:
            self.chunks.release(d, spill=spill)
        entry.chunk_digests = []

    def _record_manifest(self, entry: PoolEntry) -> None:
        if self.chunks is None or not entry.weight_digests or self.budget_bytes <= 0:
            return
        self.remember_manifest(entry.model_id, entry.weight_digests, entry.nbytes, locked=True)

    def remember_manifest(self, key: str, digests: Dict[str, str], nbytes: int, locked: bool = False) -> None:
        """Record (or put back) the manifest of a model whose weights the
        tiers may still serve, most recent last."""
        if not locked:
            with self._mu:
                return self.remember_manifest(key, digests, nbytes, locked=True)
        self._manifests.pop(key, None)
        self._manifests[key] = (dict(digests), int(nbytes))
        while len(self._manifests) > MAX_MANIFESTS:
            self._manifests.popitem(last=False)

    # -- take / put -----------------------------------------------------------

    def peek(self, model_id: str) -> Optional[PoolEntry]:
        """Non-consuming :meth:`take`: LRU order and counters untouched."""
        with self._mu:
            return self._entries.get(model_id)

    def peek_match(self, model_id: str) -> Optional[PoolEntry]:
        """Non-consuming :meth:`take_match` (the same key rule, most
        recently parked first): the cost oracle prices through it."""
        with self._mu:
            for key in reversed(self._entries):
                if key == model_id or key.startswith(model_id + "@"):
                    return self._entries[key]
        return None

    def staged_keys(self) -> List[str]:
        """Keys of the evicted models' manifests, oldest first."""
        with self._mu:
            return list(self._manifests)

    def peek_staged_match(self, model_id: str) -> Optional[Tuple[str, int, str]]:
        """Non-consuming :meth:`take_staged_match`: ``(key, nbytes,
        tier)`` of the most recently evicted manifest under this name
        whose every chunk a tier still holds (``"host"``, or ``"disk"``
        when any needs a reload), else None. Reads no file, rebuilds
        nothing."""
        if self.chunks is None:
            return None
        with self._mu:
            found = [(k, m) for k, m in reversed(self._manifests.items())
                     if k == model_id or k.startswith(model_id + "@")]
        for key, (digests, nbytes) in found:
            tiers = [self.chunks.peek_tier(d) for d in digests.values()]
            if all(t is not None for t in tiers):
                return key, int(nbytes), "disk" if "disk" in tiers else "host"
        return None

    def take(self, model_id: str) -> Optional[PoolEntry]:
        """Remove and return the entry for ``model_id`` (a pool hit: the
        caller wakes it, so it leaves the pool), or None (a miss)."""
        with self._mu:
            entry = self._entries.pop(model_id, None)
            if entry is None:
                self.misses += 1
                return None
            self.hits += 1
            self._resident_bytes -= entry.resident_bytes
        # no spill: the model is about to go live
        self._release_refs(entry, spill=False)
        return entry

    def contains_match(self, model_id: str) -> bool:
        """Whether anything is pooled under this model name, with or
        without a checkpoint qualifier (a prefetch skips a model already
        pooled); counts no hit or miss."""
        with self._mu:
            return any(key == model_id or key.startswith(model_id + "@") for key in self._entries)

    def take_match(self, model_id: str) -> Optional[PoolEntry]:
        """Remove and return the most recently parked entry pooled under
        this model name, with or without a checkpoint qualifier (keys are
        ``name`` or ``name@checkpoint``)."""
        with self._mu:
            found = None
            for key in reversed(self._entries):
                if key == model_id or key.startswith(model_id + "@"):
                    found = key
                    break
            if found is None:
                self.misses += 1
                return None
            self.hits += 1
            entry = self._entries.pop(found)
            self._resident_bytes -= entry.resident_bytes
        self._release_refs(entry, spill=False)
        return entry

    def put(
        self,
        model_id: str,
        runtime: Any,
        nbytes: int,
        chunk_digests: Optional[List[str]] = None,
        weight_digests: Optional[Dict[str, str]] = None,
        interned_bytes: int = 0,
    ) -> List[PoolEntry]:
        """Register a just-slept model as most recently used and evict LRU
        entries until the byte budget holds. Returns the evicted entries
        (the new one too, when it alone exceeds the budget or pooling is
        off); the caller frees them."""
        entry = PoolEntry(
            model_id=model_id,
            runtime=runtime,
            nbytes=int(nbytes),
            chunk_digests=list(chunk_digests or []),
            weight_digests=weight_digests,
            resident_bytes=max(0, int(nbytes) - int(interned_bytes)),
        )
        evicted: List[PoolEntry] = []
        bounced: Optional[List[PoolEntry]] = None
        spills: List[Tuple[str, Any]] = []
        with self._mu:
            old = self._entries.pop(model_id, None)
            if old is not None:
                self._resident_bytes -= old.resident_bytes
                self._release_refs(old, spill=False)
                evicted.append(old)
            if entry.nbytes > self.budget_bytes:
                # the newcomer alone can never fit: evict IT, not the
                # resident models that still can be hit
                self.evictions += 1 + len(evicted)
                bounced = evicted + [entry]
            else:
                self._entries[model_id] = entry
                self._resident_bytes += entry.resident_bytes
                while self.bytes_used > self.budget_bytes:
                    _, victim = self._entries.popitem(last=False)
                    self._resident_bytes -= victim.resident_bytes
                    # refs drop under the lock; the spill's disk writes
                    # wait until it is released
                    if self.chunks is not None:
                        for d in victim.chunk_digests:
                            freed = self.chunks.release_deferred(d)
                            if freed is not None:
                                spills.append(freed)
                        victim.chunk_digests = []
                    self._record_manifest(victim)
                    evicted.append(victim)
                    self.evictions += 1
        if bounced is None:
            for d, data in spills:
                self.chunks.spill(d, data)
            return evicted
        for e in bounced:
            self._release_refs(e, spill=True)
            with self._mu:
                self._record_manifest(e)
        return bounced

    def drain(self) -> List[PoolEntry]:
        """Remove and return every entry (counted as evictions); their
        chunks spill to the disk tier and stay rebuildable through their
        manifests."""
        with self._mu:
            out = list(self._entries.values())
            self._entries.clear()
            self._resident_bytes = 0
            self.evictions += len(out)
        for entry in out:
            self._release_refs(entry, spill=True)
            with self._mu:
                self._record_manifest(entry)
        return out

    # -- the spill tier: manifest reconstruction ------------------------------

    def take_staged(self, key: str) -> Optional[Tuple[Dict[str, Any], Dict[str, str], str]]:
        """Rebuild an evicted model's host weight tree from the tiers.
        Returns ``(params_tree, weight_digests, tier)`` — ``"host"`` when
        every chunk was still host-resident through a sibling's
        references, ``"disk"`` when any verified disk reload was needed —
        or None: any unresolvable chunk is a miss for the WHOLE model, and
        drops the manifest. Disk fetches (read + re-hash) run on a small
        thread pool."""
        with self._mu:
            manifest = self._manifests.pop(key, None)
        if manifest is None or self.chunks is None:
            return None
        digests, _nbytes = manifest
        items = list(digests.items())
        from_disk = any(d not in self.chunks for _, d in items)
        workers = min(8, os.cpu_count() or 1, max(1, len(items)))
        if workers > 1 and from_disk:
            with ThreadPoolExecutor(workers, thread_name_prefix="pool-tier-fetch") as ex:
                got = list(ex.map(lambda kv: self.chunks.fetch(kv[1]), items))
        else:
            got = [self.chunks.fetch(d) for _, d in items]
        if any(a is None for a in got):
            with self._mu:
                self.staged_misses += 1
            return None
        with self._mu:
            self.staged_hits += 1
        flat = {k: a for (k, _), a in zip(items, got)}
        return unflatten_tree(flat), dict(digests), "disk" if from_disk else "host"

    def take_staged_match(self, model_id: str) -> Optional[Tuple[Dict[str, Any], Dict[str, str], str, str]]:
        """:meth:`take_staged` under any checkpoint qualifier (most
        recently evicted first); returns (tree, digests, matched_key, tier)."""
        with self._mu:
            keys = [k for k in reversed(self._manifests) if k == model_id or k.startswith(model_id + "@")]
        for k in keys:
            got = self.take_staged(k)
            if got is not None:
                return got[0], got[1], k, got[2]
        return None

    def describe(self) -> Dict[str, Any]:
        with self._mu:
            entries = [
                {"model_id": e.model_id, "nbytes": e.nbytes, "resident_bytes": e.resident_bytes}
                for e in self._entries.values()
            ]
            manifests = list(self._manifests)
            models = list(self._entries)
        out = {
            "models": models,
            "bytes_used": self.bytes_used,
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "entries": entries,
            "staged_manifests": manifests,
            "staged_hits": self.staged_hits,
            "staged_misses": self.staged_misses,
        }
        if self.chunks is not None:
            out["chunks"] = self.chunks.describe()
        return out

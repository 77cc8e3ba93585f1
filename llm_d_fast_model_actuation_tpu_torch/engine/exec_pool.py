"""The graph pool and a new engine's warm-up.

Port of ``llm_d_fast_model_actuation_tpu/engine/exec_pool.py``, by what it
means on a GPU. There a compiled program is host code over abstract
shapes: an executable of one engine config serves any engine of it, so
the reference pools executables by config and compiles them on a thread
while a swap, a prefetch or a cold load moves the weights. Here the
compiled program of the serving path is the decode chunk's CUDA graphs
(``engine/graphs.py``): four per engine, holding the device addresses of
that engine's arenas, and their memory pool on the card.

  * :class:`ExecutablePool` is a bounded LRU over the *pooled* engines'
    graph sets, measured in the card bytes of each set's memory pool,
    under ``--exec-pool-mib``. Over budget, the least recently pooled
    engine's graphs are released (``ChunkGraphs.release``): the engine
    stays pooled, and its next swap-in captures them again and counts it
    in ``graph_captures``. The serving engine's graphs are outside the
    pool. An entry's key is ``exec_key(<the engine's model-pool key>,
    "chunk", decode_chunk)``: a graph belongs to one engine, so two
    engines of one config never share one.
  * **Spill has no counterpart.** A captured graph holds device addresses
    of one process and cannot be serialized, so the pool's entries never
    leave the process: no spill directory, no reload after a restart
    (``spill_hits`` and ``spill_errors`` stay 0, ``spill_dir`` empty).
  * :func:`warm_up` is the reference's ``WarmupTask`` of a new engine:
    its four chunk graphs captured and each ``--warmup-buckets`` prefill
    bucket run once, with ``compile_s`` under the reference's key. It runs
    on the building thread after the weights are written, not on a thread
    of its own beside the transfer as the reference compiles: on an H100
    neither order built faster both from a checkpoint and from staged
    weights (``capture_overlap.py``), and one thread is the simpler.
    A pooled engine whose graphs were released captures them again after
    its state is back.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..utils import tracing

def parse_warmup_buckets(spec: str) -> Tuple[int, ...]:
    """``--warmup-buckets``: comma-separated positive prefill token
    buckets (rounded up to the engine's power-of-two buckets when
    planned). Empty runs no prefill at a build."""
    spec = (spec or "").strip()
    if not spec:
        return ()
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            v = int(part)
        except ValueError:
            raise ValueError(f"--warmup-buckets entry {part!r} is not an int")
        if v <= 0:
            raise ValueError(f"--warmup-buckets entries must be > 0, got {v}")
        out.append(v)
    return tuple(out)


# -- identity -----------------------------------------------------------------


def exec_key(owner: str, program: str, bucket: int, quantization: str = "") -> str:
    """The pool's key for ``program`` at ``bucket`` of the engine pooled
    under ``owner``, its model-pool key, and the weights' ``quantization``
    (a W8A16 graph runs other kernels than a bf16 one): a graph holds that
    engine's arenas' addresses, and no other engine may replay it. (The
    reference's ``exec_signature``, a hash of the engine config, has no
    use here: no two engines share a graph.)"""
    return f"{owner}/{program}@{int(bucket)}" + (f"/{quantization}" if quantization else "")


def warmup_plan(engine, buckets) -> List[Tuple[str, int]]:
    """(program, bucket) pairs a warm-up runs: on one card the chunk's
    graphs (T = ``decode_chunk`` and 1, greedy and sampled: the four
    ``ChunkGraphs.keys()``), then the prefill at each requested bucket
    rounded up to the engine's bucket (bucketed serving only: the packed
    path runs no bucketed prefill)."""
    from .engine import prefill_bucket

    plan: List[Tuple[str, int]] = []
    if engine.graphs is not None:
        plan += [("chunk_sampled" if sampled else "chunk", T) for T, sampled in engine.graphs.keys()]
    if buckets and not engine.cfg.packed_serving:
        plan += [("prefill", b) for b in sorted({prefill_bucket(int(x), engine.cfg.seq_len) for x in buckets})]
    return plan


# -- the pool -----------------------------------------------------------------


@dataclasses.dataclass
class ExecEntry:
    key: str
    #: the pooled engine's ``ChunkGraphs`` (anything with ``release()``)
    compiled: Any
    nbytes: int


class ExecutablePool:
    """Bounded LRU of pooled engines' captured graph sets (see the module
    docstring), by the card bytes of each set's memory pool.

    ``budget_bytes <= 0`` disables pooling: every :meth:`put` releases the
    graphs it is given at once, so every pooled engine captures again when
    it serves again. An evicted entry's graphs are released here. Thread
    safe."""

    def __init__(self, budget_bytes: int = 0) -> None:
        self.budget_bytes = int(budget_bytes)
        self._mu = threading.Lock()
        self._entries: "OrderedDict[str, ExecEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        #: captures made, and their seconds (survive evictions)
        self.compiles_total = 0
        self.compile_s_total = 0.0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    @property
    def bytes_used(self) -> int:
        with self._mu:
            return sum(e.nbytes for e in self._entries.values())

    def note_compile(self, seconds: float) -> None:
        """Count one engine's captures (a build's or a re-capture's)."""
        with self._mu:
            self.compiles_total += 1
            self.compile_s_total += float(seconds)

    def take(self, key: str) -> Optional[Any]:
        """Remove and return the graphs pooled under ``key`` (a pooled
        engine serves again: its graphs leave the budget with it), or None
        when they were released (a miss: the engine captures again)."""
        with self._mu:
            entry = self._entries.pop(key, None)
            if entry is None:
                self.misses += 1
                return None
            self.hits += 1
            return entry.compiled

    def discard(self, key: str) -> None:
        """Forget ``key`` without releasing anything (its engine is being
        destroyed)."""
        with self._mu:
            self._entries.pop(key, None)

    def put(self, key: str, compiled: Any, nbytes: int) -> List[ExecEntry]:
        """Pool a parked engine's graphs as most recently used and release
        the least recently used ones until the budget holds; returns the
        evicted entries (their graphs released). With pooling off, or a
        set larger than the budget alone, the set given is released (not
        counted as an eviction when pooling is off)."""
        entry = ExecEntry(key=key, compiled=compiled, nbytes=int(nbytes))
        evicted: List[ExecEntry] = []
        with self._mu:
            old = self._entries.pop(key, None)  # a refresh, not an eviction
            if self.budget_bytes <= 0:
                evicted = [entry]
            elif entry.nbytes > self.budget_bytes:
                self.evictions += 1
                evicted = [entry]
            else:
                self._entries[key] = entry
                while sum(e.nbytes for e in self._entries.values()) > self.budget_bytes:
                    _, victim = self._entries.popitem(last=False)
                    evicted.append(victim)
                self.evictions += len(evicted)
        if old is not None and old.compiled is not compiled:
            old.compiled.release()
        for e in evicted:
            e.compiled.release()
        return evicted

    def drop_live(self) -> int:
        """Release every pooled graph set (counted as evictions)."""
        with self._mu:
            out = list(self._entries.values())
            self._entries.clear()
            self.evictions += len(out)
        for e in out:
            e.compiled.release()
        return len(out)

    def describe(self) -> Dict[str, Any]:
        with self._mu:
            entries, used = len(self._entries), sum(e.nbytes for e in self._entries.values())
            compiles, secs = self.compiles_total, self.compile_s_total
        return {
            "entries": entries,
            "bytes_used": used,
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            # no spill: a captured graph never leaves its process
            "spill_hits": 0,
            "spill_errors": 0,
            "spill_dir": "",
            "compiles_total": compiles,
            "compile_s_total": round(secs, 6),
            "mean_compile_s": round(secs / compiles, 6) if compiles else 0.0,
        }


# -- the warm-up --------------------------------------------------------------


def warm_up(engine, buckets=()) -> Dict[str, Any]:
    """A new engine's warm-up (:func:`warmup_plan`), on the building
    thread once its weights are written: its chunk graphs captured, then
    each prefill bucket run once. A capture that fails fails the build.
    Returns ``programs`` and ``compiled``, ``compile_s`` (the seconds of it
    all, the reference's key), ``capture_s`` (the captures') and
    ``program_s``, each program's seconds (``chunk``: the captures;
    ``prefill``: every bucket's run together).

    Spans, with the reference's names: ``warmup.overlap`` over it all
    and one ``warmup.compile`` per program under it. The port compiles
    nothing: the chunk's span (``program="chunk"``) times the graph
    captures, a prefill bucket's its run."""
    plan = warmup_plan(engine, buckets)
    stats: Dict[str, Any] = {"programs": len(plan), "compiled": 0, "compile_s": 0.0, "capture_s": 0.0,
                             "program_s": {}}
    t0 = time.monotonic()
    with tracing.span("warmup.overlap", programs=len(plan)):
        if any(program != "prefill" for program, _ in plan):
            with tracing.span("warmup.compile", program="chunk"):
                stats["capture_s"] = stats["program_s"]["chunk"] = engine.graphs.capture()
            stats["compiled"] += len(engine.graphs.keys())
        for program, bucket in plan:
            if program == "prefill":
                t_run = time.monotonic()
                with tracing.span("warmup.compile", program=program, bucket=bucket):
                    engine.warm_prefill(bucket)
                stats["program_s"]["prefill"] = stats["program_s"].get("prefill", 0.0) + time.monotonic() - t_run
                stats["compiled"] += 1
    stats["compile_s"] = time.monotonic() - t0
    return stats

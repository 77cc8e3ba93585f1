"""KnowsProcessedSync: the initial-batch rendezvous (the JAX package's
``utils/syncbarrier.py``, copied).

The reference's knows-processed-sync.go:27-103 lets callers wait until every
object that existed at controller start has been through one processing
pass — acting on a partially-processed world (e.g. deleting "excess"
launchers before having seen all of them) is how controllers eat their own
state. Our kube store relists before watching, so the *cache* is complete at
start; this barrier tracks the *processing* side: each initially-enqueued
key is noted, `arm()` closes the initial set, and the event fires when the
last of them completes its first pass (success or retry — the barrier is
about having LOOKED at everything once, not about convergence).

Used as the controllers' readiness signal: a controller that has processed
its initial batch knows enough to be trusted with destructive decisions.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Hashable, Set


class KnowsProcessedSync:
    def __init__(self) -> None:
        self._pending: Set[Hashable] = set()
        self._armed = False
        self._lock = threading.Lock()
        self._event = asyncio.Event()

    def note_pending(self, key: Hashable) -> None:
        """Record an initially-enqueued key. No-op once armed (keys arriving
        after arm() are live events, not initial state)."""
        with self._lock:
            if not self._armed:
                self._pending.add(key)

    def arm(self) -> None:
        """Close the initial set; the event fires when it drains."""
        with self._lock:
            self._armed = True
        self._maybe_fire()

    def note_processed(self, key: Hashable) -> None:
        with self._lock:
            self._pending.discard(key)
        self._maybe_fire()

    def _maybe_fire(self) -> None:
        with self._lock:
            done = self._armed and not self._pending
        if done:
            self._event.set()

    @property
    def processed(self) -> bool:
        return self._event.is_set()

    async def wait(self, timeout: float = 0.0) -> None:
        if timeout:
            await asyncio.wait_for(self._event.wait(), timeout)
        else:
            await self._event.wait()

"""Bounded asyncio event fan-out with revisions.

The launcher's watch endpoint speaks kube-watch semantics: every event
carries a monotonically increasing revision; a watcher resuming from a
revision that has been evicted from the buffer gets `RevisionTooOld`
(HTTP 410 Gone), telling it to re-list and re-watch.

The port of the JAX package's `utils/events.py` (unchanged: it never
imported JAX, and the port keeps its own copy). Reference:
EventBroadcaster, launcher.py:87-146.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Any, AsyncIterator, Deque, Tuple


class RevisionTooOld(Exception):
    """The requested resume revision predates the retained buffer."""


class EventBroadcaster:
    def __init__(self, max_buffer: int = 1000) -> None:
        self._buf: Deque[Tuple[int, Any]] = deque(maxlen=max_buffer)
        self._cond: asyncio.Condition | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._closed = False

    def _condition(self) -> asyncio.Condition:
        # Lazily bound to the running loop (the broadcaster may be built
        # before the event loop starts).
        if self._cond is None:
            self._cond = asyncio.Condition()
            self._loop = asyncio.get_running_loop()
        return self._cond

    @property
    def oldest_revision(self) -> int | None:
        return self._buf[0][0] if self._buf else None

    @property
    def latest_revision(self) -> int | None:
        return self._buf[-1][0] if self._buf else None

    async def publish(self, revision: int, event: Any) -> None:
        cond = self._condition()
        async with cond:
            self._buf.append((revision, event))
            cond.notify_all()

    def publish_nowait(self, revision: int, event: Any) -> None:
        """Publish from synchronous code — on the loop's thread OR any other
        thread (e.g. an executor running a blocking instance stop). Watchers
        are woken via the loop the condition is bound to."""
        self._buf.append((revision, event))
        cond, loop = self._cond, self._loop
        if cond is None or loop is None:
            return  # no watcher loop yet: they'll see it on first subscribe

        async def _notify() -> None:
            async with cond:
                cond.notify_all()

        def _schedule() -> None:
            loop.create_task(_notify())

        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            _schedule()
        else:
            try:
                loop.call_soon_threadsafe(_schedule)
            except RuntimeError:
                # bound loop already closed (shutdown): the event stays in the
                # buffer; there is no watcher loop left to wake
                pass

    async def close(self) -> None:
        cond = self._condition()
        async with cond:
            self._closed = True
            cond.notify_all()

    async def subscribe(self, since_revision: int = 0) -> AsyncIterator[Any]:
        """Yield events with revision > since_revision, forever (until close).

        Raises RevisionTooOld if `since_revision` is older than the oldest
        retained event (and not simply "from the beginning of retention").
        """
        cursor = since_revision
        cond = self._condition()
        while True:
            async with cond:
                oldest = self.oldest_revision
                if (
                    cursor
                    and oldest is not None
                    and cursor < oldest - 1
                ):
                    raise RevisionTooOld(
                        f"revision {cursor} evicted (oldest retained {oldest})"
                    )
                # snapshot first: publish_nowait may append from another
                # thread while we iterate
                snapshot = list(self._buf)
                pending = [e for (rev, e) in snapshot if rev > cursor]
                newest = snapshot[-1][0] if snapshot else None
                if not pending:
                    if self._closed:
                        return
                    await cond.wait()
                    continue
            for e in pending:
                yield e
            cursor = max(cursor, newest or cursor)

"""State-change reflector: instance state -> launcher Pod annotation.

The port of the JAX package's ``launcher/notifier.py`` (reference sidecar:
inference_server/launcher/launcher_pod_notifier.py:16-198). A crash inside
a launcher is node-local; the controller watches the kube API, not
launcher internals. The reflector stamps a signature of the launcher's
instance set onto the launcher Pod's `vllm-instance-signature` annotation,
so any instance-state change becomes a Pod-update event the controller's
informer sees.

It consumes the launcher's revisioned NDJSON watch stream, so a crash is
reflected within one event round-trip with zero idle polling; a broken
stream degrades to periodic polling until the launcher returns. The
sidecar's HTTP client (:class:`HttpSource`) is on asyncio streams from the
standard library (the card's machine has no aiohttp).

Ordering invariant (no lost-update window): the watch stream is CONNECTED
before each list+patch, so every state change is either (a) already visible
to the list, or (b) delivered as an event after the connection — there is no
gap in which a change can slip through unreflected.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import random
import shutil
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import urlencode, urlsplit

from ..api.constants import INSTANCE_SIGNATURE_ANNOTATION as SIGNATURE_ANNOTATION
from ..utils.events import RevisionTooOld
from .http11 import read_chunks, read_headers

logger = logging.getLogger(__name__)

MAX_HEADER_LINES = 100

#: `watcher(since_revision)` -> a CONNECTED async iterator of watch events.
#: Connection (or revision-cursor capture) must be effective at return time.
WatcherFactory = Callable[[int], Awaitable[AsyncIterator[Any]]]


def instance_signature(states: List[Dict[str, Any]]) -> str:
    """SHA-256 over the sorted (instance_id, status) pairs
    (launcher_pod_notifier.py's signature, kept byte-compatible in spirit)."""
    pairs = sorted((s.get("instance_id", ""), s.get("status", "")) for s in states)
    return hashlib.sha256(json.dumps(pairs).encode()).hexdigest()


class InstanceStateNotifier:
    """Watches a launcher and patches the signature on change.

    `lister` returns the launcher's instance states; `watcher` (optional,
    see :data:`WatcherFactory`) yields watch events — used only as change
    triggers, the list is always the source of truth; `patch` applies the
    new signature to the launcher Pod (kube patch in production, a store
    mutate in tests).
    """

    def __init__(
        self,
        lister: Callable[[], Awaitable[List[Dict[str, Any]]]],
        patch: Callable[[str], Awaitable[None]],
        watcher: Optional[WatcherFactory] = None,
        poll_interval_s: float = 2.0,
        reconnect_backoff_s: float = 0.5,
        reconnect_backoff_max_s: float = 30.0,
    ) -> None:
        self._lister = lister
        self._patch = patch
        self._watcher = watcher
        self._poll_interval_s = poll_interval_s
        # Reconnect discipline: a down launcher must not be hammered on a
        # fixed cadence — consecutive connect/stream failures back off
        # exponentially (with jitter, so a fleet of sidecars doesn't
        # reconnect in lockstep) up to a capped ceiling, and one success
        # resets the schedule.
        self._reconnect_backoff_s = reconnect_backoff_s
        self._reconnect_backoff_max_s = reconnect_backoff_max_s
        self._consecutive_failures = 0
        self._last_signature: Optional[str] = None
        self._last_revision = 0
        self._stopping = False

    def _reconnect_delay(self) -> float:
        """Delay before the next watch (re)connect after N consecutive
        failures: min(cap, base * 2**(N-1)), jittered into [d/2, d] so a
        fleet of sidecars spreads out while the configured ceiling stays a
        hard cap."""
        n = max(1, self._consecutive_failures)
        d = min(
            self._reconnect_backoff_max_s,
            self._reconnect_backoff_s * (2 ** (n - 1)),
        )
        return d * (0.5 + 0.5 * random.random())

    async def reflect_once(self) -> Optional[str]:
        """List, compute, patch-if-changed. Returns the new signature when a
        patch was made, else None."""
        states = await self._lister()
        sig = instance_signature(states)
        if sig == self._last_signature:
            return None
        await self._patch(sig)
        self._last_signature = sig
        logger.info("instance signature -> %s (%d instances)", sig[:12], len(states))
        return sig

    async def run(self) -> None:
        """Event loop. Each cycle: connect the watch stream FIRST, then
        reflect (so nothing slips between list and subscribe), then reflect
        again on every event. Falls back to polling without a watcher."""
        while not self._stopping:
            stream: Optional[AsyncIterator[Any]] = None
            connect_failed = False
            if self._watcher is not None:
                try:
                    stream = await self._watcher(self._last_revision)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    if isinstance(e, RevisionTooOld):
                        # resume cursor evicted: restart from the buffer
                        # start; the reflect below covers current state
                        self._last_revision = 0
                    connect_failed = True
                    self._consecutive_failures += 1
                    logger.warning(
                        "watch connect failed (%s); retry %d backing off",
                        e, self._consecutive_failures,
                    )

            await self._reflect_guarded()

            if stream is None:
                # no watcher configured: steady polling cadence; a FAILED
                # connect instead backs off exponentially (capped, with
                # jitter) so a down launcher isn't hammered
                await asyncio.sleep(
                    self._reconnect_delay()
                    if connect_failed
                    else self._poll_interval_s
                )
                continue
            self._consecutive_failures = 0  # connected: schedule resets
            try:
                async for event in stream:
                    rev = (event.get("object") or {}).get("revision") if isinstance(
                        event, dict
                    ) else None
                    if isinstance(rev, int):
                        self._last_revision = max(self._last_revision, rev)
                    await self._reflect_guarded()
                    if self._stopping:
                        break
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if isinstance(e, RevisionTooOld):
                    self._last_revision = 0
                self._consecutive_failures += 1
                logger.warning(
                    "watch stream broke (%s); resync %d backing off",
                    e, self._consecutive_failures,
                )
                await asyncio.sleep(self._reconnect_delay())

    async def _reflect_guarded(self) -> None:
        try:
            await self.reflect_once()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.warning("reflect failed: %s", e)

    def stop(self) -> None:
        self._stopping = True


# ---------------------------------------------------------------- sidecar glue


class HttpSource:
    """Launcher REST access for the sidecar, one connection per call
    (``Connection: close``), on asyncio streams."""

    def __init__(self, base_url: str) -> None:
        url = urlsplit(base_url)
        self._host = url.hostname or "127.0.0.1"
        self._port = url.port or 80
        self._prefix = url.path.rstrip("/")
        self._open: set = set()  # writers of open watch streams

    async def close(self) -> None:
        for writer in list(self._open):
            writer.close()
        self._open.clear()

    async def _get(self, path: str) -> Tuple[int, Dict[str, str], asyncio.StreamReader, asyncio.StreamWriter]:
        reader, writer = await asyncio.open_connection(self._host, self._port)
        writer.write(
            f"GET {self._prefix}{path} HTTP/1.1\r\nHost: {self._host}:{self._port}\r\n"
            "Connection: close\r\n\r\n".encode("latin-1")
        )
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        return status, await read_headers(reader, MAX_HEADER_LINES), reader, writer

    @staticmethod
    async def _chunks(headers: Dict[str, str], reader: asyncio.StreamReader) -> AsyncIterator[bytes]:
        """The response body as it arrives: chunk by chunk when chunked,
        else what ``Content-Length`` says (or up to EOF)."""
        if headers.get("transfer-encoding", "").lower() == "chunked":
            async for chunk in read_chunks(reader):
                yield chunk
        elif "content-length" in headers:
            yield await reader.readexactly(int(headers["content-length"]))
        else:
            yield await reader.read()

    async def lister(self) -> List[Dict[str, Any]]:
        status, headers, reader, writer = await self._get("/v2/vllm/instances")
        try:
            body = b"".join([c async for c in self._chunks(headers, reader)])
        finally:
            writer.close()
        if status != 200:
            raise RuntimeError(f"GET /v2/vllm/instances answered {status}")
        return json.loads(body).get("instances", [])

    async def watcher(self, since_revision: int) -> AsyncIterator[Any]:
        """Connect the watch stream before returning (see the notifier's
        ordering invariant). A 410 on a resume revision falls back to
        watching from now — the caller reflects right after we return, which
        covers everything up to this connection."""
        path = "/v2/vllm/instances/watch"
        query = "?" + urlencode({"since": str(since_revision)}) if since_revision > 0 else ""
        status, headers, reader, writer = await self._get(path + query)
        if status == 410:
            writer.close()
            status, headers, reader, writer = await self._get(path)
        if status != 200:
            writer.close()
            raise RuntimeError(f"GET {path} answered {status}")
        self._open.add(writer)

        async def gen() -> AsyncIterator[Any]:
            pending = b""
            try:
                async for chunk in self._chunks(headers, reader):
                    pending += chunk
                    *lines, pending = pending.split(b"\n")
                    for line in lines:
                        if line.strip():
                            yield json.loads(line)
            finally:
                self._open.discard(writer)
                writer.close()

        return gen()


def kubectl_patcher(pod_name: str, namespace: str):
    """Annotate the launcher Pod via kubectl (the sidecar has a service
    account; this avoids requiring a python kube client in the image)."""
    if shutil.which("kubectl") is None:
        raise RuntimeError("kubectl not found; provide a custom patcher")

    async def patch(signature: str) -> None:
        proc = await asyncio.create_subprocess_exec(
            "kubectl",
            "annotate",
            "pod",
            pod_name,
            "-n",
            namespace,
            f"{SIGNATURE_ANNOTATION}={signature}",
            "--overwrite",
            stdout=asyncio.subprocess.DEVNULL,
            stderr=asyncio.subprocess.PIPE,
        )
        _, err = await proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"kubectl annotate failed: {err.decode()[:500]}")

    return patch


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    import os

    parser = argparse.ArgumentParser(description="launcher state-change reflector")
    parser.add_argument("--launcher-url", default="http://127.0.0.1:8001")
    parser.add_argument("--pod-name", default=os.environ.get("POD_NAME", ""))
    parser.add_argument("--namespace", default=os.environ.get("NAMESPACE", ""))
    parser.add_argument("--poll-interval", type=float, default=2.0)
    args = parser.parse_args(argv)
    if not args.pod_name or not args.namespace:
        parser.error("--pod-name and --namespace (or POD_NAME/NAMESPACE env) required")

    source = HttpSource(args.launcher_url)
    notifier = InstanceStateNotifier(
        lister=source.lister,
        patch=kubectl_patcher(args.pod_name, args.namespace),
        watcher=source.watcher,
        poll_interval_s=args.poll_interval,
    )

    async def run() -> None:
        try:
            await notifier.run()
        finally:
            await source.close()

    asyncio.run(run())


if __name__ == "__main__":  # pragma: no cover
    main()

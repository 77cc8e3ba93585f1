"""Requester SPI server (reference: pkg/server/requester/coordination).

The port of the JAX package's ``requester/spi.py``, served on asyncio
streams (``launcher/http11.py``; the card's machine has no aiohttp) with
the same paths (``api/spi.py``), status codes, content types and bodies.
The accelerator backend is pluggable:
  * real: the machine's cards by NVML UUID, their memory in use from NVML
    (``requester/main.py``);
  * test: a provided id list + usage callable (the reference's
    `test-requester` emulates scheduler allocation the same way).

The log sink implements the reference's exact chunk protocol
(coordination/server.go:152-209): orderly dedup by absolute start position —
only bytes past the current end are appended; a chunk starting beyond the
end is a 400.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence

from ..api import spi as spiapi
from ..launcher.http11 import App, Request, Response, json_response, text_response
from ..utils import tracing


class LogSink:
    """Relayed-log accumulator with overlap dedup by start position."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._lock = threading.Lock()

    @property
    def length(self) -> int:
        return len(self._buf)

    def content(self) -> bytes:
        with self._lock:
            return bytes(self._buf)

    def add_chunk(self, start_pos: int, chunk: bytes) -> tuple:
        """Returns (http_status, message)."""
        with self._lock:
            next_pos = len(self._buf)
            if start_pos < 0:
                return 400, f"Starting position {start_pos} is unacceptable because it is negative"
            if start_pos > next_pos:
                return (
                    400,
                    f"Starting position {start_pos} is beyond the current "
                    f"contentLength={next_pos}",
                )
            if start_pos + len(chunk) <= next_pos:
                return (
                    200,
                    f"Accepted startPos={start_pos}, chunkLength={len(chunk)}, "
                    f"but that has nothing new; still contentLength={next_pos}",
                )
            news = chunk[next_pos - start_pos :] if start_pos < next_pos else chunk
            self._buf.extend(news)
            return (
                200,
                f"Accepted startPos={start_pos}, chunkLength={len(chunk)}; "
                f"addedContentLength={len(news)}, new contentLength={len(self._buf)}",
            )


class ReadyFlag:
    """Atomic readiness bool shared between the SPI and probes servers."""

    def __init__(self, initial: bool = False) -> None:
        self._val = initial
        self._lock = threading.Lock()

    def set(self, value: bool) -> None:
        with self._lock:
            self._val = value

    def get(self) -> bool:
        with self._lock:
            return self._val


class SpiServer:
    def __init__(
        self,
        chip_ids: Sequence[str],
        ready_flag: ReadyFlag,
        memory_usage: Optional[Callable[[], Dict[str, int]]] = None,
        log_sink: Optional[LogSink] = None,
    ) -> None:
        self.chip_ids = list(chip_ids)
        self.ready = ready_flag
        self.memory_usage = memory_usage or (lambda: {c: 0 for c in self.chip_ids})
        self.log_sink = log_sink or LogSink()

    def build_app(self) -> App:
        async def accelerators(request: Request) -> Response:
            return json_response(self.chip_ids)

        async def accel_memory(request: Request) -> Response:
            try:
                usage = self.memory_usage()
            except Exception as e:
                return text_response(str(e), 500)
            return json_response({k: int(v) for k, v in usage.items()})

        async def become_ready(request: Request) -> Response:
            # the readiness relay closes the actuation the controller
            # measures: a span of that trace (its traceparent rides the call)
            with tracing.span("spi.become_ready", parent=tracing.context_from_headers(request.headers)):
                self.ready.set(True)
            return text_response("OK\n")

        async def become_unready(request: Request) -> Response:
            with tracing.span("spi.become_unready", parent=tracing.context_from_headers(request.headers)):
                self.ready.set(False)
            return text_response("OK\n")

        async def set_log(request: Request) -> Response:
            start_raw = request.query.get(spiapi.LOG_START_POS_PARAM)
            if not start_raw:
                return text_response(f"Missing {spiapi.LOG_START_POS_PARAM} parameter\n", 400)
            try:
                start_pos = int(start_raw)
            except ValueError as e:
                return text_response(f"Failed to parse {start_raw!r} as an int: {e}\n", 400)
            status, message = self.log_sink.add_chunk(start_pos, request.body)
            return text_response(message + "\r\n", status)

        return App([
            ("GET", spiapi.ACCELERATOR_QUERY_PATH, accelerators),
            ("GET", spiapi.ACCELERATOR_MEMORY_QUERY_PATH, accel_memory),
            ("POST", spiapi.BECOME_READY_PATH, become_ready),
            ("POST", spiapi.BECOME_UNREADY_PATH, become_unready),
            ("POST", spiapi.SET_LOG_PATH, set_log),
        ])

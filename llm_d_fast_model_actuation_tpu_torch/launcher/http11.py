"""HTTP/1.1 framing on asyncio streams, shared by the launcher's server
(``rest.py``) and the notifier's client (``notifier.py``): header lines,
and a chunked body read chunk by chunk as it arrives."""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Dict


class FramingError(Exception):
    """The peer's bytes are not the HTTP/1.1 framing expected."""


async def read_headers(reader: asyncio.StreamReader, max_lines: int) -> Dict[str, str]:
    """The header lines up to the blank line, names lowercased."""
    headers: Dict[str, str] = {}
    for _ in range(max_lines):
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            return headers
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    raise FramingError("too many header lines")


async def read_chunks(reader: asyncio.StreamReader) -> AsyncIterator[bytes]:
    """A chunked body's chunks as they arrive; the trailers are skipped."""
    while True:
        size = int((await reader.readline()).split(b";")[0].strip() or b"0", 16)
        if size == 0:
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass
            return
        data = await reader.readexactly(size)
        await reader.readline()
        yield data

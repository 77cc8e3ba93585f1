"""HTTP/1.1 on asyncio streams, from the standard library: the framing,
a small server (:class:`App`: routes, keep-alive, chunked streams) and a
client (:func:`fetch`, :func:`open_request`).

The card's machine has no aiohttp, so every HTTP surface of the port's
control plane stands on this: the launcher's REST API (``rest.py``) and
its notifier's client (``notifier.py``), the requester stub's SPI and
probes servers (``requester/``), and the controller's clients
(``controller/clients.py``) and kube watch (``controller/kubestore.py``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import ssl as ssllib
from http import HTTPStatus
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

logger = logging.getLogger(__name__)

MAX_HEADER_LINES = 100
MAX_BODY_BYTES = 16 << 20


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


async def body_chunks(headers: Dict[str, str], reader: asyncio.StreamReader) -> AsyncIterator[bytes]:
    """A response body as it arrives: chunk by chunk when chunked, else
    what ``Content-Length`` says (or up to EOF)."""
    if headers.get("transfer-encoding", "").lower() == "chunked":
        async for chunk in read_chunks(reader):
            yield chunk
    elif "content-length" in headers:
        yield await reader.readexactly(int(headers["content-length"]))
    else:
        yield await reader.read()


# -- the server -------------------------------------------------------------------


class Request:
    def __init__(self, method: str, target: str, headers: Dict[str, str], body: bytes) -> None:
        url = urlsplit(target)
        self.method = method
        self.path = unquote(url.path)
        self.query = dict(reversed(parse_qsl(url.query, keep_blank_values=True)))  # first value wins
        self.headers = headers  # lower-case names
        self.body = body
        self.match_info: Dict[str, str] = {}

    def json(self) -> Any:
        return json.loads(self.body.decode())


class Response:
    def __init__(self, status: int = 200, body: bytes = b"", content_type: str = "application/octet-stream",
                 headers: Optional[Dict[str, str]] = None) -> None:
        self.status = status
        self.body = body
        self.headers = {"Content-Type": content_type, **(headers or {})}


class StreamResponse:
    """A 200 whose body is written chunked as ``chunks`` yields."""

    def __init__(self, chunks: AsyncIterator[bytes], headers: Dict[str, str]) -> None:
        self.status = 200
        self.chunks = chunks
        self.headers = headers


class HTTPError(Exception):
    """An error answer, with aiohttp's plain-text body (``text``, else
    ``"<code>: <reason>"``)."""

    def __init__(self, status: int, text: Optional[str] = None, headers: Optional[Dict[str, str]] = None) -> None:
        super().__init__(text)
        self.status = status
        self.text = text if text is not None else f"{status}: {HTTPStatus(status).phrase}"
        self.headers = headers or {}

    def response(self) -> Response:
        return Response(self.status, self.text.encode(), "text/plain; charset=utf-8", self.headers)


def json_response(data: Any, status: int = 200) -> Response:
    """aiohttp's ``web.json_response``."""
    return Response(status, json.dumps(data).encode(), "application/json; charset=utf-8")


def text_response(text: str, status: int = 200) -> Response:
    """aiohttp's ``web.Response(text=...)``."""
    return Response(status, text.encode(), "text/plain; charset=utf-8")


class BadRequestLine(FramingError):
    """The connection did not send an HTTP/1.x request."""


async def read_request(reader: asyncio.StreamReader) -> Optional[Request]:
    """The next request on a connection; None at a clean EOF."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1").rstrip("\r\n").split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise BadRequestLine(line[:80])
    method, target, version = parts
    headers = {"_version": version, **await read_headers(reader, MAX_HEADER_LINES)}
    if headers.get("transfer-encoding", "").lower() == "chunked":
        body = b""
        async for chunk in read_chunks(reader):
            body += chunk
            if len(body) > MAX_BODY_BYTES:
                raise BadRequestLine(b"body too large")
    else:
        n = int(headers.get("content-length") or 0)
        if n > MAX_BODY_BYTES:
            raise BadRequestLine(b"body too large")
        body = await reader.readexactly(n) if n else b""
    return Request(method, target, headers, body)


def _keep_alive(req: Request) -> bool:
    conn = req.headers.get("connection", "").lower()
    if req.headers["_version"] == "HTTP/1.0":
        return conn == "keep-alive"
    return conn != "close"


def _head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


Handler = Callable[[Request], Any]


class App:
    """Routes (``{name}`` segments land in ``request.match_info``) and the
    server that answers them, as aiohttp's router does: a GET route also
    answers HEAD (its headers, no body), 404 for an unknown path, 405 with
    ``Allow`` (sorted) for a known path and another method, 500 for a
    handler that raises."""

    def __init__(self, routes: List[Tuple[str, str, Handler]]) -> None:
        self.routes: List[Tuple[str, re.Pattern, Handler]] = []
        self._server: Optional[asyncio.base_events.Server] = None
        self._connections: set = set()
        for method, path, handler in routes:
            pattern = re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^{}/]+)", path) + "$")
            for m in (method, "HEAD") if method == "GET" else (method,):
                self.routes.append((m, pattern, handler))

    async def dispatch(self, req: Request):
        allowed = []
        for method, pattern, handler in self.routes:
            m = pattern.match(req.path)
            if m is None:
                continue
            if method != req.method:
                allowed.append(method)
                continue
            req.match_info = m.groupdict()
            try:
                return await handler(req)
            except HTTPError as e:
                return e.response()
            except Exception:  # noqa: BLE001 — the request's boundary
                logger.exception("%s %s failed", req.method, req.path)
                return HTTPError(500).response()
        if allowed:
            return HTTPError(405, headers={"Allow": ",".join(sorted(allowed))}).response()
        return HTTPError(404).response()

    async def start(self, host: str, port: int) -> int:
        """Listen on ``host:port`` (0 picks a free port); returns the port."""
        self._server = await asyncio.start_server(self._connection, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        """Stop listening and drop the open connections (streams too)."""
        if self._server is not None:
            self._server.close()
        for task in list(self._connections):
            task.cancel()
        await asyncio.gather(*self._connections, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()

    async def _connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        try:
            while True:
                try:
                    req = await read_request(reader)
                except (FramingError, ValueError):
                    writer.write(_head(400, {"Content-Length": "0", "Connection": "close"}))
                    break
                if req is None:
                    break
                resp = await self.dispatch(req)
                if isinstance(resp, StreamResponse):
                    await self._stream(resp, reader, writer)
                    break
                keep = _keep_alive(req)
                headers = {**resp.headers, "Content-Length": str(len(resp.body))}
                if not keep:
                    headers["Connection"] = "close"
                writer.write(_head(resp.status, headers) + (b"" if req.method == "HEAD" else resp.body))
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._connections.discard(task)
            writer.close()

    async def _stream(self, resp: StreamResponse, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        """Write ``resp`` chunked until its events end or the client goes
        away (its side of the connection reaches EOF)."""
        writer.write(_head(resp.status, {**resp.headers, "Transfer-Encoding": "chunked", "Connection": "close"}))
        await writer.drain()

        async def pump() -> None:
            async for chunk in resp.chunks:
                writer.write(b"%x\r\n%s\r\n" % (len(chunk), chunk))
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()

        tasks = [asyncio.ensure_future(pump()), asyncio.ensure_future(reader.read())]
        try:
            await asyncio.wait(tasks, return_when=asyncio.FIRST_COMPLETED)
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await resp.chunks.aclose()


# -- the client -------------------------------------------------------------------


async def open_request(
    method: str,
    url: str,
    body: Optional[bytes] = None,
    headers: Optional[Dict[str, str]] = None,
    ssl: Optional[ssllib.SSLContext] = None,
) -> Tuple[int, Dict[str, str], asyncio.StreamReader, asyncio.StreamWriter]:
    """Send one request on a connection of its own (``Connection:
    close``); returns the status, the response's header lines and the
    open streams, for the caller to read the body (:func:`body_chunks`)
    and close the writer. An ``https`` URL takes ``ssl`` (the default
    context when None)."""
    parts = urlsplit(url)
    tls = parts.scheme == "https"
    host = parts.hostname or "127.0.0.1"
    port = parts.port or (443 if tls else 80)
    target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
    reader, writer = await asyncio.open_connection(
        host, port, ssl=(ssl or ssllib.create_default_context()) if tls else None)
    try:
        lines = [f"{method} {target} HTTP/1.1", f"Host: {host}:{port}", "Connection: close",
                 f"Content-Length: {len(body or b'')}"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + (body or b""))
        await writer.drain()
        status_line = await reader.readline()
        if not status_line:
            raise ConnectionError(f"{method} {url}: the connection closed before an answer")
        status = int(status_line.split()[1])
        return status, await read_headers(reader, MAX_HEADER_LINES), reader, writer
    except BaseException:
        writer.close()
        raise


async def fetch(
    method: str,
    url: str,
    json_body: Any = None,
    headers: Optional[Dict[str, str]] = None,
    timeout: float = 30.0,
) -> Tuple[int, bytes]:
    """(status, body) of one request, a JSON body sent when ``json_body``
    is not None; the whole exchange within ``timeout`` seconds."""

    async def exchange() -> Tuple[int, bytes]:
        body, extra = None, dict(headers or {})
        if json_body is not None:
            body = json.dumps(json_body).encode()
            extra.setdefault("Content-Type", "application/json")
        status, head, reader, writer = await open_request(method, url, body, extra)
        try:
            return status, b"".join([c async for c in body_chunks(head, reader)])
        finally:
            writer.close()

    return await asyncio.wait_for(exchange(), timeout)

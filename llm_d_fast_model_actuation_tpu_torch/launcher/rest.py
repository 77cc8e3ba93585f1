"""Launcher REST API, on asyncio streams from the standard library.

The port of the JAX package's ``launcher/rest.py`` (aiohttp, which the
card's machine does not have), wire-compatible with the reference
launcher's surface (launcher.py:568-800) for the routes the port serves:

  GET    /health, /
  POST   /v2/vllm/instances                 create (201), id generated
  GET    /v2/vllm/instances[?detail=false]  list (with the fleet block)
  DELETE /v2/vllm/instances                 stop all
  PUT    /v2/vllm/instances/{id}            create named (201; 409 taken)
  GET    /v2/vllm/instances/{id}            status (404)
  DELETE /v2/vllm/instances/{id}            stop (404)
  GET    /v2/vllm/instances/{id}/log        log bytes, ``Range: bytes=``
                                            (206, 416, 400)
  POST   /v2/vllm/instances/{id}/swap       model hot-swap (404, 422, 400,
                                            503 rolled back, 504, 502)
  POST   /v2/vllm/instances/{id}/prefetch   stage a model on the child's
  GET    /v2/vllm/instances/{id}/prefetch   host, its state, abort it
  DELETE /v2/vllm/instances/{id}/prefetch   (404, 422, 400, 504, 502)
  GET    /v2/vllm/instances/watch[?since=N] NDJSON events (410 when N
                                            was evicted)

The same status codes, JSON bodies and plain-text error bodies as the
JAX launcher. The HTTP/1.1 server is a small one of its own: keep-alive,
``Content-Length`` or chunked request bodies, and the watch stream
written chunked, one event a chunk, flushed as it comes. Blocking manager
calls (a create forks and may probe other engines; a stop waits on the
child) run on the loop's executor; sentinel watchers are armed on the
loop thread, as the JAX launcher arms them.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
from http import HTTPStatus
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

from ..utils.events import RevisionTooOld
from .http11 import FramingError, read_chunks, read_headers
from .instance import InstanceConfig, InvalidInstanceConfig, LogRangeNotAvailable
from .manager import ChipConflict, EngineProcessManager, PrefetchFailed, SwapFailed

logger = logging.getLogger(__name__)

_RANGE_RE = re.compile(r"^bytes=(\d+)-(\d+)?$")
MAX_HEADER_LINES = 100
MAX_BODY_BYTES = 16 << 20


def parse_range_header(value: str) -> Tuple[int, Optional[int]]:
    """``bytes=START-END`` or ``bytes=START-`` (suffix ranges rejected)."""
    m = _RANGE_RE.match(value)
    if m is None:
        raise ValueError(f"Unsupported or malformed Range header: {value}")
    start = int(m.group(1))
    end = int(m.group(2)) if m.group(2) else None
    if end is not None and end < start:
        raise ValueError(f"Range end ({end}) must be >= start ({start})")
    return start, end


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
    return Response(status, json.dumps(data).encode(), "application/json; charset=utf-8")


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


class LauncherApp:
    """The routes over one manager, and the server that answers them."""

    def __init__(self, manager: EngineProcessManager) -> None:
        self.manager = manager
        self.routes: List[Tuple[str, re.Pattern, Handler]] = []
        self._server: Optional[asyncio.base_events.Server] = None
        self._connections: set = set()
        for method, path, handler in (
            ("GET", "/health", self.health),
            ("GET", "/", self.index),
            ("GET", "/v2/vllm/instances/watch", self.watch),
            ("POST", "/v2/vllm/instances", self.create_instance),
            ("PUT", "/v2/vllm/instances/{instance_id}", self.create_named_instance),
            ("DELETE", "/v2/vllm/instances/{instance_id}", self.delete_instance),
            ("DELETE", "/v2/vllm/instances", self.delete_all),
            ("GET", "/v2/vllm/instances", self.get_all),
            ("GET", "/v2/vllm/instances/{instance_id}", self.get_one),
            ("GET", "/v2/vllm/instances/{instance_id}/log", self.get_log),
            ("POST", "/v2/vllm/instances/{instance_id}/swap", self.swap_instance),
            ("POST", "/v2/vllm/instances/{instance_id}/prefetch", self.prefetch_instance),
            ("GET", "/v2/vllm/instances/{instance_id}/prefetch", self.get_instance_prefetch),
            ("DELETE", "/v2/vllm/instances/{instance_id}/prefetch", self.abort_instance_prefetch),
        ):
            pattern = re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^{}/]+)", path) + "$")
            self.routes.append((method, pattern, handler))

    # -- routing ---------------------------------------------------------------

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
            return HTTPError(405, headers={"Allow": ",".join(allowed)}).response()
        return HTTPError(404).response()

    async def _run(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(None, fn, *args)

    # -- handlers --------------------------------------------------------------

    async def health(self, req: Request) -> Response:
        return json_response({"status": "OK"})

    async def index(self, req: Request) -> Response:
        return json_response(
            {
                "name": "Multi-Instance Engine Management API (GPU)",
                "version": "2.0",
                "endpoints": {
                    "index": "GET /",
                    "health": "GET /health",
                    "create_instance": "POST /v2/vllm/instances",
                    "create_named_instance": "PUT /v2/vllm/instances/{instance_id}",
                    "delete_instance": "DELETE /v2/vllm/instances/{instance_id}",
                    "delete_all_instances": "DELETE /v2/vllm/instances",
                    "get_instance_status": "GET /v2/vllm/instances/{instance_id}",
                    "get_all_instances": "GET /v2/vllm/instances",
                    "get_instance_logs": "GET /v2/vllm/instances/{instance_id}/log",
                    "swap_instance": "POST /v2/vllm/instances/{instance_id}/swap",
                    "prefetch_instance": "POST /v2/vllm/instances/{instance_id}/prefetch",
                    "prefetch_status": "GET /v2/vllm/instances/{instance_id}/prefetch",
                    "abort_prefetch": "DELETE /v2/vllm/instances/{instance_id}/prefetch",
                    "watch_instances": "GET /v2/vllm/instances/watch",
                },
            }
        )

    def _parse_config(self, req: Request) -> InstanceConfig:
        try:
            return InstanceConfig.from_dict(req.json())
        except (ValueError, TypeError, AttributeError) as e:
            raise HTTPError(422, f"invalid instance config: {e}")

    async def _create(self, req: Request, instance_id: Optional[str]) -> Response:
        config = self._parse_config(req)
        try:
            # create forks and may probe overlapping engines over HTTP (2 s
            # timeout each): keep the event loop free
            result = await self._run(self.manager.create_instance, config, instance_id)
        except InvalidInstanceConfig as e:
            raise HTTPError(422, str(e))
        except ChipConflict as e:
            raise HTTPError(409, str(e))
        except ValueError as e:
            if instance_id is None:
                raise HTTPError(500, str(e))
            raise HTTPError(409, str(e))
        except Exception as e:
            logger.exception("create failed")
            raise HTTPError(500, str(e))
        self._watch_sentinel(result["instance_id"])
        return json_response(result, status=HTTPStatus.CREATED)

    async def create_instance(self, req: Request) -> Response:
        return await self._create(req, None)

    async def create_named_instance(self, req: Request) -> Response:
        return await self._create(req, req.match_info["instance_id"])

    async def delete_instance(self, req: Request) -> Response:
        instance_id = req.match_info["instance_id"]
        inst = self.manager.instances.get(instance_id)
        if inst is not None:
            inst.cancel_sentinel_watcher()  # must run on the loop thread
        try:
            # stop() waits on SIGTERM/join for seconds; keep the loop live
            result = await self._run(self.manager.stop_instance, instance_id)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        return json_response(result)

    async def delete_all(self, req: Request) -> Response:
        for inst in list(self.manager.instances.values()):
            inst.cancel_sentinel_watcher()
        return json_response(await self._run(self.manager.stop_all_instances))

    async def get_all(self, req: Request) -> Response:
        if req.query.get("detail", "true").lower() != "false":
            # executor: the fleet block polls engine children over HTTP
            return json_response(await self._run(lambda: self.manager.get_all_instances_status(include_fleet=True)))
        ids = self.manager.list_instances()
        return json_response({"revision": self.manager.revision, "instance_ids": ids, "count": len(ids)})

    async def get_one(self, req: Request) -> Response:
        instance_id = req.match_info["instance_id"]
        try:
            return json_response(self.manager.get_instance_status(instance_id))
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")

    async def swap_instance(self, req: Request) -> Response:
        """The model hot-swap verb: rebind a live instance to another model
        over its child's /v1/swap — same cards, same process."""
        instance_id = req.match_info["instance_id"]
        try:
            body = req.json()
        except ValueError:
            raise HTTPError(400, "invalid JSON body")
        model = body.get("model") if isinstance(body, dict) else None
        if not isinstance(model, str) or not model:
            raise HTTPError(422, "swap requires a 'model' string")
        checkpoint_dir = body.get("checkpoint_dir") or ""
        if not isinstance(checkpoint_dir, str):
            raise HTTPError(422, "checkpoint_dir must be a string")
        try:
            # the swap streams model state for seconds; keep the loop free
            result = await self._run(self.manager.swap_instance, instance_id, model, checkpoint_dir)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except SwapFailed as e:
            # the engine refused it (the client's fault), rolled it back
            # (retryable, 503), timed out unrecovered (504), or is unreachable
            if 400 <= e.status < 500:
                raise HTTPError(400, str(e))
            raise HTTPError(e.status if e.status in (503, 504) else 502, str(e))
        return json_response(result)

    @staticmethod
    def _prefetch_error(e: PrefetchFailed) -> HTTPError:
        # the engine's refusal is the client's fault; a timed-out child is
        # 504, an unreachable one 502
        if 400 <= e.status < 500:
            return HTTPError(400, str(e))
        return HTTPError(504 if e.status == 504 else 502, str(e))

    async def prefetch_instance(self, req: Request) -> Response:
        """The prefetch verb: stage a model's weights on a live instance's
        host (its child's /v1/prefetch) while it keeps serving."""
        instance_id = req.match_info["instance_id"]
        try:
            body = req.json()
        except ValueError:
            raise HTTPError(400, "invalid JSON body")
        model = body.get("model") if isinstance(body, dict) else None
        if not isinstance(model, str) or not model:
            raise HTTPError(422, "prefetch requires a 'model' string")
        checkpoint_dir = body.get("checkpoint_dir") or ""
        if not isinstance(checkpoint_dir, str):
            raise HTTPError(422, "checkpoint_dir must be a string")
        try:
            result = await self._run(self.manager.prefetch_instance, instance_id, model, checkpoint_dir)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except PrefetchFailed as e:
            raise self._prefetch_error(e)
        return json_response(result)

    async def get_instance_prefetch(self, req: Request) -> Response:
        instance_id = req.match_info["instance_id"]
        try:
            result = await self._run(self.manager.get_instance_prefetch, instance_id)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except PrefetchFailed as e:
            raise self._prefetch_error(e)
        return json_response(result)

    async def abort_instance_prefetch(self, req: Request) -> Response:
        instance_id = req.match_info["instance_id"]
        try:
            result = await self._run(self.manager.abort_instance_prefetch, instance_id)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except PrefetchFailed as e:
            raise self._prefetch_error(e)
        return json_response(result)

    async def watch(self, req: Request) -> StreamResponse:
        since_raw = req.query.get("since")
        try:
            since = int(since_raw) if since_raw is not None else None
        except ValueError:
            raise HTTPError(400, f"invalid since revision: {since_raw!r}")
        manager = self.manager
        if since is not None:
            oldest = manager.broadcaster.oldest_revision
            if oldest is not None and since < oldest - 1:
                raise HTTPError(
                    410,
                    f"Requested revision {since} is no longer available. Oldest available: {oldest}.",
                )
        if since is None:
            start_revision = manager.revision
            initial = [{"type": "CREATED", "object": inst.get_status()} for inst in list(manager.instances.values())]
        else:
            start_revision, initial = since, []

        async def lines() -> AsyncIterator[bytes]:
            for event in initial:
                yield (json.dumps(event) + "\n").encode()
            try:
                async for event in manager.broadcaster.subscribe(start_revision):
                    yield (json.dumps(event) + "\n").encode()
            except RevisionTooOld:
                pass

        return StreamResponse(lines(), {"Content-Type": "application/x-ndjson", "X-Content-Type-Options": "nosniff"})

    async def get_log(self, req: Request) -> Response:
        instance_id = req.match_info["instance_id"]
        range_header = req.headers.get("range")
        if range_header is None:
            start, end, partial = 0, None, False
        else:
            try:
                start, end = parse_range_header(range_header)
            except ValueError as e:
                raise HTTPError(400, str(e))
            partial = True
        try:
            data, total = self.manager.get_instance_log_bytes(instance_id, start, end)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except LogRangeNotAvailable as e:
            if not partial:
                # Rangeless GET of a still-empty log is a healthy 200, not 416.
                return Response(200, b"", headers={"Accept-Ranges": "bytes"})
            return Response(416, b"", headers={"Content-Range": f"bytes */{e.total}"})
        return Response(
            206 if partial else 200,
            data,
            headers={"Accept-Ranges": "bytes", "Content-Range": f"bytes {start}-{start + len(data) - 1}/{total}"},
        )

    def _watch_sentinel(self, instance_id: str) -> None:
        """Arm crash detection for a just-created instance (needs the
        running loop, hence done here, not in the manager)."""
        instance = self.manager.instances.get(instance_id)
        if instance is not None:
            instance.start_sentinel_watcher(self.manager._on_instance_stopped)

    # -- the server ------------------------------------------------------------

    async def start(self, host: str, port: int) -> int:
        """Listen on ``host:port`` (0 picks a free port); returns the port."""
        self._server = await asyncio.start_server(self._connection, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        """Stop listening, drop the open connections (watch streams too),
        and stop every instance (the JAX launcher's on_shutdown)."""
        if self._server is not None:
            self._server.close()
        for task in list(self._connections):
            task.cancel()
        await asyncio.gather(*self._connections, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
        await self._run(self.manager.stop_all_instances)

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
                writer.write(_head(resp.status, headers) + resp.body)
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

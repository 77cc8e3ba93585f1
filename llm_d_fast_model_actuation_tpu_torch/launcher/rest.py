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
  POST   /v2/vllm/instances/{id}/migrate    hand the live streams to a
                                            sibling ({"dest_id"} optional;
                                            404, 422, 409, 400, 504, 502)
  POST   /v2/vllm/instances/{id}/drain      migrate until idle (as migrate)
  POST   /v2/vllm/instances/{id}/residents  attach a co-resident sibling,
  GET    /v2/vllm/instances/{id}/residents  the resident set, detach one
  DELETE /v2/vllm/instances/{id}/residents  (404, 422, 409 refused by the
                                            engine, 400, 504, 502)
  GET    /v2/vllm/instances/watch[?since=N] NDJSON events (410 when N
                                            was evicted)
  GET    /metrics                           Prometheus text (the fleet
                                            rollup refreshed first)
  GET    /v2/vllm/traces                    this process's spans
                                            (?format=chrome|tree,
                                            trace_id, clear)
  GET    /v2/vllm/exemplars                 the fleet's SLO exemplars
  GET    /v2/vllm/faults                    the launcher's fault points:
  POST   /v2/vllm/faults                    described, armed ({"spec"}),
  DELETE /v2/vllm/faults                    reset

The same status codes, JSON bodies and plain-text error bodies as the
JAX launcher. The HTTP/1.1 server is a small one of its own: keep-alive,
``Content-Length`` or chunked request bodies, and the watch stream
written chunked, one event a chunk, flushed as it comes. Blocking manager
calls (a create forks and may probe other engines; a stop waits on the
child) run on the loop's executor, under the caller's ``traceparent``
(``tracing.run_traced``: a context variable does not follow a call into
the executor, so the worker adopts the header itself); sentinel watchers
are armed on the loop thread, as the JAX launcher arms them.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
from http import HTTPStatus
from typing import AsyncIterator, Optional, Tuple

from ..utils import faults, tracing
from ..utils.events import RevisionTooOld
from ..utils.prom import exposition
from .http11 import (  # noqa: F401 — the server's names, importable from here as before
    App,
    BadRequestLine,
    HTTPError,
    Request,
    Response,
    StreamResponse,
    json_response,
    read_request,
)
from .instance import InstanceConfig, InvalidInstanceConfig, LogRangeNotAvailable
from .manager import (ChipConflict, DrainFailed, EngineProcessManager, MigrateFailed, PrefetchFailed,
                      ResidentsFailed, SwapFailed)

logger = logging.getLogger(__name__)

_RANGE_RE = re.compile(r"^bytes=(\d+)-(\d+)?$")


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


class LauncherApp(App):
    """The routes over one manager, and the server that answers them."""

    def __init__(self, manager: EngineProcessManager) -> None:
        self.manager = manager
        super().__init__([
            ("GET", "/health", self.health),
            ("GET", "/metrics", self.metrics),
            ("GET", "/v2/vllm/traces", self.traces),
            ("GET", "/v2/vllm/exemplars", self.exemplars),
            ("GET", "/v2/vllm/faults", self.faults_get),
            ("POST", "/v2/vllm/faults", self.faults_arm),
            ("DELETE", "/v2/vllm/faults", self.faults_reset),
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
            ("POST", "/v2/vllm/instances/{instance_id}/migrate", self.migrate_instance),
            ("POST", "/v2/vllm/instances/{instance_id}/drain", self.drain_instance),
            ("POST", "/v2/vllm/instances/{instance_id}/residents", self.attach_instance_resident),
            ("GET", "/v2/vllm/instances/{instance_id}/residents", self.get_instance_residents),
            ("DELETE", "/v2/vllm/instances/{instance_id}/residents", self.detach_instance_resident),
        ])

    async def _run(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(None, fn, *args)

    async def _traced(self, req: Request, fn, *args):
        """A blocking manager verb on the executor, under the caller's
        ``traceparent``: the launcher's spans join the caller's trace, and
        the fork and the engine hop carry it on."""
        return await tracing.run_traced(asyncio.get_running_loop(), req.headers, lambda: fn(*args))

    # -- handlers --------------------------------------------------------------

    async def health(self, req: Request) -> Response:
        return json_response({"status": "OK"})

    async def metrics(self, req: Request) -> Response:
        """This process's families (``fma_launcher_rpc_seconds`` and the
        fleet gauges), the fleet rollup refreshed first on the executor (it
        polls the children over HTTP); a failed rollup leaves the gauges
        as they were."""
        try:
            await self._run(self.manager.fleet_rollup)
        except Exception:  # noqa: BLE001 — stale gauges beat a failed scrape
            logger.warning("fleet rollup during scrape failed", exc_info=True)
        return Response(200, exposition().encode(), "text/plain; version=0.0.4; charset=utf-8")

    async def traces(self, req: Request) -> Response:
        """The launcher's spans (create, restart, swap and each
        ``launcher.rpc``); each child exports its own at ``/v1/traces``,
        and the Chrome exports of several processes merge into one
        timeline."""
        status, body, ctype = tracing.export_http(
            req.query.get("format", "chrome"), trace_id=req.query.get("trace_id") or None,
            clear=req.query.get("clear") in ("1", "true"),
        )
        return Response(status, body.encode(), ctype)

    async def exemplars(self, req: Request) -> Response:
        """The fleet's SLO-violation exemplars, each with its trace id and
        the instance whose ``/v1/traces`` holds it."""
        try:
            fleet = await self._run(self.manager.fleet_rollup)
        except Exception as e:  # noqa: BLE001 — a degraded poll, not a 500
            raise HTTPError(503, str(e))
        return json_response({
            "slo_exemplars": fleet.get("slo_exemplars") or [],
            "slo_attainment": fleet.get("slo_attainment"),
            "slo_requests_violated": fleet.get("slo_requests_violated", 0),
        })

    async def faults_get(self, req: Request) -> Response:
        return json_response(faults.describe())

    async def faults_arm(self, req: Request) -> Response:
        """Arm the launcher's fault points (``launcher.rpc``,
        ``instance.spawn``) for tests and drills."""
        try:
            body = req.json()
        except ValueError:
            raise HTTPError(400, "invalid JSON body")
        spec = body.get("spec") if isinstance(body, dict) else None
        if not isinstance(spec, str) or not spec:
            raise HTTPError(400, "faults requires a 'spec' string")
        try:
            faults.arm_spec(spec)
        except ValueError as e:
            raise HTTPError(400, str(e))
        return json_response(faults.describe())

    async def faults_reset(self, req: Request) -> Response:
        faults.reset()
        return json_response(faults.describe())

    async def index(self, req: Request) -> Response:
        return json_response(
            {
                "name": "Multi-Instance Engine Management API (GPU)",
                "version": "2.0",
                "endpoints": {
                    "index": "GET /",
                    "health": "GET /health",
                    "metrics": "GET /metrics",
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
                    "migrate_instance": "POST /v2/vllm/instances/{instance_id}/migrate",
                    "drain_instance": "POST /v2/vllm/instances/{instance_id}/drain",
                    "attach_resident": "POST /v2/vllm/instances/{instance_id}/residents",
                    "residents_status": "GET /v2/vllm/instances/{instance_id}/residents",
                    "detach_resident": "DELETE /v2/vllm/instances/{instance_id}/residents",
                    "watch_instances": "GET /v2/vllm/instances/watch",
                    "faults": "GET/POST/DELETE /v2/vllm/faults",
                    "traces": "GET /v2/vllm/traces",
                    "exemplars": "GET /v2/vllm/exemplars",
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
            result = await self._traced(req, self.manager.create_instance, config, instance_id)
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
            result = await self._traced(req, self.manager.stop_instance, instance_id)
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
            result = await self._traced(req, self.manager.swap_instance, instance_id, model, checkpoint_dir)
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
    def _migrate_error(e: "MigrateFailed | DrainFailed") -> HTTPError:
        # the engines' 409 is a refusal with nothing displaced, kept as it
        # is so an orchestrator can act on it; 404 a destination that is
        # not there; 504 a timeout (the engines recovered already); any
        # other failure is the gateway's
        if e.status in (404, 409, 504):
            return HTTPError(e.status, str(e))
        if 400 <= e.status < 500:
            return HTTPError(400, str(e))
        return HTTPError(502, str(e))

    async def migrate_instance(self, req: Request) -> Response:
        """The live-migration verb: hand an instance's running and queued
        requests to a sibling serving the same model, fenced, the streams
        flowing on. Body: an optional ``dest_id`` (default the first
        sibling that serves the model)."""
        instance_id = req.match_info["instance_id"]
        try:
            body = req.json() if req.body.strip() else {}
        except ValueError:
            raise HTTPError(400, "invalid JSON body")
        dest_id = body.get("dest_id") if isinstance(body, dict) else None
        if dest_id is not None and (not isinstance(dest_id, str) or not dest_id):
            raise HTTPError(422, "dest_id must be a non-empty string")
        try:
            # the export and the import move KV for seconds: off the loop
            result = await self._traced(req, self.manager.migrate_instance, instance_id, dest_id)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except MigrateFailed as e:
            raise self._migrate_error(e)
        return json_response(result)

    async def drain_instance(self, req: Request) -> Response:
        """The drain verb: migrate passes until the instance has no live
        work, leaving it idle and safe to stop while every stream moved
        flows on through its proxies."""
        instance_id = req.match_info["instance_id"]
        try:
            result = await self._traced(req, self.manager.drain_instance, instance_id)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except (DrainFailed, MigrateFailed) as e:
            raise self._migrate_error(e)
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
            result = await self._traced(req, self.manager.prefetch_instance, instance_id, model, checkpoint_dir)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except PrefetchFailed as e:
            raise self._prefetch_error(e)
        return json_response(result)

    async def get_instance_prefetch(self, req: Request) -> Response:
        instance_id = req.match_info["instance_id"]
        try:
            result = await self._traced(req, self.manager.get_instance_prefetch, instance_id)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except PrefetchFailed as e:
            raise self._prefetch_error(e)
        return json_response(result)

    async def abort_instance_prefetch(self, req: Request) -> Response:
        instance_id = req.match_info["instance_id"]
        try:
            result = await self._traced(req, self.manager.abort_instance_prefetch, instance_id)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except PrefetchFailed as e:
            raise self._prefetch_error(e)
        return json_response(result)

    @staticmethod
    def _residents_error(e: ResidentsFailed) -> HTTPError:
        # the engine's 409 is its refusal (the cap, the budget, a live
        # variant), kept as such: a scheduler takes the swap path on it
        if e.status == 409:
            return HTTPError(409, str(e))
        if 400 <= e.status < 500:
            return HTTPError(400, str(e))
        return HTTPError(504 if e.status == 504 else 502, str(e))

    async def _residents_write(self, req: Request, verb) -> Response:
        """The attach and detach verbs' body and checks (the child's POST
        and DELETE /v1/residents)."""
        instance_id = req.match_info["instance_id"]
        try:
            body = req.json()
        except ValueError:
            raise HTTPError(400, "invalid JSON body")
        model = body.get("model") if isinstance(body, dict) else None
        if not isinstance(model, str) or not model:
            raise HTTPError(422, "residents requires a 'model' string")
        checkpoint_dir = body.get("checkpoint_dir") or ""
        if not isinstance(checkpoint_dir, str):
            raise HTTPError(422, "checkpoint_dir must be a string")
        try:
            result = await self._traced(req, verb, instance_id, model, checkpoint_dir)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except ResidentsFailed as e:
            raise self._residents_error(e)
        return json_response(result)

    async def attach_instance_resident(self, req: Request) -> Response:
        """The co-residency attach verb: a sibling's delta beside the
        instance's base, routed per request from then on."""
        return await self._residents_write(req, self.manager.attach_instance_resident)

    async def detach_instance_resident(self, req: Request) -> Response:
        return await self._residents_write(req, self.manager.detach_instance_resident)

    async def get_instance_residents(self, req: Request) -> Response:
        instance_id = req.match_info["instance_id"]
        try:
            result = await self._traced(req, self.manager.get_instance_residents, instance_id)
        except KeyError:
            raise HTTPError(404, f"Instance {instance_id} not found")
        except ResidentsFailed as e:
            raise self._residents_error(e)
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

    async def close(self) -> None:
        """Stop listening, drop the open connections (watch streams too),
        and stop every instance (the JAX launcher's on_shutdown)."""
        await super().close()
        await self._run(self.manager.stop_all_instances)

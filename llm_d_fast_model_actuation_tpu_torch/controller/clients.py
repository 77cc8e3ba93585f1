"""Controller-side clients for the three data-plane HTTP surfaces.

The dual-pods controller talks to (reference SURVEY.md §3.2 boundaries):
  (b) the requester stub's SPI (chip discovery, memory, readiness relay),
  (c) the launcher REST API (instance CRUDL),
  (d) the engine admin port (/sleep, /wake_up, /is_sleeping — the calls that
      actually move tensors).

`Transports` is the seam: the HTTP implementation resolves a Pod to its IP
and speaks HTTP/1.1 on asyncio streams (``launcher/http11.py:fetch``; the
JAX package's copy speaks aiohttp, which the card's machine lacks); tests
plug in-process fakes behind the same protocol. Every HTTP call is
latency-instrumented (fma_http_latency_seconds), matching the reference's
single doHTTP path (inference-server.go:2208-2253). The launcher handle
speaks the port launcher's ``/v2/vllm/instances``, whose create body
names the cards as ``gpu_uuids``.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, List, Protocol

from ..api import constants as C
from ..api import spi as spiapi
from ..launcher.http11 import fetch
from ..utils import tracing
from .metrics import HTTP_LATENCY


class InstanceNotFound(Exception):
    pass


class LauncherHandle(Protocol):
    async def create_named_instance(self, instance_id: str, config: Dict[str, Any]) -> Dict[str, Any]: ...
    async def list_instances(self) -> Dict[str, Any]: ...
    async def get_instance(self, instance_id: str) -> Dict[str, Any]: ...
    async def delete_instance(self, instance_id: str) -> Dict[str, Any]: ...
    async def health(self) -> bool: ...


class SpiHandle(Protocol):
    async def accelerators(self) -> List[str]: ...
    async def accelerator_memory(self) -> Dict[str, int]: ...
    async def become_ready(self) -> None: ...
    async def become_unready(self) -> None: ...


class EngineHandle(Protocol):
    async def is_sleeping(self) -> bool: ...
    async def sleep(self, level: int = 1) -> None: ...
    async def wake_up(self) -> None: ...
    async def healthy(self) -> bool: ...


class Transports(Protocol):
    def launcher(self, pod: Dict[str, Any]) -> LauncherHandle: ...
    def requester_spi(self, pod: Dict[str, Any]) -> SpiHandle: ...
    def engine_admin(self, pod: Dict[str, Any], port: int) -> EngineHandle: ...


def pod_ip(pod: Dict[str, Any]) -> str:
    ip = ((pod.get("status") or {}).get("podIP")) or ""
    if not ip:
        raise RuntimeError(f"pod {pod['metadata']['name']} has no IP yet")
    return ip


@contextlib.contextmanager
def observe_http_latency(purpose: str, method: str):
    """The fma_http_latency_seconds discipline around one
    controller-originated call."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        HTTP_LATENCY.labels(purpose=purpose, method=method).observe(
            time.monotonic() - t0
        )


class _Http:
    """One choke point for every controller-originated call: a connection
    per call, a 30 s limit, the latency histogram, and a
    ``controller.http`` span whose ``traceparent`` goes with the call, so
    the launcher's, the engine's and the SPI's side of the hop join the
    same trace."""

    async def call(self, method: str, url: str, purpose: str, json_body=None):
        with tracing.span("controller.http", purpose=purpose, method=method) as sp:
            tp = sp.traceparent()
            with observe_http_latency(purpose, method):
                status, body = await fetch(method, url, json_body, headers={"traceparent": tp} if tp else None,
                                           timeout=30.0)
            sp.set(status=status)
            return status, body


class HttpLauncherHandle:
    def __init__(self, http: _Http, base: str) -> None:
        self._http = http
        self._base = base

    async def create_named_instance(self, instance_id: str, config: Dict[str, Any]) -> Dict[str, Any]:
        status, body = await self._http.call(
            "PUT",
            f"{self._base}/v2/vllm/instances/{instance_id}",
            "createInstance",
            json_body=config,
        )
        if status not in (200, 201):
            raise RuntimeError(f"create instance {instance_id}: {status} {body[:200]}")
        return json.loads(body)

    async def list_instances(self) -> Dict[str, Any]:
        status, body = await self._http.call(
            "GET", f"{self._base}/v2/vllm/instances", "listInstances"
        )
        if status != 200:
            raise RuntimeError(f"list instances: {status}")
        return json.loads(body)

    async def get_instance(self, instance_id: str) -> Dict[str, Any]:
        status, body = await self._http.call(
            "GET", f"{self._base}/v2/vllm/instances/{instance_id}", "getInstance"
        )
        if status == 404:
            raise InstanceNotFound(instance_id)
        if status != 200:
            raise RuntimeError(f"get instance: {status}")
        return json.loads(body)

    async def delete_instance(self, instance_id: str) -> Dict[str, Any]:
        status, body = await self._http.call(
            "DELETE", f"{self._base}/v2/vllm/instances/{instance_id}", "deleteInstance"
        )
        if status == 404:
            raise InstanceNotFound(instance_id)
        if status != 200:
            raise RuntimeError(f"delete instance: {status}")
        return json.loads(body)

    async def health(self) -> bool:
        try:
            status, _ = await self._http.call(
                "GET", f"{self._base}/health", "launcherHealth"
            )
            return status == 200
        except Exception:
            return False


class HttpSpiHandle:
    def __init__(self, http: _Http, base: str) -> None:
        self._http = http
        self._base = base

    async def accelerators(self) -> List[str]:
        status, body = await self._http.call(
            "GET", self._base + spiapi.ACCELERATOR_QUERY_PATH, "queryAccelerators"
        )
        if status != 200:
            raise RuntimeError(f"accelerator query: {status}")
        return list(json.loads(body))

    async def accelerator_memory(self) -> Dict[str, int]:
        status, body = await self._http.call(
            "GET",
            self._base + spiapi.ACCELERATOR_MEMORY_QUERY_PATH,
            "queryAcceleratorMemory",
        )
        if status != 200:
            raise RuntimeError(f"memory query: {status}")
        return {k: int(v) for k, v in json.loads(body).items()}

    async def become_ready(self) -> None:
        status, _ = await self._http.call(
            "POST", self._base + spiapi.BECOME_READY_PATH, "becomeReady"
        )
        if status != 200:
            raise RuntimeError(f"become-ready: {status}")

    async def become_unready(self) -> None:
        status, _ = await self._http.call(
            "POST", self._base + spiapi.BECOME_UNREADY_PATH, "becomeUnready"
        )
        if status != 200:
            raise RuntimeError(f"become-unready: {status}")


class HttpEngineHandle:
    def __init__(self, http: _Http, base: str) -> None:
        self._http = http
        self._base = base

    async def is_sleeping(self) -> bool:
        status, body = await self._http.call(
            "GET", self._base + C.ENGINE_IS_SLEEPING_PATH, "querySleeping"
        )
        if status != 200:
            raise RuntimeError(f"is_sleeping: {status}")
        return bool(json.loads(body).get("is_sleeping"))

    async def sleep(self, level: int = 1) -> None:
        status, _ = await self._http.call(
            "POST", f"{self._base}{C.ENGINE_SLEEP_PATH}?level={level}", "sleep"
        )
        if status != 200:
            raise RuntimeError(f"sleep: {status}")

    async def wake_up(self) -> None:
        status, _ = await self._http.call(
            "POST", self._base + C.ENGINE_WAKE_PATH, "wakeUp"
        )
        if status != 200:
            raise RuntimeError(f"wake_up: {status}")

    async def healthy(self) -> bool:
        try:
            status, _ = await self._http.call(
                "GET", f"{self._base}/health", "engineHealth"
            )
            return status == 200
        except Exception:
            return False


class HttpTransports:
    """Production transports: Pod IP + well-known ports."""

    def __init__(self) -> None:
        self._http = _Http()

    def launcher(self, pod: Dict[str, Any]) -> LauncherHandle:
        port = (pod["metadata"].get("annotations") or {}).get(
            C.LAUNCHER_PORT_ANNOTATION, C.LAUNCHER_SERVICE_PORT
        )
        return HttpLauncherHandle(
            self._http, f"http://{pod_ip(pod)}:{port}"
        )

    def requester_spi(self, pod: Dict[str, Any]) -> SpiHandle:
        port = (pod["metadata"].get("annotations") or {}).get(
            C.ADMIN_PORT_ANNOTATION, C.ADMIN_PORT_DEFAULT
        )
        return HttpSpiHandle(self._http, f"http://{pod_ip(pod)}:{port}")

    def engine_admin(self, pod: Dict[str, Any], port: int) -> EngineHandle:
        return HttpEngineHandle(self._http, f"http://{pod_ip(pod)}:{port}")

"""Kube-backed ClusterStore: the InMemoryStore interface against a real
kube-apiserver.

The controllers are store-agnostic (store.py's contract). This backend
gives them the production deployment path the reference gets from
client-go + generated informers (SURVEY.md §2.1 L6):

  * **informer cache**: one list+watch loop per resource kind keeps a local
    cache; all reads (`get`/`list`) are synchronous against it, like
    informer Listers;
  * **read-your-writes**: every successful write applies the server's
    response object to the cache immediately (keyed newest-by-RV), so a
    reconcile step sees its own writes without waiting for the watch echo;
  * **writes** go straight to the apiserver with kube's optimistic
    concurrency (409 -> Conflict, 404 -> NotFound, 422 -> AlreadyExists
    mapping); `mutate` is get-fresh + apply + PUT with conflict retry;
  * **watch recovery**: a broken/expired watch re-lists and re-watches
    (resync), then resumes from the new list RV.

Writes use blocking HTTP (urllib) — one short apiserver round trip inside a
reconcile step, the same cost profile as the reference's direct kube writes
from worker goroutines. The JAX package's copy watches through aiohttp;
here the watch streams ride asyncio streams (``launcher/http11.py``), as
the card's machine has no aiohttp. Everything else is that copy's.
"""

from __future__ import annotations

import asyncio
import copy
import json
import logging
import ssl
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import urlencode

from ..launcher.http11 import body_chunks, open_request
from .store import (
    ADDED,
    AlreadyExists,
    Conflict,
    DELETED,
    MODIFIED,
    NotFound,
    labels_match,
)

logger = logging.getLogger(__name__)

#: kind -> (api prefix, plural, namespaced)
KIND_PATHS: Dict[str, Tuple[str, str, bool]] = {
    "Pod": ("/api/v1", "pods", True),
    "ConfigMap": ("/api/v1", "configmaps", True),
    "Node": ("/api/v1", "nodes", False),
    "InferenceServerConfig": (
        "/apis/fma.llm-d.ai/v1alpha1",
        "inferenceserverconfigs",
        True,
    ),
    "LauncherConfig": ("/apis/fma.llm-d.ai/v1alpha1", "launcherconfigs", True),
    "LauncherPopulationPolicy": (
        "/apis/fma.llm-d.ai/v1alpha1",
        "launcherpopulationpolicies",
        True,
    ),
}


def _rv_int(obj: Dict[str, Any]) -> int:
    try:
        return int((obj.get("metadata") or {}).get("resourceVersion", "0"))
    except (TypeError, ValueError):
        return 0


class KubeStore:
    def __init__(
        self,
        base_url: str,
        namespace: str,
        token: Optional[str] = None,
        token_file: Optional[str] = None,
        ca_file: Optional[str] = None,
        kinds: Optional[List[str]] = None,
        request_timeout_s: float = 15.0,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.namespace = namespace
        self._token = token
        #: bound service-account tokens rotate on disk (~1h TTL): re-read per
        #: request like client-go, never cache for the process lifetime
        self._token_file = token_file
        self._timeout = request_timeout_s
        self._ssl: Optional[ssl.SSLContext] = None
        if ca_file:
            self._ssl = ssl.create_default_context(cafile=ca_file)
        self.kinds = kinds or list(KIND_PATHS)
        self._cache: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
        self._lock = threading.RLock()
        self._watchers: List[Callable[[str, Dict[str, Any]], None]] = []
        self._tasks: List[asyncio.Task] = []
        self._stopping = False

    @classmethod
    def in_cluster(cls, namespace: Optional[str] = None, **kw) -> "KubeStore":
        """Standard in-cluster wiring (Downward API service account)."""
        import os

        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        sa = "/var/run/secrets/kubernetes.io/serviceaccount"
        if namespace is None:
            with open(f"{sa}/namespace") as f:
                namespace = f.read().strip()
        return cls(
            f"https://{host}:{port}",
            namespace,
            token_file=f"{sa}/token",
            ca_file=f"{sa}/ca.crt",
            **kw,
        )

    def _bearer(self) -> Optional[str]:
        if self._token_file:
            try:
                with open(self._token_file) as f:
                    return f.read().strip()
            except OSError:
                return self._token
        return self._token

    # -- paths ---------------------------------------------------------------

    def _collection_path(self, kind: str, namespace: Optional[str] = None) -> str:
        prefix, plural, namespaced = KIND_PATHS[kind]
        if namespaced:
            return f"{prefix}/namespaces/{namespace or self.namespace}/{plural}"
        return f"{prefix}/{plural}"

    def _object_path(self, kind: str, name: str, namespace: Optional[str] = None) -> str:
        return f"{self._collection_path(kind, namespace)}/{name}"

    # -- raw HTTP (blocking; used for writes and relists) ----------------------

    def _request(
        self, method: str, path: str, body: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        bearer = self._bearer()
        req = urllib.request.Request(
            self.base_url + path,
            method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={
                "Content-Type": "application/json",
                "Accept": "application/json",
                **({"Authorization": f"Bearer {bearer}"} if bearer else {}),
            },
        )
        # Per-call latency logging discipline: every kube write logs its
        # start time, latency, and the new resourceVersion — the reference
        # does this on every write path (e.g. inference-server.go:1448-1459)
        # and its benchmark log-parsing relies on it.
        start = time.monotonic()
        try:
            with urllib.request.urlopen(
                req, timeout=self._timeout, context=self._ssl
            ) as resp:
                out = json.loads(resp.read() or b"{}")
                if method != "GET" and logger.isEnabledFor(logging.DEBUG):
                    logger.debug(
                        "k8s %s %s latencySecs=%.4f rv=%s",
                        method,
                        path,
                        time.monotonic() - start,
                        (out.get("metadata") or {}).get("resourceVersion", ""),
                    )
                return out
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:500]
            if e.code == 404:
                raise NotFound(f"{method} {path}: {detail}") from e
            if e.code == 409:
                if "AlreadyExists" in detail or method == "POST":
                    raise AlreadyExists(f"{path}: {detail}") from e
                raise Conflict(f"{path}: {detail}") from e
            raise RuntimeError(f"{method} {path} -> {e.code}: {detail}") from e

    # -- cache + events --------------------------------------------------------

    def _apply(self, event: str, obj: Dict[str, Any]) -> bool:
        """Apply an event to the cache; returns False if it's stale."""
        m = obj.get("metadata") or {}
        key = (obj.get("kind", ""), m.get("namespace", ""), m.get("name", ""))
        with self._lock:
            cur = self._cache.get(key)
            if event == DELETED:
                if cur is not None and _rv_int(cur) > _rv_int(obj):
                    return False
                self._cache.pop(key, None)
                return True
            if cur is not None and _rv_int(cur) >= _rv_int(obj):
                return False
            self._cache[key] = copy.deepcopy(obj)
            return True

    def _emit(self, event: str, obj: Dict[str, Any]) -> None:
        snapshot = copy.deepcopy(obj)
        for w in list(self._watchers):
            w(event, snapshot)

    def subscribe(self, handler: Callable[[str, Dict[str, Any]], None]) -> Callable[[], None]:
        self._watchers.append(handler)
        return lambda: self._watchers.remove(handler)

    # -- list+watch loops ------------------------------------------------------

    async def start(self) -> None:
        # no baked-in auth header: tokens rotate, so each watch request
        # attaches a freshly read bearer
        for kind in self.kinds:
            rv = await asyncio.get_running_loop().run_in_executor(
                None, self._relist, kind
            )
            self._tasks.append(
                asyncio.get_running_loop().create_task(self._watch_loop(kind, rv))
            )

    async def stop(self) -> None:
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass

    def _relist(self, kind: str) -> str:
        body = self._request("GET", self._collection_path(kind))
        list_rv = (body.get("metadata") or {}).get("resourceVersion", "")
        try:
            list_rv_int = int(list_rv)
        except (TypeError, ValueError):
            list_rv_int = 0
        seen = set()
        for item in body.get("items", []):
            item.setdefault("kind", kind)
            m = item.get("metadata") or {}
            seen.add((kind, m.get("namespace", ""), m.get("name", "")))
            if self._apply(MODIFIED, item):
                self._emit(MODIFIED, item)
        # purge entries deleted while we weren't watching — but never ones
        # written AFTER the list was generated (their RV exceeds the list
        # RV; a concurrent create() on the loop thread must stay visible),
        # and only within the namespace the list actually covered
        # (cross-namespace writes are cached too but not listed here)
        _, _, namespaced = KIND_PATHS[kind]
        with self._lock:
            gone = [
                k
                for k, obj in self._cache.items()
                if k[0] == kind
                and (not namespaced or k[1] == self.namespace)
                and k not in seen
                and (not list_rv_int or _rv_int(obj) <= list_rv_int)
            ]
            removed = [self._cache.pop(k) for k in gone]
        for obj in removed:
            self._emit(DELETED, obj)
        return list_rv

    @staticmethod
    async def _iter_json_lines(chunks):
        """Newline-delimited JSON from a response's body chunks without a
        line-length limit — real Pod watch events routinely exceed 64KB
        (managedFields, env, volumes)."""
        buf = bytearray()
        async for chunk in chunks:
            buf.extend(chunk)
            while True:
                nl = buf.find(b"\n")
                if nl < 0:
                    break
                line = bytes(buf[:nl])
                del buf[: nl + 1]
                if line.strip():
                    yield json.loads(line)
        if buf.strip():
            yield json.loads(bytes(buf))

    async def _watch_loop(self, kind: str, rv: str) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopping:
            params = {"watch": "1"}
            if rv:
                params["resourceVersion"] = rv
            url = self.base_url + self._collection_path(kind) + "?" + urlencode(params)
            bearer = self._bearer()
            headers = {"Authorization": f"Bearer {bearer}"} if bearer else {}
            writer = None
            try:
                status, head, reader, writer = await open_request("GET", url, headers=headers, ssl=self._ssl)
                if status == 410:
                    raise RuntimeError("watch RV expired")
                if status != 200:
                    raise RuntimeError(f"watch answered {status}")
                async for ev in self._iter_json_lines(body_chunks(head, reader)):
                    obj = ev.get("object") or {}
                    etype = ev.get("type", MODIFIED)
                    if etype == "ERROR":
                        # apiserver reports expired RV as a 200 stream
                        # with an ERROR Status event, then closes
                        raise RuntimeError(
                            f"watch ERROR event: {obj.get('message', obj)}"
                        )
                    obj.setdefault("kind", kind)
                    if etype == "BOOKMARK":
                        rv = (obj.get("metadata") or {}).get(
                            "resourceVersion", rv
                        )
                        continue
                    rv = (obj.get("metadata") or {}).get("resourceVersion", rv)
                    if self._apply(etype, obj):
                        self._emit(etype, obj)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if self._stopping:
                    return
                logger.warning("watch %s broke (%s); relisting", kind, e)
            finally:
                if writer is not None:
                    writer.close()
            # any stream end (error, ERROR event, or server-side close)
            # throttles and relists before reconnecting: deletions missed
            # while disconnected must be purged and the RV refreshed
            if not self._stopping:
                await asyncio.sleep(0.5)
                try:
                    rv = await loop.run_in_executor(None, self._relist, kind)
                except Exception as e2:
                    logger.warning("relist %s failed: %s", kind, e2)
                    rv = ""

    # -- reads (sync, from cache) ---------------------------------------------

    def get(self, kind: str, namespace: str, name: str) -> Dict[str, Any]:
        with self._lock:
            obj = self._cache.get((kind, namespace, name))
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name}")
            return copy.deepcopy(obj)

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        try:
            return self.get(kind, namespace, name)
        except NotFound:
            return None

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        selector: Optional[Dict[str, str]] = None,
        predicate: Optional[Callable[[Dict[str, Any]], bool]] = None,
    ) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for (k, ns, _), obj in self._cache.items():
                if k != kind:
                    continue
                if namespace is not None and ns != namespace:
                    continue
                if selector and not labels_match(obj, selector):
                    continue
                if predicate and not predicate(obj):
                    continue
                out.append(copy.deepcopy(obj))
            return out

    def all_objects(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [copy.deepcopy(o) for o in self._cache.values()]

    # -- writes (blocking HTTP + immediate cache apply) ------------------------

    def create(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        kind = obj.get("kind") or ""
        ns = (obj.get("metadata") or {}).get("namespace") or None
        created = self._request("POST", self._collection_path(kind, ns), obj)
        created.setdefault("kind", kind)
        if self._apply(ADDED, created):
            self._emit(ADDED, created)
        return copy.deepcopy(created)

    def update(self, obj: Dict[str, Any], expect_rv: Optional[str] = None) -> Dict[str, Any]:
        kind = obj.get("kind") or ""
        name = obj["metadata"]["name"]
        ns = obj["metadata"].get("namespace") or None
        if expect_rv:
            obj = copy.deepcopy(obj)
            obj["metadata"]["resourceVersion"] = expect_rv
        updated = self._request("PUT", self._object_path(kind, name, ns), obj)
        updated.setdefault("kind", kind)
        gone = updated.get("metadata", {}).get("deletionTimestamp") and not updated.get(
            "metadata", {}
        ).get("finalizers")
        event = DELETED if gone else MODIFIED
        if self._apply(event, updated):
            self._emit(event, updated)
        return copy.deepcopy(updated)

    #: CRD kinds installed with a status subresource (deploy/crds/*.yaml):
    #: the apiserver STRIPS .status from main-resource writes for these, so
    #: status changes must go to the /status subresource path.
    STATUS_SUBRESOURCE_KINDS = frozenset(
        {"InferenceServerConfig", "LauncherConfig", "LauncherPopulationPolicy"}
    )

    def update_status(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """PUT the /status subresource (spec/metadata changes are ignored
        by the server on this path, mirroring kube semantics)."""
        kind = obj.get("kind") or ""
        name = obj["metadata"]["name"]
        ns = obj["metadata"].get("namespace") or None
        updated = self._request(
            "PUT", self._object_path(kind, name, ns) + "/status", obj
        )
        updated.setdefault("kind", kind)
        if self._apply(MODIFIED, updated):
            self._emit(MODIFIED, updated)
        return copy.deepcopy(updated)

    def mutate(
        self,
        kind: str,
        namespace: str,
        name: str,
        fn: Callable[[Dict[str, Any]], Optional[Dict[str, Any]]],
        retries: int = 8,
    ) -> Dict[str, Any]:
        for _ in range(retries):
            # read FRESH from the server: the cache may trail other writers
            cur = self._request("GET", self._object_path(kind, name, namespace))
            cur.setdefault("kind", kind)
            new = fn(copy.deepcopy(cur))
            if new is None:
                return cur
            try:
                if kind in self.STATUS_SUBRESOURCE_KINDS:
                    # split the write the way the apiserver demands: the
                    # main PUT drops .status, the /status PUT drops the rest
                    def strip(o):
                        return {k: v for k, v in o.items() if k != "status"}

                    out = new
                    if strip(new) != strip(cur):
                        out = self.update(new)
                    if new.get("status") != cur.get("status"):
                        merged = copy.deepcopy(out)
                        merged["status"] = new.get("status")
                        out = self.update_status(merged)
                    return out
                return self.update(new)
            except Conflict:
                continue
        raise Conflict(f"mutate {kind} {namespace}/{name}: retries exhausted")

    def delete(
        self,
        kind: str,
        namespace: str,
        name: str,
        expect_uid: Optional[str] = None,
        expect_rv: Optional[str] = None,
    ) -> None:
        body: Dict[str, Any] = {}
        pre: Dict[str, Any] = {}
        if expect_uid:
            pre["uid"] = expect_uid
        if expect_rv:
            pre["resourceVersion"] = expect_rv
        if pre:
            body["preconditions"] = pre
        result = self._request(
            "DELETE", self._object_path(kind, name, namespace), body or None
        )
        # kube returns the (terminating or final) object, or a Status
        if result.get("kind") not in ("Status", None):
            result.setdefault("kind", kind)
            terminating = result.get("metadata", {}).get("finalizers") and result.get(
                "metadata", {}
            ).get("deletionTimestamp")
            event = MODIFIED if terminating else DELETED
            if self._apply(event, result):
                self._emit(event, result)
        else:
            with self._lock:
                obj = self._cache.pop((kind, namespace, name), None)
            if obj is not None:
                self._emit(DELETED, obj)

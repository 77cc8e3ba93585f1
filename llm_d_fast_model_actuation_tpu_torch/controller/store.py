"""A kube-API-shaped in-memory ACID object store with watch: the JAX
package's ``controller/store.py``, copied.

The reference externalizes all controller state to the Kubernetes API (the
"ACID store", docs/dual-pods.md:396-404) and recovers from restarts by
re-reading it. This store reproduces the API semantics the controllers rely
on:

  * objects are JSON-shaped dicts with `kind` + `metadata` (name, namespace,
    uid, resourceVersion, labels, annotations, finalizers, deletionTimestamp);
  * **optimistic concurrency**: update/delete take optional UID and
    resourceVersion preconditions and raise Conflict on mismatch;
  * **finalizers**: delete marks `deletionTimestamp` and the object stays
    (Terminating) until its finalizer list empties;
  * **watch**: subscribers receive (ADDED | MODIFIED | DELETED, obj) events
    in commit order.

A production deployment implements this same interface against the real kube
API; every consumer (controllers, populator) is store-agnostic.
"""

from __future__ import annotations

import copy
import threading
import time
import uuid as uuidlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class NotFound(Exception):
    pass


class Conflict(Exception):
    """UID/resourceVersion precondition failed or RV is stale."""


class AlreadyExists(Exception):
    pass


def _key(kind: str, namespace: str, name: str) -> Tuple[str, str, str]:
    return (kind, namespace, name)


def meta(obj: Dict[str, Any]) -> Dict[str, Any]:
    return obj.setdefault("metadata", {})


def labels_match(obj: Dict[str, Any], selector: Dict[str, str]) -> bool:
    lab = (obj.get("metadata") or {}).get("labels") or {}
    return all(lab.get(k) == v for k, v in selector.items())


class InMemoryStore:
    def __init__(self) -> None:
        self._objs: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
        self._rv = 0
        self._lock = threading.RLock()
        self._watchers: List[Callable[[str, Dict[str, Any]], None]] = []

    # -- internals -----------------------------------------------------------

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _emit(self, event: str, obj: Dict[str, Any]) -> None:
        snapshot = copy.deepcopy(obj)
        for w in list(self._watchers):
            w(event, snapshot)

    # -- watch ---------------------------------------------------------------

    def subscribe(self, handler: Callable[[str, Dict[str, Any]], None]) -> Callable[[], None]:
        """Register a synchronous event handler; returns an unsubscribe fn.
        Handlers run inside the commit (keep them cheap: enqueue only)."""
        self._watchers.append(handler)
        return lambda: self._watchers.remove(handler)

    # -- reads ---------------------------------------------------------------

    def get(self, kind: str, namespace: str, name: str) -> Dict[str, Any]:
        with self._lock:
            obj = self._objs.get(_key(kind, namespace, name))
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
            for (k, ns, _), obj in self._objs.items():
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

    # -- writes --------------------------------------------------------------

    def create(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        obj = copy.deepcopy(obj)
        m = meta(obj)
        kind = obj.get("kind") or ""
        if not kind or not m.get("name"):
            raise ValueError("object needs kind and metadata.name")
        ns = m.setdefault("namespace", "")
        with self._lock:
            key = _key(kind, ns, m["name"])
            if key in self._objs:
                raise AlreadyExists(f"{kind} {ns}/{m['name']}")
            m.setdefault("uid", str(uuidlib.uuid4()))
            m["resourceVersion"] = self._next_rv()
            m.setdefault("creationTimestamp", time.time())
            m.setdefault("generation", 1)
            self._objs[key] = obj
            self._emit(ADDED, obj)
            return copy.deepcopy(obj)

    def update(
        self,
        obj: Dict[str, Any],
        expect_rv: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Replace the stored object. If the caller's object carries a
        resourceVersion (or expect_rv is given), it must match (optimistic
        concurrency, as kube enforces)."""
        obj = copy.deepcopy(obj)
        m = meta(obj)
        kind = obj.get("kind") or ""
        ns = m.get("namespace", "")
        with self._lock:
            key = _key(kind, ns, m["name"])
            cur = self._objs.get(key)
            if cur is None:
                raise NotFound(f"{kind} {ns}/{m['name']}")
            cur_rv = cur["metadata"]["resourceVersion"]
            want_rv = expect_rv or m.get("resourceVersion")
            if want_rv and want_rv != cur_rv:
                raise Conflict(
                    f"{kind} {ns}/{m['name']}: rv {want_rv} != {cur_rv}"
                )
            if m.get("uid") and m["uid"] != cur["metadata"]["uid"]:
                raise Conflict(f"{kind} {ns}/{m['name']}: uid mismatch")
            # spec changes bump generation (kube does this for CRs with
            # status subresources; good enough for our consumers)
            if obj.get("spec") != cur.get("spec"):
                m["generation"] = int(cur["metadata"].get("generation", 1)) + 1
            else:
                m["generation"] = cur["metadata"].get("generation", 1)
            m["uid"] = cur["metadata"]["uid"]
            m["creationTimestamp"] = cur["metadata"].get("creationTimestamp")
            if cur["metadata"].get("deletionTimestamp") is not None:
                m["deletionTimestamp"] = cur["metadata"]["deletionTimestamp"]
            m["resourceVersion"] = self._next_rv()
            self._objs[key] = obj
            # a finalizer-clearing update on a terminating object completes
            # the deletion
            if (
                m.get("deletionTimestamp") is not None
                and not m.get("finalizers")
            ):
                del self._objs[key]
                self._emit(DELETED, obj)
                return copy.deepcopy(obj)
            self._emit(MODIFIED, obj)
            return copy.deepcopy(obj)

    def mutate(
        self,
        kind: str,
        namespace: str,
        name: str,
        fn: Callable[[Dict[str, Any]], Optional[Dict[str, Any]]],
        retries: int = 8,
    ) -> Dict[str, Any]:
        """Read-modify-write with automatic Conflict retry. `fn` mutates (or
        returns) the object; return None from fn to abort (returns current)."""
        for _ in range(retries):
            cur = self.get(kind, namespace, name)
            new = fn(copy.deepcopy(cur))
            if new is None:
                return cur
            try:
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
        """Kube delete semantics: precondition check; with finalizers the
        object enters Terminating (deletionTimestamp set) and is removed only
        once finalizers empty."""
        with self._lock:
            key = _key(kind, namespace, name)
            cur = self._objs.get(key)
            if cur is None:
                raise NotFound(f"{kind} {namespace}/{name}")
            m = cur["metadata"]
            if expect_uid and m["uid"] != expect_uid:
                raise Conflict(f"uid precondition failed for {namespace}/{name}")
            if expect_rv and m["resourceVersion"] != expect_rv:
                raise Conflict(f"rv precondition failed for {namespace}/{name}")
            if m.get("finalizers"):
                if m.get("deletionTimestamp") is None:
                    m["deletionTimestamp"] = time.time()
                    m["resourceVersion"] = self._next_rv()
                    self._emit(MODIFIED, cur)
                return
            del self._objs[key]
            # kube assigns deletion a fresh RV — watch consumers resuming
            # from a list RV must see deletions committed after the list
            m["resourceVersion"] = self._next_rv()
            self._emit(DELETED, cur)

    # -- conveniences --------------------------------------------------------

    def all_objects(self) -> Iterable[Dict[str, Any]]:
        with self._lock:
            return [copy.deepcopy(o) for o in self._objs.values()]

"""ConfigMap-backed card allocation for the hardware-less test-requester:
the JAX package's ``requester/allocation.py``, copied (its ConfigMap,
names and loop are the wire's).

The reference's test-requester emulates scheduler/device-plugin contention
with an optimistic-concurrency ConfigMap loop
(cmd/test-requester/gpu-allocation.go:41-257): every requester pod claims N
accelerators on its node from a shared ConfigMap, retrying on write
conflicts, and releases its claims on exit. This is what makes multi-
requester contention on one node testable without hardware.

The ``chip-allocations`` ConfigMap holds, per node, a JSON map
``card id -> holder pod name``. `ChipAllocator.allocate` CAS-loops:

  1. read the ConfigMap fresh (never from a cache),
  2. pick the lexically-first free chips (deterministic given a snapshot),
  3. write back with a resourceVersion precondition — a concurrent claimer
     triggers Conflict and we re-read (their claim now visible).

Losing a race therefore never double-books: the loser sees the winner's
claim on retry and picks other chips, or waits for capacity.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

ALLOCATIONS_CONFIGMAP = "chip-allocations"


class OutOfChips(TimeoutError):
    """Not enough free chips appeared before the deadline."""


class ChipAllocator:
    def __init__(
        self,
        store: Any,  # KubeStore-compatible: try_get/create/mutate (fresh reads)
        namespace: str,
        node: str,
        holder: str,  # this requester pod's name
    ) -> None:
        self.store = store
        self.namespace = namespace
        self.node = node
        self.holder = holder

    # -- ConfigMap plumbing --------------------------------------------------

    def _ensure_cm(self) -> None:
        from ..controller.store import AlreadyExists

        if self.store.try_get("ConfigMap", self.namespace, ALLOCATIONS_CONFIGMAP):
            return
        try:
            self.store.create(
                {
                    "kind": "ConfigMap",
                    "metadata": {
                        "name": ALLOCATIONS_CONFIGMAP,
                        "namespace": self.namespace,
                    },
                    "data": {},
                }
            )
        except AlreadyExists:
            pass

    @staticmethod
    def _node_claims(cm: Dict[str, Any], node: str) -> Dict[str, str]:
        raw = (cm.get("data") or {}).get(node) or "{}"
        try:
            return {str(k): str(v) for k, v in json.loads(raw).items()}
        except json.JSONDecodeError:
            return {}

    # -- the allocation loop -------------------------------------------------

    def allocate(
        self,
        count: int,
        pool: List[str],
        timeout_s: float = 60.0,
        poll_s: float = 0.2,
        should_stop=None,
    ) -> List[str]:
        """Claim `count` chips of `pool` on this node; blocks (polling) while
        capacity is taken by other holders. Idempotent: existing claims by
        this holder count toward `count` (crash-restart safe).
        `should_stop()` (e.g. a SIGTERM flag) aborts the wait promptly."""
        self._ensure_cm()
        deadline = time.monotonic() + timeout_s
        while True:
            if should_stop is not None and should_stop():
                raise OutOfChips(f"{self.holder}: allocation aborted (stopping)")
            got: Optional[List[str]] = None

            def apply(cm: Dict[str, Any]) -> Optional[Dict[str, Any]]:
                nonlocal got
                claims = self._node_claims(cm, self.node)
                mine = sorted(c for c, h in claims.items() if h == self.holder)
                if len(mine) >= count:
                    got = mine[:count]
                    return None  # nothing to write
                free = sorted(
                    c for c in pool if c not in claims
                )
                need = count - len(mine)
                if len(free) < need:
                    got = None
                    return None  # not enough capacity in THIS snapshot
                take = free[:need]
                for c in take:
                    claims[c] = self.holder
                cm.setdefault("data", {})[self.node] = json.dumps(
                    claims, sort_keys=True
                )
                got = mine + take
                return cm

            # mutate = fresh-read + rv-preconditioned write + conflict retry
            self.store.mutate(
                "ConfigMap", self.namespace, ALLOCATIONS_CONFIGMAP, apply
            )
            if got is not None:
                logger.info(
                    "allocated %s on %s for %s", got, self.node, self.holder
                )
                return got
            if time.monotonic() > deadline:
                raise OutOfChips(
                    f"{self.holder}: {count} chip(s) on {self.node} not free "
                    f"within {timeout_s}s"
                )
            time.sleep(poll_s)

    def release(self) -> None:
        """Drop every claim held by this holder (exit path)."""

        def apply(cm: Dict[str, Any]) -> Optional[Dict[str, Any]]:
            claims = self._node_claims(cm, self.node)
            kept = {c: h for c, h in claims.items() if h != self.holder}
            if kept == claims:
                return None
            cm.setdefault("data", {})[self.node] = json.dumps(
                kept, sort_keys=True
            )
            return cm

        try:
            self.store.mutate(
                "ConfigMap", self.namespace, ALLOCATIONS_CONFIGMAP, apply
            )
            logger.info("released claims of %s on %s", self.holder, self.node)
        except Exception:
            logger.exception("release failed (claims will leak until GC)")

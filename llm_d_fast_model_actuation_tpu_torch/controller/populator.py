"""Launcher-populator: proactive launcher Pod population per policy.

The JAX package's ``controller/populator.py``, copied: it has no TPU
notion (a launcher Pod is node-scoped, whatever its accelerators). A
re-design of `pkg/controller/launcher-populator/` (2,960 LoC Go): a
two-stage asyncio controller:

  * a single **digest worker** — the sole writer of the digested policy
    (node x LauncherConfig -> desired count), fed by LPP/LC/Node events;
    user errors (missing/invalid LC) digest to HANDS_OFF and are reported on
    the LPP/LC `.status.errors` (this controller is their sole status writer);
  * **key workers** — per-(node, LC) reconciliation: categorize launchers
    bound / live-unbound-current / stale (template-hash drift) / deleting;
    delete stale and excess unbound (never bound ones) with UID+RV
    preconditions; create the difference from the node-specialized template.

Anti-stale-cache **pending expectations** (pending_expectations.go:31-157):
created/deleted pod UIDs are remembered until observed, with a timeout
fallback to a fresh list. Phase metrics (bound/unbound/stuck_scheduling/
stuck_starting/stale) mirror metrics.go:36-304, with event-driven
re-reconcile scheduled at the next phase-flip instant.
"""

from __future__ import annotations

import asyncio
import secrets
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Optional, Set, Tuple

from ..api import constants as C
from ..api.types import (
    EnhancedNodeSelector,
    LauncherConfig,
    LauncherPopulationPolicy,
)
from ..utils.syncbarrier import KnowsProcessedSync
from ..utils.hashing import sha256_hex, template_hash
from . import metrics as M
from .store import Conflict, InMemoryStore, NotFound

logger = logging.getLogger(__name__)

HANDS_OFF = -1  # user error: leave this (node, lc) cell alone


# --------------------------------------------------------------------------
# pending expectations
# --------------------------------------------------------------------------

SATISFIED = "Satisfied"
WAITING = "Waiting"
TIMED_OUT = "TimedOut"


class PendingExpectations:
    """Track pod UIDs we created/deleted until the cache reflects them."""

    def __init__(self, timeout_s: float = 5.0) -> None:
        self.timeout_s = timeout_s
        self._created: Dict[str, float] = {}
        self._deleted: Dict[str, float] = {}

    def expect_creation(self, uid: str) -> None:
        self._created[uid] = time.monotonic()

    def expect_deletion(self, uid: str) -> None:
        self._deleted[uid] = time.monotonic()

    def check(self, present_uids: Set[str]) -> str:
        now = time.monotonic()
        for uid in list(self._created):
            if uid in present_uids:
                del self._created[uid]
        for uid in list(self._deleted):
            if uid not in present_uids:
                del self._deleted[uid]
        pending = list(self._created.values()) + list(self._deleted.values())
        if not pending:
            return SATISFIED
        if any(now - t > self.timeout_s for t in pending):
            return TIMED_OUT
        return WAITING

    def reset(self) -> None:
        self._created.clear()
        self._deleted.clear()


# --------------------------------------------------------------------------
# digested policy
# --------------------------------------------------------------------------


@dataclass
class LcDigest:
    obj: Optional[LauncherConfig] = None
    template_error: str = ""
    template_hash: str = ""


@dataclass
class DigestEntry:
    desired: int = 0
    lpps: Set[str] = field(default_factory=set)


@dataclass
class LppDigest:
    """Cached parse of one LPP + the node names its selector matches —
    the state that makes per-event incremental row rebuilds possible
    (digest-updater.go keeps the same association)."""

    lpp: LauncherPopulationPolicy
    matched: Set[str] = field(default_factory=set)


class DigestedPolicy:
    """node -> lc -> DigestEntry; plus per-LC digests. Single writer (the
    digest worker); key workers read value snapshots."""

    def __init__(self) -> None:
        self.digest: Dict[str, Dict[str, DigestEntry]] = {}
        self.lcs: Dict[str, LcDigest] = {}

    def snapshot_for_key(self, node: str, lc: str) -> Tuple[int, Optional[LcDigest]]:
        entry = (self.digest.get(node) or {}).get(lc)
        return (entry.desired if entry else 0), self.lcs.get(lc)

    def keys(self) -> List[Tuple[str, str]]:
        return [(n, lc) for n, row in self.digest.items() for lc in row]


def node_matches(node: Dict[str, Any], sel: EnhancedNodeSelector) -> bool:
    labels = (node.get("metadata") or {}).get("labels") or {}
    if not all(labels.get(k) == v for k, v in sel.match_labels.items()):
        return False
    alloc = (node.get("status") or {}).get("allocatable") or {}
    for res, rng in sel.allocatable_resources.items():
        if res not in alloc:
            return False
        try:
            if not rng.matches(alloc[res]):
                return False
        except ValueError:
            return False
    return True


# --------------------------------------------------------------------------
# the controller
# --------------------------------------------------------------------------


@dataclass
class PopulatorConfig:
    namespace: str = ""
    expectation_timeout_s: float = 5.0
    stuck_scheduling_threshold_s: float = 120.0
    stuck_starting_threshold_s: float = 450.0
    #: deployment glue: make a created launcher Pod actually run (tests)
    launcher_runtime: Optional[Callable[[Dict[str, Any]], Awaitable[None]]] = None


class Populator:
    def __init__(
        self, store: InMemoryStore, cfg: Optional[PopulatorConfig] = None
    ) -> None:
        self.store = store
        self.cfg = cfg or PopulatorConfig()
        self.policy = DigestedPolicy()
        self._lpp_digests: Dict[str, LppDigest] = {}
        self._digest_queue: asyncio.Queue = asyncio.Queue()
        self._key_queue: asyncio.Queue = asyncio.Queue()
        self._expectations: Dict[Tuple[str, str], PendingExpectations] = {}
        self._phase_timers: Dict[Tuple[str, str], asyncio.TimerHandle] = {}
        self._unsub: Optional[Callable[[], None]] = None
        self._tasks: List[asyncio.Task] = []
        self._stopping = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._inflight = 0
        self._active_keys: Set[Tuple[str, str]] = set()
        #: fires when every initially-present LC/LPP/Node had a digest pass
        self.initial_sync = KnowsProcessedSync()

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._unsub = self.store.subscribe(self._on_event)
        self._tasks.append(self._loop.create_task(self._digest_worker()))
        for _ in range(4):
            self._tasks.append(self._loop.create_task(self._key_worker()))
        # initial digest of existing objects
        for obj in self.store.all_objects():
            self._route(obj)
        self.initial_sync.arm()

    async def stop(self) -> None:
        self._stopping = True
        if self._unsub:
            self._unsub()
        for timer in self._phase_timers.values():
            timer.cancel()
        self._phase_timers.clear()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass

    async def quiesce(self, timeout: float = 20.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if (
                self._inflight == 0
                and self._digest_queue.empty()
                and self._key_queue.empty()
            ):
                await asyncio.sleep(0.05)
                if (
                    self._inflight == 0
                    and self._digest_queue.empty()
                    and self._key_queue.empty()
                ):
                    return
            await asyncio.sleep(0.02)
        raise TimeoutError("populator did not quiesce")

    # -- event routing -------------------------------------------------------

    def _on_event(self, event: str, obj: Dict[str, Any]) -> None:
        if self._loop is None:
            return
        self._loop.call_soon_threadsafe(self._route, obj)

    def _route(self, obj: Dict[str, Any]) -> None:
        kind = obj.get("kind")
        name = (obj.get("metadata") or {}).get("name", "")
        if kind in (LauncherPopulationPolicy.KIND, LauncherConfig.KIND, "Node"):
            self.initial_sync.note_pending((kind, name))
            self._digest_queue.put_nowait((kind, name))
        elif kind == "Pod":
            lab = (obj.get("metadata") or {}).get("labels") or {}
            if lab.get(C.COMPONENT_LABEL) == C.LAUNCHER_COMPONENT:
                node = lab.get(C.NODE_NAME_LABEL) or (obj.get("spec") or {}).get(
                    "nodeName", ""
                )
                lc = lab.get(C.LAUNCHER_CONFIG_NAME_LABEL, "")
                if lc:
                    self._key_queue.put_nowait((node, lc))

    # -- digest stage --------------------------------------------------------

    async def _digest_worker(self) -> None:
        while not self._stopping:
            kind, name = await self._digest_queue.get()
            self._inflight += 1
            try:
                # digests do blocking HTTP status writes + O(nodes x LPPs)
                # recompute: keep the event loop free
                if kind == LauncherConfig.KIND:
                    await asyncio.to_thread(self._digest_lc, name)
                elif kind == LauncherPopulationPolicy.KIND:
                    await asyncio.to_thread(self._digest_lpp, name)
                else:  # Node
                    await asyncio.to_thread(self._digest_node, name)
            except Exception:
                logger.exception("digest of %s %s failed", kind, name)
            finally:
                self.initial_sync.note_processed((kind, name))
                self._inflight -= 1
                self._digest_queue.task_done()

    # Incremental digesting (the reference's digest-updater.go:42-287
    # design): each event rebuilds only the (node, lc) rows it can affect —
    # an LC touches the rows that reference it, an LPP touches its old+new
    # matched node sets, a Node touches its own row. The full recompute
    # survives only as the crash-consistency fallback.

    def _digest_lc(self, name: str) -> None:
        obj = self.store.try_get(LauncherConfig.KIND, self.cfg.namespace, name)
        if obj is None:
            self.policy.lcs.pop(name, None)
        else:
            self._digest_lc_obj(name, obj)
            err = self.policy.lcs[name].template_error
            self._write_status(LauncherConfig.KIND, name, [err] if err else [], obj)
        # only rows that reference this LC change (its desired/HANDS_OFF)
        affected = {
            node for node, row in self.policy.digest.items() if name in row
        }
        # plus rows of LPPs that reference it but had nothing digested yet
        for lname, ld in self._lpp_digests.items():
            if any(
                cfl.launcher_config_name == name
                for cfl in ld.lpp.spec.count_for_launcher
            ):
                affected |= ld.matched
                self._validate_lpp_status(lname)
        self._rebuild_rows(affected)
        # the LC itself changed (template hash / validity): its keys must
        # re-reconcile even when the digest cell value is unchanged —
        # template drift replaces stale unbound launchers
        self._enqueue_keys({(node, name) for node in affected})

    def _digest_lpp(self, name: str) -> None:
        obj = self.store.try_get(
            LauncherPopulationPolicy.KIND, self.cfg.namespace, name
        )
        old = self._lpp_digests.pop(name, None)
        affected: Set[str] = set(old.matched) if old else set()
        if obj is not None:
            lpp = LauncherPopulationPolicy.from_dict(obj)
            matched = {
                n["metadata"]["name"]
                for n in self.store.list("Node")
                if node_matches(n, lpp.spec.enhanced_node_selector)
            }
            self._lpp_digests[name] = LppDigest(lpp=lpp, matched=matched)
            affected |= matched
        self._rebuild_rows(affected)
        self._validate_lpp_status(name)

    def _validate_lpp_status(self, name: str) -> None:
        obj = self.store.try_get(
            LauncherPopulationPolicy.KIND, self.cfg.namespace, name
        )
        if obj is not None:
            lpp = LauncherPopulationPolicy.from_dict(obj)
            errors = []
            for cfl in lpp.spec.count_for_launcher:
                lcd = self.policy.lcs.get(cfl.launcher_config_name)
                if lcd is None or lcd.obj is None:
                    errors.append(
                        f"LauncherConfig {cfl.launcher_config_name} not found"
                    )
                elif lcd.template_error:
                    errors.append(
                        f"LauncherConfig {cfl.launcher_config_name}: {lcd.template_error}"
                    )
            self._write_status(LauncherPopulationPolicy.KIND, name, errors, obj)

    def _digest_node(self, name: str) -> None:
        obj = self.store.try_get("Node", "", name)
        for ld in self._lpp_digests.values():
            if obj is not None and node_matches(
                obj, ld.lpp.spec.enhanced_node_selector
            ):
                ld.matched.add(name)
            else:
                ld.matched.discard(name)
        self._rebuild_rows({name})

    def _rebuild_rows(self, nodes: Set[str]) -> None:
        """Recompute the digest rows for exactly `nodes` from the cached LPP
        digests, then enqueue every (node, lc) key whose cell appeared,
        changed, or vanished."""
        changed: Set[Tuple[str, str]] = set()
        for node in nodes:
            row: Dict[str, DigestEntry] = {}
            for lname, ld in self._lpp_digests.items():
                if node not in ld.matched:
                    continue
                for cfl in ld.lpp.spec.count_for_launcher:
                    entry = row.setdefault(cfl.launcher_config_name, DigestEntry())
                    entry.lpps.add(lname)
                    lcd = self.policy.lcs.get(cfl.launcher_config_name)
                    if lcd is None or lcd.obj is None or lcd.template_error:
                        entry.desired = HANDS_OFF
                    elif entry.desired != HANDS_OFF:
                        # all LPPs jointly define max(count)
                        entry.desired = max(entry.desired, cfl.launcher_count)
            old_row = self.policy.digest.get(node) or {}
            for lc in set(old_row) | set(row):
                a, b = old_row.get(lc), row.get(lc)
                if a is None or b is None or a.desired != b.desired or a.lpps != b.lpps:
                    changed.add((node, lc))
            if row:
                self.policy.digest[node] = row
            else:
                self.policy.digest.pop(node, None)
        self._enqueue_keys(changed)

    def _enqueue_keys(self, keys: Set[Tuple[str, str]]) -> None:
        # digests run off-loop (to_thread): hop through call_soon_threadsafe
        # when not on the loop
        try:
            on_loop = asyncio.get_running_loop() is self._loop
        except RuntimeError:
            on_loop = False
        for key in keys:
            if on_loop or self._loop is None:
                self._key_queue.put_nowait(key)
            else:
                self._loop.call_soon_threadsafe(self._key_queue.put_nowait, key)

    def _digest_lc_obj(self, name: str, obj: Dict[str, Any]) -> None:
        lc = LauncherConfig.from_dict(obj)
        err, thash = "", ""
        try:
            tpl, _ = build_launcher_template(lc)
            thash = template_hash(tpl)
        except Exception as e:
            err = f"invalid pod template: {e}"
        self.policy.lcs[name] = LcDigest(obj=lc, template_error=err, template_hash=thash)

    def _write_status(
        self, kind: str, name: str, errors: List[str], current: Dict[str, Any]
    ) -> None:
        gen = int((current.get("metadata") or {}).get("generation", 1))

        def apply(obj: Dict[str, Any]) -> Optional[Dict[str, Any]]:
            status = obj.setdefault("status", {})
            want = {"observedGeneration": gen}
            if errors:
                want["errors"] = errors
            if status == want:
                return None
            obj["status"] = want
            return obj

        try:
            self.store.mutate(kind, self.cfg.namespace, name, apply)
        except NotFound:
            pass

    # -- key stage -----------------------------------------------------------

    async def _key_worker(self) -> None:
        while not self._stopping:
            node, lc = await self._key_queue.get()
            key = (node, lc)
            # Per-key serialization: two workers reconciling the same
            # (node, lc) would both count the same world and double-create
            # across the awaits inside _reconcile_key. Defer to the holder
            # and run again once it is done.
            if key in self._active_keys:
                self._requeue_later(node, lc, 0.05)
                self._key_queue.task_done()
                continue
            self._active_keys.add(key)
            self._inflight += 1
            try:
                await self._reconcile_key(node, lc)
            except Exception:
                logger.exception("reconcile (%s, %s) failed", node, lc)
            finally:
                self._active_keys.discard(key)
                self._inflight -= 1
                self._key_queue.task_done()

    def _list_launchers(self, node: str, lc: str) -> List[Dict[str, Any]]:
        return self.store.list(
            "Pod",
            self.cfg.namespace,
            selector={
                C.COMPONENT_LABEL: C.LAUNCHER_COMPONENT,
                C.LAUNCHER_CONFIG_NAME_LABEL: lc,
            },
            predicate=lambda p: (p.get("spec") or {}).get("nodeName") == node,
        )

    async def _reconcile_key(self, node: str, lc_name: str) -> None:
        desired, lcd = self.policy.snapshot_for_key(node, lc_name)
        pods = self._list_launchers(node, lc_name)
        self._record_phases(node, lc_name, pods, lcd)

        if desired == HANDS_OFF:
            return  # user error: leave the world alone

        exp = self._expectations.setdefault(
            (node, lc_name), PendingExpectations(self.cfg.expectation_timeout_s)
        )
        state = exp.check({p["metadata"]["uid"] for p in pods})
        if state == WAITING:
            self._requeue_later(node, lc_name, 0.1)
            return
        if state == TIMED_OUT:
            exp.reset()
            pods = self._list_launchers(node, lc_name)  # fresh list

        bound: List[Dict[str, Any]] = []
        live_unbound: List[Dict[str, Any]] = []
        stale: List[Dict[str, Any]] = []
        deleting = 0
        for p in pods:
            m = p["metadata"]
            if m.get("deletionTimestamp") is not None:
                deleting += 1
                continue
            if C.REQUESTER_ANNOTATION in (m.get("annotations") or {}):
                bound.append(p)
            elif (
                lcd is not None
                and (m.get("annotations") or {}).get(C.LAUNCHER_TEMPLATE_HASH_ANNOTATION)
                == lcd.template_hash
            ):
                live_unbound.append(p)
            else:
                stale.append(p)

        # delete stale unbound and excess unbound (never bound ones)
        to_delete = list(stale)
        excess = len(live_unbound) - desired
        if excess > 0:
            to_delete.extend(live_unbound[:excess])
        for p in to_delete:
            m = p["metadata"]
            try:
                await asyncio.to_thread(
                    self.store.delete,
                    "Pod",
                    self.cfg.namespace,
                    m["name"],
                    expect_uid=m["uid"],
                    expect_rv=m["resourceVersion"],
                )
                exp.expect_deletion(m["uid"])
            except (NotFound, Conflict):
                pass
        if to_delete or deleting:
            self._requeue_later(node, lc_name, 0.1)  # requeue before creating
            return

        diff = desired - len(live_unbound)
        if diff > 0 and lcd is not None and lcd.obj is not None:
            for i in range(diff):
                pod = specialize_to_node(lcd.obj, node, lcd.template_hash)
                pod["metadata"]["namespace"] = self.cfg.namespace
                pod["metadata"]["name"] = (
                    f"{lc_name}-{node}-p{secrets.token_hex(4)}"
                )
                created = await asyncio.to_thread(self.store.create, pod)
                exp.expect_creation(created["metadata"]["uid"])
                if self.cfg.launcher_runtime is not None:
                    await self.cfg.launcher_runtime(created)
            logger.info("created %d launcher(s) for (%s, %s)", diff, node, lc_name)

    def _requeue_later(self, node: str, lc: str, delay: float) -> None:
        assert self._loop is not None
        self._inflight += 1

        def requeue() -> None:
            self._inflight -= 1
            if not self._stopping:
                self._key_queue.put_nowait((node, lc))

        self._loop.call_later(delay, requeue)

    # -- phase metrics -------------------------------------------------------

    def _phase_of(self, pod: Dict[str, Any], lcd: Optional[LcDigest]) -> str:
        m = pod["metadata"]
        if C.REQUESTER_ANNOTATION in (m.get("annotations") or {}):
            return "bound"
        if (
            lcd is None
            or (m.get("annotations") or {}).get(C.LAUNCHER_TEMPLATE_HASH_ANNOTATION)
            != lcd.template_hash
        ):
            return "stale"
        created = m.get("creationTimestamp") or time.time()
        age = time.time() - created
        st = pod.get("status") or {}
        scheduled = bool((pod.get("spec") or {}).get("nodeName"))
        ready = any(
            c.get("type") == "Ready" and c.get("status") == "True"
            for c in st.get("conditions", [])
        )
        if not scheduled and age > self.cfg.stuck_scheduling_threshold_s:
            return "stuck_scheduling"
        if scheduled and not ready and age > self.cfg.stuck_starting_threshold_s:
            return "stuck_starting"
        return "unbound"

    def _record_phases(
        self,
        node: str,
        lc_name: str,
        pods: List[Dict[str, Any]],
        lcd: Optional[LcDigest],
    ) -> None:
        counts: Dict[str, int] = {
            "bound": 0,
            "unbound": 0,
            "stuck_scheduling": 0,
            "stuck_starting": 0,
            "stale": 0,
        }
        next_flip: Optional[float] = None
        now = time.time()
        for p in pods:
            phase = self._phase_of(p, lcd)
            counts[phase] += 1
            # when will this pod's phase flip to stuck_*? schedule a
            # re-reconcile exactly then (metrics.go:297-304 — no sweeps)
            if phase == "unbound":
                created = p["metadata"].get("creationTimestamp") or now
                age = now - created
                scheduled = bool((p.get("spec") or {}).get("nodeName"))
                threshold = (
                    self.cfg.stuck_starting_threshold_s
                    if scheduled
                    else self.cfg.stuck_scheduling_threshold_s
                )
                remaining = threshold - age
                if remaining > 0 and (next_flip is None or remaining < next_flip):
                    next_flip = remaining
        for phase, count in counts.items():
            M.LAUNCHER_POD_COUNT.labels(lcfg_name=lc_name, phase=phase).set(count)
        if next_flip is not None:
            self._schedule_phase_recheck(node, lc_name, next_flip + 0.05)

    def _schedule_phase_recheck(self, node: str, lc: str, delay: float) -> None:
        """Timer for the next stuck_* phase flip. Unlike _requeue_later this
        does not count as in-flight work (it can be minutes away) and is
        deduplicated per key, keeping the earliest deadline."""
        assert self._loop is not None
        key = (node, lc)
        existing = self._phase_timers.get(key)
        if existing is not None:
            if existing.when() - self._loop.time() <= delay:
                return
            existing.cancel()

        def fire() -> None:
            self._phase_timers.pop(key, None)
            if not self._stopping:
                self._key_queue.put_nowait(key)

        self._phase_timers[key] = self._loop.call_later(delay, fire)


# --------------------------------------------------------------------------
# launcher template building (shared with the dual-pods controller)
# --------------------------------------------------------------------------


def build_launcher_template(lc: LauncherConfig) -> Tuple[Dict[str, Any], str]:
    """Node-independent launcher template (pod-helper.go:205-300): LC pod
    template + forced identity labels + launcher-port probes + the notifier
    sidecar env; returns (template, hash)."""
    spec = json.loads(json.dumps(lc.spec.pod_template.spec))
    if not spec.get("containers"):
        raise ValueError("pod template has no containers")
    tpl = {
        "metadata": {
            "labels": {
                **lc.spec.pod_template.labels,
                C.COMPONENT_LABEL: C.LAUNCHER_COMPONENT,
                C.LAUNCHER_CONFIG_NAME_LABEL: lc.metadata.name,
                C.SLEEPING_LABEL: "true",
            },
            "annotations": dict(lc.spec.pod_template.annotations),
        },
        "spec": spec,
    }
    return tpl, template_hash(tpl)


def specialize_to_node(
    lc: LauncherConfig, node: str, ti_hash: str
) -> Dict[str, Any]:
    """Template -> concrete Pod for a node (pod-helper.go:303-322)."""
    tpl, _ = build_launcher_template(lc)
    pod = json.loads(json.dumps(tpl))
    pod["kind"] = "Pod"
    pod["spec"]["nodeName"] = node
    pod["metadata"]["labels"][C.NODE_NAME_LABEL] = node
    pod["metadata"]["annotations"][C.LAUNCHER_TEMPLATE_HASH_ANNOTATION] = ti_hash
    pod["metadata"]["annotations"][C.LAUNCHER_CONFIG_HASH_ANNOTATION] = sha256_hex(
        ti_hash, node
    )
    return pod

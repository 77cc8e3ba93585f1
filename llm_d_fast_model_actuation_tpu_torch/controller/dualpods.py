"""The dual-pods controller: binds server-requesting Pods to providers.

Re-design of the reference's core reconciler (`pkg/controller/dual-pods/`,
esp. inference-server.go:170-762) as an asyncio controller over the cluster
store. Invariants preserved from the reference:

  * **engine awake => Pod bound** — bind is committed before instance
    create/wake; unbind sleeps (or deletes an obsolete) instance first;
  * binding state lives in Pod annotations only (requester ann, instance-id,
    server-port, engine-config, routing metadata) — restart recovery is just
    re-reading them (`recover_instance_state`);
  * per-node serialization: one worker per node drains that node's queue, so
    two requesters for the same chips never race;
  * deletion relays: provider deleted exogenously -> requester deleted (with
    UID precondition); troubled provider -> deleted; stopped instance ->
    requester deleted so the ReplicaSet heals;
  * requester finalizer delays its deletion until the provider is asleep;
  * ISC routing labels are stamped only while bound AND serving, and removed
    before sleep (deferred routing — EPP must not route to a sleeping pod);
  * launcher selection priority: has the sleeping target instance > free
    capacity without port conflict > reclaim victims (port-conflict first,
    then LRU) > create a new launcher pre-bound.

The port of the JAX package's ``controller/dualpods.py``, its reconcile
logic kept as it is. Ported by meaning for NVIDIA cards:

  * accelerators are card UUIDs, a flat set: placement validation checks
    the card count only (the ICI contiguity and slice-shape checks have
    no GPU meaning), and an ISC that names a topology or more than one
    host is refused into the requester's status
    (``AcceleratorSpec.validate``; multi-host gangs wait on ROADMAP
    queue 1 item 15, so there is no gang hook);
  * the memory budget before a wake reads the requester SPI's memory
    query, which NVML answers with every process's use of the card. A
    wake held back by it, or by a failed query, writes why into the
    requester's status (the JAX package only retries), so a wait on the
    budget is visible; the status clears once the engine serves;
  * the JAX package's tracing spans (``controller.reconcile_bound``)
    wait on the port of ``utils/tracing.py`` (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import asyncio
import json
import secrets
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Optional, Set, Tuple

from ..api import constants as C
from ..api.types import InferenceServerConfig, LauncherConfig
from ..utils.hashing import canonical_json, instance_id_for
from . import metrics as M
from .clients import InstanceNotFound, Transports
from .directpath import (
    DIRECT_PROVIDER_COMPONENT,
    LAST_USED_ANNOTATION,
    NOMINAL_HASH_ANNOTATION,
    ProviderData,
    load_gpu_map,
    nominal_provider_pod,
    render_server_patch,
)
from ..utils.syncbarrier import KnowsProcessedSync
from .store import AlreadyExists, Conflict, InMemoryStore, NotFound

logger = logging.getLogger(__name__)

FINALIZER = "dual-pods.llm-d.ai/finalizer"

ISC_NAME_ANNOTATION = "isc-name"  # on instances, for GC
INFERENCE_PORT_ANNOTATION = "inference-port"  # on instances, for port conflicts


def _meta(pod: Dict[str, Any]) -> Dict[str, Any]:
    return pod.setdefault("metadata", {})


def _ann(pod: Dict[str, Any]) -> Dict[str, str]:
    return _meta(pod).setdefault("annotations", {})


def _labels(pod: Dict[str, Any]) -> Dict[str, str]:
    return _meta(pod).setdefault("labels", {})


def _deleting(pod: Dict[str, Any]) -> bool:
    return _meta(pod).get("deletionTimestamp") is not None


def pod_in_trouble(pod: Dict[str, Any]) -> bool:
    """restarts > 0 and not Ready (pod-helper.go:44-53)."""
    st = pod.get("status") or {}
    restarts = sum(
        int(cs.get("restartCount", 0)) for cs in st.get("containerStatuses", [])
    )
    return restarts > 0 and not pod_is_ready(pod)


def pod_is_ready(pod: Dict[str, Any]) -> bool:
    for cond in (pod.get("status") or {}).get("conditions", []):
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False


@dataclass
class ServerData:
    """In-memory (rebuildable) state for one requester (controller.go:452-515)."""

    requester_uid: str
    chip_ids: Optional[List[str]] = None
    instance_id: str = ""
    server_port: int = 0
    engine_config: Optional[Dict[str, Any]] = None
    sleeping: Optional[bool] = None
    readiness_relayed: Optional[bool] = None
    first_ready_relayed: bool = False
    instances_deleted: int = 0
    start_time: float = field(default_factory=time.monotonic)
    path: str = ""  # hot | warm | cold


@dataclass
class LauncherData:
    """Per-launcher inventory: instance id -> last-used timestamp (LRU)."""

    instances: Dict[str, float] = field(default_factory=dict)


@dataclass
class DualPodsConfig:
    namespace: str = ""
    sleeper_limit: int = 1
    #: Card memory bytes allowed in use (by others) before waking on a card
    #: set; 0 disables the check. Reference: sleeperLimit x 4096 MiB.
    accelerator_sleeping_memory_limit_bytes: int = 0
    retry_base_s: float = 0.05
    retry_max_s: float = 2.0
    #: Hook invoked after the controller creates a launcher Pod object —
    #: deployment glue (or the test harness) makes the pod actually run.
    launcher_runtime: Optional[Callable[[Dict[str, Any]], Awaitable[None]]] = None
    #: Same for direct (server-patch path) provider Pods.
    provider_runtime: Optional[Callable[[Dict[str, Any]], Awaitable[None]]] = None


class Retry(Exception):
    def __init__(self, why: str, after: float = 0.0) -> None:
        super().__init__(why)
        self.after = after


class DualPodsController:
    def __init__(
        self,
        store: InMemoryStore,
        transports: Transports,
        cfg: Optional[DualPodsConfig] = None,
    ) -> None:
        self.store = store
        self.transports = transports
        self.cfg = cfg or DualPodsConfig()
        self.server_data: Dict[str, ServerData] = {}  # requester uid ->
        self.launcher_data: Dict[str, LauncherData] = {}  # launcher pod name ->
        # provider pod name -> duality label sets currently at 1, so unbind
        # can zero exactly what bind raised (reference: duality<-0 on unbind,
        # inference-server.go:764-780).
        self._duality_up: Dict[str, List[Tuple[str, str, str]]] = {}
        self._queues: Dict[str, asyncio.Queue] = {}
        self._workers: Dict[str, asyncio.Task] = {}
        self._enqueued_at: Dict[Tuple[str, Tuple[str, str, str]], float] = {}
        self._count_keys: Tuple[Set[str], Set[str]] = (set(), set())
        self._unsub: Optional[Callable[[], None]] = None
        self._stopping = False
        #: one-shot operator warning: namespace-scoped controller +
        #: hostNetwork launchers = port-collision protection weaker than
        #: the code path suggests (see _assign_launcher_port)
        self._warned_hostnet_ns_scope = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._idle_event = asyncio.Event()
        self._inflight = 0
        #: initial-batch rendezvous (knows-processed-sync.go:27-103): fires
        #: once every object present at start() had one reconcile pass
        self.initial_sync = KnowsProcessedSync()

    # ------------------------------------------------------------------ setup

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._unsub = self.store.subscribe(self._on_store_event)
        # initial sync: enqueue every requester and bound provider
        for obj in self.store.all_objects():
            self._classify_and_enqueue(obj)
        self.initial_sync.arm()

    async def stop(self) -> None:
        self._stopping = True
        if self._unsub:
            self._unsub()
        for task in self._workers.values():
            task.cancel()
        for task in list(self._workers.values()):
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def quiesce(self, timeout: float = 30.0) -> None:
        """Wait until all queues are drained (test convenience)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._inflight == 0 and all(
                q.empty() for q in self._queues.values()
            ):
                await asyncio.sleep(0.05)
                if self._inflight == 0 and all(
                    q.empty() for q in self._queues.values()
                ):
                    return
            await asyncio.sleep(0.02)
        raise TimeoutError("controller did not quiesce")

    # ------------------------------------------------------- event classifying

    def _on_store_event(self, event: str, obj: Dict[str, Any]) -> None:
        if self._loop is None:
            return
        self._loop.call_soon_threadsafe(self._classify_and_enqueue, obj)

    def _refresh_counts(self, ns: str) -> None:
        """fma_requester_count / fma_isc_count: recomputed from the informer
        cache on relevant events (reference keeps these via handler-driven
        gauges; the cache scan is cheap at controller scale). Keys that
        vanish are zeroed so dashboards don't show ghost series."""
        req_counts: Dict[str, int] = {}
        for pod in self.store.list("Pod", ns):
            if _deleting(pod):
                continue
            isc = (pod["metadata"].get("annotations") or {}).get(
                C.INFERENCE_SERVER_CONFIG_ANNOTATION
            )
            if isc:
                req_counts[isc] = req_counts.get(isc, 0) + 1
        isc_counts: Dict[str, int] = {}
        for obj in self.store.list(InferenceServerConfig.KIND, ns):
            lc = (obj.get("spec") or {}).get("launcherConfigName") or ""
            if lc:
                isc_counts[lc] = isc_counts.get(lc, 0) + 1
        prev_req, prev_isc = self._count_keys
        for k in prev_req - set(req_counts):
            M.REQUESTER_COUNT.labels(isc_name=k).set(0)
        for k, v in req_counts.items():
            M.REQUESTER_COUNT.labels(isc_name=k).set(v)
        for k in prev_isc - set(isc_counts):
            M.ISC_COUNT.labels(launcher_config_name=k).set(0)
        for k, v in isc_counts.items():
            M.ISC_COUNT.labels(launcher_config_name=k).set(v)
        self._count_keys = (set(req_counts), set(isc_counts))

    def _classify_and_enqueue(self, obj: Dict[str, Any]) -> None:
        kind = obj.get("kind")
        m = obj.get("metadata") or {}
        ns, name = m.get("namespace", ""), m.get("name", "")
        ann = m.get("annotations") or {}
        lab = m.get("labels") or {}
        if kind == "Pod":
            if (
                C.INFERENCE_SERVER_CONFIG_ANNOTATION in ann
                or C.SERVER_PATCH_ANNOTATION in ann
            ):
                node = (obj.get("spec") or {}).get("nodeName", "")
                self._refresh_counts(ns)
                self._enqueue(node, ("requester", ns, name))
            elif lab.get(C.COMPONENT_LABEL) == C.LAUNCHER_COMPONENT:
                node = (obj.get("spec") or {}).get("nodeName", "")
                req = ann.get(C.REQUESTER_ANNOTATION, "")
                if req:
                    self._enqueue(node, ("requester", ns, req.split("/")[0]))
                else:
                    self._enqueue(node, ("launcher-sweep", ns, name))
            elif lab.get(C.COMPONENT_LABEL) == DIRECT_PROVIDER_COMPONENT:
                req = ann.get(C.REQUESTER_ANNOTATION, "")
                if req:
                    node = ((obj.get("spec") or {}).get("nodeSelector") or {}).get(
                        "kubernetes.io/hostname", ""
                    )
                    self._enqueue(node, ("requester", ns, req.split("/")[0]))
        elif kind == InferenceServerConfig.KIND:
            self._refresh_counts(ns)
            self._enqueue("", ("isc-changed", ns, name))

    def _enqueue(self, node: str, item: Tuple[str, str, str]) -> None:
        q = self._queues.get(node)
        if q is None:
            q = asyncio.Queue()
            self._queues[node] = q
            assert self._loop is not None
            self._workers[node] = self._loop.create_task(self._worker(node, q))
        M.INNER_QUEUE_ADDS.labels(node=node or "-").inc()
        self.initial_sync.note_pending(item)
        # queue-wait measurement (queue_duration_seconds, controller.go:206-242);
        # first-enqueue wins so a retry's wait measures from its re-add
        self._enqueued_at.setdefault((node, item), time.monotonic())
        q.put_nowait(item)
        M.INNER_QUEUE_DEPTH.labels(node=node or "-").set(q.qsize())

    async def _worker(self, node: str, q: asyncio.Queue) -> None:
        attempts: Dict[Tuple[str, str, str], int] = {}
        while not self._stopping:
            item = await q.get()
            self._inflight += 1
            M.INNER_QUEUE_DEPTH.labels(node=node or "-").set(q.qsize())
            t_enq = self._enqueued_at.pop((node, item), None)
            if t_enq is not None:
                M.QUEUE_DURATION.labels(node=node or "-").observe(
                    time.monotonic() - t_enq
                )
            t0 = time.monotonic()
            try:
                await self._process(item)
                attempts.pop(item, None)
            except Retry as r:
                n = attempts.get(item, 0) + 1
                attempts[item] = n
                delay = r.after or min(
                    self.cfg.retry_base_s * (2 ** min(n, 6)), self.cfg.retry_max_s
                )
                M.INNER_QUEUE_RETRIES.labels(node=node or "-").inc()
                logger.debug("retry %s in %.2fs: %s", item, delay, r)
                self._schedule_retry(node, item, delay)
            except Exception:
                n = attempts.get(item, 0) + 1
                attempts[item] = n
                delay = min(self.cfg.retry_base_s * (2 ** min(n, 6)), self.cfg.retry_max_s)
                M.INNER_QUEUE_RETRIES.labels(node=node or "-").inc()
                logger.exception("processing %s failed; retry in %.2fs", item, delay)
                self._schedule_retry(node, item, delay)
            finally:
                M.WORK_DURATION.labels(node=node or "-").observe(
                    time.monotonic() - t0
                )
                self.initial_sync.note_processed(item)
                self._inflight -= 1
                q.task_done()

    def _schedule_retry(self, node: str, item, delay: float) -> None:
        self._inflight += 1  # count scheduled retries as in-flight for quiesce

        def requeue() -> None:
            self._inflight -= 1
            if not self._stopping:
                self._enqueue(node, item)

        assert self._loop is not None
        self._loop.call_later(delay, requeue)

    async def _process(self, item: Tuple[str, str, str]) -> None:
        kind, ns, name = item
        if kind == "requester":
            await self._reconcile_requester(ns, name)
        elif kind == "launcher-sweep":
            await self._sweep_launcher(ns, name)
        elif kind == "isc-changed":
            await self._gc_obsolete_instances(ns, name)
            # re-reconcile requesters referencing this ISC
            for pod in self.store.list("Pod", ns):
                if (pod["metadata"].get("annotations") or {}).get(
                    C.INFERENCE_SERVER_CONFIG_ANNOTATION
                ) == name:
                    node = (pod.get("spec") or {}).get("nodeName", "")
                    self._enqueue(node, ("requester", ns, pod["metadata"]["name"]))

    # ----------------------------------------------------------- main machine

    def _providers_for(self, ns: str, req_name: str) -> List[Dict[str, Any]]:
        def is_bound_to(pod: Dict[str, Any]) -> bool:
            if (pod["metadata"].get("labels") or {}).get(C.COMPONENT_LABEL) not in (
                C.LAUNCHER_COMPONENT,
                DIRECT_PROVIDER_COMPONENT,
            ):
                return False
            v = (pod["metadata"].get("annotations") or {}).get(
                C.REQUESTER_ANNOTATION, ""
            )
            return v.split("/")[0] == req_name

        return self.store.list("Pod", ns, predicate=is_bound_to)

    @staticmethod
    def _is_direct(pod: Dict[str, Any]) -> bool:
        return (
            (pod["metadata"].get("labels") or {}).get(C.COMPONENT_LABEL)
            == DIRECT_PROVIDER_COMPONENT
        )

    async def _reconcile_requester(self, ns: str, name: str) -> None:
        req = self.store.try_get("Pod", ns, name)
        providers = self._providers_for(ns, name)

        if req is None:
            # requester gone entirely: unbind any provider still pointing at it
            for p in providers:
                await self._ensure_unbound(ns, p)
            return

        uid = req["metadata"]["uid"]
        # drop providers bound to a previous incarnation (same name, new uid)
        stale = [
            p
            for p in providers
            if "/" in (p["metadata"].get("annotations") or {}).get(C.REQUESTER_ANNOTATION, "")
            and p["metadata"]["annotations"][C.REQUESTER_ANNOTATION].split("/")[1] != uid
        ]
        for p in stale:
            await self._ensure_unbound(ns, p)
        providers = [p for p in providers if p not in stale]
        provider = providers[0] if providers else None

        if _deleting(req):
            if provider is not None:
                await self._ensure_unbound(ns, provider)
            await self._remove_finalizer("Pod", ns, name)
            self.server_data.pop(uid, None)
            return

        if provider is not None and _deleting(provider):
            # exogenous provider deletion: relay to the requester (with UID
            # precondition), then let the provider finish dying.
            try:
                await asyncio.to_thread(
                    self.store.delete, "Pod", ns, name, expect_uid=uid
                )
            except (NotFound, Conflict):
                pass
            await self._remove_finalizer("Pod", ns, provider["metadata"]["name"])
            for key in self._duality_up.pop(provider["metadata"]["name"], []):
                M.DUALITY.labels(isc_name=key[0], chip=key[1], node=key[2]).set(0)
            return

        if provider is not None and pod_in_trouble(provider):
            logger.warning("provider %s in trouble; deleting", provider["metadata"]["name"])
            await asyncio.to_thread(
                self.store.delete, "Pod", ns, provider["metadata"]["name"]
            )
            return

        # node must be schedulable/known
        node = (req.get("spec") or {}).get("nodeName", "")
        if not node:
            raise Retry("requester not scheduled yet", after=0.2)

        sd = self.server_data.get(uid)
        if sd is None:
            sd = ServerData(requester_uid=uid)
            self.server_data[uid] = sd

        # A requester with no provider yet on a cordoned node can never be
        # served — delete it so its ReplicaSet reschedules elsewhere
        # (inference-server.go:603-613).
        if provider is None:
            node_obj = self.store.try_get("Node", "", node)
            if node_obj is not None and (node_obj.get("spec") or {}).get(
                "unschedulable"
            ):
                logger.warning(
                    "deleting requester %s: node %s unschedulable and no "
                    "provider bound",
                    name,
                    node,
                )
                try:
                    # uid precondition: never delete a newer incarnation that
                    # raced in under the same name
                    await asyncio.to_thread(
                        self.store.delete, "Pod", ns, name, expect_uid=uid
                    )
                except (NotFound, Conflict):
                    pass
                await self._remove_finalizer("Pod", ns, name)
                self.server_data.pop(uid, None)
                return

        # chip discovery via the requester SPI (once)
        if sd.chip_ids is None:
            spi = self.transports.requester_spi(req)
            try:
                sd.chip_ids = await spi.accelerators()
            except Exception as e:
                raise Retry(f"chip discovery: {e}", after=0.2)

        ann = req["metadata"].get("annotations") or {}
        isc_name = ann.get(C.INFERENCE_SERVER_CONFIG_ANNOTATION, "")
        patch_tmpl = ann.get(C.SERVER_PATCH_ANNOTATION, "")
        if isc_name and patch_tmpl:
            await self._set_status(
                ns,
                name,
                ["server-patch and inference-server-config are mutually exclusive"],
            )
            return
        # A provider of the wrong kind (requester annotations were switched
        # between the two paths while bound) can't be driven by either state
        # machine — unbind it and start clean.
        if provider is not None and self._is_direct(provider) != bool(patch_tmpl):
            await self._ensure_unbound(ns, provider)
            provider = None
        if patch_tmpl:
            await self._reconcile_direct(ns, req, provider, patch_tmpl, node, sd)
            return
        if not isc_name:
            await self._set_status(ns, name, ["no inference-server-config annotation"])
            return
        isc_obj = self.store.try_get(InferenceServerConfig.KIND, ns, isc_name)
        if isc_obj is None:
            await self._set_status(ns, name, [f"InferenceServerConfig {isc_name} not found"])
            raise Retry(f"ISC {isc_name} missing", after=0.5)
        isc = InferenceServerConfig.from_dict(isc_obj)

        acc_errors = self._validate_accelerators(isc, sd.chip_ids or [])
        if acc_errors:
            # Misplacement is a terminal condition for this requester (the
            # scheduler gave it the wrong cards, or the ISC asks for what a
            # GPU cannot give); surface it and stop.
            await self._set_status(ns, name, acc_errors)
            return

        engine_cfg, instance_id = self._desired_instance(isc, isc_name, sd.chip_ids)
        sd.instance_id = instance_id
        sd.server_port = isc.spec.engine_server_config.port
        sd.engine_config = engine_cfg

        if provider is None:
            provider = await self._select_or_create_launcher(
                ns, req, isc, isc_name, sd
            )
            if provider is None:
                raise Retry("no launcher available yet", after=0.3)

        await self._reconcile_bound(ns, req, provider, isc, isc_name, sd)

    def _validate_accelerators(
        self, isc: InferenceServerConfig, chip_ids: List[str]
    ) -> List[str]:
        """ISC ``accelerator`` vs the requester-reported card set: what a
        GPU cannot honour (:meth:`AcceleratorSpec.validate`), then the card
        count (the reference's GPU count check, inference-server.go:384-399).
        """
        spec = isc.spec.engine_server_config.accelerator
        if not spec.specified:
            return []  # no declared requirements: scheduler placement stands
        errors = spec.validate()
        if spec.chips and len(chip_ids) != spec.chips:
            errors.append(
                f"accelerator.chips={spec.chips} but requester reports "
                f"{len(chip_ids)} chip(s)"
            )
        return errors

    def _desired_instance(
        self,
        isc: InferenceServerConfig,
        isc_name: str,
        chip_ids: List[str],
    ) -> Tuple[Dict[str, Any], str]:
        """Desired instance config + deterministic ID
        (computeDesiredInstanceState, inference-server.go:1015-1057)."""
        esc = isc.spec.engine_server_config
        cfg = {
            "options": esc.options,
            "gpu_uuids": sorted(chip_ids),
            "env_vars": dict(esc.env_vars),
            "annotations": {
                ISC_NAME_ANNOTATION: isc_name,
                INFERENCE_PORT_ANNOTATION: str(esc.port),
            },
        }
        iid = instance_id_for(esc, chip_ids)
        return cfg, iid

    # ------------------------------------------------------ launcher selection

    def _launcher_template(self, lc: LauncherConfig, node: str) -> Tuple[Dict[str, Any], str]:
        """Node-specialized launcher pod + its config hash. Shared with the
        populator (populator.build_launcher_template) so populator-created
        launchers hash identically and are eligible for selection here."""
        from .populator import build_launcher_template, specialize_to_node

        _, ti_hash = build_launcher_template(lc)
        pod = specialize_to_node(lc, node, ti_hash)
        return pod, pod["metadata"]["annotations"][C.LAUNCHER_CONFIG_HASH_ANNOTATION]

    async def _select_or_create_launcher(
        self,
        ns: str,
        req: Dict[str, Any],
        isc: InferenceServerConfig,
        isc_name: str,
        sd: ServerData,
    ) -> Optional[Dict[str, Any]]:
        lc_name = isc.spec.launcher_config_name
        if not lc_name:
            await self._set_status(ns, req["metadata"]["name"], ["ISC has no launcherConfigName"])
            return None
        lc_obj = self.store.try_get(LauncherConfig.KIND, ns, lc_name)
        if lc_obj is None:
            await self._set_status(ns, req["metadata"]["name"], [f"LauncherConfig {lc_name} not found"])
            raise Retry(f"LauncherConfig {lc_name} missing", after=0.5)
        lc = LauncherConfig.from_dict(lc_obj)
        node = req["spec"]["nodeName"]
        _, node_hash = self._launcher_template(lc, node)

        candidates = self.store.list(
            "Pod",
            ns,
            selector={
                C.COMPONENT_LABEL: C.LAUNCHER_COMPONENT,
                C.LAUNCHER_CONFIG_NAME_LABEL: lc_name,
            },
            predicate=lambda p: (
                (p.get("spec") or {}).get("nodeName") == node
                and not _deleting(p)
                and C.REQUESTER_ANNOTATION not in (p["metadata"].get("annotations") or {})
                and (p["metadata"].get("annotations") or {}).get(
                    C.LAUNCHER_CONFIG_HASH_ANNOTATION
                )
                == node_hash
            ),
        )

        # gather inventories (also repairs the LRU bookkeeping)
        inventories: Dict[str, List[Dict[str, Any]]] = {}
        for cand in candidates:
            cname = cand["metadata"]["name"]
            try:
                inv = await self.transports.launcher(cand).list_instances()
            except Exception as e:
                logger.warning("inventory of %s failed: %s", cname, e)
                continue
            inventories[cname] = inv.get("instances", [])
            ld = self.launcher_data.setdefault(cname, LauncherData())
            for st in inventories[cname]:
                ld.instances.setdefault(st["instance_id"], time.monotonic())
            for known in list(ld.instances):
                if known not in {s["instance_id"] for s in inventories[cname]}:
                    del ld.instances[known]

        # priority 1: a launcher already holding the (sleeping) target instance
        for cand in candidates:
            cname = cand["metadata"]["name"]
            if any(
                s["instance_id"] == sd.instance_id
                for s in inventories.get(cname, [])
            ):
                sd.path = sd.path or "warm"
                return await self._bind(ns, req, cand, isc_name, sd)

        port = str(sd.server_port)
        bound_ids = self._bound_instance_ids(ns)

        def port_conflicts(states: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
            return [
                s
                for s in states
                if (s.get("annotations") or {}).get(INFERENCE_PORT_ANNOTATION) == port
            ]

        # priority 2: free capacity, no port conflict
        for cand in candidates:
            cname = cand["metadata"]["name"]
            states = inventories.get(cname)
            if states is None:
                continue
            if len(states) < lc.spec.max_instances and not port_conflicts(states):
                sd.path = sd.path or "cold"
                return await self._bind(ns, req, cand, isc_name, sd)

        # priority 3: reclaim — fewest deletions first; victims must be unbound
        best: Optional[Tuple[int, Dict[str, Any], List[str]]] = None
        for cand in candidates:
            cname = cand["metadata"]["name"]
            states = inventories.get(cname)
            if states is None:
                continue
            # port-conflict victims first; a *live* (bound) conflicting
            # instance makes this launcher unusable
            victims: List[str] = []
            usable = True
            for s in port_conflicts(states):
                if s["instance_id"] in bound_ids:
                    usable = False
                    break
                victims.append(s["instance_id"])
            if not usable:
                continue
            remaining = len(states) - len(victims)
            if remaining >= lc.spec.max_instances:
                # LRU victims among unbound instances
                ld = self.launcher_data.setdefault(cname, LauncherData())
                unbound = [
                    s["instance_id"]
                    for s in states
                    if s["instance_id"] not in bound_ids
                    and s["instance_id"] not in victims
                ]
                unbound.sort(key=lambda i: ld.instances.get(i, 0))
                need = remaining - lc.spec.max_instances + 1
                if len(unbound) < need:
                    continue
                victims.extend(unbound[:need])
            if best is None or len(victims) < best[0]:
                best = (len(victims), cand, victims)
        if best is not None:
            _, cand, victims = best
            handle = self.transports.launcher(cand)
            for vid in victims:
                try:
                    await handle.delete_instance(vid)
                    sd.instances_deleted += 1
                except InstanceNotFound:
                    pass
            sd.path = sd.path or "cold"
            return await self._bind(ns, req, cand, isc_name, sd)

        # nothing reusable: create a launcher pod, pre-bound so the populator
        # can't reap it (inference-server.go:719-761)
        return await self._create_launcher_pod(ns, req, lc, isc_name, sd, node)

    def _bound_instance_ids(self, ns: str) -> Set[str]:
        out: Set[str] = set()
        for pod in self.store.list(
            "Pod", ns, selector={C.COMPONENT_LABEL: C.LAUNCHER_COMPONENT}
        ):
            ann = pod["metadata"].get("annotations") or {}
            if C.REQUESTER_ANNOTATION in ann and C.INSTANCE_ID_ANNOTATION in ann:
                out.add(ann[C.INSTANCE_ID_ANNOTATION])
        return out

    async def _create_launcher_pod(
        self,
        ns: str,
        req: Dict[str, Any],
        lc: LauncherConfig,
        isc_name: str,
        sd: ServerData,
        node: str,
    ) -> Optional[Dict[str, Any]]:
        pod, _ = self._launcher_template(lc, node)
        pod["metadata"]["namespace"] = ns
        self._assign_launcher_port(pod, node)
        self._stamp_binding(pod, req, isc_name, sd)
        t0 = time.monotonic()
        created = await self._create_unique(pod, f"{lc.metadata.name}-{node}")
        if self.cfg.launcher_runtime is not None:
            await self.cfg.launcher_runtime(created)
        M.LAUNCHER_CREATE_SECONDS.labels(lcfg_name=lc.metadata.name).observe(
            time.monotonic() - t0
        )
        sd.path = "cold"
        logger.info(
            "created launcher pod %s pre-bound to %s",
            pod["metadata"]["name"],
            req["metadata"]["name"],
        )
        return self.store.try_get("Pod", ns, pod["metadata"]["name"])

    def _assign_launcher_port(
        self, pod: Dict[str, Any], node: str
    ) -> None:
        """hostNetwork launchers on one node share the host's port space: a
        second (third, ...) launcher gets the first free port above the
        default, recorded where both sides look — the launcher-port
        annotation (read by the controller's transport) and the
        FMA_LAUNCHER_PORT env (the launcher binds it). Pod-network
        launchers keep the fixed default: per-pod IPs cannot collide.
        Reference analogue: same-node port collision creates a
        differently-ported launcher (test/e2e/test-cases.sh:320)."""
        spec = pod.get("spec") or {}
        if not spec.get("hostNetwork"):
            return
        if self.cfg.namespace and not self._warned_hostnet_ns_scope:
            # Surface the scope caveat below as an operator-visible warning
            # instead of a code comment: a namespace-scoped informer cannot
            # provide the node-wide collision protection this scan implies.
            self._warned_hostnet_ns_scope = True
            logger.warning(
                "hostNetwork launchers with a namespace-scoped controller "
                "(namespace %r): the launcher-port collision scan only "
                "sees this namespace's informer cache, so controller "
                "instances watching OTHER namespaces can assign colliding "
                "ports on shared nodes. Deploy the controller "
                "cluster-scoped, or give each namespace a disjoint "
                "launcher port range.",
                self.cfg.namespace,
            )
        used = set()
        # hostNetwork port space is node-wide, not namespace-wide: scan
        # every launcher pod the store knows about regardless of namespace
        # (namespace=None = cache-wide), so launchers from LauncherConfigs
        # in different namespaces on the same node can't collide. Scope
        # caveat: KubeStore's informer watches a single namespace, so when
        # the controller runs namespace-scoped this still only sees its own
        # namespace plus its own cross-namespace write-throughs; full
        # protection against launchers created by OTHER controller
        # instances needs a cluster-scoped watch (deploy the controller
        # cluster-scoped, or give each namespace a disjoint port range).
        for other in self.store.list(
            "Pod", None, selector={C.COMPONENT_LABEL: C.LAUNCHER_COMPONENT}
        ):
            if (other.get("spec") or {}).get("nodeName") != node:
                continue
            ann = other["metadata"].get("annotations") or {}
            try:
                used.add(
                    int(
                        ann.get(
                            C.LAUNCHER_PORT_ANNOTATION,
                            C.LAUNCHER_SERVICE_PORT,
                        )
                    )
                )
            except (TypeError, ValueError):
                continue
        port = C.LAUNCHER_SERVICE_PORT
        while port in used:
            port += 1
        if port == C.LAUNCHER_SERVICE_PORT:
            return
        _ann(pod)[C.LAUNCHER_PORT_ANNOTATION] = str(port)
        for c in spec.get("containers") or []:
            c.setdefault("env", []).append(
                {"name": "FMA_LAUNCHER_PORT", "value": str(port)}
            )

    def _stamp_binding(
        self, pod: Dict[str, Any], req: Dict[str, Any], isc_name: str, sd: ServerData
    ) -> None:
        """Binding = one metadata stamp (bind, inference-server.go:1430-1483):
        requester ann + finalizer + dual label + instance-state annotations."""
        rm = req["metadata"]
        ann = _ann(pod)
        ann[C.REQUESTER_ANNOTATION] = f"{rm['name']}/{rm['uid']}"
        ann[C.INSTANCE_ID_ANNOTATION] = sd.instance_id
        ann[C.SERVER_PORT_ANNOTATION] = str(sd.server_port)
        ann[C.ENGINE_CONFIG_ANNOTATION] = canonical_json(sd.engine_config)
        ann[C.LAUNCHER_BASED_ANNOTATION] = "true"
        ann[ISC_NAME_ANNOTATION] = isc_name
        _labels(pod)[C.DUAL_LABEL] = rm["name"]
        fins = _meta(pod).setdefault("finalizers", [])
        if FINALIZER not in fins:
            fins.append(FINALIZER)

    async def _bind(
        self,
        ns: str,
        req: Dict[str, Any],
        launcher_pod: Dict[str, Any],
        isc_name: str,
        sd: ServerData,
    ) -> Optional[Dict[str, Any]]:
        name = launcher_pod["metadata"]["name"]
        try:
            def apply(pod: Dict[str, Any]) -> Dict[str, Any]:
                if C.REQUESTER_ANNOTATION in (pod["metadata"].get("annotations") or {}):
                    raise Conflict(f"{name} got bound concurrently")
                self._stamp_binding(pod, req, isc_name, sd)
                return pod

            bound = await asyncio.to_thread(
                self.store.mutate, "Pod", ns, name, apply
            )
        except (Conflict, NotFound) as e:
            raise Retry(f"bind {name}: {e}", after=0.1)
        ld = self.launcher_data.setdefault(name, LauncherData())
        ld.instances[sd.instance_id] = time.monotonic()
        logger.info("bound %s -> %s", req["metadata"]["name"], name)
        return bound

    # --------------------------------------------------------- the bound path

    async def _reconcile_bound(
        self,
        ns: str,
        req: Dict[str, Any],
        provider: Dict[str, Any],
        isc: InferenceServerConfig,
        isc_name: str,
        sd: ServerData,
    ) -> None:
        pname = provider["metadata"]["name"]
        self.recover_instance_state(provider, sd)
        handle = self.transports.launcher(provider)

        # launcher inventory sync incl. stopped-instance handling
        try:
            inv = await handle.list_instances()
        except Exception as e:
            raise Retry(f"launcher {pname} unreachable: {e}", after=0.2)
        states = {s["instance_id"]: s for s in inv.get("instances", [])}
        await self._sweep_states(ns, pname, states)

        inst = states.get(sd.instance_id)
        if inst is not None and inst.get("status") == "stopped":
            # stopped instance recovery: delete the requester; the ReplicaSet
            # recreates it and reconciliation starts clean (test-cases.sh:833).
            logger.warning(
                "instance %s on %s stopped; deleting requester %s",
                sd.instance_id,
                pname,
                req["metadata"]["name"],
            )
            try:
                await handle.delete_instance(sd.instance_id)
            except InstanceNotFound:
                pass
            await asyncio.to_thread(
                self.store.delete,
                "Pod",
                ns,
                req["metadata"]["name"],
                expect_uid=req["metadata"]["uid"],
            )
            return
        if inst is None:
            try:
                await handle.create_named_instance(sd.instance_id, sd.engine_config)
                sd.path = sd.path or "cold"
                sd.sleeping = False
            except Exception as e:
                raise Retry(f"create instance: {e}", after=0.2)

        engine = self.transports.engine_admin(provider, sd.server_port)
        try:
            sleeping = await engine.is_sleeping()
        except Exception as e:
            raise Retry(f"is_sleeping: {e}", after=0.3)
        if sleeping:
            await self._check_memory_budget(ns, req, sd)
            try:
                await engine.wake_up()
            except Exception as e:
                raise Retry(f"wake_up: {e}", after=0.3)
            sd.path = sd.path or "warm"
        sd.sleeping = False
        self.launcher_data.setdefault(pname, LauncherData()).instances[
            sd.instance_id
        ] = time.monotonic()

        # readiness relay + deferred routing labels
        healthy = await engine.healthy()
        if healthy:
            await self._apply_routing_metadata(ns, pname, isc)
            await self._apply_sleeping_label(ns, pname, "false")
            await self._ensure_req_state(ns, req, sd, pname)
            if sd.readiness_relayed is not True:
                spi = self.transports.requester_spi(req)
                try:
                    await spi.become_ready()
                except Exception as e:
                    raise Retry(f"become-ready: {e}", after=0.2)
                sd.readiness_relayed = True
                if not sd.first_ready_relayed:
                    sd.first_ready_relayed = True
                    path = sd.path or "hot"
                    M.ACTUATION_SECONDS.labels(
                        path=path,
                        instancesDeleted=str(sd.instances_deleted),
                        isc_name=isc_name,
                    ).observe(time.monotonic() - sd.start_time)
                    node = req["spec"].get("nodeName", "")
                    keys = [(isc_name, chip, node) for chip in sd.chip_ids or []]
                    for key in keys:
                        M.DUALITY.labels(
                            isc_name=key[0], chip=key[1], node=key[2]
                        ).set(1)
                    self._duality_up[pname] = keys
        else:
            await self._apply_sleeping_label(ns, pname, "false")
            await self._ensure_req_state(ns, req, sd, pname)
            if sd.readiness_relayed is True:
                spi = self.transports.requester_spi(req)
                try:
                    await spi.become_unready()
                except Exception:
                    pass
                sd.readiness_relayed = False
            raise Retry("engine not serving yet", after=0.3)

    async def _check_memory_budget(self, ns: str, req: Dict[str, Any], sd: ServerData) -> None:
        """Hold a wake back while the requester's cards have more memory in
        use than the sleeping budget, or while their use cannot be read;
        the reason goes into the requester's status and the wake is
        retried (``_ensure_req_state`` clears the status once it serves)."""
        limit = self.cfg.accelerator_sleeping_memory_limit_bytes
        if limit <= 0:
            return
        spi = self.transports.requester_spi(req)
        try:
            usage = await spi.accelerator_memory()
        except Exception as e:
            why = f"accelerator memory query failed ({e}); not waking"
        else:
            used = sum(usage.get(c, 0) for c in sd.chip_ids or [])
            if used <= limit:
                return
            why = (f"HBM in use ({used}B) above sleeping budget ({limit}B); "
                   "waiting for sleepers to drain")
        await self._set_status(ns, req["metadata"]["name"], [why])
        raise Retry(why, after=1.0)

    # ------------------------------------------------- direct path (M2 scope)

    async def _reconcile_direct(
        self,
        ns: str,
        req: Dict[str, Any],
        provider: Optional[Dict[str, Any]],
        patch_tmpl: str,
        node: str,
        sd: ServerData,
    ) -> None:
        """Server-patch path: derive the nominal provider from the requester,
        reuse a sleeping twin or create one (getNominalServerProvidingPod +
        the direct branch of infSvrItem.process, inference-server.go:617-668)."""
        name = req["metadata"]["name"]
        gpu_map = load_gpu_map(self.store, ns)
        try:
            patch = render_server_patch(patch_tmpl, ProviderData(node_name=node))
            nominal = nominal_provider_pod(req, patch, node, sd.chip_ids or [], gpu_map)
        except ValueError as e:
            await self._set_status(ns, name, [f"server-patch: {e}"])
            return
        want_hash = nominal["metadata"]["annotations"][NOMINAL_HASH_ANNOTATION]
        if provider is not None:
            # The committed binding is authoritative while bound: drive the
            # engine at the port recorded at bind time, not at whatever the
            # (possibly edited) patch renders to now.
            committed = (provider["metadata"].get("annotations") or {}).get(
                C.SERVER_PORT_ANNOTATION
            )
            sd.server_port = int(
                committed
                or nominal["metadata"]["annotations"][C.SERVER_PORT_ANNOTATION]
            )
        else:
            sd.server_port = int(
                nominal["metadata"]["annotations"][C.SERVER_PORT_ANNOTATION]
            )

        if provider is None:
            twin = self._find_sleeping_twin(ns, node, want_hash)
            if twin is not None:
                sd.path = sd.path or "warm"
                provider = await self._bind_direct(ns, req, twin)
            else:
                await asyncio.to_thread(
                    self._enforce_sleeper_budget, ns, node, sd.chip_ids or []
                )
                provider = await self._create_direct_provider(ns, req, nominal, sd)
            if provider is None:
                raise Retry("direct provider not available yet", after=0.2)

        await self._reconcile_bound_direct(ns, req, provider, sd)

    def _find_sleeping_twin(
        self, ns: str, node: str, want_hash: str
    ) -> Optional[Dict[str, Any]]:
        """Unbound sleeping direct provider with the same nominal hash on the
        same node (the `nominal` index lookup, inference-server.go:1848-1860)."""
        def match(pod: Dict[str, Any]) -> bool:
            m = pod["metadata"]
            ann = m.get("annotations") or {}
            return (
                (m.get("labels") or {}).get(C.COMPONENT_LABEL)
                == DIRECT_PROVIDER_COMPONENT
                and not _deleting(pod)
                and C.REQUESTER_ANNOTATION not in ann
                and ann.get(NOMINAL_HASH_ANNOTATION) == want_hash
                and ((pod.get("spec") or {}).get("nodeSelector") or {}).get(
                    "kubernetes.io/hostname"
                )
                == node
            )

        twins = self.store.list("Pod", ns, predicate=match)
        return twins[0] if twins else None

    async def _bind_direct(
        self, ns: str, req: Dict[str, Any], twin: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        name = twin["metadata"]["name"]
        rm = req["metadata"]
        try:
            def apply(pod: Dict[str, Any]) -> Dict[str, Any]:
                if C.REQUESTER_ANNOTATION in (pod["metadata"].get("annotations") or {}):
                    raise Conflict(f"{name} got bound concurrently")
                _ann(pod)[C.REQUESTER_ANNOTATION] = f"{rm['name']}/{rm['uid']}"
                _labels(pod)[C.DUAL_LABEL] = rm["name"]
                fins = _meta(pod).setdefault("finalizers", [])
                if FINALIZER not in fins:
                    fins.append(FINALIZER)
                return pod

            bound = await asyncio.to_thread(
                self.store.mutate, "Pod", ns, name, apply
            )
        except (Conflict, NotFound) as e:
            raise Retry(f"bind twin {name}: {e}", after=0.1)
        logger.info("bound %s -> sleeping twin %s", rm["name"], name)
        return bound

    async def _create_direct_provider(
        self,
        ns: str,
        req: Dict[str, Any],
        nominal: Dict[str, Any],
        sd: ServerData,
    ) -> Optional[Dict[str, Any]]:
        rm = req["metadata"]
        pod = nominal
        pod["metadata"]["namespace"] = ns
        ann = _ann(pod)
        ann[C.REQUESTER_ANNOTATION] = f"{rm['name']}/{rm['uid']}"
        _labels(pod)[C.DUAL_LABEL] = rm["name"]
        fins = _meta(pod).setdefault("finalizers", [])
        if FINALIZER not in fins:
            fins.append(FINALIZER)
        created = await self._create_unique(pod, f"{rm['name']}-provider")
        if self.cfg.provider_runtime is not None:
            await self.cfg.provider_runtime(created)
        sd.path = "cold"
        logger.info("created direct provider %s for %s", pod["metadata"]["name"], rm["name"])
        return self.store.try_get("Pod", ns, pod["metadata"]["name"])

    def _enforce_sleeper_budget(
        self, ns: str, node: str, chip_ids: List[str]
    ) -> None:
        """At most `sleeper_limit` sleeping direct providers per chip: evict
        least-recently-used sleepers until the new provider fits
        (enforceSleeperBudget, inference-server.go:1353-1427)."""
        limit = self.cfg.sleeper_limit
        if limit <= 0:
            return

        def is_sleeper(pod: Dict[str, Any]) -> bool:
            m = pod["metadata"]
            return (
                (m.get("labels") or {}).get(C.COMPONENT_LABEL)
                == DIRECT_PROVIDER_COMPONENT
                and (m.get("labels") or {}).get(C.SLEEPING_LABEL) == "true"
                and C.REQUESTER_ANNOTATION not in (m.get("annotations") or {})
                and not _deleting(pod)
                and ((pod.get("spec") or {}).get("nodeSelector") or {}).get(
                    "kubernetes.io/hostname"
                )
                == node
            )

        sleepers = self.store.list("Pod", ns, predicate=is_sleeper)

        def chips_of(pod: Dict[str, Any]) -> Set[str]:
            raw = (pod["metadata"].get("annotations") or {}).get(
                C.ACCELERATORS_ANNOTATION, ""
            )
            return {c for c in raw.split(",") if c}

        def last_used(pod: Dict[str, Any]) -> float:
            try:
                return float(
                    (pod["metadata"].get("annotations") or {}).get(
                        LAST_USED_ANNOTATION, "0"
                    )
                )
            except ValueError:
                return 0.0

        for chip in chip_ids:
            on_chip = [p for p in sleepers if chip in chips_of(p)]
            on_chip.sort(key=last_used)
            while len(on_chip) > limit:
                victim = on_chip.pop(0)
                vname = victim["metadata"]["name"]
                try:
                    self.store.delete("Pod", ns, vname)
                    logger.info("sleeper budget: evicted %s (chip %s)", vname, chip)
                except NotFound:
                    pass
                sleepers = [p for p in sleepers if p["metadata"]["name"] != vname]

    async def _reconcile_bound_direct(
        self,
        ns: str,
        req: Dict[str, Any],
        provider: Dict[str, Any],
        sd: ServerData,
    ) -> None:
        pname = provider["metadata"]["name"]
        engine = self.transports.engine_admin(provider, sd.server_port)
        try:
            sleeping = await engine.is_sleeping()
        except Exception as e:
            raise Retry(f"is_sleeping({pname}): {e}", after=0.3)
        if sleeping:
            await self._check_memory_budget(ns, req, sd)
            try:
                await engine.wake_up()
            except Exception as e:
                raise Retry(f"wake_up({pname}): {e}", after=0.3)
            sd.path = sd.path or "warm"
        sd.sleeping = False

        healthy = await engine.healthy()
        await self._apply_sleeping_label(ns, pname, "false")
        await self._ensure_req_state(ns, req, sd, pname)
        if not healthy:
            if sd.readiness_relayed is True:
                try:
                    await self.transports.requester_spi(req).become_unready()
                except Exception:
                    pass
                sd.readiness_relayed = False
            raise Retry("direct engine not serving yet", after=0.3)
        if sd.readiness_relayed is not True:
            try:
                await self.transports.requester_spi(req).become_ready()
            except Exception as e:
                raise Retry(f"become-ready: {e}", after=0.2)
            sd.readiness_relayed = True
            if not sd.first_ready_relayed:
                sd.first_ready_relayed = True
                M.ACTUATION_SECONDS.labels(
                    path=sd.path or "hot",
                    instancesDeleted=str(sd.instances_deleted),
                    isc_name="direct",
                ).observe(time.monotonic() - sd.start_time)
                node = req["spec"].get("nodeName", "")
                keys = [("direct", chip, node) for chip in sd.chip_ids or []]
                for key in keys:
                    M.DUALITY.labels(
                        isc_name=key[0], chip=key[1], node=key[2]
                    ).set(1)
                self._duality_up[pname] = keys

    async def _ensure_unbound_direct(self, ns: str, provider: Dict[str, Any]) -> None:
        """Sleep the engine and keep the Pod as a sleeping twin."""
        pname = provider["metadata"]["name"]
        ann = provider["metadata"].get("annotations") or {}
        if C.REQUESTER_ANNOTATION not in ann:
            return
        port = int(ann.get(C.SERVER_PORT_ANNOTATION, "0") or 0)
        engine = self.transports.engine_admin(provider, port)
        try:
            await engine.sleep(1)
        except Exception as e:
            logger.warning("sleep of direct provider %s failed: %s", pname, e)

        def apply(pod: Dict[str, Any]) -> Dict[str, Any]:
            a = _ann(pod)
            a.pop(C.REQUESTER_ANNOTATION, None)
            a[LAST_USED_ANNOTATION] = str(time.time())
            lab = _labels(pod)
            lab.pop(C.DUAL_LABEL, None)
            lab[C.SLEEPING_LABEL] = "true"
            fins = pod["metadata"].get("finalizers") or []
            if FINALIZER in fins:
                fins.remove(FINALIZER)
            return pod

        try:
            await asyncio.to_thread(self.store.mutate, "Pod", ns, pname, apply)
        except NotFound:
            pass
        for key in self._duality_up.pop(pname, []):
            M.DUALITY.labels(isc_name=key[0], chip=key[1], node=key[2]).set(0)
        logger.info("unbound direct provider %s (now a sleeping twin)", pname)

    # ---------------------------------------------------------------- unbind

    async def _ensure_unbound(self, ns: str, provider: Dict[str, Any]) -> None:
        """Sleep (or GC) the instance, then clear binding metadata in one
        update (ensureUnbound, inference-server.go:1669-1764)."""
        if self._is_direct(provider):
            await self._ensure_unbound_direct(ns, provider)
            return
        pname = provider["metadata"]["name"]
        ann = provider["metadata"].get("annotations") or {}
        if C.REQUESTER_ANNOTATION not in ann:
            return
        instance_id = ann.get(C.INSTANCE_ID_ANNOTATION, "")
        port = int(ann.get(C.SERVER_PORT_ANNOTATION, "0") or 0)
        isc_name = ann.get(ISC_NAME_ANNOTATION, "")

        # de-route before sleeping (EPP must stop routing first)
        await self._remove_routing_metadata(ns, pname)

        if instance_id:
            obsolete = self._instance_obsolete(ns, isc_name, instance_id, ann)
            handle = self.transports.launcher(provider)
            if obsolete:
                try:
                    await handle.delete_instance(instance_id)
                    logger.info("deleted obsolete instance %s on %s", instance_id, pname)
                except InstanceNotFound:
                    pass
                except Exception as e:
                    # Don't block the unbind: the instance stays on the
                    # launcher's inventory and _gc_obsolete_instances collects
                    # it on the next ISC event.
                    logger.warning(
                        "deleting obsolete instance %s on %s failed: %s",
                        instance_id,
                        pname,
                        e,
                    )
            else:
                engine = self.transports.engine_admin(provider, port)
                try:
                    await engine.sleep(1)
                except Exception as e:
                    logger.warning("sleep of %s failed: %s", instance_id, e)

        def apply(pod: Dict[str, Any]) -> Dict[str, Any]:
            a = _ann(pod)
            for key in (
                C.REQUESTER_ANNOTATION,
                C.INSTANCE_ID_ANNOTATION,
                C.SERVER_PORT_ANNOTATION,
                C.ENGINE_CONFIG_ANNOTATION,
                C.ISC_ROUTING_METADATA_ANNOTATION,
                ISC_NAME_ANNOTATION,
            ):
                a.pop(key, None)
            lab = _labels(pod)
            lab.pop(C.DUAL_LABEL, None)
            lab[C.SLEEPING_LABEL] = "true"
            fins = pod["metadata"].get("finalizers") or []
            if FINALIZER in fins:
                fins.remove(FINALIZER)
            return pod

        try:
            await asyncio.to_thread(self.store.mutate, "Pod", ns, pname, apply)
        except NotFound:
            pass
        for key in self._duality_up.pop(pname, []):
            M.DUALITY.labels(isc_name=key[0], chip=key[1], node=key[2]).set(0)
        logger.info("unbound provider %s", pname)

    def _instance_obsolete(
        self, ns: str, isc_name: str, instance_id: str, ann: Dict[str, str]
    ) -> bool:
        """Does the committed instance still match its ISC's current spec?
        (maybeDeleteObsoleteInstance, inference-server.go:1776-1835)."""
        if not isc_name:
            return False
        isc_obj = self.store.try_get(InferenceServerConfig.KIND, ns, isc_name)
        if isc_obj is None:
            return True
        isc = InferenceServerConfig.from_dict(isc_obj)
        try:
            cfg = json.loads(ann.get(C.ENGINE_CONFIG_ANNOTATION, "{}"))
            chips = cfg.get("gpu_uuids", [])
        except json.JSONDecodeError:
            return True
        return instance_id_for(isc.spec.engine_server_config, chips) != instance_id

    # --------------------------------------------------------------- sweeping

    async def _sweep_launcher(self, ns: str, name: str) -> None:
        """Unbound launcher changed (e.g. notifier signature): GC stopped
        instances (syncLauncherInstances, inference-server.go:2094-2182)."""
        pod = self.store.try_get("Pod", ns, name)
        if pod is None or _deleting(pod):
            self.launcher_data.pop(name, None)
            return
        try:
            inv = await self.transports.launcher(pod).list_instances()
        except Exception:
            return
        states = {s["instance_id"]: s for s in inv.get("instances", [])}
        await self._sweep_states(ns, name, states)

    async def _sweep_states(
        self, ns: str, launcher_name: str, states: Dict[str, Dict[str, Any]]
    ) -> None:
        bound = self._bound_instance_ids(ns)
        pod = self.store.try_get("Pod", ns, launcher_name)
        if pod is None:
            return
        handle = self.transports.launcher(pod)
        for iid, st in states.items():
            if st.get("status") == "stopped" and iid not in bound:
                try:
                    await handle.delete_instance(iid)
                    logger.info("GC'd stopped instance %s on %s", iid, launcher_name)
                except InstanceNotFound:
                    pass
        ld = self.launcher_data.setdefault(launcher_name, LauncherData())
        for iid in states:
            ld.instances.setdefault(iid, time.monotonic())
        for known in list(ld.instances):
            if known not in states:
                del ld.instances[known]

    async def _gc_obsolete_instances(self, ns: str, isc_name: str) -> None:
        """ISC changed: delete sleeping instances whose hash no longer matches
        (instanceGCItem, inference-server.go:1586-1663)."""
        isc_obj = self.store.try_get(InferenceServerConfig.KIND, ns, isc_name)
        bound = self._bound_instance_ids(ns)
        for pod in self.store.list(
            "Pod", ns, selector={C.COMPONENT_LABEL: C.LAUNCHER_COMPONENT}
        ):
            if _deleting(pod):
                continue
            try:
                inv = await self.transports.launcher(pod).list_instances()
            except Exception:
                continue
            for st in inv.get("instances", []):
                if (st.get("annotations") or {}).get(ISC_NAME_ANNOTATION) != isc_name:
                    continue
                iid = st["instance_id"]
                if iid in bound:
                    continue
                obsolete = True
                if isc_obj is not None:
                    isc = InferenceServerConfig.from_dict(isc_obj)
                    chips = st.get("gpu_uuids") or []
                    obsolete = instance_id_for(isc.spec.engine_server_config, chips) != iid
                if obsolete:
                    try:
                        await self.transports.launcher(pod).delete_instance(iid)
                        logger.info(
                            "GC'd obsolete instance %s on %s (ISC %s changed)",
                            iid,
                            pod["metadata"]["name"],
                            isc_name,
                        )
                    except InstanceNotFound:
                        pass

    # ------------------------------------------------------- metadata helpers

    def recover_instance_state(self, provider: Dict[str, Any], sd: ServerData) -> None:
        """Rebuild ServerData from the annotations committed at bind time
        (inference-server.go:1235-1277). The committed binding is
        authoritative while bound — if the ISC changed since bind, the OLD
        instance keeps serving until unbind (where the obsolete check deletes
        instead of sleeping it); the new hash applies at the next bind."""
        ann = provider["metadata"].get("annotations") or {}
        if C.INSTANCE_ID_ANNOTATION in ann:
            sd.instance_id = ann[C.INSTANCE_ID_ANNOTATION]
        if C.SERVER_PORT_ANNOTATION in ann:
            sd.server_port = int(ann[C.SERVER_PORT_ANNOTATION])
        if C.ENGINE_CONFIG_ANNOTATION in ann:
            try:
                sd.engine_config = json.loads(ann[C.ENGINE_CONFIG_ANNOTATION])
            except json.JSONDecodeError:
                pass

    async def _amutate(self, kind: str, ns: str, name: str, fn) -> None:
        """`store.mutate` off the event loop (writes are blocking HTTP),
        swallowing NotFound (the object died; nothing to stamp)."""
        try:
            await asyncio.to_thread(self.store.mutate, kind, ns, name, fn)
        except NotFound:
            pass

    async def _create_unique(
        self, pod: Dict[str, Any], prefix: str
    ) -> Dict[str, Any]:
        """`metadata.generateName` semantics without server support in every
        test store: random suffix + retry on AlreadyExists (replaces the old
        time-derived suffix that wrapped every 100 s)."""
        for _ in range(8):
            pod["metadata"]["name"] = f"{prefix}-{secrets.token_hex(3)}"
            try:
                return await asyncio.to_thread(self.store.create, pod)
            except AlreadyExists:
                continue
        raise Retry(f"no free pod name under prefix {prefix}", after=0.2)

    async def _apply_routing_metadata(
        self, ns: str, provider_name: str, isc: InferenceServerConfig
    ) -> None:
        esc = isc.spec.engine_server_config
        if not esc.labels and not esc.annotations:
            return

        def apply(pod: Dict[str, Any]) -> Optional[Dict[str, Any]]:
            routing = {"labels": esc.labels, "annotations": esc.annotations}
            a = _ann(pod)
            if a.get(C.ISC_ROUTING_METADATA_ANNOTATION) == canonical_json(routing):
                return None
            # drop keys from the previously-stamped routing set that are no
            # longer in the ISC (else stale labels keep routing traffic here)
            old_raw = a.get(C.ISC_ROUTING_METADATA_ANNOTATION)
            if old_raw:
                try:
                    old = json.loads(old_raw)
                except json.JSONDecodeError:
                    old = {}
                for k in old.get("labels", {}):
                    if k not in esc.labels:
                        _labels(pod).pop(k, None)
                for k in old.get("annotations", {}):
                    if k not in esc.annotations:
                        a.pop(k, None)
            _labels(pod).update(esc.labels)
            a.update(esc.annotations)
            a[C.ISC_ROUTING_METADATA_ANNOTATION] = canonical_json(routing)
            return pod

        await self._amutate("Pod", ns, provider_name, apply)

    async def _remove_routing_metadata(self, ns: str, provider_name: str) -> None:
        def apply(pod: Dict[str, Any]) -> Optional[Dict[str, Any]]:
            a = _ann(pod)
            raw = a.get(C.ISC_ROUTING_METADATA_ANNOTATION)
            if raw is None:
                return None
            try:
                routing = json.loads(raw)
            except json.JSONDecodeError:
                routing = {"labels": {}, "annotations": {}}
            for k in routing.get("labels", {}):
                _labels(pod).pop(k, None)
            for k in routing.get("annotations", {}):
                a.pop(k, None)
            a.pop(C.ISC_ROUTING_METADATA_ANNOTATION, None)
            return pod

        await self._amutate("Pod", ns, provider_name, apply)

    async def _apply_sleeping_label(self, ns: str, pod_name: str, value: str) -> None:
        def apply(pod: Dict[str, Any]) -> Optional[Dict[str, Any]]:
            if _labels(pod).get(C.SLEEPING_LABEL) == value:
                return None
            _labels(pod)[C.SLEEPING_LABEL] = value
            return pod

        await self._amutate("Pod", ns, pod_name, apply)

    async def _ensure_req_state(
        self, ns: str, req: Dict[str, Any], sd: ServerData, provider_name: str
    ) -> None:
        """Status ann, accelerators ann, dual/instance labels, finalizer — one
        conditional update (ensureReqState, inference-server.go:2028-2075)."""
        name = req["metadata"]["name"]

        def apply(pod: Dict[str, Any]) -> Optional[Dict[str, Any]]:
            changed = False
            a = _ann(pod)
            lab = _labels(pod)
            want = {
                C.ACCELERATORS_ANNOTATION: ",".join(sorted(sd.chip_ids or [])),
                C.STATUS_ANNOTATION: canonical_json({"Errors": []}),
            }
            for k, v in want.items():
                if a.get(k) != v:
                    a[k] = v
                    changed = True
            want_labels = {C.DUAL_LABEL: provider_name, C.INSTANCE_LABEL: sd.instance_id}
            for k, v in want_labels.items():
                if lab.get(k) != v:
                    lab[k] = v
                    changed = True
            fins = pod["metadata"].setdefault("finalizers", [])
            if FINALIZER not in fins:
                fins.append(FINALIZER)
                changed = True
            return pod if changed else None

        await self._amutate("Pod", ns, name, apply)

    async def _set_status(self, ns: str, req_name: str, errors: List[str]) -> None:
        def apply(pod: Dict[str, Any]) -> Optional[Dict[str, Any]]:
            a = _ann(pod)
            want = canonical_json({"Errors": errors})
            if a.get(C.STATUS_ANNOTATION) == want:
                return None
            a[C.STATUS_ANNOTATION] = want
            return pod

        await self._amutate("Pod", ns, req_name, apply)

    async def _remove_finalizer(self, kind: str, ns: str, name: str) -> None:
        def apply(obj: Dict[str, Any]) -> Optional[Dict[str, Any]]:
            fins = obj["metadata"].get("finalizers") or []
            if FINALIZER not in fins:
                return None
            fins.remove(FINALIZER)
            obj["metadata"]["finalizers"] = fins
            return obj

        await self._amutate(kind, ns, name, apply)

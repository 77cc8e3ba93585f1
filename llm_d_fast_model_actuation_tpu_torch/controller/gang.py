"""Slice-gang coordinator: actuating multi-node InferenceServerConfigs.

Port of ``llm_d_fast_model_actuation_tpu/controller/gang.py``. An ISC with
``accelerator.hosts`` above 1 is served by ONE tensor-parallel engine
running as a gang of processes, one per node (``parallel/multihost.py``,
``engine/multihost.py``). Under dual-pods that means a GANG of
requester/provider pairs. This controller owns the gang lifecycle:

  * **group**: gang-less requesters of a multi-node ISC — cards discovered
    (accelerators annotation stamped by the dual-pods controller), on
    distinct nodes — are grouped into gangs of exactly ``accelerator.hosts``
    members;
  * **plan**: the gang is planned from the gpu-map ConfigMap (each node's
    cards, and its ``origin:`` and ``slice:`` lines: the node's place in
    the gang order and its NVLink/InfiniBand domain,
    ``parallel/topology.py:gang_places``) against ``accelerator.chips``,
    the gang's global card count; planning failures are surfaced on the
    ISC status;
  * **stamp**: each member gets the gang id and its coordination env
    (``FMA_NUM_PROCESSES`` / ``FMA_PROCESS_ID`` /
    ``FMA_COORDINATOR_ADDRESS`` / ``FMA_GANG_ID``) as annotations. The
    dual-pods controller defers instance creation for multi-node
    requesters until the stamp exists, then merges the env into the engine
    instance config; each child's group join blocks until the whole gang
    joins, so readiness needs no extra gating;
  * **degrade**: a lockstep gang cannot lose a process and continue. When
    a member disappears, the remaining members' requesters are deleted
    (UID preconditions — the relay pattern of inference-server.go:256-289)
    so their ReplicaSet re-creates them and a fresh gang forms.

The coordinator address uses the process-0 member's requester Pod IP: the
requester and its provider run on one node with host networking, so the
node address is stable across the pair (and in a CPU rehearsal everything
is loopback). The annotation names and env keys are the JAX package's,
byte for byte: the launcher and the controller cross both packages.
"""

from __future__ import annotations

import asyncio
import json
import logging
import secrets
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..api import constants as C
from ..api.types import InferenceServerConfig
from ..parallel.multihost import COORDINATOR_PORT, SlicePlanError, plan_slice
from ..parallel.topology import gang_places, parse_gpu_map
from .store import Conflict, NotFound

logger = logging.getLogger(__name__)

#: Gang id a member belongs to (a fresh grouping mints a fresh id, so
#: stale stamps are detectable).
GANG_ANNOTATION = "dual-pods.llm-d.ai/slice-gang"
#: JSON env this member's engine child needs to join the gang.
GANG_ENV_ANNOTATION = "dual-pods.llm-d.ai/slice-gang-env"

#: Exactly the env keys the coordinator stamps (coordination env + gang id).
GANG_ENV_KEYS = (
    "FMA_NUM_PROCESSES",
    "FMA_PROCESS_ID",
    "FMA_COORDINATOR_ADDRESS",
    "FMA_GANG_ID",
)


def gang_env_from_instance_env(env_vars: Optional[Dict[str, Any]]) -> Optional[Dict[str, str]]:
    """The gang env of a committed engine-instance config's env_vars.
    Obsolescence checks recompute the instance identity
    (``utils/hashing.py:instance_id_for``) and must hash the SAME
    extra_env the creation path used, else every gang instance would
    self-mismatch.

    ``FMA_GANG_ID`` is the discriminator: the coordinator always stamps
    it, while an operator hand-wiring coordination env into a one-node
    ISC's env_vars (``resolve_distributed`` reads those too) never does —
    without it the keys are ISC-authored env, hashed as part of the spec
    already, and returning them here would make a healthy one-node
    instance permanently self-mismatch."""
    env_vars = env_vars or {}
    if "FMA_GANG_ID" not in env_vars:
        return None
    return {str(k): str(v) for k, v in env_vars.items() if k in GANG_ENV_KEYS}


def gang_env_of(pod: Dict[str, Any]) -> Optional[Dict[str, str]]:
    """The member coordination env stamped on a requester, if any."""
    ann = (pod.get("metadata") or {}).get("annotations") or {}
    raw = ann.get(GANG_ENV_ANNOTATION, "")
    if not raw:
        return None
    try:
        env = json.loads(raw)
    except ValueError:
        return None
    return {str(k): str(v) for k, v in env.items()}


def is_multihost(isc: InferenceServerConfig) -> bool:
    return isc.spec.engine_server_config.accelerator.hosts > 1


def _load_gpu_map(store: Any, ns: str) -> Optional[Dict[str, str]]:
    cm = store.try_get("ConfigMap", ns, C.GPU_MAP_CONFIGMAP)
    return None if cm is None else dict(cm.get("data") or {})


class SliceGangCoordinator:
    """Watches requesters of multi-node ISCs; forms, stamps, and degrades
    gangs. Store-agnostic like the other controllers."""

    def __init__(self, store: Any, namespace: str, coordinator_port: int = COORDINATOR_PORT) -> None:
        self.store = store
        self.ns = namespace
        self.port = coordinator_port
        self._queue: asyncio.Queue = asyncio.Queue()
        self._queued: set = set()
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._unsub = None
        self._stopping = False

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._unsub = self.store.subscribe(self._on_event)
        self._task = self._loop.create_task(self._run())
        # initial sync: every multi-node ISC present at startup
        for obj in self.store.list(InferenceServerConfig.KIND, self.ns):
            self._enqueue(obj["metadata"]["name"])

    async def stop(self) -> None:
        self._stopping = True
        if self._unsub:
            self._unsub()
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    def _on_event(self, event: str, obj: Dict[str, Any]) -> None:
        md = obj.get("metadata") or {}
        if md.get("namespace") != self.ns:
            return
        kind = obj.get("kind")
        if kind == InferenceServerConfig.KIND:
            self._enqueue(md["name"])
        elif kind == "Pod":
            isc = (md.get("annotations") or {}).get(C.INFERENCE_SERVER_CONFIG_ANNOTATION)
            if isc:
                self._enqueue(isc)

    def _enqueue(self, isc_name: str) -> None:
        # store subscribers run on whichever thread commits the write (our
        # own mutations run via asyncio.to_thread), and asyncio.Queue is not
        # thread-safe: hop onto the loop as the sibling controllers do
        loop = self._loop
        if loop is None or loop.is_closed():
            return

        def put() -> None:
            if isc_name in self._queued:
                return
            self._queued.add(isc_name)
            self._queue.put_nowait(isc_name)

        try:
            loop.call_soon_threadsafe(put)
        except RuntimeError:  # loop gone during shutdown
            pass

    async def _run(self) -> None:
        while not self._stopping:
            isc_name = await self._queue.get()
            self._queued.discard(isc_name)
            try:
                await self._reconcile(isc_name)
            except Exception:
                logger.exception("gang reconcile %s failed", isc_name)
                await asyncio.sleep(0.5)
                self._enqueue(isc_name)

    # -- reconcile -----------------------------------------------------------

    async def _reconcile(self, isc_name: str) -> None:
        obj = self.store.try_get(InferenceServerConfig.KIND, self.ns, isc_name)
        if obj is None:
            return
        isc = InferenceServerConfig.from_dict(obj)
        if not is_multihost(isc):
            return
        acc = isc.spec.engine_server_config.accelerator
        hosts_needed = acc.hosts

        members: List[Dict[str, Any]] = []
        for pod in self.store.list("Pod", self.ns):
            md = pod.get("metadata") or {}
            ann = md.get("annotations") or {}
            if ann.get(C.INFERENCE_SERVER_CONFIG_ANNOTATION) != isc_name:
                continue
            if md.get("deletionTimestamp"):
                continue
            members.append(pod)

        # ---- degrade broken gangs ------------------------------------------
        by_gang: Dict[str, List[Dict[str, Any]]] = {}
        for pod in members:
            gid = (pod["metadata"].get("annotations") or {}).get(GANG_ANNOTATION)
            if gid:
                by_gang.setdefault(gid, []).append(pod)
        for gid, pods in by_gang.items():
            if len(pods) >= hosts_needed:
                continue
            # a member is gone: the lockstep engine is dead — relay-delete the rest
            for pod in pods:
                md = pod["metadata"]
                logger.info("gang %s degraded (%d/%d members): deleting %s", gid, len(pods), hosts_needed,
                            md["name"])
                try:
                    await asyncio.to_thread(self.store.delete, "Pod", self.ns, md["name"], expect_uid=md.get("uid"))
                except (NotFound, Conflict):
                    pass

        # ---- form a new gang from unassigned members -----------------------
        unassigned = [
            p
            for p in members
            if not (p["metadata"].get("annotations") or {}).get(GANG_ANNOTATION)
            and (p["metadata"].get("annotations") or {}).get(C.ACCELERATORS_ANNOTATION)
            and (p.get("spec") or {}).get("nodeName")
        ]
        # one candidate per node (two requesters of one ISC on one node
        # cannot be in the same gang)
        by_node: Dict[str, Dict[str, Any]] = {}
        for p in sorted(unassigned, key=lambda p: p["metadata"]["name"]):
            by_node.setdefault(p["spec"]["nodeName"], p)
        if len(by_node) < hosts_needed:
            # not enough members yet; pod events re-enqueue us. Clear any
            # stale planning error — the world has changed since it was set.
            await self._set_status(isc_name, [])
            return

        if acc.topology:
            await self._set_status(isc_name, acc.validate())
            return
        data = _load_gpu_map(self.store, self.ns)
        if data is None:
            await self._set_status(isc_name, ["multi-host ISC needs the gpu-map ConfigMap (each node's cards and "
                                              "gang origin) to plan the gang"])
            return
        try:
            cards_of, places = parse_gpu_map(data), gang_places(data)
        except (ValueError, IndexError) as e:
            await self._set_status(isc_name, [f"gpu-map: {e}"])
            return

        # Select within ONE NVLink/InfiniBand domain (nodes of two domains
        # may share origins but no fabric — a gang never spans domain ids),
        # then by origin: one node per origin (alphabetical tie-break),
        # lexicographic origins from the zero corner. Extra candidates —
        # nodes of another domain, unmapped nodes — must not poison it.
        by_domain: Dict[str, Dict[Tuple[int, ...], str]] = {}
        for node in sorted(by_node):
            if node not in cards_of:
                continue  # an unmapped node cannot be planned; skip
            origin, domain = places[node]
            by_domain.setdefault(domain, {}).setdefault(_padded(origin, places), node)
        chosen: Dict[str, Dict[str, Any]] = {}
        for _, by_origin in sorted(by_domain.items()):
            origins = sorted(by_origin)
            if len(origins) < hosts_needed or any(o != 0 for o in origins[0]):
                continue  # this domain cannot field a gang yet
            chosen = {by_origin[o]: by_node[by_origin[o]] for o in origins[:hosts_needed]}
            break
        if not chosen:
            await self._set_status(isc_name, [])  # waiting, not an error
            return

        plan_input: Dict[str, Tuple[Sequence[int], List[Tuple[str, int]]]] = {}
        for node, pod in chosen.items():
            reported = pod["metadata"]["annotations"][C.ACCELERATORS_ANNOTATION].split(",")
            index = dict(cards_of[node])
            missing = [c for c in reported if c not in index]
            if missing:
                await self._set_status(isc_name, [f"node {node}: cards {missing} absent from gpu-map"])
                return
            plan_input[node] = (places[node][0], [(c, index[c]) for c in reported])

        try:
            plan = plan_slice(acc.chips, plan_input)
        except SlicePlanError as e:
            await self._set_status(isc_name, [f"slice planning: {e}"])
            return

        coord_pod = chosen[plan.coordinator_node]
        coord_ip = (coord_pod.get("status") or {}).get("podIP", "")
        if not coord_ip:
            await self._set_status(isc_name, [])
            return  # no IP yet; a pod update re-enqueues us

        gid = f"g{secrets.token_hex(4)}"
        # Per-gang coordinator port: a degraded gang's process-0 engine may
        # still be alive (asleep) holding the old port on the host network;
        # a fixed port would make the next gang's bind fail. Derived from
        # the gang id so all members agree without another round trip. A
        # residual collision (1/4096) heals through the crash relay: the
        # engine whose bind failed goes STOPPED -> notifier -> controller
        # deletes the requester -> this gang degrades -> the re-formed gang
        # draws a fresh gid and port.
        port = self.port + int(gid[1:], 16) % 4096
        for node, pod in chosen.items():
            assignment = plan.assignment_for(node)
            env = plan.coordination_env(assignment.process_id, coord_ip, port)
            # the gang id makes the env — and therefore the engine instance
            # identity — unique per gang: a sleeping member of a dead gang
            # must never be woken into a new gang (a process joins one
            # process group for its life)
            env["FMA_GANG_ID"] = gid
            name = pod["metadata"]["name"]

            def stamp(p, env=env):
                ann = p["metadata"].setdefault("annotations", {})
                if ann.get(GANG_ANNOTATION):
                    return None  # raced: someone stamped already
                ann[GANG_ANNOTATION] = gid
                ann[GANG_ENV_ANNOTATION] = json.dumps(env, sort_keys=True)
                return p

            try:
                await asyncio.to_thread(self.store.mutate, "Pod", self.ns, name, stamp)
            except (NotFound, Conflict):
                # member vanished mid-stamp: the partial gang degrades on
                # the next event
                return
        await self._set_status(isc_name, [])
        logger.info("gang %s formed for %s: %s", gid, isc_name, [(h.node, h.process_id) for h in plan.hosts])

    async def _set_status(self, isc_name: str, errors: List[str]) -> None:
        def apply(obj):
            status = obj.setdefault("status", {})
            cur = status.get("gangErrors") or []
            if cur == errors:
                return None
            status["gangErrors"] = errors
            return obj

        try:
            await asyncio.to_thread(self.store.mutate, InferenceServerConfig.KIND, self.ns, isc_name, apply)
        except (NotFound, Conflict):
            pass


def _padded(origin: Tuple[int, ...], places: Dict[str, Tuple[Tuple[int, ...], str]]) -> Tuple[int, ...]:
    """``origin`` with zeros to the longest origin's rank (an absent
    origin is the zero corner), so origins of any rank compare."""
    rank = max((len(o) for o, _ in places.values()), default=1) or 1
    return tuple(origin) + (0,) * (rank - len(origin))

"""Multi-instance manager: CRUDL over engine instances + revisioned events.

The port of the JAX package's ``launcher/manager.py`` (the reference's
``VllmMultiProcessManager``, launcher.py:344-515), lifecycle only: a
monotonically increasing revision stamped on every lifecycle event
(CREATED / STOPPED / RESTARTING / RESTARTED / DELETED), a duplicate id is
an error (REST maps it to 409), options are validated before the fork
(422), stop is graceful-then-kill, a crashed child produces a STOPPED
event with its exit code through the sentinel watcher, and a
``RestartPolicy`` brings it back in place.

The GPU exclusivity rule. A ``ChipLedger`` records which cards each live
instance holds, and a create whose cards overlap a holder is refused
(``ChipConflict``, 409) unless every overlapping holder is asleep. On a
TPU a sleeping process still owns its chip, so the JAX manager needs
"asleep with devices released". CUDA contexts coexist on a card, and a
level-1 sleep of the port's engine gives its memory back (under 1 GiB
reserved, nothing of its arenas mapped), so here **a holder that is
sleeping does not block; an awake or unreachable one does**. That is
what lets one card time-share engines. A supervised restart is held to
it too: a restarted child comes up awake, so it does not come back while
another holder admitted beside it is awake or unreachable.

The swap verb (:meth:`EngineProcessManager.swap_instance`) forwards to
the child's ``POST /v1/swap`` with a request id; a timed-out swap is
recovered through the child's ``GET /v1/swap``, never sent again. The
prefetch verb (:meth:`EngineProcessManager.prefetch_instance`) forwards
to the child's ``/v1/prefetch`` and records the hint in the ledger's
``prefetched`` block. The migrate verb
(:meth:`EngineProcessManager.migrate_instance`) hands an instance's live
streams to a sibling that serves the same model (its child's ``GET
/v1/parked/{model}``, the sibling's ``POST /v1/parked``, the child's
``POST /v1/parked/release``; one fenced retry of an import that failed
with a 5xx, and the fence aborted on a refusal or a timeout, so the
streams resume at home), publishing ``MIGRATED``; the drain verb
(:meth:`EngineProcessManager.drain_instance`) repeats migrate passes until
the child's queue is empty, publishing ``DRAINED``. Neither creates an
instance: the GPU exclusivity rule is applied at create, as before. The
residents verbs (:meth:`EngineProcessManager.attach_instance_resident`,
``detach_instance_resident``, ``get_instance_residents``) forward to the
child's ``/v1/residents`` and keep each holder's resident set in the
ledger (``ChipLedger.set_residents``); the engine's 409 (the cap, the
budget, a live variant) reaches the caller as a 409.
``fleet_rollup`` aggregates the children's ``/v1/stats`` as the reference
does (their ``zero_drain``, ``migration`` and ``residents`` blocks summed), onto the
``fma_launcher_fleet_*`` gauges, its ``slo_exemplars`` lifted from the
children's; a detailed instance list lifts each reporting
child's cost-oracle summary into ``ledger.costs``.

Observability, the reference's: the spans ``launcher.create_instance``
(current across the fork, so the child's ``engine.start`` parents on it),
``launcher.restart``, ``launcher.swap``, ``launcher.migrate``,
``launcher.drain`` and ``launcher.rpc`` around each
call to a child (its ``traceparent`` sent with the call), and the
families ``fma_launcher_rpc_seconds{verb,outcome}`` (one observation per
attempt) and ``fma_launcher_fleet_*``.
"""

from __future__ import annotations

import json
import logging
import os
import random
import resource
import socket
import threading
import time
import urllib.error
import urllib.request
import uuid as uuidlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..api.constants import STATUS_RUNNING
from ..utils import faults, tracing
from ..utils.events import EventBroadcaster
from ..utils.prom import Gauge, Histogram
from .chiptranslator import ChipTranslator
from .instance import EngineInstance, InstanceConfig, InvalidInstanceConfig

logger = logging.getLogger(__name__)

#: Launcher -> engine-child admin RPC latency, one observation per HTTP
#: attempt; ``outcome``: ok / http_<code> / refused (retried) / timeout /
#: unreachable. Served by the launcher's GET /metrics.
LAUNCHER_RPC_SECONDS = Histogram(
    "fma_launcher_rpc_seconds",
    "Latency of launcher -> engine-child admin RPCs",
    ["verb", "outcome"],
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 2, 5, 15, 60, 300),
)

# The fleet rollup's node-level aggregates over every live child's GET
# /v1/stats, refreshed by fleet_rollup() on instance-list and /metrics reads.
LAUNCHER_FLEET_INSTANCES = Gauge(
    "fma_launcher_fleet_instances",
    "Engine instances by stats-poll outcome",
    ["state"],  # reporting | unreachable
)
LAUNCHER_FLEET_QUEUE_DEPTH = Gauge(
    "fma_launcher_fleet_queue_depth",
    "Waiting + in-flight requests summed over reporting instances",
)
LAUNCHER_FLEET_ARRIVAL_RATE = Gauge(
    "fma_launcher_fleet_arrival_rate",
    "Summed per-instance request arrival-rate EWMAs (requests/s)",
)
LAUNCHER_FLEET_SLO_ATTAINMENT = Gauge(
    "fma_launcher_fleet_slo_attainment",
    "Fraction of SLO-judged requests that met every configured target "
    "across the fleet (1.0 when nothing has been judged yet)",
)
LAUNCHER_FLEET_GOODPUT_TOKENS = Gauge(
    "fma_launcher_fleet_goodput_tokens",
    "Cumulative generated tokens from SLO-met requests, fleet-wide",
)
LAUNCHER_FLEET_ACTUATIONS_PER_HOUR = Gauge(
    "fma_launcher_fleet_actuations_per_hour",
    "Summed per-instance actuation rates (swap+sleep+wake per uptime "
    "hour)",
)

LAUNCHER_FLEET_RESIDENT_VARIANTS = Gauge(
    "fma_launcher_fleet_resident_variants",
    "Device-resident model variants summed over reporting instances "
    "(base included per instance)",
)
LAUNCHER_FLEET_CORESIDENT_SAVED_BYTES = Gauge(
    "fma_launcher_fleet_coresident_saved_bytes",
    "HBM bytes saved fleet-wide by co-resident variants sharing their "
    "base's device tensors (vs one full copy per variant)",
)

#: the launcher families the port leaves out until their feature is
#: ported, by ROADMAP item: none is left
UNPORTED_FAMILIES: Dict[str, int] = {}

#: first backoff (seconds) before re-sending a refused engine connection
_RETRY_BACKOFF_S = 0.2

class ChipConflict(Exception):
    """Requested cards overlap an instance that is (or may be) awake."""

    def __init__(self, instance_id: str, blockers: List[str]) -> None:
        super().__init__(
            f"instance {instance_id}: cards held by awake (or not-yet-probeable) "
            f"instance(s) {blockers}; a card time-shares only with sleeping holders — sleep them first"
        )
        self.instance_id = instance_id
        self.blockers = blockers


class SwapFailed(Exception):
    """The engine child rejected (or never answered) a model hot-swap."""

    def __init__(self, instance_id: str, status: int, detail: str) -> None:
        super().__init__(f"swap of instance {instance_id} failed ({status}): {detail}")
        self.instance_id = instance_id
        self.status = status
        self.detail = detail


class PrefetchFailed(Exception):
    """The engine child rejected (or never answered) a prefetch verb."""

    def __init__(self, instance_id: str, status: int, detail: str) -> None:
        super().__init__(f"prefetch on instance {instance_id} failed ({status}): {detail}")
        self.instance_id = instance_id
        self.status = status
        self.detail = detail


class ResidentsFailed(Exception):
    """The engine child rejected (or never answered) a resident-set verb.
    Status 409 carries the engine's refusal (the cap, the budget, a detach
    while live): the caller's cue to take the swap path."""

    def __init__(self, instance_id: str, status: int, detail: str) -> None:
        super().__init__(f"residents verb on instance {instance_id} failed ({status}): {detail}")
        self.instance_id = instance_id
        self.status = status
        self.detail = detail


class StatsFailed(Exception):
    """The engine child never answered a stats poll (fleet rollup marks
    the instance unreachable instead of failing the whole read)."""

    def __init__(self, instance_id: str, status: int, detail: str) -> None:
        super().__init__(
            f"stats on instance {instance_id} failed ({status}): {detail}"
        )
        self.instance_id = instance_id
        self.status = status
        self.detail = detail


class MigrateFailed(Exception):
    """A migration step failed or was refused. A 409 is the engine's
    refusal (weights not the same, no room, a spent fence, no sibling):
    nothing was displaced. Any other status means the engines recovered
    already (the source resumed its streams at home, or the fence was
    aborted): the streams survived, the handoff did not."""

    def __init__(self, instance_id: str, status: int, detail: str) -> None:
        super().__init__(f"migrate on instance {instance_id} failed ({status}): {detail}")
        self.instance_id = instance_id
        self.status = status
        self.detail = detail


class DrainFailed(Exception):
    """A drain pass could not move the instance's remaining live work to a
    sibling (none eligible, a migrate pass failed, or arrivals outran the
    passes)."""

    def __init__(self, instance_id: str, status: int, detail: str) -> None:
        super().__init__(f"drain of instance {instance_id} failed ({status}): {detail}")
        self.instance_id = instance_id
        self.status = status
        self.detail = detail


def _engine_port(instance: "EngineInstance") -> int:
    from ..engine.server import parse_engine_options

    return parse_engine_options(instance.config.options).port


def probe_instance_awake(instance: "EngineInstance", timeout: float = 2.0) -> Optional[bool]:
    """Whether the instance's engine keeps its cards from another engine,
    read from its ``/is_sleeping``: True (awake and serving), False
    (asleep, whatever its ``devices_released`` says: the GPU rule, module
    docstring), or None (not reachable: still booting, crashed, or
    options that name no engine port). The exclusivity rule treats None
    as awake."""
    try:
        port = _engine_port(instance)
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/is_sleeping", timeout=timeout
        ) as resp:
            body = json.loads(resp.read() or b"{}")
    except Exception:  # noqa: BLE001 — refused, timed out, not engine options
        return None
    return not body.get("is_sleeping", False)


class ChipLedger:
    """Node-local truth of which live instance holds which cards, which
    model each holder serves, the model it was asked to prefetch, and its
    model pool's shape and transfer mode from its last swap or prefetch
    answer, and its resident set from its last residents answer."""

    def __init__(self) -> None:
        self._held: Dict[str, List[str]] = {}  # instance_id -> chip_ids
        self._models: Dict[str, str] = {}  # instance_id -> served model
        #: instance_id -> the model staged through the prefetch verb
        self._prefetched: Dict[str, str] = {}
        self._pools: Dict[str, Dict[str, Any]] = {}
        self._quant: Dict[str, str] = {}
        #: instance_id -> the resident-set summary of the holder's last
        #: /v1/residents answer
        self._residents: Dict[str, Dict[str, Any]] = {}

    def overlapping(
        self, chip_ids: Optional[List[str]], exclude: Optional[str] = None
    ) -> List[str]:
        """Instance IDs whose recorded chip sets overlap `chip_ids`."""
        chips = set(chip_ids or [])
        # a copy: creates, stops and restarts change the ledger from
        # other threads
        return [
            iid
            for iid, held in list(self._held.items())
            if iid != exclude and chips & set(held)
        ]

    def acquire(self, instance_id: str, chip_ids: Optional[List[str]]) -> List[str]:
        """Record ownership; returns the list of instance IDs whose chip sets
        overlap (empty = clean placement)."""
        overlaps = self.overlapping(chip_ids, exclude=instance_id)
        self._held[instance_id] = sorted(set(chip_ids or []))
        return overlaps

    def release(self, instance_id: str) -> None:
        self._held.pop(instance_id, None)
        self._models.pop(instance_id, None)
        self._prefetched.pop(instance_id, None)
        self._pools.pop(instance_id, None)
        self._quant.pop(instance_id, None)
        self._residents.pop(instance_id, None)

    def set_model(self, instance_id: str, model: str) -> None:
        """Record which model a holder serves; a swap to the prefetched
        model consumes the prefetch hint."""
        if instance_id in self._held:
            self._models[instance_id] = model
            if self._prefetched.get(instance_id) == model:
                self._prefetched.pop(instance_id, None)

    def set_prefetched(self, instance_id: str, model: Optional[str]) -> None:
        """Record (or with None, clear) the model a holder has staged
        through the prefetch verb."""
        if model is None:
            self._prefetched.pop(instance_id, None)
        elif instance_id in self._held:
            self._prefetched[instance_id] = model

    def set_pool(self, instance_id: str, pool: Optional[Dict[str, Any]]) -> None:
        """Record the holder's pool shape from an engine swap answer (a
        pool-less answer keeps the last known one)."""
        if pool is None or instance_id not in self._held:
            return
        chunks = pool.get("chunks") or {}
        self._pools[instance_id] = {
            "models": list(pool.get("models") or []),
            "bytes_used": pool.get("bytes_used", 0),
            "budget_bytes": pool.get("budget_bytes", 0),
            "dedup_saved_bytes": chunks.get("dedup_saved_bytes", 0),
            "disk_bytes": chunks.get("disk_bytes", 0),
            "staged_manifests": list(pool.get("staged_manifests") or []),
        }

    def set_quant(self, instance_id: str, quant: Optional[str]) -> None:
        """Record the transfer mode of a holder's last swap answer."""
        if quant and instance_id in self._held:
            self._quant[instance_id] = quant

    def set_residents(self, instance_id: str, view: Optional[Dict[str, Any]]) -> None:
        """Record a holder's resident set from an engine /v1/residents
        answer, compacted to what a scheduler reads: membership, budget
        and use, and what sharing the base saves."""
        if view is None or instance_id not in self._held:
            return
        ledger = view.get("ledger") or {}
        self._residents[instance_id] = {
            "base": view.get("base"),
            "resident_variants": int(view.get("resident_variants", 1)),
            "resident_variants_cap": int(view.get("resident_variants_cap", 1)),
            "residents": sorted(view.get("residents") or {}),
            "variant_hbm_bytes": int(view.get("variant_hbm_bytes", 0)),
            "variant_hbm_budget_bytes": int(view.get("variant_hbm_budget_bytes", 0)),
            "bytes_saved": int(ledger.get("bytes_saved", 0)),
        }

    def residents(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._residents)

    def holders(self) -> Dict[str, List[str]]:
        return dict(self._held)

    def pools(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._pools)

    def quant(self) -> Dict[str, str]:
        return dict(self._quant)

    def models(self) -> Dict[str, str]:
        return dict(self._models)

    def prefetched(self) -> Dict[str, str]:
        return dict(self._prefetched)


@dataclass
class RestartPolicy:
    """Supervised-restart knobs for crashed engine children.

    ``budget`` restarts per crash loop (0 disables supervision — the
    launcher then only reports the death, and the dual-pods controller
    heals by re-pairing). Delays grow ``backoff_s * 2**attempt`` up to
    ``backoff_max_s``, with up to ``jitter_frac`` random extra so a node
    full of children crashed by one cause does not restart in lockstep. A
    child that stays up longer than ``reset_window_s`` earns its crash
    counter back — the budget bounds crash *loops*, not total restarts."""

    budget: int = 0
    backoff_s: float = 0.5
    backoff_max_s: float = 30.0
    jitter_frac: float = 0.2
    reset_window_s: float = 300.0


@dataclass
class _RestartState:
    attempts: int = 0
    last_crash: float = 0.0
    timer: Optional[threading.Timer] = None
    #: set by _cancel_restart under the restart lock; a timer body that
    #: already started (Timer.cancel is a no-op then) re-checks this
    #: before forking, so an explicit stop can never race an orphan child
    cancelled: bool = False


class EngineProcessManager:
    def __init__(
        self,
        translator: ChipTranslator,
        log_dir: str = "",
        kickoff=None,
        restart_policy: Optional[RestartPolicy] = None,
    ) -> None:
        self.instances: Dict[str, EngineInstance] = {}
        self.translator = translator
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.ledger = ChipLedger()
        self.broadcaster = EventBroadcaster()
        self._revision = 0
        # create and the sentinel publish on the loop thread, stop_instance
        # from the REST handler's executor thread: minting a revision and
        # appending to the buffer are one atomic step, or a watcher skips
        self._rev_lock = threading.Lock()
        self._kickoff = kickoff
        self.restart_policy = restart_policy
        self._restart_states: Dict[str, _RestartState] = {}
        # RLock: _restart_instance holds it across its whole body (so a
        # concurrent stop_instance serializes against the fork) and its
        # spawn-failure path re-enters via _restart_allowed/_schedule
        self._restart_lock = threading.RLock()
        self._loop = None  # captured from the sentinel callback's loop
        # fleet_rollup cache: a short TTL keeps back-to-back instance-list
        # reads from double-polling every child
        self._fleet_lock = threading.Lock()
        self._fleet_cache: Optional[tuple] = None  # (monotonic_t, block)

    # -- revisions -----------------------------------------------------------

    @property
    def revision(self) -> int:
        return self._revision

    def _publish(self, event_type: str, obj: Dict[str, Any]) -> int:
        """Mint-and-append atomically (cross-thread safe); returns the
        revision stamped on the event."""
        with self._rev_lock:
            self._revision += 1
            rev = self._revision
            obj["revision"] = rev
            self.broadcaster.publish_nowait(rev, {"type": event_type, "object": obj})
        return rev

    def _served_model(self, options: str) -> Optional[str]:
        """The model an options string serves; None for the free-form
        options of a fake kickoff."""
        from ..engine.server import parse_engine_options

        try:
            return parse_engine_options(options).model
        except ValueError:
            return None

    def _awake_holders(
        self, chip_ids: Optional[List[str]], exclude: str
    ) -> List[str]:
        """The holders of any of ``chip_ids`` (other than ``exclude``) that
        keep them from another engine: awake, or not reachable (possibly
        booting: refusing a race beats two engines filling one card). A
        sleeping holder does not block."""
        blockers = []
        for other in self.ledger.overlapping(chip_ids, exclude=exclude):
            inst = self.instances.get(other)
            if inst is None:
                # stale ledger entry (a failed create); drop, not block
                self.ledger.release(other)
                continue
            if probe_instance_awake(inst) is not False:
                blockers.append(other)
        return blockers

    # -- CRUDL ---------------------------------------------------------------

    def create_instance(
        self, config: InstanceConfig, instance_id: Optional[str] = None
    ) -> Dict[str, Any]:
        """:meth:`_create_instance_impl` under ``launcher.create_instance``:
        the span is current across the fork, so the child's
        ``engine.start`` joins this trace."""
        with tracing.span("launcher.create_instance", instance=instance_id or ""):
            return self._create_instance_impl(config, instance_id)

    def _create_instance_impl(
        self, config: InstanceConfig, instance_id: Optional[str] = None
    ) -> Dict[str, Any]:
        iid = instance_id or str(uuidlib.uuid4())
        if iid in self.instances:
            raise ValueError(f"instance {iid} already exists")
        if self._kickoff is None:
            # Real engine path: validate the options string before the fork
            # so a bad config is a 422 at create time, not a crash later.
            from ..engine.server import parse_engine_options

            try:
                parse_engine_options(config.options)
            except Exception as e:
                raise InvalidInstanceConfig(f"invalid engine options: {e}")
        blockers = self._awake_holders(config.chip_ids, exclude=iid)
        if blockers:
            raise ChipConflict(iid, blockers)
        kwargs = {} if self._kickoff is None else {"kickoff": self._kickoff}
        instance = EngineInstance(
            iid, config, self.translator, log_dir=self.log_dir, **kwargs
        )
        result = instance.start()
        # record ownership only once the process actually exists — a failed
        # start must not leak a hold
        self.ledger.acquire(iid, config.chip_ids)
        model = self._served_model(config.options)
        if model is not None:
            self.ledger.set_model(iid, model)
        self.instances[iid] = instance
        instance.last_revision = self._publish("CREATED", dict(result))
        result["revision"] = instance.last_revision
        logger.info("created instance %s (rev %s)", iid, instance.last_revision)
        return result

    def _on_instance_stopped(self, instance_id: str, exitcode) -> None:
        """Sentinel callback: the child died on its own. Publishes STOPPED
        with its exit code, then — when a restart policy is armed and the
        crash-loop budget allows — keeps the ledger's hold (the cards stay
        earmarked for the comeback; a concurrent create must not take
        them) and schedules a supervised restart."""
        instance = self.instances.get(instance_id)
        if instance is None:
            return
        will_restart = self._restart_allowed(instance_id)
        if not will_restart:
            self.ledger.release(instance_id)
        obj = instance.get_status()
        obj["exit_code"] = exitcode
        instance.last_revision = self._publish("STOPPED", obj)
        logger.warning(
            "instance %s stopped itself (exit code %s)", instance_id, exitcode
        )
        if will_restart:
            try:
                import asyncio

                self._loop = asyncio.get_running_loop()
            except RuntimeError:
                pass
            self._schedule_restart(instance_id, exitcode)

    # -- crash supervision ---------------------------------------------------

    def _restart_allowed(self, instance_id: str) -> bool:
        pol = self.restart_policy
        if pol is None or pol.budget <= 0:
            return False
        if instance_id not in self.instances:
            return False
        with self._restart_lock:
            st = self._restart_states.setdefault(instance_id, _RestartState())
            now = time.monotonic()
            if st.attempts and now - st.last_crash > pol.reset_window_s:
                # survived a full window since the last crash: not a loop
                st.attempts = 0
            if st.attempts >= pol.budget:
                logger.error(
                    "instance %s crash-looped through its restart budget "
                    "(%d); leaving it stopped", instance_id, pol.budget,
                )
                return False
            return True

    def _schedule_restart(self, instance_id: str, exitcode) -> None:
        """Publish RESTARTING and arm the backoff timer for one attempt."""
        pol = self.restart_policy
        instance = self.instances.get(instance_id)
        if pol is None or instance is None:
            return
        with self._restart_lock:
            st = self._restart_states.setdefault(instance_id, _RestartState())
            attempt = st.attempts
            st.attempts += 1
            st.last_crash = time.monotonic()
            delay = min(pol.backoff_max_s, pol.backoff_s * (2 ** attempt))
            delay *= 1.0 + random.uniform(0.0, max(0.0, pol.jitter_frac))
            delay = min(delay, pol.backoff_max_s)  # cap is a hard ceiling
            timer = threading.Timer(
                delay,
                self._restart_instance,
                args=(instance_id, attempt + 1, st, exitcode),
            )
            timer.daemon = True
            st.timer = timer
        obj = instance.get_status()
        obj.update(
            exit_code=exitcode,
            restart_attempt=attempt + 1,
            restart_budget=pol.budget,
            backoff_s=round(delay, 3),
        )
        instance.last_revision = self._publish("RESTARTING", obj)
        logger.warning(
            "instance %s: supervised restart %d/%d in %.2fs",
            instance_id, attempt + 1, pol.budget, delay,
        )
        timer.start()

    def _restart_instance(
        self, instance_id: str, attempt: int, st: _RestartState, exitcode
    ) -> None:
        """Backoff-timer body: start the child again from the instance's
        stored options, reconcile the ledger, and re-arm crash detection.

        A restarted child comes up awake, so it is held to the rule a
        create is held to: while another holder of its cards is awake or
        unreachable (admitted while this one slept), there is no restart.
        The hold is released and STOPPED is published again, with the
        crash's exit code and ``restart_blocked_by``.

        Runs under the restart lock end to end: Timer.cancel is a no-op
        once this body has started, so an explicit stop_instance racing it
        serializes on the lock instead — either the restart completes
        first (and the stop then stops the fresh child and releases the
        ledger), or the cancel lands first (``st.cancelled``) and no child
        is started."""
        with self._restart_lock:
            if st.cancelled:
                return  # explicit stop won the race
            instance = self.instances.get(instance_id)
            if instance is None:
                return  # stopped/deleted while the backoff ran
            if instance.process is not None and instance.process.is_alive():
                return  # never restart a live child (manual intervention)
            blockers = self._awake_holders(
                instance.config.chip_ids, exclude=instance_id
            )
            if blockers:
                self.ledger.release(instance_id)
                obj = instance.get_status()
                obj.update(exit_code=exitcode, restart_blocked_by=blockers)
                instance.last_revision = self._publish("STOPPED", obj)
                logger.warning(
                    "instance %s not restarted: its cards are held by "
                    "awake (or unreachable) %s", instance_id, blockers,
                )
                return
            try:
                with tracing.span("launcher.restart", instance=instance_id, attempt=attempt):
                    faults.fire("instance.spawn")
                    # append to the existing log: the crash forensics
                    # above the restart marker are what the operator needs
                    instance.start(fresh_log=False, restart=True)
            except Exception as e:  # noqa: BLE001 — spawn failed: retry
                logger.warning(
                    "instance %s restart attempt %d failed to spawn: %s",
                    instance_id, attempt, e,
                )
                if self._restart_allowed(instance_id):
                    self._schedule_restart(instance_id, None)
                else:
                    self.ledger.release(instance_id)
                return
            # the hold was kept across the crash window; acquire is
            # idempotent
            self.ledger.acquire(instance_id, instance.config.chip_ids)
            model = self._served_model(instance.config.options)
            if model is not None:
                self.ledger.set_model(instance_id, model)
            obj = instance.get_status()
            obj["restart_attempt"] = attempt
            instance.last_revision = self._publish("RESTARTED", obj)
            logger.info(
                "instance %s restarted (attempt %d, pid %s)",
                instance_id, attempt,
                instance.process.pid if instance.process else None,
            )
        loop = self._loop
        if loop is not None and loop.is_running():
            # crash detection must be re-armed on the event loop thread
            loop.call_soon_threadsafe(self._rearm_sentinel, instance_id)

    def _rearm_sentinel(self, instance_id: str) -> None:
        instance = self.instances.get(instance_id)
        if instance is None:
            return
        try:
            instance.start_sentinel_watcher(self._on_instance_stopped)
        except RuntimeError:
            logger.warning(
                "no running loop; sentinel not re-armed for %s", instance_id
            )

    def _cancel_restart(self, instance_id: str) -> None:
        with self._restart_lock:
            st = self._restart_states.pop(instance_id, None)
            if st is not None:
                st.cancelled = True
                if st.timer is not None:
                    st.timer.cancel()

    def stop_instance(self, instance_id: str, timeout: float = 10) -> Dict[str, Any]:
        if instance_id not in self.instances:
            raise KeyError(instance_id)
        instance = self.instances[instance_id]
        instance.cancel_sentinel_watcher()
        self._cancel_restart(instance_id)  # an explicit stop is not a crash
        result = instance.stop(timeout=timeout)
        del self.instances[instance_id]
        self.ledger.release(instance_id)
        result["revision"] = self._publish("DELETED", dict(result))
        logger.info("stopped instance %s", instance_id)
        return result

    def _poll_instance_stats(
        self, instance_id: str, timeout: float
    ) -> Dict[str, Any]:
        """One GET /v1/stats of a live instance's engine child, no retry."""
        return self._engine_request(instance_id, "GET", "/v1/stats", None, timeout, StatsFailed, retries=0)

    def _engine_request(
        self,
        instance_id: str,
        method: str,
        api_path: str,
        body: Optional[Dict[str, Any]],
        timeout: float,
        exc_cls,
        retries: int = 2,
    ) -> Dict[str, Any]:
        """Forward a call to a live instance's engine child; failures map
        onto ``exc_cls(instance_id, status, detail)``: the child's HTTP
        status, 400 for stored options that name no engine port, 504 for a
        timeout, 502 for an unreachable child. A refused connection never
        reached the engine, so it is retried up to ``retries`` times with
        backoff; a timeout is never retried (the call may be running: a
        swap sent again could swap twice)."""
        if instance_id not in self.instances:
            raise KeyError(instance_id)
        try:
            port = _engine_port(self.instances[instance_id])
        except ValueError as e:
            raise exc_cls(instance_id, 400, f"stored options are not engine options: {e}")
        verb = f"{method} {api_path}"
        # the child adopts the traceparent sent: its verb's spans hang off
        # this one, across the process boundary
        rpc_sp = tracing.begin("launcher.rpc", instance=instance_id, verb=verb)
        headers = {"Content-Type": "application/json"}
        tp = rpc_sp.traceparent()
        if tp:
            headers["traceparent"] = tp
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{api_path}", method=method,
            data=None if body is None else json.dumps(body).encode(), headers=headers,
        )

        def done(outcome: str, t0: float, end: bool = True) -> None:
            LAUNCHER_RPC_SECONDS.labels(verb=verb, outcome=outcome).observe(time.monotonic() - t0)
            if end:
                rpc_sp.set(outcome=outcome, attempts=attempt + 1).end()

        attempt = 0
        while True:
            t0 = time.monotonic()
            try:
                faults.fire("launcher.rpc")
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    out = json.loads(resp.read() or b"{}")
                done("ok", t0)
                return out
            except urllib.error.HTTPError as e:
                done(f"http_{e.code}", t0)
                raise exc_cls(instance_id, e.code, e.read().decode(errors="replace")[:500])
            except Exception as e:  # noqa: BLE001 — refused, timed out, reset, ...
                reason = getattr(e, "reason", e)
                if isinstance(reason, ConnectionRefusedError) and attempt < retries:
                    done("refused", t0, end=False)
                    attempt += 1
                    time.sleep(min(2.0, _RETRY_BACKOFF_S * 2 ** (attempt - 1) * (1.0 + random.random())))
                    continue
                if isinstance(reason, (TimeoutError, socket.timeout)):
                    done("timeout", t0)
                    raise exc_cls(instance_id, 504, f"engine timed out: {e}")
                done("unreachable", t0)
                raise exc_cls(instance_id, 502, f"engine unreachable: {e}")

    def swap_instance(
        self, instance_id: str, model: str, checkpoint_dir: str = "", timeout: float = 300
    ) -> Dict[str, Any]:
        """Hot-swap the model a live instance serves: forward to its
        child's ``POST /v1/swap`` (no stop/start: the cards, the process
        and its ledger hold stay), then bring the stored options and the
        ledger in line with the model the child serves and publish
        ``SWAPPED``. A timed-out swap is not sent again: the child's
        committed-swap record (``GET /v1/swap``) is polled for this call's
        request id."""
        with tracing.span("launcher.swap", instance=instance_id, model=model):
            return self._swap_instance_impl(instance_id, model, checkpoint_dir, timeout)

    def _swap_instance_impl(
        self, instance_id: str, model: str, checkpoint_dir: str = "", timeout: float = 300
    ) -> Dict[str, Any]:
        if instance_id not in self.instances:
            raise KeyError(instance_id)
        instance = self.instances[instance_id]
        previous = self._served_model(instance.config.options) or ""
        request_id = uuidlib.uuid4().hex
        try:
            body = self._engine_request(
                instance_id, "POST", "/v1/swap",
                {"model": model, "checkpoint_dir": checkpoint_dir, "request_id": request_id},
                timeout, SwapFailed,
            )
        except SwapFailed as e:
            if e.status != 504:
                raise
            body = self._recover_swap_result(instance_id, request_id, e)
        from .instance import replace_model_option

        # from the engine's answer: the options describe what the child
        # serves (a restart rebuilds from them)
        instance.config.options = replace_model_option(
            instance.config.options, model, checkpoint_dir=body.get("checkpoint_dir") or checkpoint_dir
        )
        self.ledger.set_model(instance_id, model)
        self.ledger.set_pool(instance_id, body.get("pool"))
        self.ledger.set_quant(instance_id, body.get("quant"))
        obj = instance.get_status()
        obj["swap"] = body
        instance.last_revision = self._publish("SWAPPED", obj)
        logger.info("swapped instance %s: %s -> %s (pool_hit=%s, rev %s)", instance_id, previous, model,
                    body.get("pool_hit"), instance.last_revision)
        return {"instance_id": instance_id, "model": model, "previous_model": previous, "swap": body,
                "revision": instance.last_revision}

    def prefetch_instance(
        self, instance_id: str, model: str, checkpoint_dir: str = "", timeout: float = 60
    ) -> Dict[str, Any]:
        """Have a live instance stage ``model``'s weights on its host (its
        child's ``POST /v1/prefetch``) while it keeps serving, and record
        the hint in the ledger: the controller's way of warming the
        predicted next swap. The hint is advisory: status reads drop it
        when the staging failed."""
        body = self._engine_request(
            instance_id, "POST", "/v1/prefetch", {"model": model, "checkpoint_dir": checkpoint_dir},
            timeout, PrefetchFailed,
        )
        self.ledger.set_prefetched(instance_id, model)
        self.ledger.set_pool(instance_id, body.get("pool"))
        logger.info("prefetch on instance %s: %s (state=%s)", instance_id, model, body.get("state"))
        return {"instance_id": instance_id, "model": model, "prefetch": body}

    def abort_instance_prefetch(self, instance_id: str, timeout: float = 90) -> Dict[str, Any]:
        """Cancel an instance's prefetch (its child's ``DELETE
        /v1/prefetch``) and drop the hint, unless there was nothing to
        abort because it had completed: those weights are still pooled."""
        body = self._engine_request(instance_id, "DELETE", "/v1/prefetch", None, timeout, PrefetchFailed)
        if body.get("aborted") or body.get("state") != "completed":
            self.ledger.set_prefetched(instance_id, None)
        return {"instance_id": instance_id, "prefetch": body}

    def get_instance_prefetch(self, instance_id: str, timeout: float = 10) -> Dict[str, Any]:
        """The child's prefetch state (``GET /v1/prefetch``); a staging
        that ended failed, rejected or aborted drops the hint."""
        body = self._engine_request(instance_id, "GET", "/v1/prefetch", None, timeout, PrefetchFailed)
        if body.get("state") in ("failed", "rejected", "aborted"):
            self.ledger.set_prefetched(instance_id, None)
        return {"instance_id": instance_id, "prefetch": body}

    def attach_instance_resident(
        self, instance_id: str, model: str, checkpoint_dir: str = "", timeout: float = 120
    ) -> Dict[str, Any]:
        """Have a live instance put ``model``'s delta leaves beside its base
        (its child's ``POST /v1/residents``) and route requests naming it
        from then on: the swap-free alternative to :meth:`swap_instance`
        for a sibling's traffic. The engine's refusal (the cap, the budget,
        a sibling it cannot resolve) is a 409 :class:`ResidentsFailed`."""
        with tracing.span("launcher.attach_resident", instance=instance_id, model=model):
            body = self._engine_request(
                instance_id, "POST", "/v1/residents", {"model": model, "checkpoint_dir": checkpoint_dir},
                timeout, ResidentsFailed,
            )
        self.ledger.set_residents(instance_id, body)
        logger.info("attached resident on instance %s: %s (handle=%s, wire_bytes=%s)", instance_id,
                    body.get("model", model), body.get("handle"), body.get("wire_bytes"))
        return {"instance_id": instance_id, "residents": body}

    def detach_instance_resident(
        self, instance_id: str, model: str, checkpoint_dir: str = "", timeout: float = 60
    ) -> Dict[str, Any]:
        """Drop a variant's delta from an instance's card (its child's
        ``DELETE /v1/residents``): nothing moves, the tiers keep every
        chunk, so attaching it again is delta-only."""
        body = self._engine_request(
            instance_id, "DELETE", "/v1/residents", {"model": model, "checkpoint_dir": checkpoint_dir},
            timeout, ResidentsFailed,
        )
        self.ledger.set_residents(instance_id, body)
        return {"instance_id": instance_id, "residents": body}

    def get_instance_residents(self, instance_id: str, timeout: float = 10) -> Dict[str, Any]:
        """The child's resident set (``GET /v1/residents``); refreshes the
        ledger's block."""
        body = self._engine_request(instance_id, "GET", "/v1/residents", None, timeout, ResidentsFailed)
        self.ledger.set_residents(instance_id, body)
        return {"instance_id": instance_id, "residents": body}

    def _recover_swap_result(
        self, instance_id: str, request_id: str, timeout_exc: SwapFailed, window_s: float = 10.0, poll_s: float = 0.5
    ) -> Dict[str, Any]:
        """A timed-out swap: poll the child's committed-swap record for
        ``request_id``. Found: the swap happened once and this is its
        answer; not within ``window_s``: the timeout, as a 504."""
        deadline = time.monotonic() + window_s
        while time.monotonic() < deadline:
            try:
                body = self._engine_request(instance_id, "GET", "/v1/swap", None, min(5.0, window_s), SwapFailed,
                                            retries=1)
            except SwapFailed:
                body = {}
            if body.get("request_id") == request_id:
                logger.info("swap on instance %s recovered through its request id after a timeout", instance_id)
                return body
            time.sleep(poll_s)
        raise SwapFailed(
            instance_id, 504,
            f"swap timed out and no committed record with request id {request_id} appeared within {window_s}s "
            f"({timeout_exc.detail})",
        )

    # -- live request migration and node drain ---------------------------------

    def _parsed_opts(self, instance_id: str):
        """A live instance's engine options, or None when they are not
        engine options (a fake kickoff's)."""
        from ..engine.server import parse_engine_options

        try:
            return parse_engine_options(self.instances[instance_id].config.options)
        except (ValueError, KeyError):
            return None

    def _resolve_migration_dest(self, instance_id: str, model: str, dest_id: Optional[str]) -> str:
        """The sibling a migration lands on, named or the first other live
        instance whose options serve ``model``. Only that is checked here:
        the engines hold the bundle to the weights' identity and the page
        geometry at the import."""
        if dest_id is not None:
            if dest_id == instance_id:
                raise MigrateFailed(instance_id, 400, "destination must be a different instance")
            if dest_id not in self.instances:
                raise MigrateFailed(instance_id, 404, f"no such destination instance {dest_id}")
            opts = self._parsed_opts(dest_id)
            if opts is None or opts.model != model:
                raise MigrateFailed(instance_id, 409, f"destination {dest_id} does not serve {model!r}; migration "
                                                      "needs a sibling with provable weight identity")
            return dest_id
        for other in self.instances:
            if other == instance_id:
                continue
            opts = self._parsed_opts(other)
            if opts is not None and opts.model == model:
                return other
        raise MigrateFailed(instance_id, 409, f"no sibling instance serves {model!r}; nothing to migrate to")

    def _abort_migration_on_source(self, instance_id: str, token: str, timeout: float) -> None:
        """The fenced abort after a failed import, best effort: the source
        resumes the bundle at home. A failure here is logged: the import's
        failure stays the error, and the bundle stays fenced on the source
        for a later ``POST /v1/parked/abort``."""
        if not token:
            return
        try:
            self._engine_request(instance_id, "POST", "/v1/parked/abort", {"fence_token": token}, timeout,
                                 MigrateFailed)
        except (MigrateFailed, KeyError) as e:
            logger.error("migration abort on source %s failed (%s); the bundle stays fenced under token %s: "
                         "POST /v1/parked/abort when the engine is reachable again", instance_id, e, token)

    def migrate_instance(self, instance_id: str, dest_id: Optional[str] = None, timeout: float = 300) -> Dict[str, Any]:
        """:meth:`_migrate_instance_impl` under a ``launcher.migrate`` span."""
        with tracing.span("launcher.migrate", instance=instance_id, dest=dest_id or ""):
            return self._migrate_instance_impl(instance_id, dest_id, timeout)

    def _migrate_instance_impl(self, instance_id: str, dest_id: Optional[str], timeout: float) -> Dict[str, Any]:
        """Hand an instance's live work to a sibling serving the same model:
        export the fenced bundle (the child's ``GET /v1/parked/{model}``),
        import it on the sibling (``POST /v1/parked``), release the source
        (``POST /v1/parked/release``), whose proxies then carry every stream
        from the sibling's claims. The engines' recoveries decide the rest:

        * an export that fails: the bundle never left, the child resumed it;
        * an import refused (409, 400) or timed out (504, never sent again):
          the fence is aborted, so the source resumes at home;
        * an import that failed otherwise: one blind retry (the fence makes
          it idempotent: a seated import replays its ack), then the abort."""
        from urllib.parse import quote

        if instance_id not in self.instances:
            raise KeyError(instance_id)
        opts = self._parsed_opts(instance_id)
        if opts is None:
            raise MigrateFailed(instance_id, 400, "stored options are not engine options")
        model = opts.model
        dest = self._resolve_migration_dest(instance_id, model, dest_id)
        t0 = time.monotonic()
        doc = self._engine_request(instance_id, "GET", f"/v1/parked/{quote(model, safe='')}", None, timeout,
                                   MigrateFailed)
        export_s = time.monotonic() - t0
        token = str((doc.get("fence") or {}).get("token") or "")
        t1 = time.monotonic()
        try:
            ack = self._engine_request(dest, "POST", "/v1/parked", doc, timeout, MigrateFailed)
        except MigrateFailed as e:
            if e.status in (400, 409, 504):
                # refused with nothing displaced, or maybe still running:
                # never sent again, the source resumes
                self._abort_migration_on_source(instance_id, token, timeout)
                raise
            try:
                ack = self._engine_request(dest, "POST", "/v1/parked", doc, timeout, MigrateFailed)
            except MigrateFailed:
                self._abort_migration_on_source(instance_id, token, timeout)
                raise
        import_s = time.monotonic() - t1
        dest_opts = self._parsed_opts(dest)
        dest_url = f"http://127.0.0.1:{dest_opts.port}" if dest_opts else ""
        t2 = time.monotonic()
        rel = self._engine_request(instance_id, "POST", "/v1/parked/release",
                                   {"fence_token": token, "dest": dest_url, "claims": ack.get("claims") or {}},
                                   timeout, MigrateFailed)
        result = {
            "instance_id": instance_id,
            "dest_id": dest,
            "model": model,
            "fence_token": token,
            "requests": int(ack.get("requests", 0)),
            "migrated": int(rel.get("migrated", 0)),
            "proxied": int(rel.get("proxied", 0)),
            "bytes": int(doc.get("nbytes", 0)),
            # the port's own: the exported KV, and the wire's KV payload
            # (base64, about 4/3 of it)
            "kv_bytes": int((doc.get("kv") or {}).get("nbytes", 0)),
            "wire_kv_bytes": sum(len(ch.get("k", "")) + len(ch.get("v", "")) for ch in (doc.get("kv") or {}).get(
                "chunks", ())),
            "import": {k: v for k, v in ack.items() if k != "claims"},
            "release": rel,
            # the port's own: this process's peak resident memory (the wire
            # is parsed and sent again whole)
            "launcher_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "seconds": {"export": round(export_s, 6), "import": round(import_s, 6),
                        "release": round(time.monotonic() - t2, 6)},
        }
        obj = self.instances[instance_id].get_status()
        obj["migration"] = {k: result[k] for k in ("dest_id", "model", "fence_token", "requests", "migrated",
                                                   "proxied", "bytes")}
        result["revision"] = self._publish("MIGRATED", obj)
        logger.info("migrated instance %s -> %s: %d request(s), %d byte(s), %d stream(s) proxied (rev %s)",
                    instance_id, dest, result["requests"], result["bytes"], result["proxied"], result["revision"])
        return result

    def drain_instance(self, instance_id: str, timeout: float = 300, max_passes: int = 8) -> Dict[str, Any]:
        """:meth:`_drain_instance_impl` under a ``launcher.drain`` span."""
        with tracing.span("launcher.drain", instance=instance_id):
            return self._drain_instance_impl(instance_id, timeout, max_passes)

    def _drain_instance_impl(self, instance_id: str, timeout: float, max_passes: int) -> Dict[str, Any]:
        """Migrate passes until the instance reports no queued or running
        work, then call it drained: the streams moved keep flowing through
        its proxies, arrivals between passes go with the next pass, and the
        instance is left idle, safe to stop. Streams it only proxies are
        not its work."""
        if instance_id not in self.instances:
            raise KeyError(instance_id)
        passes: List[Dict[str, Any]] = []
        drained = False
        depth = 0
        for _ in range(max_passes + 1):
            try:
                stats = self._poll_instance_stats(instance_id, min(timeout, 10.0))
            except (StatsFailed, KeyError) as e:
                raise DrainFailed(instance_id, 502, f"stats poll failed: {e}")
            depth = int(stats.get("queue_depth", 0))
            if depth == 0:
                drained = True
                break
            if len(passes) >= max_passes:
                break
            try:
                res = self.migrate_instance(instance_id, timeout=timeout)
            except MigrateFailed as e:
                if e.status == 409 and len(passes) + 1 < max_passes:
                    # a refused pass displaced nothing: a busy sibling may
                    # have room by the next one
                    passes.append({"refused": e.detail[:200]})
                    time.sleep(0.2)
                    continue
                raise DrainFailed(instance_id, e.status, f"migrate pass {len(passes) + 1} failed: {e.detail}")
            passes.append({k: res[k] for k in ("dest_id", "requests", "migrated", "bytes")})
        if not drained:
            raise DrainFailed(instance_id, 409, f"{depth} request(s) still live after {len(passes)} migrate "
                                                "pass(es); arrivals may outrun the drain: stop routing new work "
                                                "to this instance and retry")
        result = {
            "instance_id": instance_id,
            "drained": True,
            "passes": passes,
            "migrated": sum(p.get("migrated", 0) for p in passes),
            "bytes": sum(p.get("bytes", 0) for p in passes),
        }
        obj = self.instances[instance_id].get_status()
        obj["drain"] = {"passes": len(passes), "migrated": result["migrated"], "bytes": result["bytes"]}
        result["revision"] = self._publish("DRAINED", obj)
        logger.info("drained instance %s: %d pass(es), %d stream(s) migrated (rev %s)", instance_id, len(passes),
                    result["migrated"], result["revision"])
        return result

    def fleet_rollup(
        self, timeout: float = 1.5, ttl_s: float = 1.0
    ) -> Dict[str, Any]:
        """Aggregate every live engine child's GET /v1/stats into the
        node-level view (the ``fleet`` block of GET /v2/vllm/instances)
        and mirror it onto the ``fma_launcher_fleet_*`` gauges. Children
        are polled concurrently with a short per-poll timeout and no
        retries: an unreachable or free-form-options instance degrades to
        an ``unreachable`` row, never an error for the whole read. The
        children's ``zero_drain`` and ``migration`` blocks are summed (did
        an actuation or a handoff drop a stream, fleet-wide, in one read),
        and their ``residents`` blocks (the variants on the cards, their
        delta bytes, what the shared bases save); ``slo_exemplars`` are the
        children's, each with the instance it came from (its trace is in
        that child's ``GET /v1/traces?trace_id=``)."""
        now = time.monotonic()
        with self._fleet_lock:
            cached = self._fleet_cache
            if cached is not None and now - cached[0] < ttl_s:
                return cached[1]
            ids = list(self.instances)
        per_instance: Dict[str, Dict[str, Any]] = {}
        if ids:
            import concurrent.futures as _cf

            with _cf.ThreadPoolExecutor(
                max_workers=min(8, len(ids))
            ) as pool:
                futs = {
                    iid: pool.submit(
                        self._poll_instance_stats, iid, timeout
                    )
                    for iid in ids
                }
            for iid, fut in futs.items():
                try:
                    stats = fut.result()
                except (StatsFailed, KeyError) as e:
                    per_instance[iid] = {
                        "reporting": False,
                        "error": str(e)[:200],
                    }
                    continue
                per_instance[iid] = {"reporting": True, **stats}
        met = violated = 0
        queue_depth = 0
        arrival = 0.0
        goodput = generated = finished = 0
        actuations = 0
        actuations_per_hour = 0.0
        aborted: Dict[str, int] = {}
        zero_drain = {"preempted": 0, "resumed": 0, "aborted": 0, "migrated": 0, "parked_kv_bytes": 0}
        mig = {"committed": 0, "resumed_local": 0, "state_loss": 0, "requests_out": 0, "requests_in": 0,
               "bytes_out": 0, "bytes_in": 0}
        slo_exemplars: List[Dict[str, Any]] = []
        reporting = 0
        resident_variants = variant_hbm_bytes = coresident_saved_bytes = 0
        for iid, row in per_instance.items():
            if not row.get("reporting"):
                continue
            reporting += 1
            for ex in row.get("slo_exemplars") or []:
                if isinstance(ex, dict):
                    slo_exemplars.append({"instance": iid, **ex})
            slo = row.get("slo") or {}
            met += int(slo.get("met", 0))
            violated += int(slo.get("violated", 0))
            queue_depth += int(row.get("queue_depth", 0))
            arrival += float(row.get("arrival_rate_rps", 0.0))
            goodput += int(row.get("goodput_tokens", 0))
            generated += int(row.get("generated_tokens", 0))
            finished += int(row.get("finished_requests", 0))
            acts = sum(
                int(v) for v in (row.get("actuations") or {}).values()
            )
            actuations += acts
            uptime = float(row.get("uptime_s", 0.0))
            if uptime > 0:
                actuations_per_hour += acts * 3600.0 / uptime
            for cause, n in (row.get("aborted") or {}).items():
                aborted[cause] = aborted.get(cause, 0) + int(n)
            for block, total in (("zero_drain", zero_drain), ("migration", mig)):
                got = row.get(block) or {}
                for k in total:
                    total[k] += int(got.get(k, 0))
            res = row.get("residents") or {}
            resident_variants += 1 + len(res.get("attached") or [])
            variant_hbm_bytes += int(res.get("variant_hbm_bytes", 0))
            coresident_saved_bytes += int(res.get("saved_bytes", 0))
        judged = met + violated
        attainment = round(met / judged, 6) if judged else None
        fleet = {
            "instances_total": len(ids),
            "instances_reporting": reporting,
            "queue_depth": queue_depth,
            "arrival_rate_rps": round(arrival, 6),
            "slo_requests_met": met,
            "slo_requests_violated": violated,
            "slo_attainment": attainment,
            "finished_requests": finished,
            "generated_tokens": generated,
            "goodput_tokens": goodput,
            "actuations": actuations,
            "actuations_per_hour": round(actuations_per_hour, 3),
            "aborted": aborted,
            # zero-drain preemption and live migration, summed over the
            # children's /v1/stats blocks
            "zero_drain": zero_drain,
            "migration": mig,
            # co-residency (the children's /v1/stats residents): the
            # variants on the cards fleet-wide, their delta bytes, and
            # what sharing the base tensors saved
            "residents": {
                "resident_variants": resident_variants,
                "variant_hbm_bytes": variant_hbm_bytes,
                "coresident_saved_bytes": coresident_saved_bytes,
            },
            "slo_exemplars": slo_exemplars[-16:],
            "per_instance": per_instance,
        }
        LAUNCHER_FLEET_INSTANCES.labels(state="reporting").set(reporting)
        LAUNCHER_FLEET_INSTANCES.labels(state="unreachable").set(len(ids) - reporting)
        LAUNCHER_FLEET_QUEUE_DEPTH.set(queue_depth)
        LAUNCHER_FLEET_ARRIVAL_RATE.set(arrival)
        LAUNCHER_FLEET_SLO_ATTAINMENT.set(attainment if attainment is not None else 1.0)
        LAUNCHER_FLEET_GOODPUT_TOKENS.set(goodput)
        LAUNCHER_FLEET_ACTUATIONS_PER_HOUR.set(actuations_per_hour)
        LAUNCHER_FLEET_RESIDENT_VARIANTS.set(resident_variants)
        LAUNCHER_FLEET_CORESIDENT_SAVED_BYTES.set(coresident_saved_bytes)
        with self._fleet_lock:
            self._fleet_cache = (time.monotonic(), fleet)
        return fleet

    def stop_all_instances(self, timeout: float = 10) -> Dict[str, Any]:
        stopped = []
        for iid in list(self.instances):
            self.stop_instance(iid, timeout=timeout)
            stopped.append(iid)
        return {"status": "all_stopped", "stopped_instances": stopped}

    def get_instance_status(self, instance_id: str) -> Dict[str, Any]:
        if instance_id not in self.instances:
            raise KeyError(instance_id)
        return self.instances[instance_id].get_status()

    def get_all_instances_status(
        self, include_fleet: bool = False
    ) -> Dict[str, Any]:
        statuses = []
        running = 0
        # a snapshot: a delete on another executor thread may drop an
        # instance while the list is read
        for instance in list(self.instances.values()):
            st = instance.get_status()
            statuses.append(st)
            if st["status"] == STATUS_RUNNING:
                running += 1
        out: Dict[str, Any] = {
            "total_instances": len(statuses),
            "running_instances": running,
            "instances": statuses,
            # who holds which cards is the ledger's; what each holder
            # serves, has staged, pools and keeps co-resident are reported
            "ledger": {
                "models": self.ledger.models(),
                "prefetched": self.ledger.prefetched(),
                "pools": self.ledger.pools(),
                "quant": self.ledger.quant(),
                "residents": self.ledger.residents(),
            },
        }
        if include_fleet:
            # blocking child polls: only REST's executor-threaded GET
            # /v2/vllm/instances asks for it — in-process callers on the
            # event loop (the notifier's lister) must not
            try:
                out["fleet"] = self.fleet_rollup()
            except Exception as e:  # noqa: BLE001 — rollup never fails the read
                logger.warning("fleet rollup failed: %s", e)
                out["fleet"] = {"error": str(e)[:200]}
            # the cost oracle's rollup: each reporting child's /v1/stats
            # carries its bandwidths and prediction accuracy, lifted here
            # so one detailed read holds demand (fleet), state (ledger)
            # and cost, from one poll cycle
            per = (out["fleet"] or {}).get("per_instance") or {}
            out["ledger"]["costs"] = {
                iid: row.get("costs")
                for iid, row in per.items()
                if row.get("reporting") and row.get("costs") is not None
            }
        return out

    def list_instances(self) -> List[str]:
        return list(self.instances.keys())

    def get_instance_log_bytes(
        self, instance_id: str, start: int = 0, end: Optional[int] = None
    ):
        if instance_id not in self.instances:
            raise KeyError(instance_id)
        return self.instances[instance_id].get_log_bytes(start, end)

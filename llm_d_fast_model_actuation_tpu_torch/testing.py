"""In-process fakes for the dual-pods control plane: the port of the JAX
package's ``testing.py``, with card ids shaped as NVML's UUIDs
(:func:`gpu_uuid`) and the direct path's requester asking for
``nvidia.com/gpu``.

Plays the roles the reference's kind-based e2e rig plays with containers
(SURVEY.md §4.3): a fake scheduler (chip assignment), fake launcher fleet
(protocol-faithful instance CRUDL), and fake engines (sleep/wake/health),
all behind the same Transports seam the production HTTP clients implement.
Used by the test suite (the JAX package's benchmark harness also runs its
simulated mode on it; the benchmark is not ported). `SimLatencies`
injects delays so simulated scenario timings are meaningful.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .api import constants as C
from .controller.clients import InstanceNotFound
from .controller.directpath import DIRECT_PROVIDER_COMPONENT
from .controller.dualpods import (
    DualPodsConfig,
    DualPodsController,
)
from .controller.store import InMemoryStore


def gpu_uuid(i: int) -> str:
    """A card id shaped as NVML's UUID: ``GPU-`` and 8-4-4-4-12 hex."""
    return f"GPU-{i:08x}-0000-4000-8000-{i:012x}"


@dataclass
class SimLatencies:
    """Injected delays (seconds) so simulated-mode benchmark timings are
    meaningful; zeros (the default) keep unit tests instant."""

    launcher_start_s: float = 0.0  # launcher pod created -> ready
    instance_create_s: float = 0.0  # engine process cold start
    wake_s: float = 0.0  # level-1 wake (host -> card)
    sleep_s: float = 0.0  # level-1 sleep (card -> host)
    #: Running total of injected (scaled) delay — lets the benchmark unscale
    #: only the simulated-hardware share of a measurement instead of
    #: amplifying fixed harness overhead by 1/time_scale. Global counter:
    #: attribution to one actuation is only valid while actuations run
    #: serially (which the shipped scenarios do).
    injected_total_s: float = 0.0

    async def delay(self, seconds: float) -> None:
        if seconds > 0:
            self.injected_total_s += seconds
            await asyncio.sleep(seconds)


class FakeEngine:
    def __init__(self) -> None:
        self.sleeping = False
        self.healthy = True
        self.sleep_calls = 0
        self.wake_calls = 0


@dataclass
class FakeInstance:
    instance_id: str
    config: Dict[str, Any]
    status: str = "running"
    engine: FakeEngine = field(default_factory=FakeEngine)

    def state(self) -> Dict[str, Any]:
        return {
            "instance_id": self.instance_id,
            "status": self.status,
            **{k: v for k, v in self.config.items()},
        }


class FakeLauncher:
    def __init__(self, name: str, latencies: Optional[SimLatencies] = None) -> None:
        self.name = name
        self.latencies = latencies or SimLatencies()
        self.instances: Dict[str, FakeInstance] = {}
        self.created: List[str] = []
        self.deleted: List[str] = []

    async def create_named_instance(self, instance_id, config):
        if instance_id in self.instances:
            raise RuntimeError("409 duplicate")
        await self.latencies.delay(self.latencies.instance_create_s)
        inst = FakeInstance(instance_id, dict(config))
        self.instances[instance_id] = inst
        self.created.append(instance_id)
        return inst.state()

    async def list_instances(self):
        states = [i.state() for i in self.instances.values()]
        return {
            "total_instances": len(states),
            "running_instances": sum(1 for s in states if s["status"] == "running"),
            "instances": states,
        }

    async def get_instance(self, instance_id):
        if instance_id not in self.instances:
            raise InstanceNotFound(instance_id)
        return self.instances[instance_id].state()

    async def delete_instance(self, instance_id):
        if instance_id not in self.instances:
            raise InstanceNotFound(instance_id)
        inst = self.instances.pop(instance_id)
        self.deleted.append(instance_id)
        inst.status = "terminated"
        return inst.state()

    async def health(self):
        return True


class FakeSpi:
    def __init__(self, chips: List[str]) -> None:
        self.chips = chips
        self.ready = False
        self.memory: Dict[str, int] = {}

    async def accelerators(self):
        return list(self.chips)

    async def accelerator_memory(self):
        return dict(self.memory)

    async def become_ready(self):
        self.ready = True

    async def become_unready(self):
        self.ready = False


class FakeEngineHandle:
    def __init__(self, launcher: FakeLauncher, port: int) -> None:
        self._launcher = launcher
        self._port = port
        self._latencies = launcher.latencies

    def _target(self) -> Optional[FakeInstance]:
        for inst in self._launcher.instances.values():
            ann = inst.config.get("annotations") or {}
            if ann.get("inference-port") == str(self._port):
                return inst
        return None

    async def is_sleeping(self) -> bool:
        inst = self._target()
        if inst is None:
            raise RuntimeError(f"no instance on port {self._port}")
        return inst.engine.sleeping

    async def sleep(self, level: int = 1) -> None:
        inst = self._target()
        if inst is None:
            raise RuntimeError(f"no instance on port {self._port}")
        await self._latencies.delay(self._latencies.sleep_s)
        inst.engine.sleeping = True
        inst.engine.sleep_calls += 1

    async def wake_up(self) -> None:
        inst = self._target()
        if inst is None:
            raise RuntimeError(f"no instance on port {self._port}")
        await self._latencies.delay(self._latencies.wake_s)
        inst.engine.sleeping = False
        inst.engine.wake_calls += 1

    async def healthy(self) -> bool:
        inst = self._target()
        return inst is not None and inst.engine.healthy and not inst.engine.sleeping


class DirectEngineHandle:
    """Admin handle for a direct provider's (single) engine."""

    def __init__(self, engine: FakeEngine) -> None:
        self._e = engine

    async def is_sleeping(self) -> bool:
        return self._e.sleeping

    async def sleep(self, level: int = 1) -> None:
        self._e.sleeping = True
        self._e.sleep_calls += 1

    async def wake_up(self) -> None:
        self._e.sleeping = False
        self._e.wake_calls += 1

    async def healthy(self) -> bool:
        return self._e.healthy and not self._e.sleeping


class FakeTransports:
    def __init__(self, harness: "Harness") -> None:
        self._h = harness

    def launcher(self, pod):
        return self._h.launcher_for(pod["metadata"]["name"])

    def requester_spi(self, pod):
        return self._h.spi_for(pod["metadata"]["name"])

    def engine_admin(self, pod, port):
        labels = pod["metadata"].get("labels") or {}
        if labels.get(C.COMPONENT_LABEL) == DIRECT_PROVIDER_COMPONENT:
            return DirectEngineHandle(self._h.direct_engine_for(pod["metadata"]["name"]))
        return FakeEngineHandle(self._h.launcher_for(pod["metadata"]["name"]), port)


class Harness:
    def __init__(
        self,
        ns: str = "ns",
        latencies: Optional[SimLatencies] = None,
        store: Optional[Any] = None,
        **cfg_kwargs,
    ) -> None:
        self.ns = ns
        self.latencies = latencies or SimLatencies()
        self.store = store if store is not None else InMemoryStore()
        self.launchers: Dict[str, FakeLauncher] = {}
        self.spis: Dict[str, FakeSpi] = {}
        self.transports = FakeTransports(self)

        async def launcher_runtime(pod):
            self.launchers.setdefault(
                pod["metadata"]["name"],
                FakeLauncher(pod["metadata"]["name"], self.latencies),
            )
            await self.latencies.delay(self.latencies.launcher_start_s)
            # the "kubelet": give the pod an IP and mark it Ready
            def run(p):
                p.setdefault("status", {})["podIP"] = "10.0.0.1"
                p["status"]["conditions"] = [{"type": "Ready", "status": "True"}]
                return p

            self.store.mutate("Pod", pod["metadata"]["namespace"], pod["metadata"]["name"], run)

        self.direct_engines: Dict[str, FakeEngine] = {}

        async def provider_runtime(pod):
            # the "kubelet" for direct providers: engine comes up awake
            self.direct_engines.setdefault(pod["metadata"]["name"], FakeEngine())

            def run(p):
                p.setdefault("status", {})["podIP"] = "10.0.0.2"
                p["status"]["conditions"] = [{"type": "Ready", "status": "True"}]
                return p

            self.store.mutate("Pod", pod["metadata"]["namespace"], pod["metadata"]["name"], run)

        self.controller = DualPodsController(
            self.store,
            self.transports,
            DualPodsConfig(
                namespace=ns,
                launcher_runtime=launcher_runtime,
                provider_runtime=provider_runtime,
                **cfg_kwargs,
            ),
        )

    def launcher_for(self, name: str) -> FakeLauncher:
        if name not in self.launchers:
            self.launchers[name] = FakeLauncher(name, self.latencies)
        return self.launchers[name]

    def direct_engine_for(self, name: str) -> FakeEngine:
        if name not in self.direct_engines:
            self.direct_engines[name] = FakeEngine()
        return self.direct_engines[name]

    def spi_for(self, name: str) -> FakeSpi:
        if name not in self.spis:
            self.spis[name] = FakeSpi([])
        return self.spis[name]

    # -- object factories ----------------------------------------------------

    def add_isc(
        self,
        name: str,
        lc_name: str = "lc1",
        port: int = 8000,
        options: str = "--model tiny",
        labels: Optional[Dict[str, str]] = None,
        accelerator: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        return self.store.create(
            {
                "kind": "InferenceServerConfig",
                "metadata": {"name": name, "namespace": self.ns},
                "spec": {
                    "modelServerConfig": {
                        "port": port,
                        "options": options,
                        **({"labels": labels} if labels else {}),
                        **({"accelerator": accelerator} if accelerator else {}),
                    },
                    "launcherConfigName": lc_name,
                },
            }
        )

    def add_lc(self, name: str = "lc1", max_instances: int = 2) -> Dict[str, Any]:
        return self.store.create(
            {
                "kind": "LauncherConfig",
                "metadata": {"name": name, "namespace": self.ns},
                "spec": {
                    "podTemplate": {
                        "metadata": {},
                        "spec": {"containers": [{"name": "launcher"}]},
                    },
                    "maxInstances": max_instances,
                },
            }
        )

    def add_requester(
        self,
        name: str,
        isc_name: str,
        node: str = "n1",
        chips: Optional[List[str]] = None,
    ) -> Dict[str, Any]:
        self.spis[name] = FakeSpi(chips or [gpu_uuid(0)])
        return self.store.create(
            {
                "kind": "Pod",
                "metadata": {
                    "name": name,
                    "namespace": self.ns,
                    "annotations": {C.INFERENCE_SERVER_CONFIG_ANNOTATION: isc_name},
                },
                "spec": {
                    "nodeName": node,
                    "containers": [{"name": C.INFERENCE_SERVER_CONTAINER_NAME}],
                },
                "status": {
                    "podIP": "10.0.0.9",
                    "conditions": [{"type": "Ready", "status": "False"}],
                },
            }
        )

    def add_direct_requester(
        self,
        name: str,
        patch: str,
        node: str = "n1",
        chips: Optional[List[str]] = None,
        port: int = 8000,
    ) -> Dict[str, Any]:
        self.spis[name] = FakeSpi(chips or [gpu_uuid(0)])
        return self.store.create(
            {
                "kind": "Pod",
                "metadata": {
                    "name": name,
                    "namespace": self.ns,
                    "annotations": {C.SERVER_PATCH_ANNOTATION: patch},
                },
                "spec": {
                    "nodeName": node,
                    "containers": [
                        {
                            "name": C.INFERENCE_SERVER_CONTAINER_NAME,
                            "image": "requester-stub",
                            "readinessProbe": {"httpGet": {"port": port, "path": "/health"}},
                            "resources": {"limits": {C.GPU_RESOURCE: "1"}},
                        }
                    ],
                },
                "status": {
                    "podIP": "10.0.0.9",
                    "conditions": [{"type": "Ready", "status": "False"}],
                },
            }
        )

    def direct_provider_pods(self) -> List[Dict[str, Any]]:
        return self.store.list(
            "Pod", self.ns, selector={C.COMPONENT_LABEL: DIRECT_PROVIDER_COMPONENT}
        )

    # -- helpers -------------------------------------------------------------

    def launcher_pods(self) -> List[Dict[str, Any]]:
        return self.store.list(
            "Pod", self.ns, selector={C.COMPONENT_LABEL: C.LAUNCHER_COMPONENT}
        )

    def the_launcher_pod(self) -> Dict[str, Any]:
        pods = self.launcher_pods()
        assert len(pods) == 1, f"expected 1 launcher pod, got {len(pods)}"
        return pods[0]

    async def run(self, body) -> None:
        await self.controller.start()
        try:
            await body()
        finally:
            await self.controller.stop()

    async def settle(self, timeout: float = 20.0) -> None:
        await self.controller.quiesce(timeout)


def run_scenario(harness: Harness, body) -> None:
    asyncio.run(harness.run(body))

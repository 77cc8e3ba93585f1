"""End to end on the CPU: the port's whole control plane on one node.

The port's dual-pods controller and launcher populator run in this
process over an ``InMemoryStore``, speaking real HTTP
(``HttpTransports``) to real processes: requester stubs
(``requester.main --backend static``, one per requester Pod) and one
launcher (``launcher.main --mock-chips`` over a gpu-map file, so the cards
have NVML-shaped UUIDs) whose children are tiny port engines on the CPU.
A hook stands in for the kubelet: it gives each launcher Pod the
launcher's address, as ``chip_smoke.py``'s ``dualpods`` phase does on the
card. Three cases: cold then warm actuation, two ISCs time-sharing one
card, and a controller restart."""

import asyncio
import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
from conftest import REPO_ROOT, cpu_subprocess_env, free_port

from llm_d_fast_model_actuation_tpu_torch.api import constants as C
from llm_d_fast_model_actuation_tpu_torch.controller.clients import HttpTransports
from llm_d_fast_model_actuation_tpu_torch.controller.dualpods import DualPodsConfig, DualPodsController
from llm_d_fast_model_actuation_tpu_torch.controller.populator import Populator, PopulatorConfig
from llm_d_fast_model_actuation_tpu_torch.controller.store import InMemoryStore
from llm_d_fast_model_actuation_tpu_torch.testing import gpu_uuid

NS = "fma"
NODE = "n1"
CARDS = [gpu_uuid(i) for i in range(4)]
PROMPT = {"prompt": [1, 2, 3, 4, 5], "max_tokens": 6}


def call(url, method="GET", body=None, timeout=60):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(), method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def status_of(url):
    try:
        return call(url, timeout=2)[0]
    except OSError:
        return None


async def until(cond, timeout=120.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not await asyncio.to_thread(cond):
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        await asyncio.sleep(0.1)


@pytest.fixture(scope="module")
def launcher(tmp_path_factory):
    """One launcher process for the module, on a gpu-map of four cards."""
    logs = tmp_path_factory.mktemp("controlplane")
    gpu_map = logs / "gpu-map.json"
    gpu_map.write_text(json.dumps({NODE: "\n".join(f"{i} {u}" for i, u in enumerate(CARDS))}))
    port = free_port()
    with open(logs / "launcher.log", "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "llm_d_fast_model_actuation_tpu_torch.launcher.main", "--mock-chips",
             "--chip-map-path", str(gpu_map), "--host", "127.0.0.1", "--port", str(port), "--log-dir", str(logs)],
            cwd=REPO_ROOT, env=cpu_subprocess_env(NODE_NAME=NODE), stdout=out, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while status_of(base + "/health") != 200:
            assert proc.poll() is None and time.monotonic() < deadline, (logs / "launcher.log").read_text()
            time.sleep(0.1)
        yield SimpleLauncher(base, port, logs)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()


class SimpleLauncher:
    def __init__(self, base, port, logs):
        self.base, self.port, self.logs = base, port, logs

    def instances(self):
        return {s["instance_id"]: s for s in json.loads(call(self.base + "/v2/vllm/instances")[1])["instances"]}


class Node:
    """The store, the controllers and this node's requester stubs; the
    kubelet's part is :meth:`runtime` (launcher Pods) and
    :meth:`add_requester` (a stub process per requester Pod)."""

    def __init__(self, launcher):
        self.launcher = launcher
        self.store = InMemoryStore()
        self.stubs = {}
        self.controller = self.new_controller()
        self.populator = Populator(self.store, PopulatorConfig(namespace=NS, launcher_runtime=self.runtime))
        self.store.create({"kind": "Node", "metadata": {"name": NODE, "labels": {"pool": "cpu"}}})
        self.store.create({"kind": "LauncherConfig", "metadata": {"name": "lc1", "namespace": NS},
                           "spec": {"podTemplate": {"spec": {"containers": [{"name": "launcher"}]}},
                                    "maxInstances": 2}})
        self.store.create({"kind": "LauncherPopulationPolicy", "metadata": {"name": "lpp", "namespace": NS},
                           "spec": {"enhancedNodeSelector": {"labelSelector": {"matchLabels": {"pool": "cpu"}}},
                                    "countForLauncher": [{"launcherConfigName": "lc1", "launcherCount": 1}]}})

    def new_controller(self):
        return DualPodsController(self.store, HttpTransports(),
                                  DualPodsConfig(namespace=NS, launcher_runtime=self.runtime))

    async def runtime(self, pod):
        def run(p):
            p["metadata"].setdefault("annotations", {})[C.LAUNCHER_PORT_ANNOTATION] = str(self.launcher.port)
            p.setdefault("status", {})["podIP"] = "127.0.0.1"
            p["status"]["conditions"] = [{"type": "Ready", "status": "True"}]
            return p

        await asyncio.to_thread(self.store.mutate, "Pod", NS, pod["metadata"]["name"], run)

    def add_isc(self, name, seed):
        port = free_port()
        self.store.create({"kind": "InferenceServerConfig", "metadata": {"name": name, "namespace": NS},
                           "spec": {"modelServerConfig": {
                               "port": port,
                               "options": f"--model tiny --device cpu --port {port} --num-pages 32 --max-batch 2 "
                                          f"--page-size 8 --max-model-len 64 --seed {seed}"},
                               "launcherConfigName": "lc1"}})
        return port

    def add_requester(self, name, isc, card):
        spi, probes = free_port(), free_port()
        log = open(self.launcher.logs / f"{name}.log", "wb")
        self.stubs[name] = (subprocess.Popen(
            [sys.executable, "-m", "llm_d_fast_model_actuation_tpu_torch.requester.main", "--host", "127.0.0.1",
             "--backend", "static", "--chips", card, "--spi-port", str(spi), "--probes-port", str(probes)],
            env=cpu_subprocess_env(), stdout=log, stderr=subprocess.STDOUT), log)
        deadline = time.monotonic() + 60
        while status_of(f"http://127.0.0.1:{spi}{'/v1/dual-pods/accelerators'}") != 200:
            assert time.monotonic() < deadline, "the requester stub never served"
            time.sleep(0.05)
        self.store.create({"kind": "Pod", "metadata": {"name": name, "namespace": NS, "annotations": {
            C.INFERENCE_SERVER_CONFIG_ANNOTATION: isc, C.ADMIN_PORT_ANNOTATION: str(spi)}},
            "spec": {"nodeName": NODE, "containers": [{"name": C.INFERENCE_SERVER_CONTAINER_NAME}]},
            "status": {"podIP": "127.0.0.1"}})
        return f"http://127.0.0.1:{probes}/ready"

    def delete_requester(self, name):
        self.store.delete("Pod", NS, name)
        proc, log = self.stubs.pop(name)
        proc.terminate()
        proc.wait(timeout=15)
        log.close()

    async def ready(self, url, timeout=120.0):
        t0 = time.monotonic()
        await until(lambda: status_of(url) == 200, timeout, f"{url} ready")
        return time.monotonic() - t0

    def tokens(self, port):
        status, body = call(f"http://127.0.0.1:{port}/v1/completions", "POST", PROMPT)
        assert status == 200, body
        return json.loads(body)["choices"][0]["token_ids"]

    def sleeping(self, port):
        return json.loads(call(f"http://127.0.0.1:{port}/is_sleeping")[1])["is_sleeping"]

    def isc_instances(self, isc):
        return {i: s for i, s in self.launcher.instances().items()
                if (s.get("annotations") or {}).get("isc-name") == isc}

    async def start(self):
        await self.populator.start()
        await self.controller.start()

    async def stop(self):
        await self.controller.stop()
        await self.populator.stop()
        for proc, log in self.stubs.values():
            proc.terminate()
            proc.wait(timeout=15)
            log.close()

    async def remove_iscs(self, *names):
        """Delete the ISCs: the controller's GC deletes their instances."""
        for name in names:
            self.store.delete("InferenceServerConfig", NS, name)
        await until(lambda: not any(self.isc_instances(n) for n in names), 60, "the GC of the ISCs' instances")


def run(node, body):
    async def go():
        await node.start()
        try:
            await body()
        finally:
            await node.stop()

    asyncio.run(go())


@pytest.mark.e2e
def test_cold_then_warm_actuation(launcher):
    node = Node(launcher)
    port = node.add_isc("iscA", seed=0)

    async def body():
        cold = await node.ready(node.add_requester("r1", "iscA", CARDS[0]))
        gold = node.tokens(port)
        (iid,) = node.isc_instances("iscA")
        node.delete_requester("r1")
        await until(lambda: node.sleeping(port), 60, "A asleep")
        await until(lambda: node.store.try_get("Pod", NS, "r1") is None, 30, "r1's finalizer")
        warm = await node.ready(node.add_requester("r1b", "iscA", CARDS[0]))
        assert node.tokens(port) == gold
        assert list(node.isc_instances("iscA")) == [iid]  # woken, not created again
        assert warm < cold, (warm, cold)
        req = node.store.get("Pod", NS, "r1b")
        assert req["metadata"]["labels"][C.INSTANCE_LABEL] == iid
        assert json.loads(req["metadata"]["annotations"][C.STATUS_ANNOTATION]) == {"Errors": []}
        node.delete_requester("r1b")
        await until(lambda: node.sleeping(port), 60, "A asleep again")
        await node.remove_iscs("iscA")

    run(node, body)


@pytest.mark.e2e
def test_two_iscs_time_share_one_card(launcher):
    node = Node(launcher)
    port_a, port_b = node.add_isc("iscA", seed=0), node.add_isc("iscB", seed=1)

    async def body():
        await node.ready(node.add_requester("r1", "iscA", CARDS[1]))
        a_tokens = node.tokens(port_a)
        node.delete_requester("r1")
        await until(lambda: node.sleeping(port_a), 60, "A asleep")
        # B on the same card: admitted beside the sleeping A
        await node.ready(node.add_requester("r2", "iscB", CARDS[1]))
        b_tokens = node.tokens(port_b)
        assert node.sleeping(port_a) and not node.sleeping(port_b)
        node.delete_requester("r2")
        await until(lambda: node.sleeping(port_b), 60, "B asleep")
        await node.ready(node.add_requester("r1b", "iscA", CARDS[1]))
        assert node.tokens(port_a) == a_tokens and node.sleeping(port_b)
        ids = {isc: list(node.isc_instances(isc)) for isc in ("iscA", "iscB")}
        assert all(len(v) == 1 for v in ids.values()), ids
        assert {s["gpu_uuids"][0] for s in launcher.instances().values() if s["instance_id"] in
                ids["iscA"] + ids["iscB"]} == {CARDS[1]}
        assert b_tokens != a_tokens
        node.delete_requester("r1b")
        await until(lambda: node.sleeping(port_a), 60, "A asleep again")
        await node.remove_iscs("iscA", "iscB")

    run(node, body)


@pytest.mark.e2e
def test_a_restarted_controller_recovers_the_binding(launcher):
    node = Node(launcher)
    port = node.add_isc("iscA", seed=2)

    async def body():
        await node.ready(node.add_requester("r1", "iscA", CARDS[2]))
        (iid,) = node.isc_instances("iscA")
        await node.controller.stop()
        node.controller = node.new_controller()  # a new process: nothing in memory
        await node.controller.start()
        await node.controller.initial_sync.wait(timeout=30)
        assert list(node.isc_instances("iscA")) == [iid] and not node.sleeping(port)
        node.delete_requester("r1")
        await until(lambda: node.sleeping(port), 60, "A asleep after the restart")
        await node.ready(node.add_requester("r2", "iscA", CARDS[2]))
        assert list(node.isc_instances("iscA")) == [iid]
        node.delete_requester("r2")
        await until(lambda: node.sleeping(port), 60, "A asleep again")
        await node.remove_iscs("iscA")

    run(node, body)


@pytest.mark.e2e
def test_the_controller_process_starts_and_serves_its_metrics(tmp_path):
    port = free_port()
    with open(tmp_path / "controller.log", "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "llm_d_fast_model_actuation_tpu_torch.controller", "dual-pods-controller",
             "--namespace", NS, "--store", "memory", "--metrics-port", str(port)],
            cwd=REPO_ROOT, env=cpu_subprocess_env(), stdout=out, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while status_of(f"http://127.0.0.1:{port}/metrics") != 200:
            assert proc.poll() is None and time.monotonic() < deadline, (tmp_path / "controller.log").read_text()
            time.sleep(0.1)
        body = call(f"http://127.0.0.1:{port}/metrics")[1].decode()
        assert "# TYPE fma_actuation_seconds histogram" in body
        deadline = time.monotonic() + 30
        while "controller ready" not in (tmp_path / "controller.log").read_text():
            assert time.monotonic() < deadline
            time.sleep(0.1)
    finally:
        proc.terminate()
        proc.wait(timeout=15)

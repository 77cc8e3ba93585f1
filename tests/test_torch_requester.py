"""The port's requester stub held against the JAX package's, on the CPU.

The SPI and probes servers run on real sockets beside the JAX package's
(aiohttp) ones: the same requests must get the same statuses, content
types and bodies, set-log chunk sequences included (the reference's
chunk protocol, coordination/server.go:152-209). Then the card backends
(``real`` by NVML through a stub library, ``env`` through a gpu-map,
``static``), NVML's memory and utilization queries, the card allocation
loop (the JAX package's ``ChipAllocator`` scripts on the port's), and
the stub as its own process: it serves with ``static``, claims disjoint
cards with ``alloc`` against ``tests/fake_apiserver.py`` and releases
them on SIGTERM, and with ``real`` and no NVML it exits naming NVML.
Tolerance: none, these are bytes.
"""

import argparse
import asyncio
import ctypes
import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from llm_d_fast_model_actuation_tpu.api import spi as jspiapi
from llm_d_fast_model_actuation_tpu.requester import allocation as jalloc
from llm_d_fast_model_actuation_tpu.requester.probes import ProbesServer as JProbes
from llm_d_fast_model_actuation_tpu.requester.spi import LogSink as JLogSink
from llm_d_fast_model_actuation_tpu.requester.spi import ReadyFlag as JReady
from llm_d_fast_model_actuation_tpu.requester.spi import SpiServer as JSpi
from llm_d_fast_model_actuation_tpu_torch.api import spi as pspiapi
from llm_d_fast_model_actuation_tpu_torch.controller.store import InMemoryStore
from llm_d_fast_model_actuation_tpu_torch.native import nvml
from llm_d_fast_model_actuation_tpu_torch.requester import allocation as palloc
from llm_d_fast_model_actuation_tpu_torch.requester import main as pmain
from llm_d_fast_model_actuation_tpu_torch.requester.probes import ProbesServer as PProbes
from llm_d_fast_model_actuation_tpu_torch.requester.spi import LogSink as PLogSink
from llm_d_fast_model_actuation_tpu_torch.requester.spi import ReadyFlag as PReady
from llm_d_fast_model_actuation_tpu_torch.requester.spi import SpiServer as PSpi
from llm_d_fast_model_actuation_tpu_torch.testing import gpu_uuid

from conftest import cpu_subprocess_env, free_port

U0, U1 = gpu_uuid(0), gpu_uuid(1)


def test_the_spi_paths_are_the_jax_packages():
    names = [n for n in dir(jspiapi) if n.isupper()]
    assert names and {n: getattr(pspiapi, n) for n in names} == {n: getattr(jspiapi, n) for n in names}


# -- the servers, side by side ------------------------------------------------------


def _request(port, method, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.headers.get("Allow"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.headers.get("Allow"), e.read()


def _jax_servers(memory):
    from aiohttp import web

    ready = JReady(False)
    spi = JSpi([U0, U1], ready, memory_usage=memory)
    runners = []

    async def start():
        ports = []
        for app in (spi.build_app(), JProbes(ready).build_app()):
            runner = web.AppRunner(app)
            await runner.setup()
            port = free_port()
            await web.TCPSite(runner, "127.0.0.1", port).start()
            runners.append(runner)
            ports.append(port)
        return ports

    async def stop():
        for r in runners:
            await r.cleanup()

    return spi, start, stop


def _port_servers(memory):
    ready = PReady(False)
    spi = PSpi([U0, U1], ready, memory_usage=memory)
    apps = [spi.build_app(), PProbes(ready).build_app()]

    async def start():
        return [await app.start("127.0.0.1", 0) for app in apps]

    async def stop():
        for app in apps:
            await app.close()

    return spi, start, stop


def _broken():
    raise RuntimeError("telemetry down")


#: each script: (SPI or probes, method, path, body)
SCRIPTS = {
    "queries": [("spi", "GET", pspiapi.ACCELERATOR_QUERY_PATH, None),
                ("spi", "GET", pspiapi.ACCELERATOR_MEMORY_QUERY_PATH, None)],
    "readiness relay": [("probes", "GET", pspiapi.READY_PATH, None),
                        ("spi", "POST", pspiapi.BECOME_READY_PATH, b""),
                        ("probes", "GET", pspiapi.READY_PATH, None),
                        ("spi", "POST", pspiapi.BECOME_UNREADY_PATH, b""),
                        ("probes", "GET", pspiapi.READY_PATH, None)],
    "log chunks: continue, overlap, contained, gap, negative": [
        ("spi", "POST", pspiapi.SET_LOG_PATH + "?startPos=0", b"line1\n"),
        ("spi", "POST", pspiapi.SET_LOG_PATH + "?startPos=3", b"e1\nline2\n"),
        ("spi", "POST", pspiapi.SET_LOG_PATH + "?startPos=0", b"line"),
        ("spi", "POST", pspiapi.SET_LOG_PATH + "?startPos=999", b"gap"),
        ("spi", "POST", pspiapi.SET_LOG_PATH + "?startPos=-1", b"x"),
        ("spi", "POST", pspiapi.SET_LOG_PATH + "?startPos=12", b"tail")],
    "log chunks: bad parameters": [
        ("spi", "POST", pspiapi.SET_LOG_PATH, b"no param"),
        ("spi", "POST", pspiapi.SET_LOG_PATH + "?startPos=xyz", b"bad"),
        ("spi", "POST", pspiapi.SET_LOG_PATH + "?startPos=", b"empty")],
    "unknown path and method": [("spi", "GET", "/v1/nope", None),
                                ("spi", "POST", pspiapi.ACCELERATOR_QUERY_PATH, b""),
                                ("probes", "POST", pspiapi.READY_PATH, b"")],
}


def _run_script(servers, memory, script):
    spi, start, stop = servers(memory)

    async def go():
        spi_port, probes_port = await start()
        try:
            answers = []
            for plane, method, path, body in script:
                port = spi_port if plane == "spi" else probes_port
                answers.append(await asyncio.to_thread(_request, port, method, path, body))
            return answers
        finally:
            await stop()

    return asyncio.run(go()), spi.log_sink.content()


def _memory():
    return {U0: 123, U1: 456}


@pytest.mark.parametrize("name,memory", [(n, _memory) for n in SCRIPTS] + [("queries", _broken)],
                         ids=list(SCRIPTS) + ["queries, the memory backend failing"])
def test_the_spi_answers_as_the_jax_spi(name, memory):
    got = _run_script(_port_servers, memory, SCRIPTS[name])
    want = _run_script(_jax_servers, memory, SCRIPTS[name])
    assert got == want


@pytest.mark.parametrize("chunks", [
    [(0, b"hello "), (6, b"world"), (6, b"world! more"), (0, b"hello"), (100, b"x"), (-1, b"x")],
    [(0, b""), (0, b"abc"), (1, b"bcdef"), (6, b"g"), (5, b"fgh")],
])
def test_the_log_sink_keeps_the_jax_sinks_chunk_protocol(chunks):
    p, j = PLogSink(), JLogSink()
    assert [p.add_chunk(s, c) for s, c in chunks] == [j.add_chunk(s, c) for s, c in chunks]
    assert p.content() == j.content() and p.length == j.length


# -- the card backends --------------------------------------------------------------


class StubNvml:
    """Answers NVML's enumeration, memory and utilization calls as the
    library would, through the same ctypes arguments."""

    def __init__(self, gpus, fail=None):
        self.gpus, self.fail, self.inits, self.shutdowns = gpus, fail, 0, 0

    def _rc(self, name):
        return 999 if self.fail == name else 0

    def nvmlInit_v2(self):
        self.inits += self._rc("nvmlInit_v2") == 0
        return self._rc("nvmlInit_v2")

    def nvmlShutdown(self):
        self.shutdowns += 1
        return 0

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.gpus)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, handle):
        handle._obj.value = 1000 + i.value
        return 0

    def nvmlDeviceGetUUID(self, handle, buf, n):
        buf.value = self.gpus[handle.value - 1000]["uuid"].encode()
        return 0

    def nvmlDeviceGetName(self, handle, buf, n):
        buf.value = b"NVIDIA H100 80GB HBM3"
        return 0

    def nvmlDeviceGetHandleByUUID(self, uuid, handle):
        index = [g["uuid"].encode() for g in self.gpus].index(uuid) if uuid in [
            g["uuid"].encode() for g in self.gpus] else None
        if index is None:
            return 13  # NVML_ERROR_NOT_FOUND
        handle._obj.value = 1000 + index
        return self._rc("nvmlDeviceGetHandleByUUID")

    def nvmlDeviceGetMemoryInfo(self, handle, mem):
        g = self.gpus[handle.value - 1000]
        mem._obj.total, mem._obj.used, mem._obj.free = g["total"], g["used"], g["total"] - g["used"]
        return self._rc("nvmlDeviceGetMemoryInfo")

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        util._obj.gpu, util._obj.memory = self.gpus[handle.value - 1000]["util"]
        return self._rc("nvmlDeviceGetUtilizationRates")


class StubNvmlV2(StubNvml):
    """A library that also answers the second memory query, whose
    ``used`` leaves the driver's reservation out."""

    RESERVED = 536_870_912

    def nvmlDeviceGetMemoryInfo_v2(self, handle, mem):
        assert mem._obj.version == nvml.MEMORY_V2
        g = self.gpus[handle.value - 1000]
        m = mem._obj
        m.total, m.reserved, m.used = g["total"], self.RESERVED, g["used"]
        m.free = g["total"] - self.RESERVED - g["used"]
        return self._rc("nvmlDeviceGetMemoryInfo_v2")


GPUS = [{"uuid": U0, "total": 85_520_809_984, "used": 1_159_725_056, "util": (87, 41)},
        {"uuid": U1, "total": 85_520_809_984, "used": 4_194_304, "util": (0, 0)}]


@pytest.mark.parametrize("fail", [None, "nvmlInit_v2", "nvmlDeviceGetMemoryInfo", "nvmlDeviceGetUtilizationRates"])
def test_nvml_memory_and_utilization_queries(fail):
    lib = StubNvml(GPUS, fail)
    if fail in ("nvmlInit_v2", "nvmlDeviceGetMemoryInfo"):
        with pytest.raises(nvml.NvmlError, match=fail):
            nvml.memory_info([U1, U0], lib)
    else:
        assert nvml.memory_info([U1, U0], lib) == {
            U1: {"used": 4_194_304, "free": 85_516_615_680, "total": 85_520_809_984},
            U0: {"used": 1_159_725_056, "free": 84_361_084_928, "total": 85_520_809_984}}
        v2 = nvml.memory_info([U0], StubNvmlV2(GPUS))[U0]
        assert v2 == {"used": 1_159_725_056, "reserved": StubNvmlV2.RESERVED, "total": 85_520_809_984,
                      "free": 85_520_809_984 - StubNvmlV2.RESERVED - 1_159_725_056}
    if fail in ("nvmlInit_v2", "nvmlDeviceGetUtilizationRates"):
        with pytest.raises(nvml.NvmlError, match=fail):
            nvml.utilization([U0], lib)
    else:
        assert nvml.utilization([U0, U1], lib) == {U0: {"gpu": 87, "memory": 41}, U1: {"gpu": 0, "memory": 0}}
    with pytest.raises(nvml.NvmlError, match="nvmlDeviceGetHandleByUUID"):
        nvml.memory_info(["GPU-absent"], StubNvml(GPUS))
    assert lib.shutdowns == lib.inits  # every session opened is closed


def test_nvml_structures_match_the_librarys_layout():
    assert ctypes.sizeof(nvml.Memory) == 24 and ctypes.sizeof(nvml.Utilization) == 8
    assert ctypes.sizeof(nvml.MemoryV2) == 40 and nvml.MEMORY_V2 == 0x2000028  # nvml.h's nvmlMemory_v2


def test_the_real_backend_names_every_card_by_uuid_and_reads_nvmls_used_bytes(monkeypatch):
    lib = StubNvml(GPUS)
    monkeypatch.setattr(nvml, "load", lambda: lib)
    args = argparse.Namespace(backend="real", chips="", chip_map_path="")
    chips, cleanup = pmain.resolve_chips(args)
    assert chips == [U0, U1] and cleanup is None
    assert pmain.memory_backend(args, chips)() == {U0: 1_159_725_056, U1: 4_194_304}


def test_the_real_backend_raises_without_nvml(monkeypatch):
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    args = argparse.Namespace(backend="real", chips=U0, chip_map_path="")
    with pytest.raises(RuntimeError, match="needs NVML"):
        pmain.resolve_chips(args)
    with pytest.raises(nvml.NvmlError):
        pmain.memory_backend(args, [U0])()


def test_the_env_backend_reads_cuda_visible_devices_through_the_gpu_map(tmp_path, monkeypatch):
    path = tmp_path / "gpu-map.json"
    path.write_text(json.dumps({"n9": f"0 {U0}\n1 {U1}\n3 {gpu_uuid(3)}", "n8": f"0 {gpu_uuid(8)}"}))
    monkeypatch.setenv("NODE_NAME", "n9")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,1")
    args = argparse.Namespace(backend="env", chips="", chip_map_path=str(path))
    assert pmain.resolve_chips(args) == ([U1, gpu_uuid(3)], None)
    assert pmain.memory_backend(args, [U1])() == {U1: 0}
    monkeypatch.setenv("NODE_NAME", "absent")
    with pytest.raises(RuntimeError, match="not in the gpu-map"):
        pmain.resolve_chips(args)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    with pytest.raises(RuntimeError, match="CUDA_VISIBLE_DEVICES"):
        pmain.resolve_chips(args)


def test_the_static_backend():
    args = argparse.Namespace(backend="static", chips=f"{U0},{U1}", chip_map_path="")
    assert pmain.resolve_chips(args) == ([U0, U1], None)


# -- the allocation loop ------------------------------------------------------------


def _alloc_script(mod, store_cls):
    s = store_cls()
    pool = [U0, U1]
    out = []
    a, b = mod.ChipAllocator(s, "fma", "n1", "pod-a"), mod.ChipAllocator(s, "fma", "n1", "pod-b")
    out.append(a.allocate(1, pool))
    out.append(b.allocate(1, pool))
    c = mod.ChipAllocator(s, "fma", "n1", "pod-c")
    with pytest.raises(mod.OutOfChips):
        c.allocate(1, pool, timeout_s=0.2, poll_s=0.05)
    a.release()
    out.append(c.allocate(1, pool, timeout_s=5))
    out.append(mod.ChipAllocator(s, "fma", "n1", "pod-c").allocate(1, pool))  # idempotent
    out.append(json.loads(s.get("ConfigMap", "fma", mod.ALLOCATIONS_CONFIGMAP)["data"]["n1"]))
    return out


def test_the_allocation_loop_claims_as_the_jax_loop():
    from llm_d_fast_model_actuation_tpu.controller.store import InMemoryStore as JStore

    assert palloc.ALLOCATIONS_CONFIGMAP == jalloc.ALLOCATIONS_CONFIGMAP
    assert _alloc_script(palloc, InMemoryStore) == _alloc_script(jalloc, JStore)


def test_concurrent_claims_never_double_book():
    import threading

    s = InMemoryStore()
    pool = [gpu_uuid(i) for i in range(4)]
    got = {}

    def claim(i):
        got[i] = palloc.ChipAllocator(s, "fma", "n1", f"pod-{i}").allocate(1, pool, timeout_s=10)

    threads = [threading.Thread(target=claim, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(c for v in got.values() for c in v) == sorted(pool)


# -- the stub as its own process ----------------------------------------------------


def _stub(*flags, log):
    spi, probes = free_port(), free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_d_fast_model_actuation_tpu_torch.requester.main", "--host", "127.0.0.1",
         "--spi-port", str(spi), "--probes-port", str(probes), *flags],
        env=cpu_subprocess_env(), stdout=log, stderr=subprocess.STDOUT)
    return proc, spi, probes


def _wait_get(port, path, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return _request(port, "GET", path)
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"port {port} never answered")


def test_the_stub_process_serves_claims_and_releases(tmp_path):
    from fake_apiserver import FakeApiServer

    srv = FakeApiServer()
    srv.start()
    procs = []
    try:
        with open(tmp_path / "stub.log", "wb") as log:
            procs.append(_stub("--backend", "static", "--chips", f"{U0},{U1}", log=log))
            for i in range(2):
                procs.append(_stub("--backend", "alloc", "--api-base", f"http://127.0.0.1:{srv.port}",
                                   "--namespace", "fma", "--node", "n1", "--pod-name", f"pod-{i}",
                                   "--chips", f"{U0},{U1}", "--alloc-count", "1", log=log))
            static, spi, probes = procs[0]
            assert json.loads(_wait_get(spi, pspiapi.ACCELERATOR_QUERY_PATH)[3]) == [U0, U1]
            assert _wait_get(probes, pspiapi.READY_PATH)[0] == 503
            assert _request(spi, "POST", pspiapi.BECOME_READY_PATH, b"")[0] == 200
            assert _wait_get(probes, pspiapi.READY_PATH)[:2] == (200, "text/plain; charset=utf-8")
            claimed = [json.loads(_wait_get(p[1], pspiapi.ACCELERATOR_QUERY_PATH)[3]) for p in procs[1:]]
            assert sorted(c for got in claimed for c in got) == [U0, U1]
            procs[1][0].terminate()
            assert procs[1][0].wait(timeout=15) == 0
            cm = srv.store.get("ConfigMap", "fma", palloc.ALLOCATIONS_CONFIGMAP)
            assert list(json.loads(cm["data"]["n1"]).values()) == ["pod-1"]
    finally:
        for proc, _, _ in procs:
            proc.terminate()
        for proc, _, _ in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        srv.stop()


def test_the_real_backend_exits_naming_nvml_without_it(tmp_path):
    with open(tmp_path / "real.log", "wb") as log:
        proc, _, _ = _stub("--backend", "real", log=log)
        rc = proc.wait(timeout=60)
    out = (tmp_path / "real.log").read_text()
    assert rc != 0 and "needs NVML" in out and "libnvidia-ml.so.1" in out

"""The port's launcher held against the JAX launcher on the CPU.

Both launchers get the same fake children (``torch_launcher_fakes``: one
that logs and sleeps, one that exits with 17) and the same requests; the
JAX one through aiohttp's test client, the port's through ``urllib`` on
``127.0.0.1:0``. Their answers must agree in status, JSON (pids,
generated ids, revisions' absolute values and log paths masked, and the
card-pinning variables compared by meaning: ``TPU_VISIBLE_DEVICES``
against ``CUDA_VISIBLE_DEVICES``) and event types. Besides: the options
parser's repair, the translators, the exclusivity rule (where the GPU
rule differs from the TPU's, by design) at a create and at a restart,
supervision, and that preload
never touches ``torch.cuda``.
"""

import asyncio
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
from aiohttp.test_utils import TestClient, TestServer
from conftest import free_port
from torch_launcher_fakes import crashing_kickoff, fake_kickoff

from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu.launcher import chiptranslator as jchip
from llm_d_fast_model_actuation_tpu.launcher import instance as jinst
from llm_d_fast_model_actuation_tpu.launcher import manager as jmgr
from llm_d_fast_model_actuation_tpu.launcher import rest as jrest
from llm_d_fast_model_actuation_tpu.parallel.topology import ChipMap, HostTopology
from llm_d_fast_model_actuation_tpu_torch.engine import server as pserver
from llm_d_fast_model_actuation_tpu_torch.launcher import chiptranslator as pchip
from llm_d_fast_model_actuation_tpu_torch.launcher import instance as pinst
from llm_d_fast_model_actuation_tpu_torch.launcher import manager as pmgr
from llm_d_fast_model_actuation_tpu_torch.launcher import rest as prest
from llm_d_fast_model_actuation_tpu_torch.native import nvml

ROOT = pathlib.Path(__file__).resolve().parents[1]
MANAGERS = {"jax": jmgr, "port": pmgr}


# -- the options parser's repair -----------------------------------------------

OPTIONS = [
    '--model "hf:/models/my model" --port 8001',
    "--model 'hf:/a b/c d' --max-batch 4 --seed 3",
    "--model tiny --bogus 1",
    '--model "hf:/x y" --unknown-flag --port 9',
    "--model tiny extra",
    "--model tiny --port 'not a number'",
]


@pytest.mark.parametrize("options", OPTIONS)
def test_options_parse_as_the_reference_parses_them(options):
    """Quoted values (an ``hf:`` path holding a space) and unknown flags:
    the port's parser answers as the reference's, refusals word for word."""

    def parse(fn):
        try:
            a = fn(options)
        except (ValueError, SystemExit) as e:
            return type(e).__name__, str(e)
        return {k: getattr(a, k) for k in ("model", "port", "max_batch", "seed", "page_size")}

    want = parse(jserver.parse_engine_options)
    got = parse(pserver.parse_engine_options)
    if isinstance(want, tuple) and want[0] == "SystemExit":
        # argparse's own refusal of a bad value: the reference exits, the
        # port raises ValueError (its launcher answers 422 either way)
        assert got[0] == "ValueError" and "not a number" in got[1]
        return
    assert got == want


@pytest.mark.parametrize("model", ["hf:/models/my model", "tiny-gemma", "hf:/q'uote/d\"ir"])
def test_replace_model_option_round_trips_through_both_parsers(model):
    opts = "--model tiny --port 80 --checkpoint-dir /old"
    out = pinst.replace_model_option(opts, model)
    assert out == jinst.replace_model_option(opts, model)
    assert "--checkpoint-dir" not in out
    assert pserver.parse_engine_options(out).model == model
    assert jserver.parse_engine_options(out).model == model


# -- clients of the two servers --------------------------------------------------


class _Loop:
    """An event loop on a thread of its own, for synchronous test code."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 30):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


class JaxClient:
    """The JAX launcher's app behind aiohttp's test client."""

    def __init__(self, manager) -> None:
        self.manager = manager
        self._loop = _Loop()

        async def start():
            client = TestClient(TestServer(jrest.build_app(manager)))
            await client.start_server()
            return client

        self.client = self._loop.run(start())

    def request(self, method, path, json_body=None, data=None, headers=None):
        async def go():
            kw = {"headers": headers or {}}
            if json_body is not None:
                kw["json"] = json_body
            if data is not None:
                kw["data"] = data
            r = await self.client.request(method, path, **kw)
            return r.status, dict(r.headers), await r.read()

        return self._loop.run(go())

    def watch(self, path, n, timeout=10):
        async def go():
            resp = await self.client.get(path)
            if resp.status != 200:
                return resp.status, []
            events = []
            while len(events) < n:
                line = await asyncio.wait_for(resp.content.readline(), timeout)
                if line.strip():
                    events.append(json.loads(line))
            resp.close()
            return 200, events

        return self._loop.run(go(), timeout + 20)

    def close(self) -> None:
        self._loop.run(self.client.close())
        self._loop.stop()


class PortClient:
    """The port's app served on ``127.0.0.1:0`` from a thread, driven by
    ``urllib``."""

    def __init__(self, manager) -> None:
        self.manager = manager
        self.app = prest.LauncherApp(manager)
        self._loop = _Loop()
        self.url = f"http://127.0.0.1:{self._loop.run(self.app.start('127.0.0.1', 0))}"

    def request(self, method, path, json_body=None, data=None, headers=None):
        if json_body is not None:
            data = json.dumps(json_body).encode()
        req = urllib.request.Request(self.url + path, data=data, method=method, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def watch(self, path, n, timeout=10):
        try:
            r = urllib.request.urlopen(self.url + path, timeout=timeout)
        except urllib.error.HTTPError as e:
            return e.code, []
        with r:
            events = []
            while len(events) < n:
                line = r.readline()
                if line.strip():
                    events.append(json.loads(line))
            return 200, events

    def close(self) -> None:
        self._loop.run(self.app.close())
        self._loop.stop()


CLIENTS = {"jax": JaxClient, "port": PortClient}


def translators():
    return {
        "jax": jchip.ChipTranslator.create(mock_chips=True, mock_chip_count=8, mock_topology="2x4"),
        "port": pchip.ChipTranslator.create(mock_chips=True, mock_chip_count=8, mock_topology="2x4"),
    }


def make(impl, tmp_path, kickoff=fake_kickoff, **kw):
    manager = MANAGERS[impl].EngineProcessManager(
        translators()[impl], log_dir=str(tmp_path / impl), kickoff=kickoff, **kw
    )
    return CLIENTS[impl](manager)


class Masks:
    """Masks the values that differ by nature between two runs: pids,
    generated ids, revisions' absolute values, the fleet rows' error
    text; and the card-pinning variables, by meaning."""

    def __init__(self) -> None:
        self.ids = {}

    def id(self, value):
        return self.ids.setdefault(value, f"<id{len(self.ids)}>")

    def text(self, body: bytes) -> str:
        s = body.decode(errors="replace")
        for raw, masked in self.ids.items():
            s = s.replace(raw, masked)
        return s

    def __call__(self, obj, key=None):
        if isinstance(obj, dict):
            if key == "env_vars":
                visible = obj.get("TPU_VISIBLE_DEVICES", obj.get("CUDA_VISIBLE_DEVICES"))
                rest = {k: v for k, v in obj.items() if not k.startswith(("TPU_", "CUDA_"))}
                return {"visible": visible, **self(rest)}
            return {self.id(k) if k in self.ids else k: self(v, k) for k, v in obj.items()}
        if isinstance(obj, list):
            return [self(v, key) for v in obj]
        if key == "pid" and obj is not None:
            return "<pid>"
        if key == "revision" and obj is not None:
            return "<rev>"
        if key == "error":
            return "<error>"
        if isinstance(obj, str) and obj in self.ids:
            return self.ids[obj]
        return obj


def answer(masks, resp):
    status, headers, body = resp
    ctype = headers.get("Content-Type", "")
    if ctype.startswith("application/json"):
        return status, masks(json.loads(body))
    return status, masks.text(body), {k: headers[k] for k in ("Content-Range", "Accept-Ranges") if k in headers}


def wire_scenario(c) -> list:
    """The request sequence of the wire test; its masked answers."""
    m = Masks()
    out = []

    def step(name, *args, **kw):
        out.append((name, answer(m, c.request(*args, **kw))))
        return out[-1][1]

    step("health", "GET", "/health")
    status, index = c.request("GET", "/")[0], json.loads(c.request("GET", "/")[2])
    out.append(("index", (status, sorted(index["endpoints"]))))
    step("create named", "PUT", "/v2/vllm/instances/inst1", {"options": "--model tiny"})
    step("duplicate", "PUT", "/v2/vllm/instances/inst1", {"options": "x"})
    status, _, body = c.request("POST", "/v2/vllm/instances", {"options": "y", "chip_ids": ["tpu-mock-0-2"]})
    m.id(json.loads(body)["instance_id"])
    out.append(("create unnamed", (status, m(json.loads(body)))))
    step("create pinned", "PUT", "/v2/vllm/instances/pinned",
         {"options": "z", "gpu_uuids": ["tpu-mock-1-3", "tpu-mock-0-1"], "annotations": {"a": "b"}})
    step("not json", "POST", "/v2/vllm/instances", data=b"not json")
    step("no options", "POST", "/v2/vllm/instances", {"gpu_uuids": []})
    step("unknown chip", "PUT", "/v2/vllm/instances/bad", {"options": "q", "gpu_uuids": ["nope"]})
    step("get all", "GET", "/v2/vllm/instances")
    step("get ids", "GET", "/v2/vllm/instances?detail=false")
    step("get one", "GET", "/v2/vllm/instances/inst1")
    step("get unknown", "GET", "/v2/vllm/instances/ghost")
    step("unrouted", "GET", "/v2/vllm/nothing")
    deadline = time.time() + 20
    while time.time() < deadline:
        status, _, body = c.request("GET", "/v2/vllm/instances/inst1/log")
        if status == 200 and body.endswith(b"--model tiny\n"):
            break
        time.sleep(0.05)
    step("log", "GET", "/v2/vllm/instances/inst1/log")
    step("log 2-5", "GET", "/v2/vllm/instances/inst1/log", headers={"Range": "bytes=2-5"})
    step("log 3-", "GET", "/v2/vllm/instances/inst1/log", headers={"Range": "bytes=3-"})
    step("log suffix", "GET", "/v2/vllm/instances/inst1/log", headers={"Range": "bytes=-5"})
    step("log past end", "GET", "/v2/vllm/instances/inst1/log", headers={"Range": "bytes=999999-"})
    step("log unknown", "GET", "/v2/vllm/instances/ghost/log")
    status, events = c.watch("/v2/vllm/instances/watch", 3)
    out.append(("watch", (status, m(events))))
    status, events = c.watch("/v2/vllm/instances/watch?since=1", 2)
    out.append(("watch since 1", (status, m(events))))
    step("watch bad since", "GET", "/v2/vllm/instances/watch?since=x")
    step("delete", "DELETE", "/v2/vllm/instances/inst1")
    step("delete again", "DELETE", "/v2/vllm/instances/inst1")
    step("delete unknown", "DELETE", "/v2/vllm/instances/ghost")
    status, events = c.watch("/v2/vllm/instances/watch?since=3", 1)
    out.append(("watch the delete", (status, m(events))))
    step("delete all", "DELETE", "/v2/vllm/instances")
    step("get all, empty", "GET", "/v2/vllm/instances")
    # evict the buffer's head: a resume from revision 1 is gone
    while len(c.manager.broadcaster._buf) > 2:
        c.manager.broadcaster._buf.popleft()
    step("watch evicted", "GET", "/v2/vllm/instances/watch?since=1")
    return out


def test_wire_and_lifecycle_answer_as_the_jax_launcher(tmp_path):
    """The same request sequence against both launchers, with the same
    fake children: equal statuses, JSON and plain-text bodies, ranged-log
    headers, and watch events (types and objects) once masked."""
    runs = {}
    for impl in ("jax", "port"):
        c = make(impl, tmp_path)
        try:
            runs[impl] = wire_scenario(c)
        finally:
            c.close()
    (_, (jax_status, jax_index)), (_, (port_status, port_index)) = runs["jax"].pop(1), runs["port"].pop(1)
    # the port's index lists the routes it serves, each the JAX one's: all
    # of them since the residents verbs were ported
    assert port_status == jax_status == 200 and set(port_index) == set(jax_index)
    assert [name for name, _ in runs["port"]] == [name for name, _ in runs["jax"]]
    for (name, want), (_, got) in zip(runs["jax"], runs["port"]):
        assert got == want, name
    statuses = {name: ans[0] for name, ans in runs["port"]}
    assert statuses["create named"] == 201 and statuses["duplicate"] == 409
    assert statuses["not json"] == 422 and statuses["log 2-5"] == 206
    assert statuses["log past end"] == 416 and statuses["watch evicted"] == 410


def test_supervision_publishes_the_jax_managers_sequence(tmp_path):
    """A crashing child under ``RestartPolicy(budget=1)``: CREATED,
    STOPPED (exit code 17), RESTARTING, RESTARTED, then STOPPED with no
    restart, from both managers."""
    seqs = {}
    for impl in ("jax", "port"):
        policy = MANAGERS[impl].RestartPolicy(budget=1, backoff_s=0.05, jitter_frac=0.0)
        c = make(impl, tmp_path, kickoff=crashing_kickoff, restart_policy=policy)
        try:
            got = []

            def watch():
                got.extend(c.watch("/v2/vllm/instances/watch?since=0", 5, timeout=20)[1])

            t = threading.Thread(target=watch)
            t.start()
            time.sleep(0.2)
            assert c.request("PUT", "/v2/vllm/instances/C", {"options": "x"})[0] == 201
            t.join(40)
            time.sleep(0.5)  # no sixth event: the budget is spent
            assert c.manager.revision == 5
            assert c.request("GET", "/v2/vllm/instances/C")[0] == 200
            seqs[impl] = [(e["type"], e["object"].get("exit_code"), e["object"]["status"]) for e in got]
        finally:
            c.close()
    assert seqs["port"] == seqs["jax"] == [
        ("CREATED", None, "started"), ("STOPPED", 17, "stopped"), ("RESTARTING", 17, "stopped"),
        ("RESTARTED", None, "running"), ("STOPPED", 17, "stopped"),
    ]


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_a_delete_is_not_a_crash(impl, tmp_path):
    """A supervised instance deleted through REST: CREATED and DELETED,
    and no STOPPED, RESTARTING or new child after it (the port stops a
    child on the REST server's executor, off the loop that watches it)."""
    policy = MANAGERS[impl].RestartPolicy(budget=1, backoff_s=0.05, jitter_frac=0.0)
    c = make(impl, tmp_path, restart_policy=policy)
    try:
        assert c.request("PUT", "/v2/vllm/instances/d", {"options": "x"})[0] == 201
        assert json.loads(c.request("DELETE", "/v2/vllm/instances/d")[2])["status"] == "terminated"
        time.sleep(0.5)
        status, events = c.watch("/v2/vllm/instances/watch?since=0", 2)
        assert [e["type"] for e in events] == ["CREATED", "DELETED"]
        assert c.manager.revision == 2 and c.manager.instances == {}
    finally:
        c.close()


def test_a_sentinel_cancelled_off_the_loop_calls_back_nothing(tmp_path):
    """The port stops a child on the REST server's executor: a cancel from
    a thread that is not the loop's must still keep the child's end from
    reading as a crash."""
    loop = _Loop()
    inst = pinst.EngineInstance("s", pinst.InstanceConfig("x"), translators()["port"],
                                log_dir=str(tmp_path), kickoff=fake_kickoff)
    inst.start()
    calls = []
    try:
        async def arm():
            inst.start_sentinel_watcher(lambda iid, code: calls.append(code))

        loop.run(arm())
        inst.cancel_sentinel_watcher()
        os.kill(inst.process.pid, 9)
        inst.process.join(10)
        time.sleep(0.3)
        loop.run(asyncio.sleep(0))
        assert calls == [] and not inst.process.is_alive()
    finally:
        loop.stop()


# -- translators -------------------------------------------------------------------


def _chip_map(tmp_path):
    cm = ChipMap()
    cm.set_host("node-a", HostTopology.make("2x2", node="node-a"))
    path = tmp_path / "chipmap.json"
    path.write_text(json.dumps(cm.dump()))
    return str(path)


TRANSLATOR_CASES = {
    "chip-map": lambda p: dict(mock_chips=True, chip_map_path=_chip_map(p), node_name="node-a"),
    "node not in the map": lambda p: dict(mock_chips=True, chip_map_path=_chip_map(p), node_name="x",
                                          mock_chip_count=2),
    "naive 8": lambda p: dict(mock_chips=True, mock_chip_count=8),
    "naive 4": lambda p: dict(mock_chips=True, mock_chip_count=4),
    "naive 2x4": lambda p: dict(mock_chips=True, mock_topology="2x4"),
    "naive 12": lambda p: dict(mock_chips=True, mock_chip_count=12),
}


@pytest.mark.parametrize("case", list(TRANSLATOR_CASES))
def test_translators_agree_on_ids_and_visible_devices(case, tmp_path):
    kw = TRANSLATOR_CASES[case](tmp_path)
    j = jchip.ChipTranslator.create(**kw)
    p = pchip.ChipTranslator.create(**kw)
    assert p.mode == j.mode
    assert p.chip_ids() == j.chip_ids()
    ids = p.chip_ids()
    for subset in (ids[:1], ids[::-1][:3], ids[1::2]):
        want, got = j.env_for(subset), p.env_for(subset)
        assert got["CUDA_VISIBLE_DEVICES"] == want["TPU_VISIBLE_DEVICES"]
        assert got["FMA_CHIP_IDS"] == want["FMA_CHIP_IDS"]
        assert got["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
    for cid in ids:
        assert p.id_to_index(cid) == j.id_to_index(cid)
    with pytest.raises(KeyError):
        p.env_for(["bogus"])


def test_real_mode_without_nvml_raises_naming_mock_chips(monkeypatch):
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    with pytest.raises(RuntimeError, match="--mock-chips"):
        pchip.ChipTranslator.create()


class StubNvml:
    """Answers NVML's calls as the library would, through the same ctypes
    arguments."""

    def __init__(self, gpus, fail=None):
        self.gpus, self.fail, self.shut = gpus, fail, False

    def _rc(self, name):
        return 999 if self.fail == name else 0

    def nvmlInit_v2(self):
        return self._rc("nvmlInit_v2")

    def nvmlShutdown(self):
        self.shut = True
        return 0

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.gpus)
        return self._rc("nvmlDeviceGetCount_v2")

    def nvmlDeviceGetHandleByIndex_v2(self, i, handle):
        handle._obj.value = 1000 + i.value
        return self._rc("nvmlDeviceGetHandleByIndex_v2")

    def nvmlDeviceGetUUID(self, handle, buf, n):
        buf.value = self.gpus[handle.value - 1000][0].encode()
        assert n.value == len(buf)
        return self._rc("nvmlDeviceGetUUID")

    def nvmlDeviceGetName(self, handle, buf, n):
        buf.value = self.gpus[handle.value - 1000][1].encode()
        return self._rc("nvmlDeviceGetName")


@pytest.mark.parametrize("fail", [None, "nvmlInit_v2", "nvmlDeviceGetUUID"])
def test_nvml_parses_the_librarys_answers(fail):
    gpus = [("GPU-5b1e0c7a-0000-1111-2222-333344445555", "NVIDIA H100 80GB HBM3"),
            ("GPU-0f9d8c7b-aaaa-bbbb-cccc-ddddeeeeffff", "NVIDIA H100 80GB HBM3")]
    lib = StubNvml(gpus, fail)
    if fail:
        with pytest.raises(nvml.NvmlError, match=fail):
            nvml.enumerate_gpus(lib)
        return
    assert nvml.enumerate_gpus(lib) == [
        {"index": i, "uuid": u, "name": n} for i, (u, n) in enumerate(gpus)
    ]
    assert lib.shut


# -- the exclusivity rule ---------------------------------------------------------


def _stub_engine(body):
    """An engine admin API that answers /is_sleeping with ``body``."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            data = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


# holder state -> (JAX manager admits a second engine, the port's does)
HOLDERS = {
    # the GPU rule (SURVEY.md §7, "Exclusivity nuance"): CUDA contexts
    # coexist and a level-1 sleep gives the port's memory back, so a
    # sleeping holder does not block there; a TPU chip keeps one holder
    # until it releases its devices
    "asleep": ({"is_sleeping": True, "devices_released": False}, False, True),
    "asleep, devices released": ({"is_sleeping": True, "devices_released": True}, True, True),
    "awake": ({"is_sleeping": False, "devices_released": False}, False, False),
    "unreachable": (None, False, False),
}


@pytest.mark.parametrize("holder", list(HOLDERS))
def test_exclusivity_against_a_stub_engine(holder, tmp_path):
    body, jax_admits, port_admits = HOLDERS[holder]
    server = _stub_engine(body) if body is not None else None
    port = server.server_address[1] if server else free_port()
    try:
        for impl, admits in (("jax", jax_admits), ("port", port_admits)):
            mgr = MANAGERS[impl]
            t = translators()[impl]
            m = mgr.EngineProcessManager(t, log_dir=str(tmp_path / impl), kickoff=fake_kickoff)
            try:
                ids = t.chip_ids()
                m.create_instance(_config(impl, f"--model tiny --port {port}", ids[:2]), "x")
                if admits:
                    assert m.create_instance(_config(impl, "y", ids[1:3]), "y")["status"] == "started"
                else:
                    with pytest.raises(mgr.ChipConflict) as e:
                        m.create_instance(_config(impl, "y", ids[1:3]), "y")
                    assert e.value.blockers == ["x"] and "y" not in m.ledger.holders()
                # disjoint cards never consult the probe
                assert m.create_instance(_config(impl, "z", ids[5:7]), "z")["status"] == "started"
            finally:
                m.stop_all_instances(timeout=2)
    finally:
        if server:
            server.shutdown()


def _config(impl, options, chips):
    return (jinst if impl == "jax" else pinst).InstanceConfig(options=options, chip_ids=list(chips))


def test_the_port_probe_reads_a_sleeping_engine_as_asleep():
    asleep = _stub_engine({"is_sleeping": True, "devices_released": False})
    awake = _stub_engine({"is_sleeping": False, "devices_released": False})
    try:
        def probe(options):
            return pmgr.probe_instance_awake(pinst.EngineInstance("x", pinst.InstanceConfig(options),
                                                                  translators()["port"]))

        assert probe(f"--port {asleep.server_address[1]}") is False
        assert probe(f"--port {awake.server_address[1]}") is True
        assert probe(f"--port {free_port()}") is None  # nothing listening
        assert probe("--bogus") is None  # not engine options
    finally:
        asleep.shutdown()
        awake.shutdown()


# the other holder's state when a sleeping holder's child crashes -> whether
# the crashed one comes back
RESTART_HOLDERS = {"asleep": True, "awake": False, "unreachable": False}


@pytest.mark.parametrize("other", list(RESTART_HOLDERS))
def test_a_restart_is_held_to_the_exclusivity_rule(other, tmp_path):
    """``a`` sleeps, so ``b`` is admitted on its card; then ``a``'s child
    dies. A restarted child comes up awake: it comes back only if ``b`` is
    asleep. Otherwise STOPPED again, naming ``b``, the hold released and
    ``b``'s kept."""
    stub_a = _stub_engine({"is_sleeping": True, "devices_released": False})
    stub_b = None if other == "unreachable" else _stub_engine({"is_sleeping": other == "asleep"})
    port_b = stub_b.server_address[1] if stub_b else free_port()
    policy = pmgr.RestartPolicy(budget=1, backoff_s=0.05, jitter_frac=0.0)
    c = make("port", tmp_path, restart_policy=policy)
    try:
        card = translators()["port"].chip_ids()[:1]
        for iid, port in (("a", stub_a.server_address[1]), ("b", port_b)):
            body = {"options": f"--model tiny --port {port}", "chip_ids": card}
            assert c.request("PUT", f"/v2/vllm/instances/{iid}", body)[0] == 201
        pid = json.loads(c.request("GET", "/v2/vllm/instances/a")[2])["pid"]
        rev = c.manager.revision
        os.kill(pid, 9)
        status, events = c.watch(f"/v2/vllm/instances/watch?since={rev}", 3, timeout=20)
        assert status == 200
        got = [(e["type"], e["object"]["instance_id"], e["object"].get("exit_code")) for e in events]
        if RESTART_HOLDERS[other]:
            assert got == [("STOPPED", "a", -9), ("RESTARTING", "a", -9), ("RESTARTED", "a", None)]
            assert c.manager.ledger.holders() == {"a": card, "b": card}
        else:
            assert got == [("STOPPED", "a", -9), ("RESTARTING", "a", -9), ("STOPPED", "a", -9)]
            assert events[-1]["object"]["restart_blocked_by"] == ["b"]
            assert events[-1]["object"]["status"] == "stopped"
            assert c.manager.ledger.holders() == {"b": card}
    finally:
        c.close()
        stub_a.shutdown()
        if stub_b:
            stub_b.shutdown()


def test_a_create_validates_card_options_before_the_fork(tmp_path):
    """Without a fake kickoff the options are the engine's: a bad string
    is refused before any child exists (REST: 422)."""
    m = pmgr.EngineProcessManager(translators()["port"], log_dir=str(tmp_path))
    with pytest.raises(pinst.InvalidInstanceConfig, match="unknown engine options"):
        m.create_instance(pinst.InstanceConfig("--model llama3-8b --bogus"), "a")
    with pytest.raises(pinst.InvalidInstanceConfig, match="unknown model"):
        m.create_instance(pinst.InstanceConfig("--model nope"), "a")
    assert m.instances == {} and m.revision == 0


class _DeletesAnother:
    """An instance whose status read sees another one deleted meanwhile,
    as a DELETE on the REST server's executor does during a list."""

    def __init__(self, manager, iid, other):
        self.manager, self.iid, self.other = manager, iid, other

    def get_status(self):
        self.manager.instances.pop(self.other, None)
        return {"instance_id": self.iid, "status": "running"}


def test_the_list_survives_a_delete_while_it_reads(tmp_path):
    """The instance list reads a snapshot of the instances: a delete on
    another thread in the middle of the read never fails it (it answered
    500 when the controller's garbage collection raced the list)."""
    m = pmgr.EngineProcessManager(translators()["port"], log_dir=str(tmp_path))
    m.instances = {"a": _DeletesAnother(m, "a", "b"), "b": _DeletesAnother(m, "b", "a")}
    out = m.get_all_instances_status()
    assert [s["instance_id"] for s in out["instances"]] == ["a", "b"] and out["running_instances"] == 2
    assert m.instances == {}


# -- no CUDA at preload ---------------------------------------------------------------


def test_preload_and_option_checks_never_touch_cuda():
    """In a process where the first touch of ``torch.cuda`` raises:
    preload (mock mode, the fork server started), the check of a card
    options string, and a mock translator's pinning."""
    code = (
        "import torch\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('torch.cuda was touched')\n"
        "torch.cuda.is_available = torch.cuda.init = torch.cuda._lazy_init = boom\n"
        "from llm_d_fast_model_actuation_tpu_torch.launcher import chiptranslator, main, manager\n"
        "from llm_d_fast_model_actuation_tpu_torch.launcher.instance import CONTEXT\n"
        "main.preload()\n"
        "t = chiptranslator.ChipTranslator.create(mock_chips=True)\n"
        "env = t.env_for(t.chip_ids()[:1])\n"
        "m = manager.EngineProcessManager(t)\n"
        "from llm_d_fast_model_actuation_tpu_torch.engine.server import parse_engine_options\n"
        "a = parse_engine_options('--model llama3-8b --device cuda --num-pages 2048 --tensor-parallel-size 1')\n"
        "assert a.device == 'cuda' and env['CUDA_VISIBLE_DEVICES'] == '0'\n"
        "assert CONTEXT.get_start_method() == 'forkserver'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")

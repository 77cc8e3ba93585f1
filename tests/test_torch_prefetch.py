"""Prefetch through the port's service (``POST/GET/DELETE /v1/prefetch``,
the swap's ``prefetched`` tier) held against the reference's
``EngineService`` on the CPU, and the launcher's prefetch verb against the
JAX launcher's, mirroring the reference's ``tests/test_prefetch.py``.

* Prefetch then swap: two tiny sibling ``hf:`` directories (B's
  ``lm_head`` rows reversed), A serving, B prefetched, then swapped to,
  through both services at fp32 (``config_from_hf``'s dtype patched in on
  both sides, as ``tests/test_torch_service.py`` does): the same answer
  keys, greedy tokens equal to the reference's (no tolerance), the
  ``prefetched`` tier, and no checkpoint read on the swap's edge.
* The states and refusals: already pooled, the serving model, the pool's
  budget, validation, an abort over HTTP; a prefetched sibling holds only
  the leaves that differ; the tiers' fast path stages with no read.
* The launcher's verb and the ledger's ``prefetched`` block, over a stub
  engine, answer as the JAX launcher's.
"""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax.numpy as jnp
import pytest
import torch
from test_torch_launcher import Masks, answer, make, translators
from torch_launcher_fakes import fake_kickoff

from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.engine.model_pool import PrefetchedWeights
from llm_d_fast_model_actuation_tpu_torch.launcher import manager as pmgr
from llm_d_fast_model_actuation_tpu_torch.launcher.instance import InstanceConfig
from llm_d_fast_model_actuation_tpu_torch.models import hf as thf
from llm_d_fast_model_actuation_tpu_torch.utils import faults
from tests.conftest import build_tiny_hf_model_dir

OPTS = "--num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0 --swap-bucket-mib 1"
PROMPT = [1, 2, 3]
#: the keys of a swap's answer both services give for a prefetched swap
SWAP_KEYS = ("swapped", "pool_hit", "prefetched", "tier", "model", "previous_model")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def siblings(tmp_path_factory):
    """Two tiny HF directories that share every tensor but ``lm_head``."""
    from safetensors.torch import load_file, save_file

    a = build_tiny_hf_model_dir(str(tmp_path_factory.mktemp("hf") / "a"))
    b = str(tmp_path_factory.mktemp("hf") / "b")
    shutil.copytree(a, b)
    tensors = load_file(os.path.join(b, "model.safetensors"))
    tensors["lm_head.weight"] = tensors["lm_head.weight"].flip(0).contiguous()
    save_file(tensors, os.path.join(b, "model.safetensors"), metadata={"format": "pt"})
    return a, b


@pytest.fixture(scope="module")
def fp32():
    """Both packages' ``config_from_hf`` with ``dtype`` forced to fp32."""
    from llm_d_fast_model_actuation_tpu.models import hf as jhf

    jcfg, tcfg = jhf.config_from_hf, thf.config_from_hf
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhf, "config_from_hf", lambda path, **kw: jcfg(path, **dict(kw, dtype=jnp.float32)))
        mp.setattr(thf, "config_from_hf", lambda path, **kw: tcfg(path, **dict(kw, dtype=torch.float32)))
        yield


def _port(model: str, extra: str = ""):
    return tserver.EngineService(tserver.parse_engine_options(f"--model {model} {OPTS} --device cpu {extra}"))


def _gen(svc) -> list:
    return svc.submit(prompt=PROMPT, max_new_tokens=4).result(timeout=120).out_tokens


def _jgen(svc) -> list:
    return svc.submit(PROMPT, 4, 0.0).result(timeout=120).out_tokens


def _wait(status, timeout: float = 60.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        body = status()
        if body.get("state") != "running":
            return body
        time.sleep(0.02)
    raise AssertionError("the prefetch did not finish in time")


class _Http:
    """The port's server on a free port, called over HTTP."""

    def __init__(self, svc) -> None:
        self.svc = svc
        self.server = tserver.serve(svc, "127.0.0.1", 0)
        self.port = self.server.server_address[1]

    def __call__(self, method: str, path: str, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}", method=method,
                                     data=None if body is None else json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def wait(self) -> dict:
        return _wait(lambda: self("GET", "/v1/prefetch")[1])

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.svc.shutdown()


def test_prefetch_then_the_first_swap_is_the_prefetched_tier(siblings, fp32, monkeypatch):
    a, b = siblings
    model = f"hf:{b}"
    j = jserver.EngineService(jserver.parse_engine_options(f"--model hf:{a} {OPTS} --model-pool-mib 256"))
    try:
        want = [_jgen(j)]
        assert j.prefetch(model)["started"]
        assert _wait(j.prefetch_status)["state"] == "completed"
        out = j.swap(model)
        want += [{k: out[k] for k in SWAP_KEYS}, _jgen(j)]
    finally:
        j.shutdown()
    http = _Http(_port(f"hf:{a}", "--model-pool-mib 256"))
    svc = http.svc
    try:
        got = [_gen(svc)]
        builds = svc.builds_total
        status, body = http("POST", "/v1/prefetch", {"model": model})
        assert status == 200 and body["started"] and body["state"] in ("running", "completed")
        assert _gen(svc) == got[0]  # the serving model answers while the next one stages
        done = http.wait()
        assert done["state"] == "completed" and done["bytes"] == thf.estimate_param_bytes(thf.config_from_hf(b))
        assert model in done["pool"]["models"] and done["workers"] >= 1 and done["read_s"] > 0
        assert svc.builds_total == builds, "staging built an engine"
        reads = []
        real = thf.load_params
        monkeypatch.setattr(thf, "load_params", lambda *args, **kw: reads.append(args) or real(*args, **kw))
        status, out = http("POST", "/v1/swap", {"model": model})
        assert status == 200
        got += [{k: out[k] for k in SWAP_KEYS}, _gen(svc)]
        assert got == want
        assert out["tier"] == "prefetched" and out["prefetched"] and out["bytes_in"] > 0 and out["build_s"] > 0
        assert reads == [] and svc.loads == 0, "the prefetched swap read the checkpoint"
        assert svc.builds_total == builds + 1 and out["warmup"]["programs"] == 0  # the CPU captures no graph
        assert svc._runtime.digests and set(svc._runtime.digests) == set(svc.model_pool.peek(f"hf:{a}").weight_digests)
        status, models = http("GET", "/v1/models")
        assert models["data"][0]["id"] == model
    finally:
        http.close()


def test_prefetch_already_pooled_and_serving_model(siblings):
    a, b = siblings
    http = _Http(_port(f"hf:{a}"))
    try:
        assert http("POST", "/v1/prefetch", {"model": f"hf:{b}"})[0] == 200
        assert http.wait()["state"] == "completed"
        status, body = http("POST", "/v1/prefetch", {"model": f"hf:{b}"})
        assert status == 200 and body["state"] == "already_pooled" and not body["started"]
        status, body = http("POST", "/v1/prefetch", {"model": f"hf:{a}"})
        assert status == 400 and "already the serving model" in body["error"]
        assert http("POST", "/v1/swap", {"model": f"hf:{b}"})[1]["tier"] == "prefetched"
        status, body = http("POST", "/v1/prefetch", {"model": f"hf:{b}"})
        assert status == 400 and "already the serving model" in body["error"]
        # A was pooled by the swap
        assert http("POST", "/v1/prefetch", {"model": f"hf:{a}"})[1]["state"] == "already_pooled"
    finally:
        http.close()


def test_prefetch_budget_rejection(siblings):
    """--model-pool-mib 0 disables pooling: a prefetch is refused up front
    instead of staging bytes the pool can never keep."""
    a, b = siblings
    http = _Http(_port(f"hf:{a}", "--model-pool-mib 0"))
    try:
        status, body = http("POST", "/v1/prefetch", {"model": f"hf:{b}"})
        assert status == 400 and "budget" in body["error"]
        assert http("GET", "/v1/prefetch")[1]["state"] == "idle"
    finally:
        http.close()


def test_prefetch_validation_errors(siblings):
    a, _ = siblings
    http = _Http(_port(f"hf:{a}"))
    try:
        for body, match in (({}, "'model' string"), ({"model": "hf:"}, "directory path"),
                            ({"model": "no-such-model"}, "hf:<model-dir>"), ({"model": "tiny"}, "hf:<model-dir>"),
                            ({"model": "hf:/nonexistent-dir"}, "config.json"),
                            ({"model": "hf:/x", "checkpoint_dir": "/ckpt"}, "checkpoint_dir")):
            status, out = http("POST", "/v1/prefetch", body)
            assert status == 400 and match in out["error"], (body, out)
        assert http("GET", "/v1/prefetch")[1] == {"state": "idle"}
        assert http("DELETE", "/v1/prefetch")[1] == {"aborted": False, "state": "idle"}
    finally:
        http.close()
    mesh = tserver.EngineService(tserver.parse_engine_options(
        f"--model tiny {OPTS} --device cpu,cpu --tensor-parallel-size 2"))
    try:
        with pytest.raises(ValueError, match="tensor-parallel mesh"):
            mesh.prefetch(f"hf:{a}")
    finally:
        mesh.shutdown()


def test_prefetch_abort_over_http(siblings, monkeypatch):
    """DELETE /v1/prefetch while the readers are held by the fault point:
    state aborted, nothing pooled; a new prefetch then completes."""
    a, b = siblings
    http = _Http(_port(f"hf:{a}"))
    try:
        faults.arm_spec("coldload.read=delay:0.5")
        assert http("POST", "/v1/prefetch", {"model": f"hf:{b}"})[0] == 200
        time.sleep(0.1)
        status, body = http("DELETE", "/v1/prefetch")
        assert status == 200 and body["aborted"] is True and body["state"] == "aborted"
        assert http("GET", "/v1/prefetch")[1]["state"] == "aborted"
        assert len(http.svc.model_pool) == 0
        faults.reset()
        status, body = http("POST", "/v1/prefetch", {"model": f"hf:{b}"})
        assert status == 200 and body["started"]
        assert http.wait()["state"] == "completed"
        # the prefetch.stage point fails the next one, reported by GET
        http.svc._free_pooled(http.svc.model_pool.drain())
        faults.arm_spec("prefetch.stage=fail:1")
        assert http("POST", "/v1/prefetch", {"model": f"hf:{b}"})[0] == 200
        done = http.wait()
        assert done["state"] == "failed" and "prefetch.stage" in done["error"]
    finally:
        http.close()


def test_one_prefetch_at_a_time(siblings):
    a, b = siblings
    http = _Http(_port(f"hf:{a}", "--prefetch-mib-s 1"))  # 1 MiB/s: the 0.2 MB model stages for a while
    try:
        faults.arm_spec("coldload.read=delay:0.5")
        assert http("POST", "/v1/prefetch", {"model": f"hf:{b}"})[0] == 200
        status, body = http("POST", "/v1/prefetch", {"model": f"hf:{b}"})
        assert status == 400 and "already in progress" in body["error"]
        assert http.wait()["state"] == "completed"
    finally:
        http.close()


def test_a_prefetched_sibling_holds_only_the_leaves_that_differ(siblings):
    """B serves and A is pooled (its copies interned): a prefetch of A's
    sibling B' adds only its lm_head to the pool's host bytes."""
    a, b = siblings
    svc = _port(f"hf:{a}")
    try:
        svc.swap(f"hf:{b}")  # A pooled
        before = svc.model_pool.bytes_used
        c = b.rstrip("/") + "-again"
        shutil.copytree(b, c)
        try:
            svc.prefetch(f"hf:{c}")
            assert _wait(svc.prefetch_status)["state"] == "completed"
            entry = svc.model_pool.peek(f"hf:{c}")
            assert isinstance(entry.runtime, PrefetchedWeights)
            lm_head = entry.runtime.params_host["lm_head"]
            shared = entry.nbytes - lm_head.numel() * lm_head.element_size()
            assert svc.model_pool.bytes_used == before + entry.nbytes - shared
            assert entry.runtime.params_host["embed"] is svc.model_pool.chunks.fetch(entry.runtime.digests["embed"])
        finally:
            shutil.rmtree(c)
    finally:
        svc.shutdown()


def test_the_tiers_fast_path_stages_with_no_read(siblings, tmp_path, monkeypatch):
    """An evicted model whose chunks spilled to the disk tier prefetches
    from the tier (no checkpoint read), and its swap is prefetched."""
    a, b = siblings
    copy = str(tmp_path / "a-copy")
    shutil.copytree(a, copy)
    svc = _port(f"hf:{copy}", f"--pool-disk-dir {tmp_path / 'tier'} --pool-disk-mib 64")
    try:
        gold = _gen(svc)
        svc.swap(f"hf:{b}")  # pools A
        svc._free_pooled(svc.model_pool.drain())  # evicted: its chunks spill, its manifest stays
        shutil.rmtree(copy)  # nothing to read again
        reads = []
        monkeypatch.setattr(thf, "load_params", lambda *args, **kw: reads.append(args))
        out = svc.prefetch(f"hf:{copy}")
        assert out["state"] == "completed" and out["source"] == "tier" and out["tier"] == "disk" and not out["started"]
        swap = svc.swap(f"hf:{copy}")
        assert swap["tier"] == "prefetched" and _gen(svc) == gold and reads == []
    finally:
        svc.shutdown()


# -- the launcher's verb ------------------------------------------------------


def _stub_prefetch_engine():
    """An engine admin API for the prefetch verb: ``POST /v1/prefetch``
    answers running (400 for ``hf:/bad``), ``GET`` completed (failed for
    the model after ``hf:/fails``), ``DELETE`` aborted."""
    calls = []
    state = {"get": {"state": "completed", "bytes": 123,
                     "pool": {"models": ["hf:/models/next"], "bytes_used": 10, "budget_bytes": 100,
                              "chunks": {"dedup_saved_bytes": 0, "disk_bytes": 0}, "staged_manifests": []}}}

    class Handler(BaseHTTPRequestHandler):
        def _send(self, status, obj):
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])) or b"{}")
            calls.append(("POST", self.path, body))
            if body.get("model") == "hf:/bad":
                return self._send(400, {"error": "nope"})
            return self._send(200, {"state": "running", "model": body.get("model"), "started": True})

        def do_GET(self):
            calls.append(("GET", self.path, None))
            if self.path == "/is_sleeping":
                return self._send(200, {"is_sleeping": False, "devices_released": False})
            return self._send(200, state["get"])

        def do_DELETE(self):
            calls.append(("DELETE", self.path, None))
            return self._send(200, {"aborted": True, "state": "aborted"})

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, calls, state


def _prefetch_scenario(c, port: int, state: dict) -> list:
    masks = Masks()
    out = []
    assert c.request("PUT", "/v2/vllm/instances/a", {"options": f"--model tiny --port {port}"})[0] == 201
    state["get"]["state"] = "completed"

    def ledger():
        listing = json.loads(c.request("GET", "/v2/vllm/instances")[2])
        return listing["ledger"]["prefetched"], listing["ledger"]["pools"]

    out.append(answer(masks, c.request("POST", "/v2/vllm/instances/a/prefetch", {"model": "hf:/models/next"})))
    out.append(ledger())
    out.append(answer(masks, c.request("GET", "/v2/vllm/instances/a/prefetch")))
    out.append(ledger())
    out.append(answer(masks, c.request("DELETE", "/v2/vllm/instances/a/prefetch")))
    out.append(ledger())
    for body in ({}, {"model": "hf:/x", "checkpoint_dir": 3}):
        out.append(answer(masks, c.request("POST", "/v2/vllm/instances/a/prefetch", body))[0])
    out.append(answer(masks, c.request("POST", "/v2/vllm/instances/zzz/prefetch", {"model": "hf:/x"}))[0])
    out.append(answer(masks, c.request("GET", "/v2/vllm/instances/zzz/prefetch"))[0])
    out.append(answer(masks, c.request("POST", "/v2/vllm/instances/a/prefetch", {"model": "hf:/bad"}))[0])
    # a staging that failed drops the hint at the next status read
    c.request("POST", "/v2/vllm/instances/a/prefetch", {"model": "hf:/fails"})
    out.append(ledger()[0])
    state["get"]["state"] = "failed"
    out.append(answer(masks, c.request("GET", "/v2/vllm/instances/a/prefetch"))[0])
    out.append(ledger()[0])
    return out


def test_the_launcher_prefetch_verb_answers_as_the_jax_launchers(tmp_path):
    engine, calls, state = _stub_prefetch_engine()
    results = {}
    try:
        for impl in ("jax", "port"):
            c = make(impl, tmp_path)
            try:
                results[impl] = _prefetch_scenario(c, engine.server_address[1], state)
            finally:
                c.manager.stop_all_instances(timeout=2)
                c.close()
    finally:
        engine.shutdown()
    assert results["port"] == results["jax"]
    got = results["port"]
    assert got[0][0] == 200 and got[0][1]["prefetch"]["state"] == "running"
    assert got[1][0] == {"a": "hf:/models/next"} and got[5][0] == {}
    assert got[6:11] == [422, 422, 404, 404, 400]
    assert got[11] == {"a": "hf:/fails"} and got[13] == {}
    assert ("POST", "/v1/prefetch", {"model": "hf:/models/next", "checkpoint_dir": ""}) in calls


def test_the_ledger_hint_is_consumed_by_a_swap_to_it(tmp_path):
    m = pmgr.EngineProcessManager(translators()["port"], log_dir=str(tmp_path), kickoff=fake_kickoff)
    try:
        m.create_instance(InstanceConfig(options="--model tiny --port 18124"), "i1")
        m.ledger.set_prefetched("i1", "hf:/models/next")
        m.ledger.set_model("i1", "hf:/other")
        assert m.ledger.prefetched() == {"i1": "hf:/models/next"}
        m.ledger.set_model("i1", "hf:/models/next")
        assert m.ledger.prefetched() == {}
        m.ledger.set_prefetched("i1", "hf:/x")
        m.stop_instance("i1", timeout=2)
        assert m.ledger.prefetched() == {}
        with pytest.raises(KeyError):
            m.prefetch_instance("nope", "hf:/x")
        with pytest.raises(pmgr.PrefetchFailed) as e:
            m.create_instance(InstanceConfig(options="--model tiny --port 18125"), "i2")
            m.prefetch_instance("i2", "hf:/x", timeout=1)
        assert e.value.status == 502
    finally:
        m.stop_all_instances(timeout=2)

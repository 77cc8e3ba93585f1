"""Model hot-swap through the port's service (``POST /v1/swap``), held
against the reference's ``EngineService`` on the CPU, and the launcher's
swap verb against the JAX launcher's.

* The service sequence: two tiny sibling ``hf:`` directories (A, and B
  with ``lm_head``'s rows reversed), A -> B (cold) -> A (pool, delta) -> B ->
  ``tiny-gemma``, through both services at fp32 (``config_from_hf``'s
  dtype patched in on both sides, as ``test_torch_service.py`` does): the
  same tiers, byte keys and pooled models at each step, greedy tokens
  equal to the reference's and bit-equal across swap-backs; the port's
  pool holds the siblings' shared tensors once (the reference's pool on
  the CPU interns nothing: its slept copies there are pinned-host JAX
  arrays, which it keeps per entry).
* The pool: eviction destroys the engine, a disk-tier rebuild with the
  checkpoint deleted, ``--content-hash off``.
* The reference's rollback drills (``test_faults_recovery.py``): a
  ``swap.h2d`` fault armed over HTTP (503, DEGRADED, both models'
  tokens, the retry a pool hit, then OK), a fault at the first outgoing
  bucket, a repeated ``request_id`` replaying the committed swap, the
  refusals.
* Two engines in one process trade the device repeatedly through
  ``swap_states`` with their generations bit-exact.
* The launcher's swap verb over a stub engine, through both launchers,
  and the recovery of a timed-out swap through ``GET /v1/swap``.
"""

import dataclasses
import json
import os
import shutil
import threading
import urllib.error
import urllib.request
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax.numpy as jnp
import pytest
import torch
from test_torch_launcher import Masks, answer, make
from torch_launcher_fakes import fake_kickoff

from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu.utils import faults as jfaults
from llm_d_fast_model_actuation_tpu_torch.engine import EngineConfig, InferenceEngine
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.engine.sleep import SwapRolledBack, attach_sleep, swap_states
from llm_d_fast_model_actuation_tpu_torch.launcher import manager as pmgr
from llm_d_fast_model_actuation_tpu_torch.launcher.instance import InstanceConfig
from llm_d_fast_model_actuation_tpu_torch.models import llama
from llm_d_fast_model_actuation_tpu_torch.utils import faults
from tests.conftest import build_tiny_hf_model_dir

OPTS = "--num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0 --swap-bucket-mib 1"
PROMPT = [1, 2, 3]
#: the byte keys both services report for every swap
BYTE_KEYS = ("tier", "pool_hit", "swapped", "bytes_out", "bytes_in", "bytes_moved", "bytes_deduped", "deduped_leaves")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def siblings(tmp_path_factory):
    """Two tiny HF directories that share every tensor but ``lm_head``."""
    from safetensors.torch import load_file, save_file

    a = build_tiny_hf_model_dir(str(tmp_path_factory.mktemp("hf") / "a"))
    b = str(tmp_path_factory.mktemp("hf") / "b")
    shutil.copytree(a, b)
    tensors = load_file(os.path.join(b, "model.safetensors"))
    tensors["lm_head.weight"] = tensors["lm_head.weight"].flip(0).contiguous()  # the vocabulary's rows reversed
    save_file(tensors, os.path.join(b, "model.safetensors"), metadata={"format": "pt"})
    return a, b


@pytest.fixture(scope="module")
def fp32():
    """Both packages' ``config_from_hf`` with ``dtype`` forced to fp32."""
    from llm_d_fast_model_actuation_tpu.models import hf as jhf
    from llm_d_fast_model_actuation_tpu_torch.models import hf as thf

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




def test_service_sequence_equals_the_reference(siblings, fp32):
    """A -> B (cold) -> A (pool, delta) -> B (pool, delta) -> tiny-gemma
    (cold) through both services."""
    a, b = siblings
    seq = [f"hf:{b}", f"hf:{a}", f"hf:{b}", "tiny-gemma"]

    def run(svc, swap, gen):
        out = [("start", gen(svc))]
        for model in seq:
            got = swap(model)
            # a named config's weights are drawn by each framework's own
            # generator: its tokens are compared within the port only
            tokens = gen(svc) if model.startswith("hf:") else None
            out.append(({k: got[k] for k in BYTE_KEYS}, got["pool"]["models"], tokens))
        return out

    j = jserver.EngineService(jserver.parse_engine_options(f"--model hf:{a} {OPTS}"))
    try:
        want = run(j, j.swap, _jgen)
    finally:
        j.shutdown()
    t = _port(f"hf:{a}")
    try:
        got = run(t, t.swap, _gen)
        assert [s[0]["tier"] for s in got[1:]] == ["cold", "pool", "pool", "cold"]
        assert got == want
        # bit-equal across the swap-backs, and the siblings differ
        assert got[0][1] == got[2][2] and got[1][2] == got[3][2] != got[0][1]
        assert _gen(t) == _gen(t)  # tiny-gemma serves
        assert got[2][0]["deduped_leaves"] == 11 and got[2][0]["bytes_moved"] < 0.6 * (got[2][0]["bytes_out"] + got[2][0]["bytes_in"])
        pool = t.model_pool.describe()
        nominal = sum(e["nbytes"] for e in pool["entries"] if e["model_id"].startswith("hf:"))
        assert pool["bytes_used"] < nominal, "two pooled siblings hold their shared tensors once"
        assert t.builds_total == 3 and all(p["mapped_bytes"] == 0 for p in t.pooled_engines())
        stats = t.stats()
        assert stats["actuations"] == {"swap": 4} and stats["pool"]["models"] == pool["models"]
    finally:
        t.shutdown()


def test_eviction_destroys_the_engine_and_the_next_swap_in_is_cold():
    svc = _port("tiny", "--model-pool-mib 0")
    try:
        gold = _gen(svc)
        first = weakref.ref(svc.engine)
        out = svc.swap("tiny-gemma")
        assert out["tier"] == "cold" and out["pool"]["evictions"] == 1 and out["pool"]["models"] == []
        assert first() is None, "an evicted model's engine is destroyed"
        out = svc.swap("tiny")
        assert out["tier"] == "cold" and not out["pool_hit"] and _gen(svc) == gold
    finally:
        svc.shutdown()


def test_disk_tier_rebuild_with_the_directory_deleted(siblings, tmp_path):
    a, b = siblings
    copy = str(tmp_path / "a-copy")
    shutil.copytree(a, copy)
    svc = _port(f"hf:{copy}", f"--pool-disk-dir {tmp_path / 'tier'} --pool-disk-mib 64")
    try:
        gold = _gen(svc)
        svc.swap(f"hf:{b}")  # pools A
        svc._free_pooled(svc.model_pool.drain())  # evicted: its chunks spill, its manifest stays
        assert list(svc.model_pool._manifests) == [f"hf:{copy}"] and os.listdir(tmp_path / "tier")
        shutil.rmtree(copy)  # nothing to read again
        out = svc.swap(f"hf:{copy}")
        assert out["tier"] == "disk" and not out["pool_hit"]
        assert _gen(svc) == gold, "the disk-tier rebuild is not bit-exact"
        assert svc._runtime.digests and svc.builds_total == 3
    finally:
        svc.shutdown()


def test_content_hash_off_is_a_full_transfer(siblings):
    a, b = siblings
    svc = _port(f"hf:{a}", "--content-hash off")
    try:
        assert svc.model_pool.chunks is None and svc._runtime.digests is None
        svc.swap(f"hf:{b}")
        out = svc.swap(f"hf:{a}")
        assert out["pool_hit"] and out["bytes_deduped"] == 0
        assert out["bytes_moved"] == out["bytes_out"] + out["bytes_in"]
    finally:
        svc.shutdown()


def _call(port: int, method: str, path: str, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_swap_h2d_rollback_over_http():
    """The reference's drill: swap.h2d armed fail-once over REST; the
    pool-hit swap rolls back (503), /health DEGRADED, the outgoing model
    serves bit-exact, the retry is a pool hit, /health OK, GET /v1/swap
    the committed record."""
    svc = _port("tiny")
    http = tserver.serve(svc, "127.0.0.1", 0)
    port = http.server_address[1]
    try:
        gold_tiny = _gen(svc)
        assert svc.swap("tiny-gemma")["swapped"]
        gold_gemma = _gen(svc)
        status, armed = _call(port, "POST", "/v1/faults", {"spec": "swap.h2d=fail:1"})
        assert status == 200 and "swap.h2d" in armed["armed"]
        status, body = _call(port, "POST", "/v1/swap", {"model": "tiny"})
        assert status == 503 and body["rolled_back"] and body["model"] == "tiny-gemma"
        status, health = _call(port, "GET", "/health")
        assert status == 200 and health["status"] == "DEGRADED" and "rolled back" in health["reason"]
        status, out = _call(port, "POST", "/v1/completions", {"prompt": PROMPT, "max_tokens": 4})
        assert out["choices"][0]["token_ids"] == gold_gemma
        status, retry = _call(port, "POST", "/v1/swap", {"model": "tiny", "request_id": "rid-1"})
        assert status == 200 and retry["swapped"] and retry["pool_hit"]
        assert _call(port, "GET", "/health")[1]["status"] == "OK"
        last = _call(port, "GET", "/v1/swap")[1]
        assert last["request_id"] == "rid-1" and last["model"] == "tiny" and last["degraded"] is None
        assert _call(port, "DELETE", "/v1/faults")[1]["armed"] == {}
        assert svc.failure is None and svc.builds_total == 2 and _gen(svc) == gold_tiny
    finally:
        http.shutdown()
        svc.shutdown()


def test_swap_d2h_rollback_first_bucket_and_request_id_replay():
    svc = _port("tiny", "--faults swap.d2h=fail:1")  # armed by the flag
    try:
        gold = _gen(svc)
        out = svc.swap("tiny-gemma", request_id="req-A")  # cold: fires nothing
        gemma = _gen(svc)
        with pytest.raises(SwapRolledBack):
            svc.swap("tiny")
        assert svc.failure is None and svc.degraded and _gen(svc) == gemma
        # the same id again, another model: the committed record, no swap
        replay = svc.swap("tiny", request_id="req-A")
        assert replay["replayed"] and replay["model"] == "tiny-gemma" and svc.model == "tiny-gemma"
        assert replay["bytes_moved"] == out["bytes_moved"]
        assert svc.swap("tiny")["pool_hit"] and _gen(svc) == gold and svc.degraded is None
    finally:
        svc.shutdown()


def test_a_swap_keeps_an_idle_prefix_cache_and_aborts_the_outgoing_models_requests():
    """An idle outgoing engine's prefix cache comes back with it; queued
    and in-flight requests fail with the reference's message and count as
    aborted by ``swap``."""
    svc = _port("tiny")
    try:
        long_prompt = list(range(1, 20))
        svc.submit(prompt=long_prompt, max_new_tokens=2).result(timeout=120)  # fills the prefix cache
        eng = svc.engine
        resident, hits = eng.prefix_cache.stats()["resident_pages"], eng.prefix_cache.stats()["hits"]
        assert resident > 0
        svc.swap("tiny-gemma")
        svc.swap("tiny")
        assert svc.engine is eng and eng.prefix_cache.stats()["resident_pages"] == resident
        svc.submit(prompt=long_prompt, max_new_tokens=2).result(timeout=120)
        assert eng.prefix_cache.stats()["hits"] == hits + 1
        hold = threading.Event()
        # the engine thread runs this first: the requests below wait behind it
        svc._on_loop(hold.wait, wait=False)
        futs = [svc.submit(prompt=[5, 6, 7], max_new_tokens=40) for _ in range(2)]
        swapper = threading.Thread(target=lambda: svc.swap("tiny-gemma"))
        swapper.start()
        hold.set()
        swapper.join(60)
        for f in futs:
            with pytest.raises(RuntimeError, match=r"aborted by model swap \(tiny -> tiny-gemma\)"):
                f.result(timeout=60)
        assert svc.stats()["aborted"] == {"swap": 2} and svc.model == "tiny-gemma"
    finally:
        svc.shutdown()


def test_refusals(tmp_path):
    # an Orbax checkpoint of another shape: refused with the reference's
    # message, the serving model woken again
    from llm_d_fast_model_actuation_tpu_torch.models import checkpoint

    gemma = llama.LlamaConfig.tiny_gemma()
    checkpoint.save_params(str(tmp_path), gemma, llama.init_params(gemma, torch.Generator().manual_seed(0), "cpu"))
    svc = _port("tiny")
    http = tserver.serve(svc, "127.0.0.1", 0)
    port = http.server_address[1]
    try:
        for body, needle in (({"model": "tiny", "checkpoint_dir": str(tmp_path)}, "different model shape"),
                             ({"model": "nope"}, "unknown model"), ({}, "'model' string"),
                             ({"model": "hf:"}, "directory")):
            status, out = _call(port, "POST", "/v1/swap", body)
            assert status == 400 and needle in out["error"]
        assert _call(port, "POST", "/v1/swap", {"model": "tiny"})[1]["swapped"] is False
        svc.sleep(1)
        status, out = _call(port, "POST", "/v1/swap", {"model": "tiny-gemma"})
        assert status == 400 and "sleeping" in out["error"]
        assert _call(port, "POST", "/v1/faults", {"spec": "swap.h2d=explode"})[0] == 400
    finally:
        http.shutdown()
        svc.shutdown()
    with pytest.raises(ValueError, match="--faults"):
        tserver.parse_engine_options("--faults nonsense --device cpu")
    two = tserver.EngineService(tserver.parse_engine_options(f"--model tiny {OPTS} --tensor-parallel-size 2 --device cpu,cpu"))
    try:
        with pytest.raises(ValueError, match="item 14"):
            two.swap("tiny-gemma")
    finally:
        two.shutdown()


def test_two_engines_trade_the_device_bit_exact():
    """The reference's engine-level identity test: each engine serves its
    own tokens whenever it is the awake one."""
    cfg = EngineConfig(model=dataclasses.replace(llama.LlamaConfig.tiny()), max_batch=4, page_size=8, num_pages=64,
                       max_seq_len=64)
    a = InferenceEngine(cfg, seed=0, device="cpu")
    b = InferenceEngine(cfg, seed=1, device="cpu")
    gold_a = a.generate([[7, 8, 9]], max_new_tokens=8)[0]
    gold_b = b.generate([[7, 8, 9]], max_new_tokens=8)[0]
    assert gold_a != gold_b
    mgr_a, mgr_b = attach_sleep(a), attach_sleep(b)
    mgr_b.sleep(1)
    for _ in range(2):
        swap_states(mgr_a, mgr_b, bucket_bytes=2048)
        assert b.generate([[7, 8, 9]], max_new_tokens=8)[0] == gold_b
        swap_states(mgr_b, mgr_a, bucket_bytes=2048, overlapped=False)
        assert a.generate([[7, 8, 9]], max_new_tokens=8)[0] == gold_a


# -- the launcher's swap verb ----------------------------------------------------


def _stub_swap_engine(mode: dict):
    """An engine admin API for the swap verb: ``POST /v1/swap`` answers
    per ``mode["status"]`` (200 commits the record), ``GET /v1/swap`` the
    committed record, ``/is_sleeping`` awake."""
    committed = {}

    class Handler(BaseHTTPRequestHandler):
        def _send(self, status, obj):
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/v1/swap":
                return self._send(200, dict(committed, degraded=None))
            return self._send(200, {"is_sleeping": False, "devices_released": False})

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            if mode["status"] != 200:
                return self._send(mode["status"], {"error": "refused", "rolled_back": mode["status"] == 503})
            committed.clear()
            committed.update(model=body["model"], request_id=body["request_id"], swapped=True, pool_hit=False,
                             checkpoint_dir="", tier="cold", quant="off",
                             pool={"models": ["tiny"], "bytes_used": 10, "budget_bytes": 100,
                                   "chunks": {"dedup_saved_bytes": 3, "disk_bytes": 0}, "staged_manifests": []})
            return self._send(200, committed)

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _swap_scenario(c, port: int, mode: dict) -> list:
    masks = Masks()
    out = []
    status, _, body = c.request("PUT", "/v2/vllm/instances/a", {"options": f"--model tiny --port {port}"})
    assert status == 201
    rev = json.loads(body)["revision"]
    for body, status in (({"model": "tiny-gemma"}, 200), ({"model": "tiny"}, 400), ({"model": "tiny"}, 503), ({}, None)):
        mode["status"] = status or 200
        resp = c.request("POST", "/v2/vllm/instances/a/swap", body)
        got = answer(masks, resp)
        if resp[0] == 200:
            got[1]["swap"]["request_id"] = "<rid>"
        out.append(got if resp[0] == 200 else got[0])
    out.append(answer(masks, c.request("POST", "/v2/vllm/instances/zzz/swap", {"model": "tiny"}))[0])
    status, events = c.watch(f"/v2/vllm/instances/watch?since={rev}", 1)
    out.append((status, [e["type"] for e in events]))
    listing = json.loads(c.request("GET", "/v2/vllm/instances")[2])
    out.append((listing["ledger"]["models"], listing["ledger"]["pools"], listing["ledger"]["quant"]))
    out.append(json.loads(c.request("GET", "/v2/vllm/instances/a")[2])["options"])
    return out


def test_the_launcher_swap_verb_answers_as_the_jax_launchers(tmp_path):
    mode = {"status": 200}
    engine = _stub_swap_engine(mode)
    results = {}
    try:
        for impl in ("jax", "port"):
            c = make(impl, tmp_path)
            try:
                results[impl] = _swap_scenario(c, engine.server_address[1], mode)
            finally:
                c.manager.stop_all_instances(timeout=2)
                c.close()
    finally:
        engine.shutdown()
    assert results["port"] == results["jax"]
    ok = results["port"][0][1]
    assert ok["model"] == "tiny-gemma" and ok["previous_model"] == "tiny" and ok["swap"]["tier"] == "cold"
    assert results["port"][3] == 422 and results["port"][-1] == f"--model tiny-gemma --port {engine.server_address[1]}"


def test_a_timed_out_swap_is_recovered_through_its_request_id(tmp_path, monkeypatch):
    """The POST times out after the engine committed the swap: the
    launcher does not send it again, it reads GET /v1/swap and takes the
    record with its own request id."""
    from test_torch_launcher import translators

    m = pmgr.EngineProcessManager(translators()["port"], log_dir=str(tmp_path), kickoff=fake_kickoff)
    posts, committed, commit = [], {}, [True]
    real = urllib.request.urlopen

    class Resp:
        def __init__(self, body):
            self.body = body

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return json.dumps(self.body).encode()

    def fake_urlopen(req, timeout=None):
        if not isinstance(req, urllib.request.Request) or "/v1/swap" not in req.full_url:
            return real(req, timeout=timeout)
        if req.get_method() == "POST":
            body = json.loads(req.data)
            posts.append(body)
            if commit[0]:
                committed.update(body, swapped=True, pool_hit=True)
            raise urllib.error.URLError(TimeoutError("read timed out"))
        return Resp(dict(committed))

    try:
        m.create_instance(InstanceConfig(options="--model tiny --port 18123"), "t1")
        monkeypatch.setattr(pmgr.urllib.request, "urlopen", fake_urlopen)
        out = m.swap_instance("t1", "tiny-gemma", timeout=1)
        assert len(posts) == 1, "a timed-out swap is never sent again"
        assert out["swap"]["model"] == "tiny-gemma" and out["swap"]["request_id"] == posts[0]["request_id"]
        assert "--model tiny-gemma" in m.instances["t1"].config.options
        # no record with its id within the window: a 504
        commit[0] = False
        monkeypatch.setattr(m, "_recover_swap_result", lambda iid, rid, exc: pmgr.EngineProcessManager._recover_swap_result(
            m, iid, rid, exc, window_s=0.3, poll_s=0.1))
        with pytest.raises(pmgr.SwapFailed) as e:
            m.swap_instance("t1", "tiny", timeout=1)
        assert e.value.status == 504 and "--model tiny-gemma" in m.instances["t1"].config.options
    finally:
        monkeypatch.undo()
        m.stop_all_instances(timeout=2)

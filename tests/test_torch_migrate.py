"""Live request migration in the port (``GET/POST /v1/parked``, the
single-use fence, the launcher's migrate and drain verbs), held against
the JAX package's ``tests/test_migrate.py`` case by case, and across the
two packages.

* An engine pair of the same tiny ``hf:`` checkpoint (``--content-hash
  on``: its weights' fingerprint is the identity; the port's digests are
  the reference's, so the fingerprints of the two packages agree too): a
  stream migrated mid-decode finishes bit-exact, greedy and seeded, each
  token delivered once; the fence is single-use and the import
  idempotent under it; every drilled fault point recovers as the
  reference's does; other weights and a tampered chunk are refused before
  anything is displaced.
* Across the packages (both at fp32 through a patched ``config_from_hf``,
  as ``tests/test_torch_service.py`` does): a greedy bundle exported by
  the JAX ``EngineService`` finishes in the port with the JAX package's
  uninterrupted tokens, and the reverse; a sampled JAX bundle is refused
  with a 409, nothing displaced (neither package can continue the other's
  generator stream).
* The launcher's verbs over stub engines: export, import, release; one
  fenced retry of a 5xx import; an abort after a refusal or a second
  failure; no sibling; drain passes until the queue is empty.
"""

import http.server
import json
import os
import shutil
import socket
import threading
import time

import jax.numpy as jnp
import pytest
import torch
from torch_launcher_fakes import fake_kickoff

from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu.utils import faults as jfaults
from llm_d_fast_model_actuation_tpu_torch.engine.server import (
    EngineService,
    MigrationFailed,
    MigrationRejected,
    parse_engine_options,
)
from llm_d_fast_model_actuation_tpu_torch.launcher import manager as pmgr
from llm_d_fast_model_actuation_tpu_torch.launcher.instance import InstanceConfig
from llm_d_fast_model_actuation_tpu_torch.utils import faults
from llm_d_fast_model_actuation_tpu_torch.utils.prom import REGISTRY, exposition
from tests.conftest import build_tiny_hf_model_dir

OPTS = "--num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --swap-bucket-mib 1 --zero-drain on"


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Base checkpoint A, and sibling weights B that differ only in
    ``lm_head``."""
    from safetensors.torch import load_file, save_file

    a = build_tiny_hf_model_dir(str(tmp_path_factory.mktemp("mig") / "a"))
    b = str(tmp_path_factory.mktemp("mig") / "b")
    shutil.copytree(a, b)
    tensors = load_file(os.path.join(b, "model.safetensors"))
    tensors["lm_head.weight"] = (tensors["lm_head.weight"] * 1.5 + 0.25).contiguous()
    save_file(tensors, os.path.join(b, "model.safetensors"), metadata={"format": "pt"})
    return a, b


def _service(ckpt: str, extra: str = "") -> EngineService:
    return EngineService(parse_engine_options(f"--model hf:{ckpt} {OPTS} --device cpu {extra}"))


def _wire(src, dst) -> None:
    """The in-process transport: the source's claim proxy calls the
    destination's claim verbs directly instead of over HTTP."""
    src._claim_fetch = lambda dest, cid, have, wait_s: dst.claim_view(cid, wait_s=wait_s, have=have)
    src._claim_abort = lambda dest, cid: dst.abort_claim(cid)


@pytest.fixture
def pair(ckpts):
    src, dst = _service(ckpts[0]), _service(ckpts[0])
    _wire(src, dst)
    yield src, dst
    src.shutdown()
    dst.shutdown()


def _balance(svc) -> None:
    """Each preempted stream ends exactly one way."""
    zd = svc.stats()["zero_drain"]
    assert zd["preempted"] == zd["resumed"] + zd["aborted"] + zd["migrated"], zd


def _submit(svc, prompt, max_tokens=8, temperature=0.0, **kw):
    """A submission to either package's service."""
    if isinstance(svc, jserver.EngineService):
        return svc.submit(list(prompt), max_tokens, temperature, **kw)
    return svc.submit(prompt=list(prompt), max_new_tokens=max_tokens, temperature=temperature, **kw)


def _live_stream(svc, prompt, max_tokens=8, **kw):
    """A stream mid-decode at the export: its streaming hook sleeps on the
    engine thread, so the whole batch is throttled while the export waits
    for the step's end."""
    toks: list = []
    started = threading.Event()

    def slow(req, tok):
        toks.append(tok)
        started.set()
        time.sleep(0.05)

    fut = _submit(svc, prompt, max_tokens, on_token=slow, **kw)
    assert started.wait(timeout=60), "the stream never produced a token"
    return fut, toks


def _counter(name: str, **labels) -> float:
    family = name[: -len("_total")]  # a counter's family drops its _total
    for m in REGISTRY:
        if m.name == family:
            child = m._children.get(tuple(labels[k] for k in m.labelnames))
            return child.value if child is not None else 0.0
    return 0.0


def _gold(svc, prompt, max_tokens=8, **kw):
    return _submit(svc, prompt, max_tokens, **kw).result(timeout=120).out_tokens


# ------------------------------------------------ happy path, bit-exact


def test_migrate_mid_decode_bit_exact_exactly_once(pair, ckpts):
    src, dst = pair
    model = f"hf:{ckpts[0]}"
    gold_g = _gold(src, [1, 2, 3])
    gold_s = _gold(src, [4, 5, 6], temperature=0.9, seed=11)
    pre_mig = _counter("fma_engine_preempted_requests_total", model=model, outcome="migrated")
    pre_bytes = _counter("fma_engine_migrate_bytes_total", dir="export")
    f1, toks = _live_stream(src, [1, 2, 3])
    f2 = _submit(src, [4, 5, 6], 8, 0.9, seed=11)
    doc = json.loads(json.dumps(src.export_parked(model)))  # as it crosses the wire
    token = doc["fence"]["token"]
    assert doc["nbytes"] > 0 and doc["requests"]["live"]
    ack = dst.import_parked(doc)
    assert ack["ok"] and ack["requests"] == 2 and ack["kv_bytes"] == doc["kv"]["nbytes"]
    rel = src.release_parked(token, dest="local", claims=ack["claims"])
    assert rel["ok"] and rel["fence_token"] == token and rel["migrated"] == 2
    assert f1.result(timeout=120).out_tokens == gold_g
    assert f2.result(timeout=120).out_tokens == gold_s
    assert toks == gold_g, "the streaming hook saw each token once"
    s = src.stats()
    assert (s["migration"]["committed"], s["migration"]["state_loss"], s["migration"]["exported"]) == (1, 0, 1)
    assert s["migration"]["bytes_out"] == doc["nbytes"] and s["zero_drain"]["migrated"] == 2
    _balance(src)
    d = dst.stats()["migration"]
    assert d["imported"] == 1 and d["requests_in"] == 2 and d["bytes_in"] == doc["nbytes"]
    assert _counter("fma_engine_preempted_requests_total", model=model, outcome="migrated") - pre_mig == 2
    assert _counter("fma_engine_migrate_bytes_total", dir="export") - pre_bytes == doc["nbytes"]
    text = exposition()
    assert "fma_engine_migrations_total" in text and "fma_engine_migrate_bytes_total" in text
    row = src.costs_view()["migrate"]
    assert row["kind"] == "migrate" and row["enabled"]
    # the fence is spent and the source serves on: the same bits again
    assert _gold(src, [1, 2, 3]) == gold_g


# ------------------------------------------------ fence semantics


def test_fence_single_use_and_idempotent_import_replay(pair, ckpts):
    src, dst = pair
    f, _ = _live_stream(src, [5, 6, 7])
    doc = src.export_parked(f"hf:{ckpts[0]}")
    token = doc["fence"]["token"]
    ack = dst.import_parked(doc)
    # a repeat before the release replays the stored ack: no second seat
    assert dst.import_parked(doc)["claims"] == ack["claims"]
    assert dst.stats()["migration"]["imported"] == 1
    assert src.release_parked(token, dest="local", claims=ack["claims"])["ok"]
    f.result(timeout=120)
    with pytest.raises(MigrationRejected, match="spent or unknown"):
        src.release_parked(token, dest="local", claims=ack["claims"])
    with pytest.raises(MigrationRejected, match="spent or unknown"):
        src.abort_migration(token)
    _balance(src)


# ------------------------------------------------ drilled fault points


def test_export_fault_resumes_streams_locally(ckpts):
    src = _service(ckpts[0])
    try:
        gold = _gold(src, [7, 8, 9])
        f, _ = _live_stream(src, [7, 8, 9])
        faults.arm("migrate.export", mode="fail", count=1)
        with pytest.raises(MigrationFailed, match="resumed locally"):
            src.export_parked(f"hf:{ckpts[0]}")
        assert f.result(timeout=120).out_tokens == gold
        s = src.stats()["migration"]
        assert s["resumed_local"] == 1 and s["exported"] == 0
        _balance(src)
    finally:
        src.shutdown()


def test_import_fault_rolls_back_destination_clean(pair, ckpts):
    src, dst = pair
    gold = _gold(src, [2, 4, 6])
    f, _ = _live_stream(src, [2, 4, 6])
    doc = src.export_parked(f"hf:{ckpts[0]}")
    faults.arm("migrate.import", mode="fail", count=1)
    with pytest.raises(MigrationFailed, match="clean"):
        dst.import_parked(doc)
    d = dst.stats()["migration"]
    assert d["rolled_back"] == 1 and d["requests_in"] == 0 and dst.queue_depth() == 0
    ack = dst.import_parked(doc)  # the fence is live: a plain retry seats
    assert src.release_parked(doc["fence"]["token"], dest="local", claims=ack["claims"])["ok"]
    assert f.result(timeout=120).out_tokens == gold
    _balance(src)


def test_import_double_fault_aborts_to_local_resume(pair, ckpts):
    src, dst = pair
    gold = _gold(src, [9, 9, 2])
    f, _ = _live_stream(src, [9, 9, 2])
    doc = src.export_parked(f"hf:{ckpts[0]}")
    token = doc["fence"]["token"]
    faults.arm("migrate.import", mode="fail", count=2)
    for _ in range(2):
        with pytest.raises(MigrationFailed):
            dst.import_parked(doc)
    ab = src.abort_migration(token)
    assert ab["ok"] and ab["outcome"] == "resumed_local"
    assert f.result(timeout=120).out_tokens == gold
    with pytest.raises(MigrationRejected, match="spent or unknown"):
        src.release_parked(token, dest="local", claims={})
    _balance(src)


def test_ack_lost_retry_replays_stored_ack(pair, ckpts):
    src, dst = pair
    gold = _gold(src, [3, 2, 1], 6)
    f, _ = _live_stream(src, [3, 2, 1], max_tokens=6)
    doc = src.export_parked(f"hf:{ckpts[0]}")
    faults.arm("migrate.ack", mode="fail", count=1)
    with pytest.raises(MigrationFailed, match="ack lost"):
        dst.import_parked(doc)
    ack = dst.import_parked(doc)  # the seat stood: the fenced retry replays
    assert dst.stats()["migration"]["imported"] == 1
    assert src.release_parked(doc["fence"]["token"], dest="local", claims=ack["claims"])["ok"]
    assert f.result(timeout=120).out_tokens == gold
    _balance(src)


# ------------------------------------------------ identity and integrity


def test_foreign_weights_refused_then_local_resume(ckpts, tmp_path):
    """The same model name over other weights: the fingerprints differ
    and the import is refused before anything moves."""
    d = str(tmp_path / "c")
    shutil.copytree(ckpts[0], d)
    src = _service(d)
    shutil.copy(os.path.join(ckpts[1], "model.safetensors"), os.path.join(d, "model.safetensors"))
    dst = _service(d)
    _wire(src, dst)
    try:
        gold = _gold(src, [6, 5, 4])
        f, _ = _live_stream(src, [6, 5, 4])
        doc = src.export_parked(f"hf:{d}")
        with pytest.raises(MigrationRejected, match="fingerprint mismatch"):
            dst.import_parked(doc)
        assert dst.queue_depth() == 0
        assert src.abort_migration(doc["fence"]["token"])["outcome"] == "resumed_local"
        assert f.result(timeout=120).out_tokens == gold
        _balance(src)
    finally:
        src.shutdown()
        dst.shutdown()


def test_tampered_kv_chunk_refused(pair, ckpts):
    src, dst = pair
    gold = _gold(src, [8, 7, 6])
    f, _ = _live_stream(src, [8, 7, 6])
    doc = src.export_parked(f"hf:{ckpts[0]}")
    chunk = doc["kv"]["chunks"][0]
    chunk["k"] = chunk["k"][:-8] + "AAAAAAA="
    with pytest.raises(ValueError, match="digest"):
        dst.import_parked(doc)
    assert dst.queue_depth() == 0
    assert src.abort_migration(doc["fence"]["token"])["outcome"] == "resumed_local"
    assert f.result(timeout=120).out_tokens == gold
    _balance(src)


def test_residents_pin_detach_first_contract(pair, ckpts):
    """The reference's detach-first refusals: while a co-resident variant
    is attached, an export and an import are refused (409, nothing
    displaced), and so are a swap and a sleep; a parked request's
    ``variant`` travels on the wire as the reference carries it."""
    from llm_d_fast_model_actuation_tpu_torch.engine import parked as tparked
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import Request

    src, dst = pair
    f, _ = _live_stream(src, [1, 2, 3])
    doc = json.loads(json.dumps(src.export_parked(f"hf:{ckpts[0]}")))
    doc["requests"]["live"][0]["variant"] = 1
    assert tparked.decode_request(doc["requests"]["live"][0], Request).variant == 1
    dst._residents["hf:/sibling"] = {"handle": 1}  # an attached variant, as the registry holds it
    try:
        with pytest.raises(MigrationRejected, match=r"detach them \(DELETE /v1/residents\) before importing"):
            dst.import_parked(doc)
        with pytest.raises(MigrationRejected, match="before migrating the base"):
            dst.export_parked(f"hf:{ckpts[0]}")
        with pytest.raises(ValueError, match="before swapping the base"):
            dst.swap(f"hf:{ckpts[1]}")
        with pytest.raises(ValueError, match="before sleeping"):
            dst.sleep(1)
    finally:
        dst._residents.clear()
    assert dst.queue_depth() == 0
    assert src.abort_migration(doc["fence"]["token"])["outcome"] == "resumed_local"
    f.result(timeout=120)
    _balance(src)


@pytest.mark.parametrize("part", ["live", "waiting", "pending"])
def test_a_parked_request_of_a_variant_is_refused(pair, ckpts, part):
    """A variant handle names a resident of the engine that attached it: a
    bundle with a live, waiting or queued request routed to one is a 400
    on a destination with no residents, nothing is seated, and the
    destination still serves."""
    src, dst = pair
    gold = _gold(dst, [4, 5, 6])
    f, _ = _live_stream(src, [1, 2, 3])
    doc = json.loads(json.dumps(src.export_parked(f"hf:{ckpts[0]}")))
    live = doc["requests"]["live"][0]
    if part == "live":
        live["variant"] = 1
    elif part == "waiting":
        extra = {k: v for k, v in live.items() if k not in ("old_pages", "counts_row", "key_data")}
        doc["requests"]["waiting"].append(dict(extra, seq_id=live["seq_id"] + 1000, variant=1))
    else:
        doc["requests"]["pending"].append(dst._encode_pending({"prompt": [7, 8], "variant": 1}))
    assert not dst._residents
    with pytest.raises(ValueError, match=r"co-resident variant handles \[1\]"):
        dst.import_parked(doc)
    assert dst.queue_depth() == 0
    assert _gold(dst, [4, 5, 6]) == gold
    assert src.abort_migration(doc["fence"]["token"])["outcome"] == "resumed_local"
    f.result(timeout=120)
    _balance(src)


# ------------------------------------------------ across the two packages


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


@pytest.fixture
def mixed(ckpts, fp32):
    """A JAX service and a port service on checkpoint A, wired both ways."""
    jsvc = jserver.EngineService(jserver.parse_engine_options(f"--model hf:{ckpts[0]} {OPTS}"))
    tsvc = _service(ckpts[0])
    _wire(jsvc, tsvc)
    _wire(tsvc, jsvc)
    yield jsvc, tsvc
    jsvc.shutdown()
    tsvc.shutdown()


def test_a_jax_bundle_finishes_in_the_port(mixed, ckpts):
    jsvc, tsvc = mixed
    gold = _gold(jsvc, [1, 2, 3])
    assert _gold(tsvc, [1, 2, 3]) == gold
    f, toks = _live_stream(jsvc, [1, 2, 3])
    doc = json.loads(json.dumps(jsvc.export_parked(f"hf:{ckpts[0]}")))
    ack = tsvc.import_parked(doc)
    assert ack["seated"] + ack["waiting"] == 1
    assert jsvc.release_parked(doc["fence"]["token"], dest="local", claims=ack["claims"])["migrated"] == 1
    assert f.result(timeout=120).out_tokens == gold and toks == gold


def test_a_port_bundle_finishes_in_the_jax_package(mixed, ckpts):
    jsvc, tsvc = mixed
    gold = _gold(jsvc, [4, 3, 2, 1])
    f, toks = _live_stream(tsvc, [4, 3, 2, 1])
    doc = json.loads(json.dumps(tsvc.export_parked(f"hf:{ckpts[0]}")))
    ack = jsvc.import_parked(doc)
    assert ack["seated"] + ack["waiting"] == 1
    assert tsvc.release_parked(doc["fence"]["token"], dest="local", claims=ack["claims"])["migrated"] == 1
    assert f.result(timeout=120).out_tokens == gold and toks == gold
    _balance(tsvc)


def test_a_sampled_jax_bundle_is_refused(mixed, ckpts):
    """The reference's threefry key cannot be continued by the port's
    generator: a 409, and the port's engine takes nothing in."""
    jsvc, tsvc = mixed
    f, _ = _live_stream(jsvc, [5, 6, 7], temperature=0.9, seed=11)
    doc = json.loads(json.dumps(jsvc.export_parked(f"hf:{ckpts[0]}")))
    with pytest.raises(MigrationRejected, match="reference package's generator key"):
        tsvc.import_parked(doc)
    assert tsvc.queue_depth() == 0 and tsvc.stats()["migration"]["imported"] == 0
    assert jsvc.abort_migration(doc["fence"]["token"])["outcome"] == "resumed_local"
    assert len(f.result(timeout=120).out_tokens) == 8


# ------------------------------------------------ launcher verbs


def _stub_engine(behavior):
    """A stub engine child. ``behavior`` scripts it: ``depths`` its
    successive /v1/stats queue depths (the last repeats),
    ``import_fail``/``import_status`` the next N imports' failure."""

    class Handler(http.server.BaseHTTPRequestHandler):
        calls: list = []

        def _reply(self, obj, status=200):
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            type(self).calls.append(("GET", self.path, None))
            if self.path.startswith("/v1/parked/"):
                n = behavior["exports"] = behavior.get("exports", 0) + 1
                self._reply({"fence": {"token": f"mig-{n}-stub"}, "identity": {"model": "tiny"}, "nbytes": 4096,
                             "requests": {"live": [{}], "waiting": [], "pending": []}})
            elif self.path == "/v1/stats":
                depths = behavior.setdefault("depths", [0])
                self._reply({"queue_depth": depths.pop(0) if len(depths) > 1 else depths[0]})
            else:
                self._reply({"error": "not found"}, status=404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            type(self).calls.append(("POST", self.path, body))
            if self.path == "/v1/parked":
                fail = behavior.get("import_fail", 0)
                if fail:
                    behavior["import_fail"] = fail - 1
                    self._reply({"error": "injected import failure"}, status=behavior.get("import_status", 500))
                else:
                    self._reply({"ok": True, "fence_token": (body.get("fence") or {}).get("token"), "requests": 2,
                                 "claims": {"5": "aa", "p0": "bb"}})
            elif self.path == "/v1/parked/release":
                self._reply({"ok": True, "fence_token": body.get("fence_token"), "migrated": 2, "proxied": 1})
            elif self.path == "/v1/parked/abort":
                self._reply({"ok": True, "outcome": "resumed_local"})
            else:
                self._reply({"error": "not found"}, status=404)

        def log_message(self, *a):
            pass

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, port, Handler


def _manager(tmp_path):
    from test_torch_launcher import translators

    return pmgr.EngineProcessManager(translators()["port"], log_dir=str(tmp_path), kickoff=fake_kickoff)


@pytest.fixture
def stub_fleet(tmp_path):
    """Two stub engine children behind a launcher with fake children: i0
    the source, i1 its sibling."""
    src_b, dst_b = {}, {}
    src_srv, src_port, src_h = _stub_engine(src_b)
    dst_srv, dst_port, dst_h = _stub_engine(dst_b)
    manager = _manager(tmp_path)
    chips = manager.translator.chip_ids()
    for i, port in enumerate((src_port, dst_port)):
        manager.create_instance(InstanceConfig(options=f"--model tiny --port {port}", chip_ids=[chips[i]]),
                                instance_id=f"i{i}")

    class Fleet:
        pass

    fl = Fleet()
    fl.manager, fl.src_b, fl.dst_b, fl.src_h, fl.dst_h, fl.dst_port = manager, src_b, dst_b, src_h, dst_h, dst_port
    yield fl
    manager.stop_all_instances(timeout=2)
    for srv in (src_srv, dst_srv):
        srv.shutdown()
        srv.server_close()


def test_launcher_migrate_export_import_release(stub_fleet):
    fl = stub_fleet
    out = fl.manager.migrate_instance("i0")
    assert out["dest_id"] == "i1" and out["model"] == "tiny" and out["fence_token"] == "mig-1-stub"
    assert out["migrated"] == 2 and out["proxied"] == 1 and out["bytes"] == 4096 and out["revision"]
    posts = [c for c in fl.dst_h.calls if c[1] == "/v1/parked"]
    assert len(posts) == 1 and posts[0][2]["fence"]["token"] == "mig-1-stub"
    rel = [c for c in fl.src_h.calls if c[1] == "/v1/parked/release"]
    assert rel[0][2] == {"fence_token": "mig-1-stub", "dest": f"http://127.0.0.1:{fl.dst_port}",
                         "claims": {"5": "aa", "p0": "bb"}}
    events = [e for rev, e in fl.manager.broadcaster._buf if e["type"] == "MIGRATED"]
    assert len(events) == 1 and events[0]["object"]["migration"]["fence_token"] == "mig-1-stub"


def test_launcher_import_5xx_gets_one_fenced_retry(stub_fleet):
    fl = stub_fleet
    fl.dst_b.update(import_fail=1, import_status=500)
    assert fl.manager.migrate_instance("i0")["migrated"] == 2
    assert len([c for c in fl.dst_h.calls if c[1] == "/v1/parked"]) == 2  # the one blind retry
    assert not [c for c in fl.src_h.calls if c[1] == "/v1/parked/abort"]


def test_launcher_import_double_failure_aborts_on_source(stub_fleet):
    fl = stub_fleet
    fl.dst_b.update(import_fail=2, import_status=500)
    with pytest.raises(pmgr.MigrateFailed) as ei:
        fl.manager.migrate_instance("i0")
    assert ei.value.status == 500
    aborts = [c for c in fl.src_h.calls if c[1] == "/v1/parked/abort"]
    assert aborts and aborts[0][2] == {"fence_token": "mig-1-stub"}


def test_launcher_import_refusal_aborts_without_retry(stub_fleet):
    fl = stub_fleet
    fl.dst_b.update(import_fail=1, import_status=409)
    with pytest.raises(pmgr.MigrateFailed) as ei:
        fl.manager.migrate_instance("i0")
    assert ei.value.status == 409
    assert len([c for c in fl.dst_h.calls if c[1] == "/v1/parked"]) == 1  # a refusal is never re-sent
    assert [c for c in fl.src_h.calls if c[1] == "/v1/parked/abort"]


def test_launcher_migrate_needs_a_sibling(tmp_path):
    manager = _manager(tmp_path)
    try:
        manager.create_instance(InstanceConfig(options="--model tiny --port 1",
                                               chip_ids=[manager.translator.chip_ids()[0]]), instance_id="only")
        with pytest.raises(pmgr.MigrateFailed) as ei:
            manager.migrate_instance("only")
        assert ei.value.status == 409 and "nothing to migrate to" in str(ei.value)
    finally:
        manager.stop_all_instances(timeout=2)


def test_launcher_drain_loops_migrate_passes_to_empty(stub_fleet):
    fl = stub_fleet
    fl.src_b["depths"] = [3, 2, 0]
    out = fl.manager.drain_instance("i0")
    assert out["drained"] is True and len(out["passes"]) == 2
    assert out["migrated"] == 4 and out["bytes"] == 8192 and out["revision"]
    assert len([c for c in fl.src_h.calls if c[1] == "/v1/parked/release"]) == 2

"""The port's actuation tracing (``utils/tracing.py``) held against the JAX
package's: the unit tests of ``tests/test_tracing.py`` on the port's
module, a traceparent and a Chrome export crossing the two packages both
ways, and the service tests on the port's CPU engine over HTTP: the swap's
spans, nothing recorded with tracing off, ``/v1/traces`` with a
traceparent hop, the profile gate, and the launcher's rpc metric and
header."""

import json
import threading
import urllib.error
import urllib.request

import pytest

from llm_d_fast_model_actuation_tpu.utils import tracing as jtracing
from llm_d_fast_model_actuation_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def _clean_tracing():
    """Tracing state is process-global, in both packages."""
    for t in (tracing, jtracing):
        t.enable()
        t.clear()
    yield
    for t in (tracing, jtracing):
        t.enable()
        t.clear()


# -- span model ---------------------------------------------------------------


@pytest.mark.tracing
def test_span_nesting_parents_and_attrs():
    with tracing.span("outer", kind="root") as outer:
        with tracing.span("inner", bytes=123) as inner:
            assert inner.trace_id == outer.trace_id
            assert tracing.current_context().span_id == inner.span_id
        assert tracing.current_context().span_id == outer.span_id
    assert tracing.current_context() is None
    spans = {s.name: s for s in tracing.snapshot()}
    assert spans["inner"].parent_id == spans["outer"].span_id
    assert spans["outer"].parent_id == ""
    assert spans["inner"].attrs["bytes"] == 123
    assert spans["outer"].end_s >= spans["outer"].start_s


@pytest.mark.tracing
def test_span_exception_stamps_error_and_resets_context():
    with pytest.raises(RuntimeError):
        with tracing.span("boom"):
            raise RuntimeError("kaput")
    assert tracing.current_context() is None
    (sp,) = tracing.snapshot()
    assert sp.name == "boom" and "kaput" in sp.attrs["error"]


@pytest.mark.tracing
def test_explicit_parent_for_worker_threads():
    with tracing.span("root") as root:
        ctx = root.context()

        def worker():
            assert tracing.current_context() is None
            with tracing.span("child", parent=ctx):
                pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    spans = {s.name: s for s in tracing.snapshot()}
    assert spans["child"].parent_id == spans["root"].span_id
    assert spans["child"].trace_id == spans["root"].trace_id


@pytest.mark.tracing
def test_overlapping_handles_with_activate_false():
    with tracing.span("loop") as root:
        ctx = root.context()
        a = tracing.begin("bucket", parent=ctx, activate=False, bucket=0)
        b = tracing.begin("bucket", parent=ctx, activate=False, bucket=1)
        assert tracing.current_context().span_id == root.span_id
        b.end()
        a.end()
        a.end()  # idempotent
    buckets = [s for s in tracing.snapshot() if s.name == "bucket"]
    assert len(buckets) == 2 and {s.parent_id for s in buckets} == {root.span_id}


@pytest.mark.tracing
def test_ring_buffer_is_bounded(monkeypatch):
    buf = tracing.TraceBuffer(capacity=8)
    monkeypatch.setattr(tracing, "_BUFFER", buf)
    for i in range(100):
        with tracing.span(f"s{i}"):
            pass
    assert len(buf) == 8
    assert [s.name for s in buf.snapshot()] == [f"s{i}" for i in range(92, 100)]


@pytest.mark.tracing
def test_buffer_capacity_env(monkeypatch):
    monkeypatch.setenv(tracing.BUFFER_ENV_VAR, "16")
    monkeypatch.setenv(tracing.ENV_VAR, "")
    tracing.reset_after_fork()
    try:
        for _ in range(50):
            with tracing.span("x"):
                pass
        assert tracing.buffer_len() == 16
    finally:
        monkeypatch.delenv(tracing.BUFFER_ENV_VAR)
        tracing.reset_after_fork()


@pytest.mark.tracing
def test_disabled_tracing_is_the_noop_singleton():
    tracing.disable()
    assert not tracing.enabled()
    sp = tracing.begin("hot", bytes=1)
    assert sp is tracing.NOOP_SPAN and tracing.begin("hot2") is sp
    with tracing.span("ctx") as c:
        assert c is tracing.NOOP_SPAN
    sp.set(x=1).end()
    assert sp.traceparent() is None
    assert tracing.buffer_len() == 0 and tracing.current_traceparent() is None


BAD_TRACEPARENTS = (
    None, "", "junk", "00-short-abcdabcdabcdabcd-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "1" * 16,
)


@pytest.mark.tracing
def test_traceparent_roundtrip_and_rejects():
    with tracing.span("root") as root:
        tp = tracing.current_traceparent()
        assert tp == f"00-{root.trace_id}-{root.span_id}-01"
    ctx = tracing.parse_traceparent(tp)
    assert ctx.trace_id == root.trace_id and ctx.span_id == root.span_id
    for bad in BAD_TRACEPARENTS:
        assert tracing.parse_traceparent(bad) is None, bad


@pytest.mark.tracing
def test_env_context_and_use_context(monkeypatch):
    monkeypatch.setenv(tracing.TRACEPARENT_ENV, "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01")
    ctx = tracing.env_context()
    assert ctx.trace_id == "ab" * 16 and ctx.span_id == "cd" * 8
    with tracing.use_context(ctx):
        assert tracing.current_context() is ctx
        with tracing.span("adopted"):
            pass
    assert tracing.current_context() is None
    (sp,) = tracing.snapshot()
    assert sp.trace_id == ctx.trace_id and sp.parent_id == ctx.span_id
    with tracing.use_context(None):
        assert tracing.current_context() is None


@pytest.mark.tracing
def test_chrome_export_shape_and_reimport():
    with tracing.span("parent", model="tiny"):
        with tracing.span("child", bytes=42):
            pass
    spans = tracing.snapshot()
    payload = tracing.export_chrome(spans)
    assert payload["displayTimeUnit"] == "ms" and len(payload["traceEvents"]) == 2
    for e in payload["traceEvents"]:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid", "args"} <= set(e)
        assert e["ph"] == "X" and e["ts"] > 0 and e["dur"] >= 0
    back = {s.name: s for s in tracing.spans_from_chrome(json.loads(json.dumps(payload)))}
    orig = {s.name: s for s in spans}
    assert back["child"].parent_id == orig["child"].parent_id
    assert back["child"].trace_id == orig["child"].trace_id
    assert abs(back["child"].duration_s - orig["child"].duration_s) < 1e-3
    assert back["child"].attrs["bytes"] == 42


@pytest.mark.tracing
def test_tree_render_indents_children():
    with tracing.span("root"):
        with tracing.span("mid"):
            with tracing.span("leaf", bytes=7):
                pass
    lines = tracing.render_tree(tracing.snapshot()).splitlines()
    assert lines[0].startswith("trace ")
    indent = {n: next(len(ln) - len(ln.lstrip()) for ln in lines if f"{n}  " in ln) for n in ("root", "mid", "leaf")}
    assert indent["root"] < indent["mid"] < indent["leaf"]
    assert "bytes=7" in next(ln for ln in lines if "leaf" in ln)


@pytest.mark.tracing
def test_export_http_clear_scoped_to_trace_id():
    with tracing.span("trace_a") as a:
        pass
    with tracing.span("trace_b"):
        pass
    status, body, ctype = tracing.export_http("chrome", trace_id=a.trace_id, clear=True)
    assert status == 200 and ctype == "application/json"
    assert [e["name"] for e in json.loads(body)["traceEvents"]] == ["trace_a"]
    assert [s.name for s in tracing.snapshot()] == ["trace_b"]
    tracing.export_http("chrome", clear=True)
    assert tracing.buffer_len() == 0 and tracing.export_http("bogus")[0] == 400


@pytest.mark.tracing
def test_orphan_spans_are_roots_not_dropped():
    with tracing.span("kept"):
        pass
    (kept,) = tracing.snapshot()
    orphan = tracing.Span(trace_id=kept.trace_id, span_id="f" * 16, parent_id="e" * 16, name="orphan",
                          start_s=kept.start_s, end_s=kept.end_s)
    roots, _ = tracing.build_tree([kept, orphan])
    assert {r.name for r in roots} == {"kept", "orphan"}
    assert "orphan" in tracing.render_tree([kept, orphan])


# -- across the two packages ----------------------------------------------------


@pytest.mark.tracing
@pytest.mark.parametrize("writer,reader", [(jtracing, tracing), (tracing, jtracing)], ids=["jax->port", "port->jax"])
def test_a_traceparent_formatted_by_either_module_parses_in_the_other(writer, reader):
    with writer.span("hop") as sp:
        tp = writer.current_traceparent()
    ctx = reader.parse_traceparent(tp)
    assert (ctx.trace_id, ctx.span_id) == (sp.trace_id, sp.span_id)
    assert reader.format_traceparent(ctx) == tp
    for bad in BAD_TRACEPARENTS:
        assert (reader.parse_traceparent(bad) is None) and (writer.parse_traceparent(bad) is None)


@pytest.mark.tracing
@pytest.mark.parametrize("writer,reader", [(jtracing, tracing), (tracing, jtracing)], ids=["jax->port", "port->jax"])
def test_a_chrome_export_crosses_the_packages_into_the_same_tree(writer, reader):
    """Spans recorded and exported by one module load through the other's
    ``spans_from_chrome``/``build_tree`` into the same ``render_tree``
    text, once each side maps the wall-anchored times onto its clock."""
    with writer.span("engine.swap", model="tiny"):
        with writer.span("swap.transfer", overlapped=True):
            writer.begin("swap.d2h", activate=False, bucket=0, bytes=4096).end()
    payload = json.loads(json.dumps(writer.export_chrome(writer.snapshot())))
    theirs = reader.spans_from_chrome(payload)
    mine = writer.spans_from_chrome(payload)
    strip = lambda text: [ln.split("  ")[0] + ln.split("ms")[-1] for ln in text.splitlines()]  # noqa: E731
    assert strip(reader.render_tree(theirs)) == strip(writer.render_tree(mine))
    roots, children = reader.build_tree(theirs)
    assert [r.name for r in roots] == ["engine.swap"]
    assert [c.name for c in children[roots[0].span_id]] == ["swap.transfer"]
    assert json.dumps(reader.export_chrome(theirs)["traceEvents"][0]["args"], sort_keys=True) == json.dumps(
        payload["traceEvents"][0]["args"], sort_keys=True)


# -- the port's engine service over HTTP ---------------------------------------

OPTS = "--num-pages 16 --page-size 8 --max-batch 2 --max-model-len 32 --swap-bucket-mib 1 --model-pool-mib 256 --device cpu"


@pytest.fixture(scope="module")
def swap_service():
    from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver

    svc = tserver.EngineService(tserver.parse_engine_options(f"--model tiny {OPTS}"))
    server = tserver.serve(svc, "127.0.0.1", 0)
    yield svc, server.server_address[1]
    server.shutdown()
    server.server_close()
    svc.shutdown()


def _call(port, method, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.tracing
def test_swap_records_device_transfer_spans(swap_service):
    svc, _ = swap_service
    with tracing.span("test.root") as root:
        svc.swap("tiny-gemma")
        tracing.clear()
        svc.swap("tiny")  # pool hit: the chunked transfer both ways
    spans = tracing.snapshot(trace_id=root.trace_id)
    by_id = {s.span_id: s for s in spans}
    assert {"engine.swap", "swap.transfer", "swap.d2h", "swap.h2d"} <= {s.name for s in spans}
    swap_sp = next(s for s in spans if s.name == "engine.swap")
    assert swap_sp.attrs["pool_hit"] is True and "predicted_bytes" in swap_sp.attrs
    xfer = next(s for s in spans if s.name == "swap.transfer")
    assert by_id[xfer.parent_id].name == "engine.swap"
    for s in spans:
        if s.name in ("swap.d2h", "swap.h2d"):
            assert by_id[s.parent_id] is xfer and s.attrs["bytes"] > 0
    assert sum(s.attrs["bytes"] for s in spans if s.name == "swap.h2d") == xfer.attrs["bytes_in"]
    assert {s.trace_id for s in spans} == {root.trace_id}


@pytest.mark.tracing
def test_disabled_tracing_records_nothing_on_swap(swap_service):
    svc, _ = swap_service
    tracing.disable()
    svc.swap("tiny-gemma")
    svc.swap("tiny")
    svc.sleep(1)
    svc.wake_up()
    assert tracing.buffer_len() == 0 and tracing.request_buffer_len() == 0


@pytest.mark.tracing
def test_sleep_and_wake_bucket_spans_sum_to_the_offload(swap_service):
    svc, port = swap_service
    header = {"traceparent": f"00-{'ef' * 16}-{'12' * 8}-01"}
    st, body = _call(port, "POST", "/sleep?level=1", {}, header)
    nbytes = json.loads(body)["bytes_offloaded"]
    assert st == 200 and _call(port, "POST", "/wake_up", {}, header)[0] == 200
    spans = tracing.snapshot(trace_id="ef" * 16)
    sleep = next(s for s in spans if s.name == "engine.sleep")
    wake = next(s for s in spans if s.name == "engine.wake")
    assert sleep.parent_id == wake.parent_id == "12" * 8
    d2h = [s for s in spans if s.name == "sleep.d2h"]
    h2d = [s for s in spans if s.name == "wake.h2d"]
    assert {s.parent_id for s in d2h} == {sleep.span_id} and {s.parent_id for s in h2d} == {wake.span_id}
    assert sum(s.attrs["bytes"] for s in d2h) == sum(s.attrs["bytes"] for s in h2d) == nbytes
    assert wake.duration_s >= sum(s.duration_s for s in h2d)


@pytest.mark.tracing
def test_traces_endpoint_and_traceparent_hop(swap_service):
    _, port = swap_service
    remote_trace, remote_span = "ab" * 16, "cd" * 8
    header = {"traceparent": f"00-{remote_trace}-{remote_span}-01"}
    st, body = _call(port, "POST", "/v1/swap", {"model": "tiny-gemma"}, header)
    assert st == 200, body
    st, body = _call(port, "GET", "/v1/traces")
    evs = json.loads(body)["traceEvents"]
    assert st == 200 and evs
    for e in evs:
        assert {"name", "ph", "ts", "dur", "pid", "tid", "args"} <= set(e)
    swap_evs = [e for e in evs if e["name"] == "engine.swap"]
    assert swap_evs[-1]["args"]["trace_id"] == remote_trace and swap_evs[-1]["args"]["parent_id"] == remote_span
    st, body = _call(port, "GET", "/v1/traces?format=tree")
    assert st == 200 and b"engine.swap" in body
    assert _call(port, "GET", "/v1/traces?format=bogus")[0] == 400
    assert _call(port, "GET", "/v1/traces?clear=1")[0] == 200
    assert json.loads(_call(port, "GET", "/v1/traces")[1])["traceEvents"] == []
    assert _call(port, "POST", "/v1/swap", {"model": "tiny"})[0] == 200


@pytest.mark.tracing
def test_profile_endpoints_gate_one_capture(swap_service, tmp_path):
    """POST starts a torch.profiler capture, a second POST is a 409,
    DELETE stops it and writes the Chrome trace under log_dir, DELETE with
    none is a 409: the reference's bodies."""
    _, port = swap_service
    log_dir = str(tmp_path / "prof")
    assert json.loads(_call(port, "GET", "/v1/profile")[1]) == {"profiling": False, "log_dir": ""}
    st, body = _call(port, "POST", "/v1/profile", {"log_dir": log_dir})
    assert st == 200 and json.loads(body) == {"profiling": True, "log_dir": log_dir}
    assert _call(port, "POST", "/v1/profile", {"log_dir": log_dir})[0] == 409
    assert json.loads(_call(port, "GET", "/v1/profile")[1])["profiling"] is True
    assert _call(port, "POST", "/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 2})[0] == 200
    st, body = _call(port, "DELETE", "/v1/profile")
    assert st == 200 and json.loads(body) == {"profiling": False, "log_dir": log_dir}
    assert _call(port, "DELETE", "/v1/profile")[0] == 409
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)  # the engine thread's operators


@pytest.mark.tracing
def test_launcher_rpc_metric_and_traceparent_header(tmp_path):
    """``_engine_request`` observes ``fma_launcher_rpc_seconds{verb,outcome}``
    per attempt and sends the current traceparent, so the engine side
    joins the launcher's trace."""
    from llm_d_fast_model_actuation_tpu_torch.launcher import manager as manager_mod
    from llm_d_fast_model_actuation_tpu_torch.launcher.chiptranslator import ChipTranslator
    from llm_d_fast_model_actuation_tpu_torch.launcher.instance import InstanceConfig
    from llm_d_fast_model_actuation_tpu_torch.utils.prom import exposition
    from tests.torch_launcher_fakes import fake_kickoff

    m = manager_mod.EngineProcessManager(ChipTranslator.create(mock_chips=True, mock_chip_count=2),
                                         log_dir=str(tmp_path), kickoff=fake_kickoff)

    def count(outcome):
        return manager_mod.LAUNCHER_RPC_SECONDS.labels(verb="GET /v1/swap", outcome=outcome).count

    seen = {}

    class _Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return json.dumps({"ok": True}).encode()

    def fake_urlopen(req, timeout=None):
        seen.update(req.headers)
        return _Resp()

    orig = manager_mod.urllib.request.urlopen
    manager_mod.urllib.request.urlopen = fake_urlopen
    try:
        m.create_instance(InstanceConfig(options="--model tiny --port 1"), "m1")
        ok_before = count("ok")
        with tracing.span("test.rpc") as root:
            assert m._engine_request("m1", "GET", "/v1/swap", None, 5, manager_mod.SwapFailed) == {"ok": True}
        assert count("ok") == ok_before + 1
        ctx = tracing.parse_traceparent(seen.get("Traceparent"))
        assert ctx is not None and ctx.trace_id == root.trace_id
        rpc = next(s for s in tracing.snapshot() if s.name == "launcher.rpc")
        assert rpc.parent_id == root.span_id and rpc.attrs["outcome"] == "ok"

        def failing_urlopen(req, timeout=None):
            raise urllib.error.HTTPError(req.full_url, 503, "busy", {}, None)

        manager_mod.urllib.request.urlopen = failing_urlopen
        err_before = count("http_503")
        with pytest.raises(manager_mod.SwapFailed):
            m._engine_request("m1", "GET", "/v1/swap", None, 5, manager_mod.SwapFailed)
        assert count("http_503") == err_before + 1
        assert "fma_launcher_rpc_seconds_count" in exposition()
    finally:
        manager_mod.urllib.request.urlopen = orig
        m.stop_all_instances(timeout=2)

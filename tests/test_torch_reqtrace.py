"""Request-lifecycle tracing in the port, the tests of
``tests/test_reqtrace.py``: the request ring is apart from the actuation
ring, ``--trace-requests 0`` records nothing for a met request, a client
traceparent forces a trace, and tail-keep keeps a violated request's trace
with an SLO exemplar whose legs partition its wall time. The
engine-backed cases run the port's CPU service beside the JAX package's
on the same prompt and compare the span trees' shapes. The migration
cases: a stream migrated to a sibling keeps one trace id across the two
engines, and a client that leaves before or after the release is one
client abort on each side."""

import json
import threading
import time

import pytest

from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu.utils import tracing as jtracing
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.utils import tracing

pytestmark = pytest.mark.reqtrace


@pytest.fixture(autouse=True)
def _clean_tracing():
    for t in (tracing, jtracing):
        t.enable()
        t.clear()
        t.clear_requests()
        t.configure_request_sampling(0.0)
    yield
    for t in (tracing, jtracing):
        t.enable()
        t.clear()
        t.clear_requests()
        t.configure_request_sampling(0.0)


def test_request_spans_never_evict_actuation_spans(monkeypatch):
    buf, rbuf = tracing.TraceBuffer(capacity=4), tracing.TraceBuffer(capacity=4)
    monkeypatch.setattr(tracing, "_BUFFER", buf)
    monkeypatch.setattr(tracing, "_REQ_BUFFER", rbuf)
    with tracing.span("engine.swap"):
        pass
    for _ in range(50):
        tr = tracing.RequestTrace(sampled=True)
        tr.add("request.queue", 0.0, 1.0)
        tr.finish(0.0, 2.0, keep=True)
    assert len(rbuf) == 4
    assert [s.name for s in buf.snapshot()] == ["engine.swap"]
    assert all(s.name.startswith("request.") for s in rbuf.snapshot())
    assert [s.name for s in tracing.snapshot()] == ["engine.swap"]


def test_sampling_draw_clamps_and_short_circuits(monkeypatch):
    tracing.configure_request_sampling(1.0)
    assert tracing.sample_request() is True
    tracing.configure_request_sampling(2.0)
    assert tracing.request_sampling() == 1.0
    tracing.configure_request_sampling(-3)
    assert tracing.request_sampling() == 0.0
    tracing.configure_request_sampling("nope")
    assert tracing.request_sampling() == 0.0

    def boom():
        raise AssertionError("sample_request drew RNG at frac 0")

    monkeypatch.setattr(tracing.random, "random", boom)
    assert tracing.sample_request() is False
    tracing.configure_request_sampling(1.0)
    tracing.disable()
    monkeypatch.undo()
    assert tracing.sample_request() is False


def test_unsampled_finish_drops_and_double_finish_is_idempotent():
    tr = tracing.RequestTrace(sampled=False)
    tr.add("request.queue", 0.0, 1.0)
    assert tr.finish(0.0, 2.0, keep=False) and tracing.request_buffer_len() == 0
    kept = tracing.RequestTrace(sampled=True)
    kept.finish(0.0, 1.0, keep=True)
    n = tracing.request_buffer_len()
    kept.finish(0.0, 1.0, keep=True)
    assert tracing.request_buffer_len() == n


def test_export_http_unions_both_rings():
    with tracing.span("engine.swap"):
        pass
    tr = tracing.RequestTrace(sampled=True)
    tr.add("request.queue", 1.0, 2.0)
    tr.finish(1.0, 3.0, keep=True)
    status, body, _ = tracing.export_http("chrome")
    assert status == 200
    assert {"engine.swap", "request.lifecycle", "request.queue"} <= {e["name"] for e in json.loads(body)["traceEvents"]}
    _, body, _ = tracing.export_http("chrome", trace_id=tr.trace_id)
    assert {e["name"] for e in json.loads(body)["traceEvents"]} == {"request.lifecycle", "request.queue"}


def test_reset_after_fork_resets_request_ring_and_sampling(monkeypatch):
    monkeypatch.setenv(tracing.REQ_BUFFER_ENV_VAR, "8")
    try:
        tracing.configure_request_sampling(0.5)
        tracing.RequestTrace(sampled=True).finish(0.0, 1.0, keep=True)
        tracing.reset_after_fork()
        assert tracing.request_buffer_len() == 0 and tracing.request_sampling() == 0.0
        for _ in range(20):
            tracing.RequestTrace(sampled=True).finish(0.0, 1.0, keep=True)
        assert tracing.request_buffer_len() == 8
    finally:
        monkeypatch.delenv(tracing.REQ_BUFFER_ENV_VAR)
        tracing.reset_after_fork()


OPTS = "--num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --swap-bucket-mib 1"


@pytest.fixture
def services(request):
    """The port's CPU service and the JAX package's, each with the given
    extra flags (the tiny config; each framework draws its own weights)."""
    made = []

    def make(extra: str = ""):
        t = tserver.EngineService(tserver.parse_engine_options(f"--model tiny {OPTS} --device cpu {extra}"))
        made.append(t)
        j = jserver.EngineService(jserver.parse_engine_options(f"--model tiny {OPTS} {extra}"))
        made.append(j)
        return t, j

    yield make
    for svc in made:
        svc.shutdown()


def _tree_shape(spans) -> list:
    by_id = {s.span_id: s for s in spans}
    return sorted((s.name, by_id[s.parent_id].name if s.parent_id in by_id else "") for s in spans)


def test_trace_requests_zero_records_nothing_for_met_requests(services):
    t, j = services()
    req = t.submit(prompt=[1, 2, 3], max_new_tokens=4).result(timeout=120)
    jreq = j.submit([1, 2, 3], 4, 0.0).result(timeout=120)
    assert req.trace_id == "" == jreq.trace_id
    assert tracing.request_buffer_len() == 0 == jtracing.request_buffer_len()
    u, ju = tserver._lifecycle_usage(req), jserver._lifecycle_usage(jreq)
    assert set(u) == set(ju) and "trace_id" not in u
    assert t.stats()["slo_exemplars"] == [] == j.stats()["slo_exemplars"]


def test_client_traceparent_forces_a_trace_at_zero_sampling(services):
    t, j = services()
    remote_trace, remote_span = "ab" * 16, "cd" * 8
    req = t.submit(prompt=[1, 2, 3], max_new_tokens=4,
                   trace_ctx=tracing.SpanContext(remote_trace, remote_span)).result(timeout=120)
    jreq = j.submit([1, 2, 3], 4, 0.0, trace_ctx=jtracing.SpanContext(remote_trace, remote_span)).result(timeout=120)
    assert req.trace_id == remote_trace == jreq.trace_id
    assert tserver._lifecycle_usage(req)["trace_id"] == remote_trace
    spans, jspans = tracing.request_snapshot(remote_trace), jtracing.request_snapshot(remote_trace)
    assert _tree_shape(spans) == _tree_shape(jspans)
    by_name = {s.name: s for s in spans}
    root = by_name["request.lifecycle"]
    assert root.parent_id == remote_span and root.attrs["outcome"] == "finished"
    assert {k for k in root.attrs} == {k for k in {s.name: s for s in jspans}["request.lifecycle"].attrs}
    for name in ("request.queue", "request.prefill", "request.decode"):
        assert by_name[name].parent_id == root.span_id
    assert sum(1 for s in spans if s.name == "request.decode") == 1
    assert by_name["request.decode"].attrs["tokens"] == len(req.out_tokens)
    assert tracing.snapshot(trace_id=remote_trace) == []


def test_tail_keep_retains_violated_trace_at_zero_sampling(services):
    t, j = services("--slo-ttft-ms 0.001")
    req = t.submit(prompt=[1, 2, 3], max_new_tokens=4).result(timeout=120)
    jreq = j.submit([1, 2, 3], 4, 0.0).result(timeout=120)
    assert req.trace_id and jreq.trace_id
    spans = tracing.request_snapshot(req.trace_id)
    assert _tree_shape(spans) == _tree_shape(jtracing.request_snapshot(jreq.trace_id))
    by_name = {s.name: s for s in spans}
    assert by_name["request.prefill"].attrs.get("synthesized") is True
    root = by_name["request.lifecycle"]
    assert root.attrs["violated"] is True
    ex, jex = t.stats()["slo_exemplars"], j.stats()["slo_exemplars"]
    assert ex[-1]["trace_id"] == req.trace_id and ex[-1]["violated"] == ["ttft"] == jex[-1]["violated"]
    assert set(ex[-1]) == set(jex[-1]) and set(ex[-1]["legs"]) == set(jex[-1]["legs"])
    wall = root.end_s - root.start_s
    assert abs(sum(ex[-1]["legs"].values()) - wall) <= 0.1 * wall + 1e-3


def test_head_sampling_traces_every_request_at_one(services):
    t, _ = services("--trace-requests 1")
    req = t.submit(prompt=[1, 2, 3], max_new_tokens=3).result(timeout=120)
    assert req.trace_id and {s.name for s in tracing.request_snapshot(req.trace_id)} == {
        "request.lifecycle", "request.queue", "request.prefill", "request.decode"}


# -- migrated streams (zero-drain parking, live migration) ---------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.conftest import build_tiny_hf_model_dir

    return build_tiny_hf_model_dir(str(tmp_path_factory.mktemp("reqtrace") / "m"))


@pytest.fixture
def pair(ckpt):
    """Two port services of one checkpoint, the source's claim verbs wired
    to the destination in process."""
    src, dst = (tserver.EngineService(tserver.parse_engine_options(
        f"--model hf:{ckpt} {OPTS} --zero-drain on --device cpu")) for _ in range(2))
    src._claim_fetch = lambda dest, cid, have, wait_s: dst.claim_view(cid, wait_s=wait_s, have=have)
    src._claim_abort = lambda dest, cid: dst.abort_claim(cid)
    yield src, dst
    src.shutdown()
    dst.shutdown()


def _live_stream(svc, prompt, max_tokens=8, **kw):
    toks: list = []
    started = threading.Event()

    def slow(req, tok):
        toks.append(tok)
        started.set()
        time.sleep(0.05)

    fut = svc.submit(prompt=list(prompt), max_new_tokens=max_tokens, on_token=slow, **kw)
    assert started.wait(timeout=60), "the stream never produced a token"
    return fut, toks


def _counter(name: str, **labels) -> float:
    from llm_d_fast_model_actuation_tpu_torch.utils.prom import REGISTRY

    for m in REGISTRY:
        if m.name == name[: -len("_total")]:
            child = m._children.get(tuple(labels[k] for k in m.labelnames))
            return child.value if child is not None else 0.0
    return 0.0


def _wait_counter(name, floor, timeout=30.0, **labels):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _counter(name, **labels) >= floor:
            return
        time.sleep(0.05)
    raise AssertionError(f"{name}{labels} never reached {floor} (at {_counter(name, **labels)})")


def _balance(svc) -> None:
    zd = svc.stats()["zero_drain"]
    assert zd["preempted"] == zd["resumed"] + zd["aborted"] + zd["migrated"], zd


def test_migrated_stream_spans_share_origin_trace_id(pair, ckpt):
    """One timeline for a stream that lived on two engines: the trace
    context rides the bundle, so the destination's resume and decode spans
    and the source's migrate span carry the same trace id."""
    src, dst = pair
    trace_id = "ab" * 16
    fut, toks = _live_stream(src, [1, 2, 3], trace_ctx=tracing.SpanContext(trace_id, "cd" * 8))
    doc = src.export_parked(f"hf:{ckpt}")
    ack = dst.import_parked(doc)
    rel = src.release_parked(doc["fence"]["token"], dest="local", claims=ack["claims"])
    assert rel["ok"] and rel["migrated"] == 1
    req = fut.result(timeout=120)
    assert req.out_tokens and toks == req.out_tokens
    spans = tracing.request_snapshot(trace_id)
    assert {s.trace_id for s in spans} == {trace_id}
    names = [s.name for s in spans]
    assert "request.preempt" in names and "request.migrate" in names
    resume = next(s for s in spans if s.name == "request.resume")
    assert resume.attrs.get("migrated") is True
    roots = [s for s in spans if s.name == "request.lifecycle"]
    assert {r.attrs.get("outcome") for r in roots} == {"migrated", "finished"}
    assert next(s for s in spans if s.name == "request.migrate").attrs["outcome"] == "migrated"


def test_client_drop_before_release_counts_one_abort_per_side(pair, ckpt):
    """The client leaves while the bundle is away: the source counts one
    client abort and one aborted outcome (no state_loss), and the
    destination, told through its claim, counts its own one."""
    src, dst = pair
    model = f"hf:{ckpt}"
    fut, _ = _live_stream(src, [1, 2, 3], max_tokens=48)
    doc = src.export_parked(model)
    ack = dst.import_parked(doc)
    client0 = _counter("fma_engine_aborted_requests_total", model=model, reason="client")
    loss0 = _counter("fma_engine_aborted_requests_total", model=model, reason="state_loss")
    aborted0 = _counter("fma_engine_preempted_requests_total", model=model, outcome="aborted")
    assert fut.cancel()
    rel = src.release_parked(doc["fence"]["token"], dest="http://dst", claims=ack["claims"])
    assert rel["migrated"] == 0 and rel["proxied"] == 0
    assert _counter("fma_engine_aborted_requests_total", model=model, reason="client") - client0 == 1
    assert _counter("fma_engine_preempted_requests_total", model=model, outcome="aborted") - aborted0 == 1
    _balance(src)
    # both services count under the same model label, process-wide: the
    # total settling at exactly 2 pins one abort on each side
    _wait_counter("fma_engine_aborted_requests_total", client0 + 2, model=model, reason="client")
    time.sleep(0.3)
    assert _counter("fma_engine_aborted_requests_total", model=model, reason="client") - client0 == 2
    assert _counter("fma_engine_aborted_requests_total", model=model, reason="state_loss") == loss0
    s = src.stats()["zero_drain"]
    assert s["migrated"] == 0 and s["aborted"] == 1


def test_client_drop_after_release_counts_one_abort_per_side(pair, ckpt):
    """The client leaves after the handoff committed: the watcher stops,
    the source counts its one client abort from its proxy registry, the
    destination its own from the claim abort; the outcome stays the
    ``migrated`` counted at the release."""
    src, dst = pair
    model = f"hf:{ckpt}"
    fut, _ = _live_stream(src, [1, 2, 3], max_tokens=48)
    doc = src.export_parked(model)
    ack = dst.import_parked(doc)
    client0 = _counter("fma_engine_aborted_requests_total", model=model, reason="client")
    loss0 = _counter("fma_engine_aborted_requests_total", model=model, reason="state_loss")
    mig0 = _counter("fma_engine_preempted_requests_total", model=model, outcome="migrated")
    rel = src.release_parked(doc["fence"]["token"], dest="http://dst", claims=ack["claims"])
    assert rel["migrated"] == 1 and rel["proxied"] == 1
    assert _counter("fma_engine_preempted_requests_total", model=model, outcome="migrated") - mig0 == 1
    src.abort(fut)
    _wait_counter("fma_engine_aborted_requests_total", client0 + 2, model=model, reason="client")
    time.sleep(0.3)
    assert _counter("fma_engine_aborted_requests_total", model=model, reason="client") - client0 == 2
    assert _counter("fma_engine_aborted_requests_total", model=model, reason="state_loss") == loss0
    assert fut.done()
    _balance(src)
    s = src.stats()["zero_drain"]
    assert s["migrated"] == 1 and s["aborted"] == 0

"""Request-lifecycle tracing in the port, the tests of
``tests/test_reqtrace.py`` that involve no parking: the request ring is
apart from the actuation ring, ``--trace-requests 0`` records nothing for
a met request, a client traceparent forces a trace, and tail-keep keeps a
violated request's trace with an SLO exemplar whose legs partition its
wall time. The engine-backed cases run the port's CPU service beside the
JAX package's on the same prompt and compare the span trees' shapes."""

import json

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

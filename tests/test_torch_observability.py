"""The port's metrics held against the JAX package's: the engine's and the
launcher's families equal the reference's by name, type, label names,
buckets and help text, less the named families that wait on ROADMAP
queue 1 items 12 and 13; every registered engine family is exercised by
one scripted run of the CPU service (and of a zero-drain service, for the
parking and migration families) and its exposition parses with
``prometheus_client``'s parser; the debug server; the lifecycle metrics
(queue wait once per request, the SLO split and goodput, the arrival
EWMA); and the launcher's fleet rollup onto its gauges."""

import json
import os
import shutil
import threading
import time
import urllib.request

import pytest
from prometheus_client import metrics as pm
from prometheus_client.parser import text_string_to_metric_families

from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu.launcher import manager as jmanager
from llm_d_fast_model_actuation_tpu_torch.engine import metrics as tmetrics
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.launcher import manager as tmanager
from llm_d_fast_model_actuation_tpu_torch.utils import prom, tracing
from tests.conftest import build_tiny_hf_model_dir
from tests.torch_launcher_fakes import fake_kickoff

UNPORTED = {**tmetrics.UNPORTED_FAMILIES, **tmanager.UNPORTED_FAMILIES}


def _jax_families() -> dict:
    out = {}
    for mod in (jserver, jmanager):
        for v in vars(mod).values():
            if isinstance(v, pm.MetricWrapperBase) and v._name.startswith(("fma_engine_", "fma_launcher_")):
                buckets = tuple(b for b in getattr(v, "_upper_bounds", ()) if b != float("inf"))
                out[v._name] = (v._type, tuple(v._labelnames), buckets, v._documentation)
    return out


def _port_families() -> dict:
    return {m.name: (m.kind, m.labelnames, tuple(getattr(m, "buckets", ())), m.documentation)
            for mod in (tmetrics, tmanager) for m in vars(mod).values() if isinstance(m, prom._Metric)}


def test_the_families_equal_the_jax_packages_less_the_named_ones():
    jax, port = _jax_families(), _port_families()
    assert set(UNPORTED) <= set(jax) and not set(UNPORTED) & set(port)
    assert UNPORTED == {}  # every family of the reference is the port's
    assert {k: v for k, v in jax.items() if k not in UNPORTED} == port


def test_registering_a_family_twice_does_not_double_its_samples():
    n0 = len(prom.REGISTRY)
    try:
        a = prom.Counter("t_twice_total", "doc", ["x"])
        b = prom.Counter("t_twice_total", "doc", ["x"])
        a.labels(x="1").inc(2)
        b.labels(x="1").inc(3)
        assert len(prom.REGISTRY) == n0 + 1
        lines = [ln for ln in prom.exposition().splitlines() if ln.startswith("t_twice")]
        assert lines == ['t_twice_total{x="1"} 5.0']
    finally:
        del prom.REGISTRY[n0:]


def _scrape(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/plain; version=0.0.4")
        return r.read().decode()


def _value(text: str, name: str, **labels) -> float:
    return sum(s.value for fam in text_string_to_metric_families(text) for s in fam.samples
               if s.name == name and all(s.labels.get(k) == v for k, v in labels.items()))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return [build_tiny_hf_model_dir(str(tmp_path_factory.mktemp("hf") / n), num_hidden_layers=k)
            for n, k in (("a", 2), ("b", 1), ("c", 1))]


def test_every_registered_engine_family_is_exercised(dirs, tmp_path):
    """A bucketed build's warm-up, then one scripted run of a packed CPU
    service from a Hugging Face directory (requests, an echo, an abort, two sleep/wake cycles, a cold
    swap, a pool hit, a rolled-back swap, a prefetch of a third), and a
    zero-drain service of the second directory that exports a live stream
    and resumes it at home, and a co-resident attach, routed request and
    detach on two siblings of the first, leave a sample in
    every engine family, labelled families with a child, and the counters
    the traffic moves at the traffic's numbers; the exposition parses with
    prometheus_client's parser into exactly the registered families."""
    from llm_d_fast_model_actuation_tpu_torch.utils import faults

    a, b, c = (f"hf:{d}" for d in dirs)
    # a bucketed build runs its warm-up's prefill bucket (the packed path
    # runs none; the CPU captures no graph)
    tserver.EngineService(tserver.parse_engine_options(
        "--model tiny --device cpu --num-pages 16 --page-size 8 --max-batch 2 --max-model-len 32 "
        "--warmup-buckets 16")).shutdown()
    svc = tserver.EngineService(tserver.parse_engine_options(
        f"--model {a} --device cpu --num-pages 64 --page-size 8 --max-batch 2 --max-model-len 64 "
        f"--swap-bucket-mib 1 --model-pool-mib 64 --pool-disk-dir {tmp_path / 'tier'} --packed-serving on "
        "--slo-ttft-ms 60000 --slo-tpot-ms 60000"))
    server = tserver.serve(svc, "127.0.0.1", 0)
    port = server.server_address[1]
    # co-residency, before the deltas start and under models of its own:
    # two siblings of A (lm_head changed), one serving, the other pooled,
    # attached, a request routed to it, detached
    from safetensors.torch import load_file, save_file

    sibs = []
    for i, fn in enumerate((lambda t: t.flip(0), lambda t: t.roll(t.shape[0] // 2, 0))):
        sibs.append(str(tmp_path / f"sibling-{i}"))
        shutil.copytree(dirs[0], sibs[-1])
        t = load_file(os.path.join(sibs[-1], "model.safetensors"))
        t["lm_head.weight"] = fn(t["lm_head.weight"]).contiguous()
        save_file(t, os.path.join(sibs[-1], "model.safetensors"), metadata={"format": "pt"})
    s1, s2 = (f"hf:{d}" for d in sibs)
    co = tserver.EngineService(tserver.parse_engine_options(
        f"--model {s1} --device cpu --num-pages 64 --page-size 8 --max-batch 2 --max-model-len 64 "
        "--packed-serving on --resident-variants 2"))
    try:
        co.swap(s2)
        co.swap(s1)
        handle = co.attach_resident(s2)["handle"]
        assert co.submit(prompt=[1, 2, 3], max_new_tokens=2, variant=handle).result(timeout=120).out_tokens
        co.detach_resident(s2)
    finally:
        co.shutdown()
    # the registry is the process's: families without a model label count
    # what other services of this process did too, so those are deltas
    before = _scrape(port)
    try:
        reqs = [svc.submit(prompt=[1, 2, 3, i], max_new_tokens=4).result(timeout=120) for i in range(3)]
        svc.submit(prompt=[4, 5, 6], max_new_tokens=1, want_prompt_logprobs=True).result(timeout=120)
        fut = svc.submit(prompt=[7, 8, 9], max_new_tokens=50)
        svc.abort(fut)
        with pytest.raises(Exception):
            fut.result(timeout=60)
        nbytes = [svc.sleep(1)["bytes_offloaded"] for _ in range(1)]
        svc.wake_up()
        svc.sleep(1)
        svc.wake_up()
        svc.swap(b)  # cold
        svc.swap(a)  # pool hit
        faults.arm_spec("swap.h2d=fail:1")
        try:
            with pytest.raises(tserver.SwapRolledBack):
                svc.swap(b)
        finally:
            faults.reset()
        assert svc.prefetch(c)["started"]
        svc._prefetch_thread.join(timeout=120)
        assert svc.prefetch_status()["state"] == "completed"
        # parking and migration: a live stream parked into an export, then
        # resumed at home by the fence's abort
        zd = tserver.EngineService(tserver.parse_engine_options(
            f"--model {b} --device cpu --num-pages 64 --page-size 8 --max-batch 2 --max-model-len 64 "
            "--zero-drain on"))
        try:
            started = threading.Event()
            live = zd.submit(prompt=[1, 2, 3], max_new_tokens=16,
                             on_token=lambda req, tok: (started.set(), time.sleep(0.05)))
            assert started.wait(timeout=60)
            doc = zd.export_parked(b)
            assert doc["kv"]["nbytes"] > 0
            assert zd.abort_migration(doc["fence"]["token"])["outcome"] == "resumed_local"
            assert len(live.result(timeout=120).out_tokens) == 16
        finally:
            zd.shutdown()
        # n-gram speculation: its two families are set by its service's scrape
        sp = tserver.EngineService(tserver.parse_engine_options(
            f"--model {b} --device cpu --num-pages 64 --page-size 8 --max-batch 2 --max-model-len 64 "
            "--speculative-ngram 4"))
        try:
            sp.submit(prompt=[7, 8, 9, 7, 8, 9, 7, 8, 9], max_new_tokens=8).result(timeout=120)
            sp.metrics_text()
        finally:
            sp.shutdown()
        text = _scrape(port)
        families = {f.name: f for f in text_string_to_metric_families(text)}
        registered = {m.name for m in prom.REGISTRY}
        assert set(families) == registered
        for m in prom.REGISTRY:
            if not m.name.startswith("fma_engine_"):
                continue
            assert families[m.name].samples, f"{m.name} has no sample"
            assert not m.labelnames or m._children, f"{m.name} was never set"
        model = svc.model
        assert _value(text, "fma_engine_time_to_first_token_seconds_count", model=a) == 4
        assert _value(text, "fma_engine_queue_wait_seconds_count", model=a) == 4  # the aborted one never finished
        assert _value(text, "fma_engine_generation_tokens_total", model=a) == 13
        assert _value(text, "fma_engine_aborted_requests_total", model=a, reason="client") == 1
        def grew(name, **labels):
            return _value(text, name, **labels) - _value(before, name, **labels)

        assert grew("fma_engine_actuation_bytes", mode="off", dir="d2h") >= 2 * nbytes[0]
        assert _value(text, "fma_engine_swaps_total", model=a, source="pool") == 1
        assert grew("fma_engine_model_pool_hits_total") == 1
        assert grew("fma_engine_recoveries_total", path="swap", outcome="rolled_back") == 1
        assert _value(text, "fma_engine_packed_tokens_per_step_count", model=a) > 0
        assert grew("fma_engine_prefetch_total", outcome="completed") == 1
        assert _value(text, "fma_engine_prefetch_staged_bytes") > 0
        assert _value(text, "fma_engine_slo_requests_total", model=a, slo="ttft", outcome="met") == 4
        assert _value(text, "fma_engine_goodput_tokens_total", model=a) == 13
        assert model == a and all(len(r.out_tokens) == 4 for r in reqs)
    finally:
        server.shutdown()
        server.server_close()
        svc.shutdown()


def test_debug_server_endpoints():
    from llm_d_fast_model_actuation_tpu_torch.utils.observability import serve_observability

    server = serve_observability(0, "127.0.0.1")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with tracing.span("debug.probe"):
            pass
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert r.status == 200 and list(text_string_to_metric_families(r.read().decode()))
        with urllib.request.urlopen(f"{base}/debug/stacks", timeout=10) as r:
            assert b"--- thread" in r.read()
        with urllib.request.urlopen(f"{base}/debug/vars", timeout=10) as r:
            v = json.loads(r.read())
            assert v["threads"] >= 1 and v["uptime_s"] >= 0 and "gc_counts" in v
        with urllib.request.urlopen(f"{base}/debug/traces?format=tree", timeout=10) as r:
            assert b"debug.probe" in r.read()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=10)
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


@pytest.fixture(scope="module")
def lifecycle_service():
    svc = tserver.EngineService(tserver.parse_engine_options(
        "--model tiny --device cpu --num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 "
        "--slo-ttft-ms 60000 --slo-tpot-ms 60000"))
    server = tserver.serve(svc, "127.0.0.1", 0)
    yield svc, server.server_address[1]
    server.shutdown()
    server.server_close()
    svc.shutdown()


def _gen(svc, n=3, prompt=(1, 2, 3)):
    return svc.submit(prompt=list(prompt), max_new_tokens=n).result(timeout=120)


def _sample(port, name, **labels):
    return _value(_scrape(port), name, **labels)


def test_queue_wait_observed_once_per_request(lifecycle_service):
    svc, port = lifecycle_service
    before = _sample(port, "fma_engine_queue_wait_seconds_count", model="tiny")
    reqs = [_gen(svc) for _ in range(3)]
    assert _sample(port, "fma_engine_queue_wait_seconds_count", model="tiny") == before + 3
    for r in reqs:
        assert r.submit_time <= r.first_sched_time <= r.first_token_time <= r.done_time


def test_slo_split_met_violated_and_goodput(lifecycle_service):
    svc, port = lifecycle_service

    def counts():
        text = _scrape(port)
        return ({(slo, o): _value(text, "fma_engine_slo_requests_total", model="tiny", slo=slo, outcome=o)
                 for slo in ("ttft", "tpot") for o in ("met", "violated")},
                _value(text, "fma_engine_goodput_tokens_total", model="tiny"),
                _value(text, "fma_engine_generation_tokens_total", model="tiny"))

    before, gp0, _ = counts()
    r = _gen(svc, n=4)
    after, gp1, gen1 = counts()
    assert after[("ttft", "met")] == before[("ttft", "met")] + 1
    assert after[("tpot", "met")] == before[("tpot", "met")] + 1
    assert gp1 == gp0 + len(r.out_tokens)
    svc._slo_ttft_s = 1e-9
    try:
        r = _gen(svc, n=4)
        after2, gp2, gen2 = counts()
        assert after2[("ttft", "violated")] == after[("ttft", "violated")] + 1
        assert gp2 == gp1 and gen2 == gen1 + len(r.out_tokens)
        st = svc.stats()
        assert st["slo"]["violated"] >= 1 and st["slo"]["met"] >= 1
        assert st["goodput_tokens"] < st["generated_tokens"] and 0.0 <= st["slo"]["attainment"] <= 1.0
        assert st["slo_exemplars"][-1]["violated"] == ["ttft"]
    finally:
        svc._slo_ttft_s = 60.0
    svc._slo_tpot_s = 1e-9
    try:
        b0 = counts()[0][("tpot", "violated")]
        _gen(svc, n=4)
        assert counts()[0][("tpot", "violated")] == b0 + 1
    finally:
        svc._slo_tpot_s = 60.0


def test_arrival_rate_ewma_decays():
    ew = tserver._RateEWMA(tau_s=5.0)
    ref = jserver._RateEWMA(tau_s=5.0)
    t = 100.0
    for _ in range(50):
        ew.observe(t)
        ref.observe(t)
        t += 0.1
    peak = ew.rate(t)
    assert peak == pytest.approx(ref.rate(t), rel=1e-12) and peak > 2.0
    later, much_later = ew.rate(t + 5.0), ew.rate(t + 30.0)
    assert later < peak and much_later < later and much_later < 0.05 * peak


def test_stats_slo_block_and_usage_fields(lifecycle_service):
    svc, port = lifecycle_service
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", method="POST",
                                 data=json.dumps({"prompt": [1, 2, 3], "max_tokens": 4}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        usage = json.loads(r.read())["usage"]
    assert usage["queue_wait_s"] >= 0 and usage["decode_tpot_s"] >= 0
    assert usage["time_to_first_token_s"] >= usage["queue_wait_s"] and "trace_id" not in usage
    st = svc.stats()
    assert st["slo"]["ttft_ms"] == 60000.0 and st["slo"]["tpot_ms"] == 60000.0
    assert st["arrival_rate_rps"] > 0 and st["finished_requests"] >= 1
    assert st["engine"]["cold_prefills"] >= 1 and st["engine"]["decode_steps"] >= 1


def test_fleet_rollup_aggregates_and_mirrors_gauges(monkeypatch, tmp_path):
    from llm_d_fast_model_actuation_tpu_torch.launcher.chiptranslator import ChipTranslator
    from llm_d_fast_model_actuation_tpu_torch.launcher.instance import InstanceConfig

    manager = tmanager.EngineProcessManager(ChipTranslator.create(mock_chips=True, mock_chip_count=4),
                                            log_dir=str(tmp_path), kickoff=fake_kickoff)
    try:
        for iid in ("i-a", "i-b", "i-down"):
            manager.create_instance(InstanceConfig(options="--model tiny"), instance_id=iid)
        exemplar = {"trace_id": "ab" * 16, "model": "tiny", "violated": ["ttft"], "ttft_s": 0.5,
                    "legs": {"queue": 0.1, "prefill": 0.4, "decode": 0.0, "preempt": 0.0, "migrate": 0.0}}
        canned = {
            "i-a": {"model": "tiny", "queue_depth": 3, "arrival_rate_rps": 1.5,
                    "slo": {"ttft_ms": 500, "tpot_ms": 0, "met": 8, "violated": 2}, "finished_requests": 10,
                    "generated_tokens": 100, "goodput_tokens": 80, "aborted": {"swap": 2},
                    "actuations": {"swap": 2, "sleep": 1}, "uptime_s": 3600.0, "slo_exemplars": [exemplar]},
            "i-b": {"model": "tiny-gemma", "queue_depth": 1, "arrival_rate_rps": 0.5,
                    "slo": {"ttft_ms": 500, "tpot_ms": 0, "met": 2, "violated": 3}, "finished_requests": 5,
                    "generated_tokens": 50, "goodput_tokens": 20, "aborted": {"client": 1, "swap": 1},
                    "actuations": {"wake": 3}, "uptime_s": 1800.0},
        }

        def fake_poll(iid, timeout):
            if iid == "i-down":
                raise tmanager.StatsFailed(iid, 502, "engine unreachable")
            return canned[iid]

        monkeypatch.setattr(manager, "_poll_instance_stats", fake_poll)
        fleet = manager.get_all_instances_status(include_fleet=True)["fleet"]
        assert (fleet["instances_total"], fleet["instances_reporting"], fleet["queue_depth"]) == (3, 2, 4)
        assert fleet["slo_attainment"] == pytest.approx(10 / 15) and fleet["goodput_tokens"] == 100
        assert fleet["actuations_per_hour"] == pytest.approx(9.0)
        assert fleet["aborted"] == {"swap": 3, "client": 1}
        assert fleet["slo_exemplars"] == [{"instance": "i-a", **exemplar}]
        text = prom.exposition()
        assert _value(text, "fma_launcher_fleet_instances", state="reporting") == 2
        assert _value(text, "fma_launcher_fleet_instances", state="unreachable") == 1
        assert _value(text, "fma_launcher_fleet_queue_depth") == 4
        assert _value(text, "fma_launcher_fleet_arrival_rate") == pytest.approx(2.0)
        assert _value(text, "fma_launcher_fleet_slo_attainment") == pytest.approx(10 / 15)
        assert _value(text, "fma_launcher_fleet_goodput_tokens") == 100
        assert _value(text, "fma_launcher_fleet_actuations_per_hour") == pytest.approx(9.0)
        monkeypatch.setattr(manager, "_poll_instance_stats",
                            lambda *a: (_ for _ in ()).throw(AssertionError("re-polled")))
        assert manager.fleet_rollup()["slo_attainment"] == fleet["slo_attainment"]
    finally:
        manager.stop_all_instances(timeout=2)

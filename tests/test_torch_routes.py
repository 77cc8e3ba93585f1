"""Routes of the reference server the port does not serve yet answer 400
with the port's message, not a 404 ("no route"), whatever lies under
them; and a swap whose build fails from the disk tier leaves the weights
it rebuilt in the pool as prefetched, so the next swap reads neither the
checkpoint nor the tier again (the reference's behaviour)."""

import json
import shutil
import urllib.error
import urllib.request

import pytest

from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.engine.model_pool import PrefetchedWeights
from llm_d_fast_model_actuation_tpu_torch.models import hf as thf
from llm_d_fast_model_actuation_tpu_torch.utils import faults
from tests.conftest import build_tiny_hf_model_dir

OPTS = "--num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0 --swap-bucket-mib 1 --device cpu"


@pytest.fixture(scope="module")
def served():
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model tiny {OPTS}"))
    server = tserver.serve(svc, "127.0.0.1", 0)
    yield server.server_address[1]
    server.shutdown()
    server.server_close()
    svc.shutdown()


def _call(port: int, method: str, path: str):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=b"{}" if method == "POST" else None, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("method,path", [
    ("POST", "/v1/parked/release"),
    ("POST", "/v1/parked/abort"),
    ("GET", "/v1/parked/claims/x"),
    ("GET", "/v1/parked/m"),
    ("POST", "/v1/residents"),
])
def test_an_unported_route_answers_400(served, method, path):
    status, body = _call(served, method, path)
    assert status == 400 and body == {"error": f"{path} is not supported by this server yet"}


@pytest.mark.parametrize("method,path", [("GET", "/v1/profile"), ("GET", "/metrics"), ("GET", "/v1/traces")])
def test_a_ported_observability_route_is_served(served, method, path):
    """``/v1/profile``, ``/metrics`` and ``/v1/traces`` left the unported
    routes: each answers 200."""
    req = urllib.request.Request(f"http://127.0.0.1:{served}{path}", method=method)
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200 and r.read()
    assert not tserver.unported_route(path)


def test_a_prefix_is_not_a_route(served):
    """Matching is by path segment: a route that merely starts with an
    unported one's letters is no route at all."""
    assert tserver.unported_route("/v1/parked") and tserver.unported_route("/v1/residents/x")
    assert not tserver.unported_route("/v1/parkedx") and not tserver.unported_route("/v1/prefetch")
    assert not tserver.unported_route("/v1/profile") and tserver.UNPORTED_ROUTES == ("/v1/parked", "/v1/residents")
    assert _call(served, "GET", "/v1/parkedx")[0] == 404


def test_a_build_that_fails_from_the_disk_tier_leaves_prefetched_weights(tmp_path, monkeypatch):
    a = build_tiny_hf_model_dir(str(tmp_path / "a"))
    copy = str(tmp_path / "a-copy")
    shutil.copytree(a, copy)
    model = f"hf:{copy}"
    svc = tserver.EngineService(tserver.parse_engine_options(
        f"--model {model} {OPTS} --pool-disk-dir {tmp_path / 'tier'} --pool-disk-mib 64"))
    try:
        gold = svc.submit(prompt=[1, 2, 3], max_new_tokens=4).result(timeout=60).out_tokens
        svc.swap("tiny")  # pools A
        svc._free_pooled(svc.model_pool.drain())  # evicted: its chunks spill, its manifest stays
        shutil.rmtree(copy)  # nothing to read again
        faults.arm_spec("coldload.h2d=fail:1")  # the tier's weights fail on their way to the device
        try:
            with pytest.raises(faults.FaultError):
                svc.swap(model)
        finally:
            faults.reset()
        assert svc.model == "tiny" and svc.degraded and svc.failure is None
        entry = svc.model_pool.peek(model)
        assert isinstance(entry.runtime, PrefetchedWeights) and entry.runtime.digests
        reads = []
        real = thf.load_params
        monkeypatch.setattr(thf, "load_params", lambda *args, **kw: reads.append(args) or real(*args, **kw))
        out = svc.swap(model)
        assert out["tier"] == "prefetched" and out["prefetched"] and reads == [] and svc.degraded is None
        assert svc.submit(prompt=[1, 2, 3], max_new_tokens=4).result(timeout=60).out_tokens == gold
    finally:
        svc.shutdown()

"""The port's actuation cost oracle (``utils/costs.py``, the service's
``/v1/costs`` and ``/v1/actuations``, the launcher's ``ledger.costs``)
held against the JAX package's, on the CPU.

  * the same observations (with the same clock) give the same bandwidth
    estimates, ``describe()`` and recorder summary as the reference's
    ``utils/costs.py``;
  * the sleep manager's ``on_transfer`` hook feeds the reference's kinds
    from a sleep, a wake and a swap, quantized or not;
  * both services, driven through the same sequence of named-config
    models, price the same candidates with the same bytes; a pool-tier
    swap's ``bytes_moved`` equals the ``predicted_bytes`` read just
    before it, and the flight recorders hold the same rows (times aside);
  * a rolled-back swap is recorded as the reference records it, a refused
    one not at all;
  * the routes answer over HTTP with the reference's keys;
  * ``/v1/costs`` joins a running digest job on the caller's thread,
    never on the engine thread, and a row priced while one still runs
    says so;
  * the launcher's detailed instance list carries each reporting child's
    summary under ``ledger.costs``, as the reference's does.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu.launcher import chiptranslator as jchip
from llm_d_fast_model_actuation_tpu.launcher import instance as jinst
from llm_d_fast_model_actuation_tpu.launcher import manager as jmgr
from llm_d_fast_model_actuation_tpu.utils import costs as jcosts
from llm_d_fast_model_actuation_tpu.utils import faults as jfaults
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.launcher import chiptranslator as pchip
from llm_d_fast_model_actuation_tpu_torch.launcher import instance as pinst
from llm_d_fast_model_actuation_tpu_torch.launcher import manager as pmgr
from llm_d_fast_model_actuation_tpu_torch.utils import costs as tcosts
from llm_d_fast_model_actuation_tpu_torch.utils import faults
from tests.test_torch_quant_swap import _tmgr, _params
from tests.torch_launcher_fakes import fake_kickoff

#: (kind, bytes, seconds, clock) observations: a cold start, a fast
#: recent window dominating a slow first one, a gap that decays the past,
#: degenerate windows dropped, and a second direction family
OBSERVATIONS = [
    ("swap.d2h", 8 << 30, 4.0, 0.0),
    ("swap.d2h", 8 << 30, 0.5, 1.0),
    ("swap.h2d", 4 << 30, 0.25, 2.0),
    ("swap.d2h", 0, 1.0, 3.0),
    ("swap.d2h", 1 << 30, 0.0, 3.5),
    ("wake.h2d", 3 << 30, 0.12, 900.0),
    ("coldload.read", 1 << 30, 2.0, 901.0),
    ("swap.d2h", 2 << 30, 0.1, 2000.0),
]


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


@pytest.mark.parametrize("upto", [1, 3, len(OBSERVATIONS)])
def test_the_cost_book_estimates_as_the_reference(monkeypatch, upto):
    clock = _Clock()
    for mod in (tcosts, jcosts):
        monkeypatch.setattr(mod.time, "monotonic", clock)
    books = [tcosts.CostBook(capacity=4), jcosts.CostBook(capacity=4)]
    ewmas = [tcosts.BandwidthEWMA(), jcosts.BandwidthEWMA()]
    for kind, nb, sec, now in OBSERVATIONS[:upto]:
        clock.now = now
        for book in books:
            book.observe_transfer(kind, nb, sec)
        for ew in ewmas:
            ew.observe(nb, sec, now=now)
    got, want = books
    assert got.bandwidths.describe() == want.bandwidths.describe()
    assert ewmas[0].gibps() == ewmas[1].gibps() and ewmas[0].samples == ewmas[1].samples
    for kind in ("swap.d2h", "swap.h2d", "swap.total", "wake.h2d", "sleep.d2h", "coldload.read", "coldload.h2d"):
        assert got.bandwidths.estimate(kind) == want.bandwidths.estimate(kind)
        assert got.bandwidths.seconds_for(kind, 5 << 30) == want.bandwidths.seconds_for(kind, 5 << 30)
    rows = [
        dict(kind="swap", model="a", tier="pool", actual_bytes=10, actual_s=1.0, predicted_bytes=10,
             predicted_s=1.5, measured=True),
        dict(kind="swap", model="b", tier="pool", outcome="rolled_back", predicted_bytes=7, predicted_s=0.5),
        dict(kind="sleep", model="a", tier="host", actual_bytes=5, actual_s=0.2, predicted_bytes=4,
             predicted_s=0.1, measured=True),
        dict(kind="wake", model="a", actual_bytes=5, actual_s=0.0),
        dict(kind="coldload", model="a", trigger="startup", tier="cold", actual_bytes=3, actual_s=0.3),
    ]
    for row in rows[:upto + 1]:
        for book in books:
            book.record(**row)

    def timeless(x):
        if isinstance(x, dict):
            return {k: timeless(v) for k, v in x.items() if k != "t_wall"}
        if isinstance(x, list):
            return [timeless(v) for v in x]
        return x

    assert timeless(got.summary()) == timeless(want.summary())
    assert timeless(got.recorder.records(n=2, kind="swap")) == timeless(want.recorder.records(n=2, kind="swap"))
    assert len(got.recorder) == len(want.recorder) == min(4, upto + 1)


def test_a_raising_observation_never_fails():
    book = tcosts.CostBook()
    book.bandwidths.observe = lambda *a: 1 / 0
    book.observe_transfer("swap.d2h", 1, 1.0)  # swallowed, as the reference's


@pytest.mark.parametrize("mode", ["off", "int8"])
def test_the_transfer_hook_feeds_the_reference_kinds(mode):
    seen = []
    hook = lambda kind, nb, sec: seen.append((kind, nb))  # noqa: E731
    a, _ = _tmgr(_params(1), 1, quant_mode=mode, on_transfer=hook)
    b, _ = _tmgr(_params(2), 2, quant_mode=mode, on_transfer=hook)
    a.sleep(1)
    a.wake_up()
    b.sleep(1)
    m = __import__("llm_d_fast_model_actuation_tpu_torch.engine.sleep", fromlist=["swap_states"]).swap_states(
        a, b, bucket_bytes=4096
    )
    want = ["sleep.d2h", "wake.h2d", "sleep.d2h", "swap.d2h", "swap.h2d", "swap.total"]
    if mode == "int8":  # the wake's and the swap's expansion of the payloads
        want = want[:1] + ["quant.dequant"] + want[1:3] + ["quant.dequant"] + want[3:]
    assert [k for k, _ in seen] == want
    assert dict(seen)["swap.total"] == m["bytes_moved"] and seen[0][1] == a.stats.bytes_offloaded


OPTS = "--num-pages 24 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0 --swap-bucket-mib 1"


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("t_wall", "actual_s", "predicted_s", "measured",
                                                      "seconds_error_ratio")}


@pytest.fixture(scope="module")
def services():
    t = tserver.EngineService(tserver.parse_engine_options(f"--model tiny {OPTS} --device cpu --sleep-quant int8"))
    j = jserver.EngineService(jserver.parse_engine_options(f"--model tiny {OPTS} --sleep-quant int8"))
    yield t, j
    t.shutdown()
    j.shutdown()


def _row(view, model):
    return next(c for c in view["candidates"] if c["model"] == model)


def test_both_services_price_and_record_alike(services):
    """The same sequence through both services: a quantized level-1 cycle,
    a cold swap, then a pool-tier swap back. Each swap's bytes equal the
    candidate's ``predicted_bytes`` read just before it, in both
    packages, and the two price and record the same bytes."""
    t, j = services
    for svc in (t, j):
        svc.sleep(1)
        svc.wake_up()
    tv, jv = t.costs_report(["tiny-gemma"]), j.costs_view([("tiny-gemma", "")])
    assert set(tv) == set(jv)
    assert set(tv["sleep"]) == set(jv["sleep"]) and set(tv["wake"]) == set(jv["wake"])
    for model in ("tiny", "tiny-gemma"):
        got, want = _row(tv, model), _row(jv, model)
        assert set(got) == set(want) and got["tier"] == want["tier"]
        assert got["predicted_bytes"] == want["predicted_bytes"]
    cold = {"port": t.swap("tiny-gemma"), "jax": j.swap("tiny-gemma")}
    assert cold["port"]["bytes_moved"] == _row(tv, "tiny-gemma")["predicted_bytes"] == cold["jax"]["bytes_moved"]
    tv, jv = t.costs_report(), j.costs_view()
    got, want = _row(tv, "tiny"), _row(jv, "tiny")
    assert got["tier"] == want["tier"] == "pool" and set(got) == set(want)
    assert got["predicted_bytes"] == want["predicted_bytes"] and got["quant"] == want["quant"] == "int8"
    back = t.swap("tiny")
    assert back["bytes_moved"] == got["predicted_bytes"] == j.swap("tiny")["bytes_moved"]
    assert back["costs"]["bytes_error_ratio"] == 0.0
    trecs, jrecs = t.actuations_view()["records"], j.actuations_view()["records"]
    assert [_strip(r) for r in trecs] == [_strip(r) for r in jrecs]
    summary = t.actuations_view()["summary"]
    assert summary["byte_exact_frac"] == 1.0 and summary["by_kind"] == {"coldload": 1, "sleep": 1, "wake": 1, "swap": 2}
    assert t.stats()["costs"]["prediction"]["recorded_total"] == 5


def test_a_failed_swap_is_recorded_as_the_reference_records_it(services):
    t, j = services
    t.swap("tiny-gemma")
    j.swap("tiny-gemma")
    faults.arm("swap.h2d", mode="fail", count=1)
    jfaults.arm("swap.h2d", mode="fail", count=1)
    with pytest.raises(tserver.SwapRolledBack):
        t.swap("tiny")
    with pytest.raises(Exception):
        j.swap("tiny")
    got, want = t.actuations_view(n=1, kind="swap")["records"][0], j.actuations_view(n=1, kind="swap")["records"][0]
    assert got["outcome"] == want["outcome"] == "rolled_back" and _strip(got) == _strip(want)
    n = len(t.actuations_view()["records"])
    with pytest.raises(ValueError):
        t.swap("no-such-model")
    assert len(t.actuations_view()["records"]) == n  # a refusal moved nothing
    t.swap("tiny")
    j.swap("tiny")


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_the_routes_answer_with_the_reference_keys(services):
    t, j = services
    server = tserver.serve(t, "127.0.0.1", 0)
    try:
        port = server.server_address[1]
        status, costs = _get(port, "/v1/costs?model=tiny-gemma")
        assert status == 200 and set(costs) == set(j.costs_view())
        assert {c["model"] for c in costs["candidates"]} >= {"tiny", "tiny-gemma"}
        status, acts = _get(port, "/v1/actuations?n=2&kind=swap")
        assert status == 200 and set(acts) == {"records", "summary"} and len(acts["records"]) == 2
        assert all(r["kind"] == "swap" for r in acts["records"])
        assert set(acts["summary"]) == set(j.actuations_view()["summary"])
        assert _get(port, "/v1/actuations?n=x")[0] == 400
        assert _get(port, "/v1/costs?model=nope")[1]["candidates"][-1]["error"]
    finally:
        server.shutdown()
        server.server_close()


class _HashingJob:
    """A digest job that is still hashing: each join is recorded with the
    thread that made it."""

    seconds, times = 0.0, {}

    def __init__(self):
        self.joined_on = []

    def done(self):
        return False

    def result(self):
        self.joined_on.append(threading.current_thread().name)
        return {}


def test_costs_never_join_a_running_digest_job_on_the_engine_thread():
    """A pool-tier row priced on the engine thread while a digest job
    runs is priced without the delta and marked ``digest_pending``, the
    job left running; ``costs_report`` joins the jobs on its caller's
    thread first, so the engine loop never waits on hashing."""
    t = tserver.EngineService(tserver.parse_engine_options(f"--model tiny {OPTS} --device cpu --sleep-quant int8"))
    try:
        t.swap("tiny-gemma")
        full = _row(t.costs_report(), "tiny")
        t._on_loop(lambda: setattr(t, "_content_hash", True))
        jobs = [_HashingJob(), _HashingJob()]
        t._runtime.digest_job, t.model_pool.peek_match("tiny").runtime.digest_job = jobs
        row = _row(t._on_loop(t.costs_view), "tiny")
        assert row["tier"] == "pool" and row["digest_pending"] is True
        assert row["predicted_bytes"] == full["predicted_bytes"] and "digest_pending" not in full
        assert [j.joined_on for j in jobs] == [[], []]
        row = _row(t.costs_report(), "tiny")
        me = threading.current_thread().name
        assert [j.joined_on for j in jobs] == [[me], [me]] and "digest_pending" not in row
        assert t._runtime.digest_job is None and row["predicted_bytes"] == full["predicted_bytes"]
    finally:
        t.shutdown()


def test_the_launcher_lifts_each_child_costs_into_its_ledger(tmp_path, monkeypatch):
    """The reference's ``ledger.costs``: each reporting child's
    ``/v1/stats`` costs block, keyed by instance, only in a detailed
    read."""
    row = {"bandwidth_gibps": {"swap.d2h": {"gibps": 1.5, "samples": 3}},
           "prediction": {"recorded_total": 4, "byte_exact_frac": 1.0}}
    out = {}
    for impl, mgr, chip, inst in (("port", pmgr, pchip, pinst), ("jax", jmgr, jchip, jinst)):
        kw = {} if impl == "port" else {"enforce_chip_exclusivity": False}
        m = mgr.EngineProcessManager(
            chip.ChipTranslator.create(mock_chips=True, mock_chip_count=4, mock_topology="2x2"),
            log_dir=str(tmp_path / impl), kickoff=fake_kickoff, **kw,
        )
        try:
            for iid in ("c-a", "c-down"):
                m.create_instance(inst.InstanceConfig(options="--model tiny", chip_ids=None), instance_id=iid)

            def poll(iid, timeout, _mgr=mgr):
                if iid == "c-down":
                    raise _mgr.StatsFailed(iid, 502, "engine unreachable")
                return {"model": "tiny", "queue_depth": 0, "slo": {}, "costs": row, "uptime_s": 10.0}

            monkeypatch.setattr(m, "_poll_instance_stats", poll)
            out[impl] = (m.get_all_instances_status(include_fleet=True), m.get_all_instances_status())
        finally:
            m.stop_all_instances(timeout=2)
    for impl in out:
        detailed, plain = out[impl]
        assert detailed["ledger"]["costs"] == {"c-a": row}
        assert detailed["fleet"]["per_instance"]["c-a"]["costs"] == row
        assert "costs" not in plain["ledger"]


@pytest.mark.e2e
def test_a_quantized_swap_through_the_launcher_shows_in_its_ledger(tmp_path):
    """End to end on the CPU: a launcher process forks a tiny engine with
    ``--sleep-quant int8``; its swap verb answers the child's quantized
    swap, after which the detailed instance list's ledger holds the
    holder's ``quant`` (int8) and the child's ``costs`` summary with the
    swap recorded byte-exact."""
    from tests.test_torch_launcher_e2e import call, start_launcher, tiny_options, wait_ok
    from tests.conftest import free_port

    proc, base = start_launcher(tmp_path)
    try:
        port = free_port()
        opts = tiny_options(port) + " --sleep-quant int8 --model-pool-mib 64"
        status, body = call(base + "/v2/vllm/instances/q", "PUT", {"options": opts, "gpu_uuids": ["tpu-mock-0-0"]})
        assert status == 201, body
        wait_ok(f"http://127.0.0.1:{port}/health")
        status, body = call(base + "/v2/vllm/instances/q/swap", "POST", {"model": "tiny-gemma"}, timeout=120)
        assert status == 200, body
        swap = json.loads(body)["swap"]
        assert swap["quant"] == "int8" and swap["tier"] == "cold" and swap["costs"]["bytes_error_ratio"] == 0.0
        ledger = json.loads(call(base + "/v2/vllm/instances")[1])["ledger"]
        assert ledger["quant"] == {"q": "int8"}
        prediction = ledger["costs"]["q"]["prediction"]
        assert prediction["by_kind"] == {"coldload": 1, "swap": 1} and prediction["byte_exact_frac"] == 1.0
        call(base + "/v2/vllm/instances/q", "DELETE", timeout=30)
    finally:
        proc.terminate()
        proc.wait(timeout=30)

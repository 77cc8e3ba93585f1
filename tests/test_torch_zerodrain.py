"""Zero-drain actuation in the port (``--zero-drain``, ``engine/parked.py``),
held against the JAX package's ``tests/test_zerodrain.py`` case by case.

Engine level: the greedy park-and-resume streams are held against the JAX
engine's own ``park_requests``/``resume_parked`` run on the same fp32
weights (``models/convert.py``), and against an uninterrupted run; seeded
streams are held bit-exact within the port (each package draws its own
random stream). Service level: a swap and a level-1 sleep under live load
abort nothing, the parked streams finish bit-exact, the fault drills end
as the reference's do, the oracle prices the parked KV exactly, and
``--zero-drain off`` keeps the abort path, its ``/v1/stats.zero_drain``
block the one the JAX service returns.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu.utils import faults as jfaults
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.utils import faults
from llm_d_fast_model_actuation_tpu_torch.utils.prom import exposition

# ------------------------------------------------------------ engine level


def _cfg(**kw):
    jm = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    base = dict(max_batch=2, page_size=8, num_pages=32, max_seq_len=64, decode_chunk=2)
    base.update(kw)
    return jengine.EngineConfig(model=jm, **base), tengine.EngineConfig(model=config_from_jax(jm), **base)


def _engines(**kw):
    """A JAX engine and a port engine on the same fp32 weights; a second
    port engine on them for the uninterrupted run."""
    jcfg, tcfg = _cfg(**kw)
    jeng = jengine.InferenceEngine(jcfg, seed=0)
    state = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    return jeng, tengine.InferenceEngine(tcfg, params=state, device="cpu"), \
        tengine.InferenceEngine(tcfg, params=state, device="cpu")


def _drain(eng, results):
    while eng.has_work():
        for r in eng.step():
            results[r.seq_id] = r


def _interrupt_cycle(eng, steps: int):
    """Step ``steps`` times, then park, rebuild the pool and resume: the
    engine-level skeleton of a swap away and back."""
    results = {}
    for _ in range(steps):
        if not eng.has_work():
            break
        for r in eng.step():
            results[r.seq_id] = r
    bundle, finished = eng.park_requests()
    for r in finished:
        results[r.seq_id] = r
    assert eng.kv_detached and not eng.has_work()
    eng.rebuild_kv_pool()
    eng.resume_parked(bundle)
    _drain(eng, results)
    return results


def test_park_resume_mid_decode_bit_exact():
    jeng, teng, gold_eng = _engines()
    gold = gold_eng.generate([[1, 2, 3, 4, 5]], max_new_tokens=12)[0]
    jid = jeng.add_request([1, 2, 3, 4, 5], max_new_tokens=12)
    tid = teng.add_request([1, 2, 3, 4, 5], max_new_tokens=12)
    jres = _interrupt_cycle(jeng, steps=2)
    tres = _interrupt_cycle(teng, steps=2)
    assert tres[tid].out_tokens == gold == jres[jid].out_tokens


def test_park_resume_penalties_bias_stop_seeded():
    """The whole sampling state: penalties (the parked counts row, which a
    stripped stop sequence makes unrecomputable), logit bias, a stop
    sequence and a seeded temperature > 0 stream (the parked generator
    state). Resumed == uninterrupted, the finish reason included."""
    kw = dict(max_new_tokens=14, temperature=0.8, seed=1234, top_p=0.9, presence_penalty=0.7,
              frequency_penalty=0.4, logit_bias={7: 4.0, 11: -6.0}, stop_seqs=((9, 9, 9),))
    _, teng, gold_eng = _engines()
    gid = gold_eng.add_request([3, 1, 4, 1, 5], **kw)
    gold = {}
    _drain(gold_eng, gold)
    sid = teng.add_request([3, 1, 4, 1, 5], **kw)
    results = _interrupt_cycle(teng, steps=2)
    assert results[sid].out_tokens == gold[gid].out_tokens
    assert results[sid].out_logprobs == gold[gid].out_logprobs
    assert results[sid].finish_reason == gold[gid].finish_reason


def test_park_resume_packed_mid_prefill():
    """Packed serving: a request parked mid chunked prefill goes back to
    the queue without KV and its prefill runs again, to the uninterrupted
    output (the JAX engine's and the port's)."""
    kw = dict(packed_serving=True, max_prefill_tokens=4)
    prompt = list(range(1, 17))  # 16 tokens: 4 packed segments
    jeng, teng, gold_eng = _engines(**kw)
    gold = gold_eng.generate([prompt], max_new_tokens=6)[0]
    jgold = jeng.generate([prompt], max_new_tokens=6)[0]
    sid = teng.add_request(prompt, max_new_tokens=6)
    results = {}
    for r in teng.step():
        results[r.seq_id] = r
    req = next(r for r in teng._slots if r is not None)
    assert req.prefilling, "expected a park mid-prefill"
    bundle, _ = teng.park_requests()
    assert not bundle.live and len(bundle.waiting) == 1 and bundle.kv_nbytes == 0
    teng.rebuild_kv_pool()
    teng.resume_parked(bundle)
    _drain(teng, results)
    assert results[sid].out_tokens == gold == jgold


def test_park_resume_shared_prefix_pages():
    """Two live requests sharing prefix-cache pages: each shared page is
    paged out once, the resume keeps the sharing, and both streams go on
    bit-exact (against the JAX engine's interrupted run too)."""
    shared = list(range(1, 10))  # more than one page of shared prefix
    p1, p2 = shared + [21], shared + [22]
    jeng, teng, gold_eng = _engines()
    gold = gold_eng.generate([p1, p2], max_new_tokens=10)
    ids = [teng.add_request(p, max_new_tokens=10) for p in (p1, p2)]
    jids = [jeng.add_request(p, max_new_tokens=10) for p in (p1, p2)]
    tres = _interrupt_cycle(teng, steps=3)
    jres = _interrupt_cycle(jeng, steps=3)
    assert [tres[i].out_tokens for i in ids] == gold == [jres[i].out_tokens for i in jids]


def test_park_gather_failure_leaves_engine_serving():
    """A ``kvsave.d2h`` failure mid page-out leaves the engine untouched
    (the gather runs before any detach): the request decodes on to its
    normal end."""
    _, teng, gold_eng = _engines()
    gold = gold_eng.generate([[5, 6, 7]], max_new_tokens=8)[0]
    sid = teng.add_request([5, 6, 7], max_new_tokens=8)
    results = {}
    for r in teng.step():
        results[r.seq_id] = r
    faults.arm("kvsave.d2h", mode="fail", count=1)
    try:
        with pytest.raises(faults.FaultError):
            teng.park_requests()
    finally:
        faults.reset()
    assert not teng.kv_detached and teng.has_work()
    _drain(teng, results)
    assert results[sid].out_tokens == gold


# ----------------------------------------------------------- service level


BASE_OPTS = "--model tiny --num-pages 32 --page-size 16 --max-batch 2 --max-model-len 64 --swap-bucket-mib 1 "
PORT_OPTS = BASE_OPTS + "--device cpu "


def _service(extra: str = "--zero-drain on") -> tserver.EngineService:
    return tserver.EngineService(tserver.parse_engine_options(PORT_OPTS + extra))


@pytest.fixture
def zd_service():
    svc = _service()
    yield svc
    faults.reset()
    svc.shutdown()


def _slow_stream(seen, delay=0.03):
    def cb(req, tok):
        seen.append(tok)
        time.sleep(delay)

    return cb


def _live_request(svc, prompt=(1, 2, 3, 4), max_tokens=24, min_tokens=3):
    """A throttled greedy request, waited for until it is mid-decode (the
    throttle keeps it live while the verb waits for the step's end)."""
    seen: list = []
    fut = svc.submit(prompt=list(prompt), max_new_tokens=max_tokens, on_token=_slow_stream(seen))
    deadline = time.time() + 60
    while len(seen) < min_tokens and time.time() < deadline:
        time.sleep(0.005)
    assert len(seen) >= min_tokens, "request never started decoding"
    return fut


def _gold(svc, prompt=(1, 2, 3, 4), max_tokens=24):
    return svc.submit(prompt=list(prompt), max_new_tokens=max_tokens).result(timeout=120).out_tokens


def test_flag_validation():
    """The reference refuses multi-host gangs; the port has none, and
    refuses a tensor-parallel mesh instead, as it refuses a swap there."""
    tserver.parse_engine_options("--model tiny --zero-drain on")
    tserver.parse_engine_options("--model tiny --zero-drain off")
    with pytest.raises(ValueError, match="item 14"):
        tserver.parse_engine_options("--model tiny --zero-drain on --tensor-parallel-size 2 --device cpu,cpu")


def test_swap_preempts_and_resumes_bit_exact(zd_service):
    svc = zd_service
    gold = _gold(svc)
    fut = _live_request(svc)
    out = svc.swap("tiny-gemma")
    zd = out["zero_drain"]
    assert zd["parked"] >= 1 and zd["kv_pageout_bytes"] > 0
    assert out["kv_pageout_bytes"] == zd["kv_pageout_bytes"]
    assert not fut.done(), "a preempted stream stays open, it does not abort"
    st = svc.stats()
    assert "swap" not in st["aborted"]
    assert st["zero_drain"]["preempted"] >= 1
    assert st["zero_drain"]["parked_kv_bytes"] == zd["kv_pageout_bytes"]
    # the other model serves while the stream is parked
    assert len(svc.submit(prompt=[9, 8, 7], max_new_tokens=4).result(120).out_tokens) == 4
    back = svc.swap("tiny")
    assert back["zero_drain"]["resumed"] >= 1
    assert back["zero_drain"]["kv_pagein_bytes"] > 0 and back["kv_pagein_bytes"] == back["zero_drain"]["kv_pagein_bytes"]
    assert fut.result(timeout=120).out_tokens == gold, "the resumed stream is bit-exact"
    st = svc.stats()
    assert st["zero_drain"]["resumed"] >= 1 and st["zero_drain"]["parked_kv_bytes"] == 0
    recs = svc.actuations_view(kind="swap")["records"]
    assert any((r.get("extra") or {}).get("preempted", 0) >= 1 for r in recs)
    assert any((r.get("extra") or {}).get("resumed", 0) >= 1 for r in recs)
    text = exposition()
    assert "fma_engine_preempted_requests_total{" in text and 'outcome="resumed"' in text
    assert 'fma_engine_kv_pageout_bytes_total{dir="d2h"}' in text
    assert 'fma_engine_kv_pageout_bytes_total{dir="h2d"}' in text


def test_preempting_swap_predicted_bytes_exact(zd_service):
    """With the parked KV counted, the predicted bytes equal the moved
    bytes on the preempting swap and on the resuming swap back (page size
    16 and a short request keep the live page count still between the
    price and the park)."""
    svc = zd_service
    svc.swap("tiny-gemma")  # both models pooled: both directions pool hits
    svc.swap("tiny")
    fut = _live_request(svc, max_tokens=8)
    out = svc.swap("tiny-gemma")
    rec = out["costs"]
    assert out["zero_drain"]["parked"] >= 1
    assert rec["predicted_bytes"] == rec["actual_bytes"], rec
    assert rec["bytes_error_ratio"] == 0.0
    back = svc.swap("tiny")
    rec2 = back["costs"]
    assert back["zero_drain"]["resumed"] >= 1
    assert rec2["predicted_bytes"] == rec2["actual_bytes"], rec2
    fut.result(timeout=120)
    summary = svc.stats()["costs"]["prediction"]
    assert summary["byte_exact_frac"] == 1.0, summary


def test_sleep_wake_park_resume_bit_exact(zd_service):
    svc = zd_service
    gold = _gold(svc)
    fut = _live_request(svc)
    pred = svc.price_sleep()
    out = svc.sleep(1)
    assert svc._runtime.parked is not None
    assert pred["predicted_kv_pageout_bytes"] > 0
    # the weights alone: the pool the park released is not offloaded
    weights = sum(t.numel() * t.element_size() for t in svc.engine.model.parameters())
    assert out["bytes_offloaded"] == weights < svc.price_wake()["predicted_bytes"] + 1
    svc.wake_up()
    assert svc._runtime.parked is None
    assert fut.result(timeout=120).out_tokens == gold
    assert svc.stats()["zero_drain"]["resumed"] >= 1
    for kind in ("sleep", "wake"):
        recs = svc.actuations_view(kind=kind)["records"]
        assert recs and recs[-1]["predicted_bytes"] == recs[-1]["actual_bytes"], recs[-1]


def test_kvrestore_fault_rolls_back_to_clean_state_loss(zd_service):
    """A ``kvrestore.h2d`` failure mid resume ends with the engine
    serving: the preempted request aborts with ``state_loss``, nothing
    wedges, and new traffic flows."""
    svc = zd_service
    fut = _live_request(svc)
    svc.sleep(1)
    assert svc._runtime.parked is not None
    faults.arm("kvrestore.h2d", mode="fail", count=1)
    svc.wake_up()
    with pytest.raises(RuntimeError, match="zero-drain KV restore"):
        fut.result(timeout=60)
    st = svc.stats()
    assert st["aborted"].get("state_loss") == 1
    zd = st["zero_drain"]
    assert zd["aborted"] == 1 and zd["preempted"] == zd["resumed"] + zd["aborted"], zd
    assert svc.failure is None and "state_loss" in (svc.degraded or "")
    # the rolled-back restore moved none of the priced page-in: unpriced
    recs = svc.actuations_view(kind="wake")["records"]
    assert recs and recs[-1]["predicted_bytes"] is None, recs[-1]
    assert len(svc.submit(prompt=[5, 6, 7], max_new_tokens=4).result(120).out_tokens) == 4
    svc.sleep(1)
    svc.wake_up()
    assert len(svc.submit(prompt=[5, 6, 7], max_new_tokens=4).result(120).out_tokens) == 4


def test_kvsave_fault_falls_back_to_abort_path(zd_service):
    """A park that fails mid page-out preempts nothing: the swap takes the
    abort path (cause ``swap``) and still commits, unpriced."""
    svc = zd_service
    fut = _live_request(svc)
    faults.arm("kvsave.d2h", mode="fail", count=1)
    out = svc.swap("tiny-gemma")
    assert out["swapped"] and out["zero_drain"]["parked"] == 0 and "fallback" in out["zero_drain"]
    with pytest.raises(RuntimeError, match="aborted by model swap"):
        fut.result(timeout=60)
    assert svc.stats()["aborted"].get("swap", 0) >= 1
    recs = svc.actuations_view(kind="swap")["records"]
    assert recs and recs[-1]["predicted_bytes"] is None, recs[-1]


def test_l2_escalation_aborts_parked_state_loss(zd_service):
    """A level 1 -> 2 escalation drops the host state a parked bundle would
    resume against: the parked requests abort cleanly (state_loss)."""
    svc = zd_service
    fut = _live_request(svc)
    svc.sleep(1)
    assert svc._runtime.parked is not None
    svc.sleep(2)
    assert svc._runtime.parked is None
    with pytest.raises(RuntimeError, match="level-2 sleep"):
        fut.result(timeout=60)
    assert svc.stats()["aborted"].get("state_loss", 0) >= 1
    svc.wake_up()  # a level-2 wake writes fresh weights; the pool is rebuilt
    assert len(svc.submit(prompt=[5, 6, 7], max_new_tokens=4).result(120).out_tokens) == 4


def test_pool_budget_admission_rejects_park():
    """A park whose bytes cannot fit ``--model-pool-mib`` would be evicted,
    and aborted, at once: it is refused up front and the swap takes the
    abort path."""
    svc = _service("--zero-drain on --model-pool-mib 0")
    try:
        fut = _live_request(svc)
        out = svc.swap("tiny-gemma")
        assert out["swapped"] and out["zero_drain"]["parked"] == 0
        assert "park rejected" in out["zero_drain"]["fallback"]
        with pytest.raises(RuntimeError):
            fut.result(timeout=60)
        assert svc.stats()["aborted"].get("swap", 0) >= 1
    finally:
        svc.shutdown()


def test_zero_drain_off_is_inert():
    """The default keeps the abort path: live work aborts with cause
    ``swap``, the response has no ``zero_drain`` block, and
    ``/v1/stats.zero_drain`` is the block the JAX service returns with the
    feature off, ``migrated`` among its keys. (The JAX package's test of
    this name expects the block without ``migrated``, which its service has
    since gained: that test is red on its own.)"""
    jsvc = jserver.EngineService(jserver.parse_engine_options(BASE_OPTS))
    try:
        want = jsvc.stats()["zero_drain"]
    finally:
        jsvc.shutdown()
    assert want == {"enabled": False, "preempted": 0, "resumed": 0, "aborted": 0, "migrated": 0,
                    "parked_kv_bytes": 0}
    svc = _service("")
    try:
        fut = _live_request(svc)
        out = svc.swap("tiny-gemma")
        assert out["swapped"] and "zero_drain" not in out and "kv_pageout_bytes" not in out
        with pytest.raises(RuntimeError, match="aborted by model swap"):
            fut.result(timeout=60)
        st = svc.stats()
        assert st["aborted"].get("swap", 0) >= 1
        assert st["zero_drain"] == want
    finally:
        svc.shutdown()


def test_parked_model_eviction_aborts_bundle():
    """Evicting a parked model's pool entry resolves its parked futures
    (state_loss); none is left hanging."""
    svc = _service()
    try:
        fut = _live_request(svc)
        svc.swap("tiny-gemma")
        assert not fut.done()
        entry = svc.model_pool.take_match("tiny")
        assert entry is not None and entry.runtime.parked is not None
        svc._free_pooled([entry])
        with pytest.raises(RuntimeError, match="evicted"):
            fut.result(timeout=60)
        st = svc.stats()
        assert st["aborted"].get("state_loss", 0) >= 1 and st["zero_drain"]["aborted"] >= 1
    finally:
        svc.shutdown()


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()

"""The port's engine and sleep manager against the JAX package's.

Both engines run the same converted weights (tiny Llama, float32, so
greedy decoding is off the bf16 near-tie knife edge) on the CPU; the port
is asked for the CPU explicitly. Token streams are compared exactly.
Seeded sampling is held to the port's own contract (the same seed gives
the same stream at any batch position), not to JAX's threefry stream.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.engine import kv_cache as jkv
from llm_d_fast_model_actuation_tpu.engine import sleep as jsleep
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import kv_cache as tkv
from llm_d_fast_model_actuation_tpu_torch.engine import sleep as tsleep
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models.convert import (
    config_from_jax,
    params_from_jax,
)

PROMPTS = [[5, 9, 200, 3, 77], list(range(10, 31)), [42]]


def _cfgs(dtype=jnp.float32, **kw):
    jm = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=dtype)
    base = dict(max_batch=4, page_size=8, num_pages=48, max_seq_len=64, **kw)
    return jengine.EngineConfig(model=jm, **base), tengine.EngineConfig(model=config_from_jax(jm), **base)


def _engines(dtype=jnp.float32, **kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    jeng = jengine.InferenceEngine(jcfg, seed=0)
    state = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    teng = tengine.InferenceEngine(tcfg, params=state, device="cpu")
    return jeng, teng


def _port(**kw):
    jm = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    cfg = tengine.EngineConfig(
        model=config_from_jax(jm), max_batch=4, page_size=8, num_pages=48, max_seq_len=64, **kw
    )
    return tengine.InferenceEngine(cfg, seed=0, device="cpu")


def test_greedy_streams_match_the_jax_engine_and_batch_equals_single():
    jeng, teng = _engines()
    want = jeng.generate(PROMPTS, max_new_tokens=12)
    got = teng.generate(PROMPTS, max_new_tokens=12)
    assert got == want
    assert [teng.generate([p], max_new_tokens=12)[0] for p in PROMPTS] == got


def test_prefix_cache_hit_equals_miss():
    eng = _port()
    shared = list(range(100, 124))  # three full pages
    first = eng.generate([shared + [1, 2]], max_new_tokens=10)[0]
    hit = eng.generate([shared + [1, 2]], max_new_tokens=10)[0]
    assert eng.prefix_cache.stats()["hits"] >= 1
    miss = _port(prefix_caching=False).generate([shared + [1, 2]], max_new_tokens=10)[0]
    assert first == hit == miss


def test_chunked_prefill_equals_whole_prefill():
    whole = _port(prefix_caching=False).generate(PROMPTS[1:2], max_new_tokens=8)
    chunked = _port(prefix_caching=False, max_prefill_tokens=8).generate(PROMPTS[1:2], max_new_tokens=8)
    assert chunked == whole


def _run(eng, reqs):
    ids = [eng.add_request(**r) for r in reqs]
    out = {}
    while eng.has_work():
        for r in eng.step():
            out[r.seq_id] = r.out_tokens
    return [out[i] for i in ids]


def test_seeded_request_is_independent_of_batch_position():
    seeded = dict(prompt=[7, 8, 9], max_new_tokens=10, temperature=0.9, top_p=0.95, seed=1234)
    alone = _run(_port(), [seeded])[0]
    others = [dict(prompt=[1 + i, 2, 3], max_new_tokens=6, temperature=1.0) for i in range(2)]
    behind = _run(_port(), others + [seeded])[2]
    assert alone == behind
    other_seed = _run(_port(), [dict(seeded, seed=99)])[0]
    assert other_seed != alone  # the seed drives the stream


@pytest.mark.parametrize("bucket_bytes", [None, 4096])  # one bucket; many
def test_level1_sleep_mid_generation_resumes_bit_exact(bucket_bytes):
    gold = _port().generate([PROMPTS[0]], max_new_tokens=24)[0]
    eng = _port()
    eng.add_request(PROMPTS[0], max_new_tokens=24)
    eng.step()  # prefill + one decode chunk; still mid-generation
    assert eng.has_work()
    mgr = tsleep.attach_sleep(eng, bucket_bytes=bucket_bytes)
    info = mgr.sleep(1)
    assert info["is_sleeping"] and info["level"] == 1 and eng.asleep
    # the device memory is released; the tensors stay where they were
    assert all(a.mapped_bytes == 0 for a in eng.arenas.values())
    with pytest.raises(tengine.EngineAsleep):
        eng.step()
    mgr.wake_up()
    outs = []
    while eng.has_work():
        outs.extend(eng.step())
    assert outs[0].out_tokens == gold


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_bytes_offloaded_equal_the_jax_sleep_manager(dtype):
    jeng, teng = _engines(dtype)
    cfg, m = teng.cfg, teng.cfg.model
    shape = (m.num_layers, cfg.num_pages, cfg.page_size, m.num_kv_heads, m.head_dim)
    assert teng.pool.nbytes() == tkv.PagePool.estimate_nbytes(*shape, dtype=m.dtype) == (
        jkv.PagePool.estimate_nbytes(*shape, dtype=dtype)
    )
    assert tkv.PagePool.page_nbytes(*shape[:1], *shape[2:], dtype=m.dtype) == (
        jkv.PagePool.page_nbytes(*shape[:1], *shape[2:], dtype=dtype)
    )
    jinfo = jsleep.attach_sleep(jeng).sleep(1)
    tinfo = tsleep.attach_sleep(teng).sleep(1)
    assert tinfo["bytes_offloaded"] == jinfo["bytes_offloaded"] > 0
    assert set(tinfo) == set(jinfo)  # describe() keys


def test_abort_frees_a_waiting_and_a_running_request():
    eng = _port()
    free0 = eng.allocator.available
    running = eng.add_request([1, 2, 3], max_new_tokens=20)
    eng.step()
    waiting = eng.add_request([4, 5], max_new_tokens=4)
    assert eng.abort(waiting) and eng.abort(running)
    assert not eng.abort(12345)
    assert not eng.has_work()
    # prompt pages the prefix cache still indexes are the only ones held
    assert eng.allocator.available + eng.prefix_cache.resident_pages() == free0


def test_level2_wake_reinitializes_and_escalation_drops_host_copy():
    eng = _port()
    fresh = _port().generate([[1, 2]], max_new_tokens=5)[0]
    eng.generate([[3, 4, 5]], max_new_tokens=5)
    mgr = tsleep.attach_sleep(eng)
    mgr.sleep(1)
    assert mgr.stats.bytes_offloaded > 0 and mgr._host is not None
    info = mgr.sleep(2)  # escalate: the host copy goes too
    assert info["level"] == 2 and info["bytes_offloaded"] == 0 and mgr._host is None
    with pytest.raises(ValueError):
        mgr.wake_up()  # level 2 needs a reinit
    eng.abort_all("level-2 sleep discarded state")
    mgr.wake_up(reinit=lambda: tsleep.fresh_state(eng))
    assert not mgr.is_sleeping
    assert eng.generate([[1, 2]], max_new_tokens=5)[0] == fresh
    assert isinstance(eng.model, tllama.Llama) and all(
        p.numel() > 0 for p in eng.model.parameters()
    )


def test_engine_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.InferenceEngine(tcfg)
    from llm_d_fast_model_actuation_tpu_torch.engine import server

    args = server.parse_engine_options("--model tiny")
    assert args.device == "cuda"
    with pytest.raises(RuntimeError):
        server.EngineService(args)


def test_unported_engine_options_are_refused():
    _, tcfg = _cfgs()
    for field in ("speculative_ngram", "pipeline_decode"):
        with pytest.raises(TypeError):
            dataclasses.replace(tcfg, **{field: 1})
    with pytest.raises(ValueError):
        tllama.Llama(dataclasses.replace(tcfg.model, quantization="int8"), "cpu")
    with pytest.raises(ValueError):
        tengine.InferenceEngine(dataclasses.replace(tcfg, attention_impl="flash"), device="cpu")


def test_packed_serving_option_reaches_the_engine():
    from llm_d_fast_model_actuation_tpu_torch.engine import server

    opts = "--model tiny --num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --device cpu"
    args = server.parse_engine_options(opts + " --packed-serving on --token-budget 40 --attention-impl reference")
    svc = server.EngineService(args)
    try:
        cfg = svc.engine.cfg
        assert cfg.packed_serving and cfg.token_budget == 40 and cfg.packed_token_budget == 40
        assert svc.engine.model.cfg.attention_impl == "reference"  # the engine's flag wins
        req = svc.submit(prompt=[1, 2, 3], max_new_tokens=3).result(timeout=60)
        assert len(req.out_tokens) == 3
        assert svc.engine.packed_steps > 0 and svc.engine.cold_prefills == 0
    finally:
        svc.shutdown()
    assert server.parse_engine_options(opts).packed_serving == "off"
    for bad in ("--packed-serving maybe", "--token-budget -1", "--attention-impl flash"):
        with pytest.raises(ValueError):
            server.parse_engine_options(opts + " " + bad)

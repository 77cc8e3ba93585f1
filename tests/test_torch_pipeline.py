"""Pipelined decode (``pipeline_decode``: chunk k+1 dispatched before
chunk k is read) of the port, against its own sequential engine and the
JAX engine, on the CPU.

The reference's four cases (``tests/test_engine.py``) and its tp case
(``tests/test_engine_sharded.py``): a pipelined engine's tokens equal the
sequential engine's, with seeded requests admitted while a chunk is in
flight, host finishes (stop sequences, aborts) deferring their retires,
a level-1 sleep draining the chunk in flight, and no chunk dispatched at
the end-of-batch tail; the greedy tokens and the dispatch counts also
equal the JAX engine's (fp32, the same converted weights). Sampled
streams are compared within the port: each framework draws its own noise.

The card's hazard, stood in on the CPU: a replayed chunk returns its
graph's static outputs, which the next replay overwrites. With stand-in
graphs that do the same, a pipelined engine still emits the sequential
engine's tokens, and without the copy at dispatch it would not.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import graphs as tgraphs
from llm_d_fast_model_actuation_tpu_torch.engine.sleep import attach_sleep
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import serving_mesh

JM = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
BASE = dict(max_batch=4, page_size=8, num_pages=64, max_seq_len=64, decode_chunk=4)


def _jax(pipeline=False, **kw):
    return jengine.InferenceEngine(jengine.EngineConfig(model=JM, pipeline_decode=pipeline, **BASE, **kw), seed=0)


def _port(pipeline=False, params=None, mesh=None, **kw):
    cfg = tengine.EngineConfig(model=config_from_jax(JM), pipeline_decode=pipeline, **BASE, **kw)
    if mesh is not None:
        return tengine.InferenceEngine(cfg, seed=0, mesh=mesh)
    return tengine.InferenceEngine(cfg, params=params, seed=0, device="cpu")


def _weights():
    return params_from_jax(jax.tree.map(np.asarray, _jax().params))


def _pair(**kw):
    """Sequential and pipelined port engines on the JAX engine's weights."""
    state = _weights()
    return _port(False, state, **kw), _port(True, state, **kw)


def _waves(eng, greedy_only=False):
    """The reference's traffic: two greedy prompts, then (unless
    ``greedy_only``) a second wave of seeded sampled ones admitted while
    a chunk is in flight."""
    prompts = [[5, 6, 7], [9, 8], [1, 2, 3, 4], [11]]
    for p in prompts[:2]:
        eng.add_request(p, max_new_tokens=20)
    done = list(eng.step()) + list(eng.step())
    if eng.cfg.pipeline_decode:
        assert eng._inflight is not None  # admission really interleaves
    if not greedy_only:
        for p in prompts[2:]:
            eng.add_request(p, max_new_tokens=9, temperature=0.8, seed=7)
    while eng.has_work():
        done.extend(eng.step())
    return sorted(tuple(r.out_tokens) for r in done)


def test_pipeline_decode_matches_sequential():
    seq, pipe = _pair()
    assert _waves(pipe) == _waves(seq)
    # the greedy wave alone: the JAX engine's tokens, pipelined there too
    _, pipe2 = _pair()
    assert _waves(pipe2, greedy_only=True) == _waves(_jax(True), greedy_only=True)


def test_pipeline_decode_stop_sequences_and_sleep():
    seq, pipe = _pair()
    gold = seq.generate([[3, 1, 4]], max_new_tokens=30)[0]
    assert gold == _jax().generate([[3, 1, 4]], max_new_tokens=30)[0]
    stop = tuple(gold[4:6])

    def run_with_stop(eng):
        eng.add_request([3, 1, 4], max_new_tokens=30, stop_seqs=(stop,))
        done = []
        while eng.has_work():
            done.extend(eng.step())
        return done[0].out_tokens, done[0].finish_reason

    assert run_with_stop(seq) == run_with_stop(pipe) == run_with_stop(_jax(True))
    # a sleep with a chunk dispatched but unread: the drain keeps its tokens
    mgr = attach_sleep(pipe)
    pipe.add_request([3, 1, 4], max_new_tokens=12)
    pipe.step()
    assert pipe._inflight is not None
    mgr.sleep(1)
    assert pipe._inflight is None
    mgr.wake_up()
    done = []
    while pipe.has_work():
        done.extend(pipe.step())
    assert done and done[0].out_tokens == gold[:12]


def test_pipeline_decode_no_wasted_tail_dispatch():
    seq, pipe = _pair()
    jpipe = _jax(True)
    counts = {}
    for name, eng in (("port", pipe), ("jax", jpipe)):
        seen = counts[name] = []
        orig = eng._dispatch_chunk

        def counting(running, seen=seen, orig=orig):
            seen.append(sorted(running))
            return orig(running)

        eng._dispatch_chunk = counting
    prompt = [5, 6, 7]
    # 1 token from the prefill + 4 decoded: exactly one T=4 chunk
    gold = seq.generate([prompt], max_new_tokens=5)[0]
    assert pipe.generate([prompt], max_new_tokens=5)[0] == gold == jpipe.generate([prompt], max_new_tokens=5)[0]
    assert len(counts["port"]) == len(counts["jax"]) == 1
    counts["port"].clear()
    counts["jax"].clear()
    out = pipe.generate([prompt], max_new_tokens=9)[0]
    assert out == seq.generate([prompt], max_new_tokens=9)[0] == jpipe.generate([prompt], max_new_tokens=9)[0]
    assert len(counts["port"]) == len(counts["jax"]) == 2


def test_pipeline_decode_abort_mid_flight():
    _, pipe = _pair()
    free0 = pipe.allocator.available
    sid = pipe.add_request([5, 6, 7], max_new_tokens=40)
    pipe.step()  # prefill + dispatch
    assert pipe._inflight is not None
    assert pipe.abort(sid)
    assert pipe._pending_retire  # deferred, not freed mid-flight
    assert not pipe.abort(sid)  # a second abort does not retire it twice
    while pipe.has_work():
        pipe.step()
    assert pipe._pending_retire == []
    if pipe.prefix_cache is not None:
        pipe.allocator.free(pipe.prefix_cache.clear())
    assert pipe.allocator.available == free0


def test_pipeline_decode_park_mid_flight_loses_no_token():
    """A zero-drain park with a chunk in flight reads it first: the
    bundle's request resumes at the drained position and finishes with the
    sequential tokens."""
    seq, pipe = _pair()
    gold = seq.generate([[3, 1, 4]], max_new_tokens=14)[0]
    pipe.add_request([3, 1, 4], max_new_tokens=14)
    pipe.step()
    assert pipe._inflight is not None
    bundle, finished = pipe.park_requests()
    assert pipe._inflight is None and finished == [] and len(bundle.live) == 1
    assert len(bundle.live[0].req.out_tokens) == 1 + BASE["decode_chunk"]
    pipe.rebuild_kv_pool()
    pipe.resume_parked(bundle)
    done = []
    while pipe.has_work():
        done.extend(pipe.step())
    assert done[0].out_tokens == gold


def test_pipeline_decode_matches_on_tp_mesh():
    prompts = [[5, 6, 7, 8], [2, 4]]
    gold = _port(False).generate(prompts, max_new_tokens=12)
    got = _port(True, mesh=serving_mesh(2, ["cpu", "cpu"])).generate(prompts, max_new_tokens=12)
    assert got == gold


class _StaticGraph:
    """A captured chunk as the card has it: every replay writes its
    results into the same static output tensors."""

    def __init__(self, eng, T, sampled):
        self.eng, self.T, self.sampled = eng, T, sampled
        self.outputs = eng.chunk_body(T, sampled)

    def replay(self):
        new = self.eng.chunk_body(self.T, self.sampled)
        for dst, src in zip(self.outputs[:2] + self.outputs[2], new[:2] + new[2]):
            dst.copy_(src)


@pytest.fixture
def static_graphs(monkeypatch):
    def capture(self, T, sampled):
        g = _StaticGraph(self.engine, T, sampled)
        self.engine.graph_captures += 1
        return tgraphs.Program(g, T, {}, g.outputs)

    monkeypatch.setattr(tgraphs.ChunkGraphs, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tgraphs, "release_cached_memory", lambda device: None)
    made = []

    def with_graphs(eng):
        eng.graphs = tgraphs.ChunkGraphs(eng)
        eng.graphs.capture()
        made.append(eng.graphs)
        return eng

    yield with_graphs
    for g in made:
        tgraphs._holders.discard(g)


def test_pipelined_replays_of_static_outputs_emit_the_sequential_tokens(static_graphs, monkeypatch):
    reqs = [dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=17), dict(prompt=[9, 2, 6], max_new_tokens=11),
            dict(prompt=[5, 3], max_new_tokens=13, temperature=0.8, seed=3, want_top_logprobs=True)]

    def run(eng):
        ids = [eng.add_request(**r) for r in reqs]
        done = {}
        while eng.has_work():
            for r in eng.step():
                done[r.seq_id] = r
        return [(done[i].out_tokens, done[i].out_logprobs, done[i].out_top_logprobs) for i in ids]

    seq, pipe = _pair()
    want = run(static_graphs(seq))
    pipe = static_graphs(pipe)
    assert run(pipe) == want
    assert pipe.graph_replays == pipe.decode_chunks > 2
    # the hazard is real: read at the drain without the dispatch's copy,
    # chunk k's outputs are chunk k+1's
    _, bare = _pair()
    bare = static_graphs(bare)
    monkeypatch.setattr(bare, "_stage_outputs", lambda toks, lps, alts: (toks, lps, alts, None))
    assert run(bare) != want

"""The port's graph pool and warm-up (``engine/exec_pool.py``), mirroring
the reference's ``tests/test_exec_pool.py`` by meaning: the reference
pools compiled executables by config, the port pools a pooled engine's
captured chunk graphs under a card budget.

* Keys: ``exec_key`` per owner (a graph holds its own engine's
  addresses), program and bucket; the warm-up's plan.
* The pool: LRU under the budget (an evicted entry's graphs released), a
  same-key refresh is not an eviction, budget 0 releases what it is
  given, ``drop_live``, and its entries never leave the process (no file
  is written: a captured graph cannot be serialized, so there is no
  spill).
* The warm-up: its plan run on the building thread; the flags' checks.
* Through the service on the CPU, with stand-in graphs (a CPU engine
  captures none; the stand-in reruns the chunk's body into its outputs,
  as ``tests/test_torch_graphs.py`` does): a pool-hit swap whose graphs
  were kept captures nothing, and an engine whose graphs the budget
  released captures its four again at its swap-in and gives the same
  greedy tokens, bit for bit.
"""

import builtins
import contextlib
import os
import threading

import pytest
import torch
from test_torch_graphs import _RerunGraph

from llm_d_fast_model_actuation_tpu_torch.engine import exec_pool as texec
from llm_d_fast_model_actuation_tpu_torch.engine import graphs as tgraphs
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from llm_d_fast_model_actuation_tpu_torch.engine.sleep import SwapRolledBack
from llm_d_fast_model_actuation_tpu_torch.models import llama
from tests.conftest import build_tiny_hf_model_dir

MIB = 1 << 20


def tiny_cfg(**kw):
    base = dict(model=llama.LlamaConfig.tiny(), max_batch=2, page_size=8, num_pages=32, max_seq_len=64)
    base.update(kw)
    return EngineConfig(**base)


class Graphs:
    """A stand-in graph set: counts its releases."""

    def __init__(self) -> None:
        self.released = 0

    def release(self) -> None:
        self.released += 1


# -- identity -----------------------------------------------------------------


def test_exec_key_varies_by_owner_program_and_bucket():
    keys = {texec.exec_key(owner, p, b) for owner in ("hf:/a", "hf:/b")
            for p in ("chunk", "chunk_sampled", "prefill") for b in (1, 8, 16)}
    assert len(keys) == 18  # two engines of one config never share graphs: the owner is the key's


def test_warmup_plan_buckets_round_up_and_dedupe():
    eng = InferenceEngine(tiny_cfg(), device="cpu")
    assert texec.warmup_plan(eng, (3, 16, 17)) == [("prefill", 16), ("prefill", 32)]
    assert texec.warmup_plan(eng, ()) == []
    eng.graphs = tgraphs.ChunkGraphs(eng)  # as on one card
    plan = texec.warmup_plan(eng, (3,))
    assert plan == [("chunk", 8), ("chunk_sampled", 8), ("chunk", 1), ("chunk_sampled", 1), ("prefill", 16)]
    packed = InferenceEngine(tiny_cfg(packed_serving=True), device="cpu")
    assert texec.warmup_plan(packed, (3, 64)) == []  # the packed path runs no bucketed prefill


# -- LRU / budget -------------------------------------------------------------


def test_pool_lru_eviction_under_budget():
    pool = texec.ExecutablePool(budget_bytes=100)
    a, b, c = Graphs(), Graphs(), Graphs()
    assert pool.put("a", a, nbytes=40) == [] and pool.put("b", b, nbytes=40) == []
    assert pool.put("a", a, nbytes=40) == []  # a pooled again: b is the least recently used
    evicted = pool.put("c", c, nbytes=40)
    assert [e.key for e in evicted] == ["b"] and b.released == 1 and not (a.released or c.released)
    assert "a" in pool and "c" in pool and "b" not in pool
    assert pool.take("b") is None
    assert (pool.hits, pool.misses, pool.evictions) == (0, 1, 1)
    # a set alone over the budget bounces itself, not the residents
    huge = Graphs()
    assert [e.key for e in pool.put("huge", huge, nbytes=1000)] == ["huge"] and huge.released == 1
    assert "a" in pool and "c" in pool and pool.bytes_used == 80 <= pool.budget_bytes
    # a pooled engine that serves again leaves with its graphs
    assert pool.take("a") is a and pool.take("a") is None and a.released == 0
    assert (pool.hits, pool.misses) == (1, 2)
    pool.discard("c")
    assert len(pool) == 0 and c.released == 0


def test_pool_same_key_refresh_is_not_an_eviction():
    pool = texec.ExecutablePool(budget_bytes=100)
    g = Graphs()
    pool.put("a", g, nbytes=40)
    assert pool.put("a", g, nbytes=50) == []
    assert pool.evictions == 0 and g.released == 0 and pool.bytes_used == 50


def test_pool_budget_zero_disables_pooling():
    pool = texec.ExecutablePool(budget_bytes=0)
    g = Graphs()
    assert [e.key for e in pool.put("a", g, nbytes=1)] == ["a"]
    assert g.released == 1 and "a" not in pool and pool.take("a") is None
    assert pool.evictions == 0  # a disabled pool is not budget pressure


def test_pool_drop_live_counts_evictions():
    pool = texec.ExecutablePool(budget_bytes=100)
    sets = [Graphs() for _ in range(2)]
    for i, g in enumerate(sets):
        pool.put(str(i), g, nbytes=10)
    assert pool.drop_live() == 2 and pool.evictions == 2 and len(pool) == 0
    assert [g.released for g in sets] == [1, 1]


def test_pool_entries_never_leave_the_process(tmp_path, monkeypatch):
    """A captured graph holds one process's device addresses: the pool
    writes nothing anywhere (no spill), whatever its traffic."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FMA_EXEC_SPILL_DIR", str(tmp_path / "spill"))

    def no_file(*a, **kw):
        raise AssertionError(f"the exec pool opened a file: {a}")

    monkeypatch.setattr(builtins, "open", no_file)
    monkeypatch.setattr(os, "replace", no_file)
    pool = texec.ExecutablePool(budget_bytes=100)
    for i in range(5):
        pool.put(f"k{i}", Graphs(), nbytes=30)
        pool.take(f"k{i - 1}")
    pool.drop_live()
    desc = pool.describe()
    monkeypatch.undo()
    assert (desc["spill_dir"], desc["spill_hits"], desc["spill_errors"]) == ("", 0, 0)
    assert os.listdir(tmp_path) == []
    pool.note_compile(1.5)
    pool.note_compile(0.5)
    assert pool.describe()["compiles_total"] == 2 and pool.describe()["mean_compile_s"] == 1.0


# -- the warm-up task ---------------------------------------------------------


def test_warm_up_runs_its_plan_on_the_calling_thread(monkeypatch):
    """The prefill buckets run once each, in order, on the thread that
    builds; with nothing to warm nothing runs."""
    eng = InferenceEngine(tiny_cfg(), device="cpu")
    ran = []

    def prefill(self, bucket):
        ran.append((bucket, threading.current_thread().name))

    monkeypatch.setattr(InferenceEngine, "warm_prefill", prefill)
    stats = texec.warm_up(eng, (1, 20, 3, 64))
    me = threading.current_thread().name
    assert ran == [(16, me), (32, me), (64, me)]  # rounded up to the buckets, 64 the cap
    assert stats["programs"] == stats["compiled"] == 3 and stats["capture_s"] == 0 and stats["compile_s"] >= 0
    ran.clear()
    idle = texec.warm_up(eng, ())
    assert (idle["programs"], idle["compiled"], idle["capture_s"]) == (0, 0, 0.0) and not ran


def test_a_warmup_that_fails_fails_the_build(monkeypatch):
    def broken(self, bucket):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(InferenceEngine, "warm_prefill", broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        InferenceEngine(tiny_cfg(), device="cpu", warmup_buckets=(16,))


def test_exec_pool_flags_validated():
    for bad in ("--exec-pool-mib -1", "--warmup-buckets 16,zap", "--warmup-buckets 0", "--load-workers -1",
                "--load-inflight-mib 0", "--prefetch-mib-s -1"):
        with pytest.raises(ValueError):
            tserver.parse_engine_options(f"--model tiny {bad}")
    args = tserver.parse_engine_options("--model tiny --warmup-buckets 16,128 --exec-pool-mib 0")
    assert texec.parse_warmup_buckets(args.warmup_buckets) == (16, 128) and args.exec_pool_mib == 0


# -- through the service, with stand-in graphs --------------------------------


GRAPH_POOL_BYTES = 40 * MIB
OPTS = "--num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0 --swap-bucket-mib 1 --device cpu"


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """Every engine gets chunk graphs, as on one card; a capture runs the
    chunk eagerly (the warm-up) and is a stand-in that reruns the chunk's
    body into its outputs on a replay, and each set's memory pool counts
    ``GRAPH_POOL_BYTES``."""
    built = []
    real_build = InferenceEngine._build

    def build(self, params, buckets):
        self.graphs = tgraphs.ChunkGraphs(self)
        built.append(self)
        real_build(self, params, buckets)

    def capture(self, T, sampled):
        self.engine.chunk_eager(T, sampled)  # the warm-up, as on the card
        g = _RerunGraph(self.engine, T, sampled)
        self.engine.graph_captures += 1
        return tgraphs.Program(g, T, {}, g.outputs)

    monkeypatch.setattr(InferenceEngine, "_build", build)
    monkeypatch.setattr(tgraphs.ChunkGraphs, "_capture", capture)
    monkeypatch.setattr(tgraphs.ChunkGraphs, "pool_bytes", lambda self: GRAPH_POOL_BYTES if self.programs else 0)
    monkeypatch.setattr(tgraphs, "release_cached_memory", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    yield built
    for eng in built:
        if eng.graphs is not None:
            tgraphs._holders.discard(eng.graphs)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return [build_tiny_hf_model_dir(str(tmp_path_factory.mktemp("hf") / n), num_hidden_layers=n_layers)
            for n, n_layers in (("a", 2), ("b", 3), ("c", 1))]


def _gen(svc) -> list:
    return svc.submit(prompt=[1, 2, 3], max_new_tokens=6).result(timeout=120).out_tokens


def test_a_released_engine_recaptures_its_four_graphs_and_a_kept_one_none(stand_in_graphs, dirs):
    """--exec-pool-mib 64 holds one pooled set of 40 MiB: A -> B (A
    pooled) -> A (a pool hit: its graphs kept, nothing captured) -> C (B
    and A pooled: B's graphs released) -> B (captured again: four more,
    the same tokens)."""
    a, b, c = (f"hf:{d}" for d in dirs)
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model {a} {OPTS} --exec-pool-mib 64"))
    try:
        eng_a = svc.engine
        assert eng_a.graph_captures == 4 and eng_a.graphs.captured
        assert eng_a.warmup_stats["compiled"] == 4 and eng_a.warmup_stats["capture_s"] > 0
        gold = {a: _gen(svc)}
        out = svc.swap(b)
        assert out["tier"] == "cold" and out["warmup"]["compiled"] == 4 and out["warmup"]["capture_s"] > 0
        eng_b = svc.engine
        gold[b] = _gen(svc)
        assert svc.exec_pool.describe()["bytes_used"] == GRAPH_POOL_BYTES
        out = svc.swap(a)
        assert out["tier"] == "pool" and out["graphs_kept"] and out["recapture_s"] == 0
        assert eng_a.graph_captures == 4 and _gen(svc) == gold[a]
        out = svc.swap(c)  # pools A beside B: over 64 MiB, B's graphs go
        assert out["exec_pool"]["evictions"] == 1 and out["exec_pool"]["bytes_used"] == GRAPH_POOL_BYTES <= 64 * MIB
        assert not eng_b.graphs.captured and eng_a.graphs.captured
        shares = {p["model"]: p["graph_pool_bytes"] for p in svc.pooled_engines()}
        assert shares == {b: 0, a: GRAPH_POOL_BYTES}
        out = svc.swap(b)
        assert out["tier"] == "pool" and not out["graphs_kept"] and out["recapture_s"] > 0
        assert eng_b.graph_captures == 8 and eng_b.graphs.captured
        assert _gen(svc) == gold[b]
        assert eng_b.graph_replays > 0 and eng_b.decode_chunks == eng_b.graph_replays
    finally:
        svc.shutdown()


def test_exec_pool_zero_releases_every_pooled_engines_graphs(stand_in_graphs, dirs):
    a, b, _ = (f"hf:{d}" for d in dirs)
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model {a} {OPTS} --exec-pool-mib 0"))
    try:
        eng_a = svc.engine
        gold = _gen(svc)
        svc.swap(b)
        assert not eng_a.graphs.captured and len(svc.exec_pool) == 0
        out = svc.swap(a)
        assert not out["graphs_kept"] and eng_a.graph_captures == 8 and _gen(svc) == gold
    finally:
        svc.shutdown()


def test_a_build_failure_captures_nothing(stand_in_graphs, dirs, monkeypatch):
    """A cold swap whose load fails never reaches its warm-up, rolls
    back, and the outgoing model serves on."""
    a, b, _ = (f"hf:{d}" for d in dirs)
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model {a} {OPTS}"))
    try:
        gold = _gen(svc)
        warmed = []
        real = texec.warm_up

        def spy(engine, buckets=()):
            warmed.append(engine)
            return real(engine, buckets)

        def failing_load(*args, **kw):
            raise OSError("the checkpoint went away")

        monkeypatch.setattr(texec, "warm_up", spy)
        monkeypatch.setattr(tserver.hf_models, "load_params", failing_load)
        with pytest.raises(OSError, match="went away"):
            svc.swap(b)
        assert warmed == [] and len(stand_in_graphs) == 2 and stand_in_graphs[1].graph_captures == 0
        assert svc.failure is None and svc.degraded and svc.model == a and _gen(svc) == gold
    finally:
        svc.shutdown()


def test_a_recapture_that_fails_swaps_back(stand_in_graphs, dirs, monkeypatch):
    """A's graphs released (--exec-pool-mib 0), then its re-capture at the
    swap back to it fails half-way: the swap rolls back (B serving its own
    tokens, the service DEGRADED, not failed), A is pooled again with no
    graph left captured, and the next swap to A captures and serves."""
    a, b, _ = (f"hf:{d}" for d in dirs)
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model {a} {OPTS} --exec-pool-mib 0"))
    try:
        eng_a = svc.engine
        gold = {a: _gen(svc)}
        svc.swap(b)
        eng_b = svc.engine
        gold[b] = _gen(svc)
        real, calls = tgraphs.ChunkGraphs._capture, []

        def flaky(self, T, sampled):
            if self.engine is eng_a:
                calls.append(T)
                if len(calls) == 2:
                    raise RuntimeError("out of memory in the graph pool")
            return real(self, T, sampled)

        monkeypatch.setattr(tgraphs.ChunkGraphs, "_capture", flaky)
        with pytest.raises(SwapRolledBack, match="re-capture failed"):
            svc.swap(a)
        assert svc.engine is eng_b and svc.model == b and svc.failure is None and "re-capture" in svc.degraded
        assert not eng_a.graphs.captured and a in svc.model_pool and eng_a.asleep and not eng_b.asleep
        assert _gen(svc) == gold[b]
        out = svc.swap(a)
        assert out["tier"] == "pool" and not out["graphs_kept"] and out["recapture_s"] > 0
        assert svc.degraded is None and eng_a.graphs.captured and _gen(svc) == gold[a]
    finally:
        svc.shutdown()


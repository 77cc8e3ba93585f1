"""The decode chunk's graphs and the state they read, on the CPU.

A CUDA graph cannot be captured here, so what the graphs rest on is held
instead:

* the chunk length is a scheduling knob only: the port engine at
  ``decode_chunk`` 4 and 32 gives the JAX engine's greedy tokens (the port
  of ``tests/test_engine.py:test_decode_chunk_length_invariant``), and a
  seeded sampled request among greedy ones gives the same tokens at chunk
  1 and 8;
* the noise drawn ahead of a chunk equals the per-step draws, bit for bit;
* every tensor a graph reads keeps its object and its ``data_ptr()``
  across an upload, a packed admission, a chunk and a level-1 and level-2
  sleep/wake (``engine/arena.py``'s CPU version);
* the arena's plan: sizes rounded to the granularity, offsets, tags, and
  nothing mapped while asleep;
* a replay's accounting, with a stand-in graph object (the wrappers
  count eager launches only, none into a capture), and a whole run
  served through ``ChunkGraphs.replay`` with stand-in graphs that rerun
  the chunk into their static outputs, against the eager engine.
"""

import contextlib
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu_torch.engine import arena as tarena
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import graphs as tgraphs
from llm_d_fast_model_actuation_tpu_torch.engine import sleep as tsleep
from llm_d_fast_model_actuation_tpu_torch.engine.arena import CPU_GRANULARITY, Arena, arena_of, round_up
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import decode as tdecode
from llm_d_fast_model_actuation_tpu_torch.ops.cuda.build import count_launch
from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import serving_mesh

MIB = 1 << 20


def _jm():
    return dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)


def _port(mesh=None, **kw):
    base = dict(max_batch=4, page_size=8, num_pages=48, max_seq_len=64)
    base.update(kw)
    cfg = tengine.EngineConfig(model=config_from_jax(_jm()), **base)
    return tengine.InferenceEngine(cfg, seed=0, device=None if mesh else "cpu", mesh=mesh)


def _run(eng, reqs):
    ids = [eng.add_request(**r) for r in reqs]
    out = {}
    while eng.has_work():
        for r in eng.step():
            out[r.seq_id] = r.out_tokens
    return [out[i] for i in ids]


def _state(eng):
    """Every tensor a chunk graph reads or writes, and every other tensor
    of the engine's state."""
    return (list(eng.model.parameters()) + list(eng.model.buffers()) + eng.pool.tensors()
            + eng.sched_tensors())


def _where(eng):
    return [(id(t), t.data_ptr(), tuple(t.shape)) for t in _state(eng)]


# -- the chunk length, against the JAX engine --------------------------------


@pytest.mark.parametrize("chunk", [4, 32])
def test_decode_chunk_length_gives_the_jax_engines_tokens(chunk):
    prompt = [5, 6, 7, 8, 9]
    base = dict(max_batch=2, page_size=8, num_pages=32, max_seq_len=64, decode_chunk=chunk)
    jeng = jengine.InferenceEngine(jengine.EngineConfig(model=_jm(), **base), seed=0)
    want = jeng.generate([prompt], max_new_tokens=40)[0]
    state = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    teng = tengine.InferenceEngine(
        tengine.EngineConfig(model=config_from_jax(_jm()), **base), params=state, device="cpu"
    )
    assert teng.generate([prompt], max_new_tokens=40)[0] == want
    # 40 tokens: the chunk runs, then the drain tail's single steps
    assert teng.decode_chunks > 1 and teng.decode_steps == 39


def test_a_seeded_sampled_request_among_greedy_ones_is_chunk_length_invariant():
    reqs = [
        dict(prompt=[1, 2, 3], max_new_tokens=14),
        dict(prompt=[7, 8, 9], max_new_tokens=17, temperature=0.9, top_p=0.9, seed=1234),
        dict(prompt=[4, 4], max_new_tokens=11, presence_penalty=0.5),
    ]
    one, eight = _run(_port(decode_chunk=1), reqs), _run(_port(decode_chunk=8), reqs)
    assert one == eight
    assert one[1] != _run(_port(decode_chunk=8), [dict(reqs[1], seed=99)])[0]  # the seed drives it


# -- the noise drawn ahead ---------------------------------------------------


@pytest.mark.parametrize("T", [1, 4])
def test_noise_drawn_ahead_equals_the_per_step_draws(T):
    eng = _port(decode_chunk=4)
    slots = [0, 2]
    for s in slots:
        eng._gens[s] = torch.Generator().manual_seed(100 + s)
    states = {s: eng._gens[s].get_state() for s in slots}
    eng._dev["noise"].fill_(7.0)  # stale content the draw must clear
    eng._draw_chunk_noise(slots, T)
    ahead = eng._dev["noise"][:T].clone()
    for s in slots:
        eng._gens[s].set_state(states[s])
    per_step = torch.stack([eng._draw_noise(slots, eng.cfg.max_batch) for _ in range(T)])
    assert torch.equal(ahead, per_step)
    assert ahead[:, [1, 3]].eq(0).all() and ahead[:, slots].ne(0).any()


# -- the state stays in place ---------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2], ids=["one_device", "cpu_cpu_mesh"])
def test_state_keeps_its_tensors_across_upload_admission_and_chunk(tp):
    eng = _port(serving_mesh(2, ["cpu", "cpu"]) if tp == 2 else None, packed_serving=True)
    where = _where(eng)
    eng.add_request([1, 2, 3, 4, 5], max_new_tokens=12)
    eng.step()  # a packed admission and step, then a chunk
    assert eng.packed_steps == 1 and eng.decode_chunks == 1
    eng.add_request([9, 9], max_new_tokens=3)
    eng.step()  # a second admission beside a running sequence
    eng._upload_sched()
    assert _where(eng) == where
    # the page table the forwards read is the static buffer, written in
    # place: one for the device both ranks of the mesh share
    assert len(eng._pt_bufs) == 1
    assert all(t is eng._pt_bufs[0] for t in ([eng._table()] if tp == 1 else eng._table()))
    assert torch.equal(eng._pt_bufs[0], torch.from_numpy(eng._page_table))
    assert eng.graphs is None and eng.decode_chunks == 2  # eager on the CPU and on a mesh


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
def test_state_keeps_its_tensors_across_level1_and_level2_sleep(packed):
    prompts = [[5, 9, 200, 3, 77], [42, 1]]
    gold = _run(_port(packed_serving=packed), [dict(prompt=p, max_new_tokens=20) for p in prompts])
    eng = _port(packed_serving=packed)
    ids = [eng.add_request(p, max_new_tokens=20) for p in prompts]
    eng.step()
    where = _where(eng)
    params = {n: p.clone() for n, p in eng.model.named_parameters()}
    mgr = tsleep.attach_sleep(eng)
    mgr.sleep(1)
    arena = eng.arenas[eng.device]
    assert arena.mapped_bytes == 0 and arena.reserved_va_bytes == 0  # the CPU arena reserves nothing
    # what the CPU arena does with memory it unmaps: no value survives
    assert eng.model.layers["wq"].isnan().all() and (eng.pool.k_pages.isnan().all())
    assert (eng._dev["budget"] == -1).all()
    mgr.wake_up()
    assert _where(eng) == where
    assert all(torch.equal(p, params[n]) for n, p in eng.model.named_parameters())
    assert mgr.stats.last_alloc_seconds >= mgr.stats.wake_map_s == 0.0  # the CPU maps nothing
    out = {}
    while eng.has_work():
        out.update({r.seq_id: r.out_tokens for r in eng.step()})
    assert [out[i] for i in ids] == gold
    mgr.sleep(2)
    assert arena.mapped_bytes == 0
    eng.abort_all("level-2 sleep discarded state")
    mgr.wake_up(reinit=lambda: tsleep.fresh_state(eng))
    assert _where(eng) == where and arena.mapped_bytes > 0
    assert _run(eng, [dict(prompt=p, max_new_tokens=20) for p in prompts]) == gold


# -- the arena's plan ---------------------------------------------------------


def test_arena_plan_rounds_to_the_granularity_and_tags_each_block():
    arena = Arena("cpu")
    G = CPU_GRANULARITY
    assert arena.granularity == G == 2 * MIB and arena.reserved_va_bytes == 0  # the CPU reserves nothing
    w = arena.empty((3, 1000, 300), torch.bfloat16, "offload", "w")  # 1,800,000 bytes: 1.72 MiB
    pool = arena.zeros((G // 4 + 1,), torch.float32, "offload", "pool")  # 4 bytes past 2 MiB
    pt = arena.zeros((8, 4), torch.int32, "discard", "pt")
    assert [(b.name, b.tag, b.offset, b.nbytes) for b in arena.blocks] == [
        ("w", "offload", 0, G), ("pool", "offload", G, 2 * G), ("pt", "discard", 3 * G, G),
    ]
    assert [round_up(n, G) for n in (1_800_000, G, G + 4, 128)] == [G, G, 2 * G, G]
    assert arena.mapped_bytes == 4 * G
    with pytest.raises(ValueError, match="tag"):
        arena.empty((1,), torch.uint8, "keep")
    with pytest.raises(ValueError, match="at least one element"):
        arena.empty((0, 4), torch.uint8, "offload")
    with pytest.raises(ValueError, match="not an allocation"):
        arena.block(w[1])
    pt.fill_(3)
    arena.unmap(tag="discard")
    assert arena.mapped_bytes == 3 * G and (pt == -1).all()
    arena.unmap([w, pool])
    assert arena.mapped_bytes == 0 and w.isnan().all()
    arena.map([pool])
    arena.map(tag="discard")
    assert arena.mapped_bytes == 3 * G and not arena.block(w).mapped
    arena.map()
    assert arena.mapped_bytes == 4 * G and arena_of([Arena("cpu"), arena], pt) is arena


def test_engine_state_lies_in_its_arena_with_each_tag():
    eng = _port()
    arena = eng.arenas[eng.device]
    tags = {arena.block(t).tag for t in list(eng.model.parameters()) + eng.pool.tensors()}
    assert tags == {"offload"}
    assert {arena.block(t).tag for t in list(eng.model.buffers()) + eng.sched_tensors()} == {"discard"}
    assert len(arena.blocks) == len(_state(eng))
    m = eng.cfg.model
    assert eng._dev["noise"].shape == (eng.cfg.decode_chunk, eng.cfg.max_batch, m.vocab_size + min(64, m.vocab_size))
    # on the CPU nothing is captured: every chunk runs eagerly
    eng.generate([[1, 2, 3]], max_new_tokens=10)
    assert eng.graphs is None and eng.graph_captures == eng.graph_replays == 0 and eng.decode_chunks > 0


# -- replays -----------------------------------------------------------------


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _no_card(monkeypatch):
    """What ChunkGraphs asks of the card, as no-ops: its device context
    and its allocator."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tgraphs, "release_cached_memory", lambda device: None)


def test_a_replay_adds_its_steps_and_its_captured_launches(monkeypatch):
    _no_card(monkeypatch)
    eng = _port()
    graphs = tgraphs.ChunkGraphs(eng)
    fake = _FakeGraph()
    graphs.programs[(4, False)] = tgraphs.Program(fake, 4, {"decode_kernel": 8, "gemm": 12}, ("outputs",))
    graphs.programs[(1, False)] = tgraphs.Program(_FakeGraph(), 1, {"decode_kernel": 2}, ("one",))
    wrapper = tdecode.paged_decode_attention_inline
    before, steps = wrapper.launches, eng.decode_steps
    assert graphs.replay(4, False) == ("outputs",)
    assert graphs.replay(4, False) == ("outputs",)
    assert graphs.replay(1, False) == ("one",)
    assert fake.replays == 2 and eng.graph_replays == 3
    assert eng.decode_steps == steps + 9
    # a replay runs what its graph holds; the wrappers count eager launches only
    assert graphs.replayed_launches() == {"decode_kernel": 18, "gemm": 24} and wrapper.launches == before
    with pytest.raises(RuntimeError, match="no chunk graph"):
        graphs.replay(1, True)
    # a capture with a request mid-stream runs on a blank device scheduler
    # state; the host mirrors stay the request's and go up at the next step
    eng.add_request([1, 2], max_new_tokens=4)
    eng.step()
    budgets, table = eng._budgets.copy(), eng._page_table.copy()
    seen = []

    def capture(self, T, sampled):
        d = self.engine._dev
        seen.append((int(d["budget"].abs().sum()), int(d["pt"].abs().sum())))
        return tgraphs.Program(_FakeGraph(), T, {}, ("outputs",))

    graphs.programs.clear()
    monkeypatch.setattr(tgraphs.ChunkGraphs, "_capture", capture)
    graphs.capture()
    tgraphs._holders.discard(graphs)
    assert seen == [(0, 0)] * 4 and budgets.any() and table.any()
    assert (eng._budgets == budgets).all() and (eng._page_table == table).all() and eng._dirty
    assert graphs.keys() == [(8, False), (8, True), (1, False), (1, True)]


def test_a_launch_into_a_capture_is_not_counted(monkeypatch):
    def wrapper():
        pass

    wrapper.launches, wrapper.by_rows = 0, {}
    capturing = False
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    count_launch(wrapper, "by_rows", 72)
    count_launch(wrapper)
    capturing = True
    count_launch(wrapper, "by_rows", 72)
    assert wrapper.launches == 2 and wrapper.by_rows == {72: 1}


class _RerunGraph:
    """A stand-in for a captured chunk on the CPU: capturing runs the body
    once (every slot inactive, as at the engine's start) to make the
    static outputs; a replay runs it again and writes into them."""

    def __init__(self, eng, T, sampled):
        self.eng, self.T, self.sampled = eng, T, sampled
        self.outputs = eng.chunk_body(T, sampled)

    def replay(self):
        new = self.eng.chunk_body(self.T, self.sampled)
        for dst, src in zip(self.outputs[:2] + self.outputs[2], new[:2] + new[2]):
            dst.copy_(src)


def test_serving_through_replays_gives_the_eager_engines_tokens(monkeypatch):
    reqs = [
        dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=13),
        dict(prompt=[9, 2, 6], max_new_tokens=6, temperature=0.8, seed=5),
        dict(prompt=[5, 3], max_new_tokens=9, want_top_logprobs=True),
    ]
    eager = _port(decode_chunk=4)
    want = _run(eager, reqs)

    def capture(self, T, sampled):
        g = _RerunGraph(self.engine, T, sampled)
        self.engine.graph_captures += 1
        return tgraphs.Program(g, T, {}, g.outputs)

    monkeypatch.setattr(tgraphs.ChunkGraphs, "_capture", capture)
    _no_card(monkeypatch)
    eng = _port(decode_chunk=4)
    where = _where(eng)
    eng.graphs = tgraphs.ChunkGraphs(eng)
    eng.graphs.capture()
    assert _run(eng, reqs) == want
    assert eng.graph_captures == 4 and eng.graph_replays == eng.decode_chunks == eager.decode_chunks
    assert eng.decode_steps == eager.decode_steps and _where(eng) == where
    tgraphs._holders.discard(eng.graphs)


def test_graphs_pad_the_malloc_heaps_once(monkeypatch):
    """The first engine with graphs sets glibc's M_TOP_PAD, once per
    process (a capture's driver allocations on the engine thread)."""
    calls = []

    class Libc:
        def mallopt(self, param, value):
            calls.append((param, value))
            return 1

    monkeypatch.setattr(tgraphs, "_malloc_padded", False)
    monkeypatch.setattr(tgraphs.ctypes, "CDLL", lambda name: Libc())
    eng = _port()
    tgraphs.ChunkGraphs(eng)
    tgraphs.ChunkGraphs(eng)
    assert calls == [(-2, 64 << 20)]


def _card_arena(monkeypatch, events: list) -> Arena:
    """An arena that takes the card's end of life, recording on which
    thread it gave its memory back and whether a capture was then held."""
    arena = Arena("cpu")
    arena.cuda, arena.base = True, 1

    def give_back(self):
        events.append(("give_back", threading.current_thread().name,
                       bool(getattr(tarena._capture_thread, "active", False))))
        self.base = 0

    monkeypatch.setattr(Arena, "_give_back", give_back)
    return arena


def test_an_arena_dropped_beside_a_capture_waits_for_its_end(monkeypatch):
    """An arena's teardown synchronizes the card, which invalidates a
    capture on another thread: one whose last view goes on another thread
    during a capture gives its memory back only after the capture."""
    events = []
    holder = {"arena": _card_arena(monkeypatch, events)}
    capturing, dropped = threading.Event(), threading.Event()

    def drop():
        capturing.wait()
        dropped.set()
        holder.pop("arena")

    t = threading.Thread(target=drop, name="dropper")
    t.start()
    with tarena.capture_guard():
        capturing.set()
        dropped.wait()
        t.join(timeout=0.5)
        assert t.is_alive() and events == []
        events.append(("capture_end", threading.current_thread().name, True))
    t.join(timeout=10)
    assert not t.is_alive()
    assert [e[0] for e in events] == ["capture_end", "give_back"] and events[1][1:] == ("dropper", False)


def test_an_arena_dropped_inside_a_capture_is_given_back_at_its_end(monkeypatch):
    """On the capturing thread itself the teardown is put off to the
    capture's end, and runs there once."""
    events = []
    arena = _card_arena(monkeypatch, events)
    with tarena.capture_guard():
        del arena
        assert events == [] and len(tarena._deferred) == 1
    assert events == [("give_back", threading.current_thread().name, False)] and tarena._deferred == []
    with tarena.capture_guard():
        pass
    assert len(events) == 1


def test_a_digest_job_closed_leaves_no_worker_running():
    """A stopped service closes its load's digest job: the leaves not yet
    started are dropped, the started ones finish, and no worker outlives
    it holding the engine's tensors."""
    from llm_d_fast_model_actuation_tpu_torch.engine.chunk_store import DigestJob

    leaves = {f"w{i}": torch.arange(1 << 16, dtype=torch.float32) + i for i in range(64)}
    job = DigestJob(leaves, workers=2)
    job.close()
    assert all(f.done() for f in job._futures)
    assert job._pool._threads and not [t for t in job._pool._threads if t.is_alive()]


def test_a_level2_sleep_beside_a_capture_synchronizes_after_its_end(monkeypatch):
    """A level-2 sleep waits for the whole card before it unmaps the
    state; on the card that synchronize would invalidate a capture in
    progress on another thread, so it waits for the capture's end
    (``arena.synchronize``, under the captures' lock)."""
    eng = _port()
    mgr = tsleep.attach_sleep(eng)
    mgr._cuda = True  # the card's path, its device calls stood in for
    capturing = threading.Event()
    events = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: events.append(
        ("synchronize", threading.current_thread().name, capturing.is_set())))
    monkeypatch.setattr(tsleep, "release_cached_memory", lambda device: None)
    t = threading.Thread(target=lambda: mgr.sleep(2), name="sleeper")
    with tarena.capture_guard():
        capturing.set()
        t.start()
        t.join(timeout=0.5)
        assert t.is_alive() and events == []
        capturing.clear()
    t.join(timeout=10)
    assert not t.is_alive() and mgr.level == 2
    assert events and all(e == ("synchronize", "sleeper", False) for e in events)


def test_every_device_wide_synchronize_is_taken_under_the_capture_lock():
    """No ``torch.cuda.synchronize`` in the port outside the captures'
    lock: only ``arena.synchronize`` and an arena's teardown (both under
    the lock) and ``graphs.release_cached_memory`` (inside
    ``excluding_captures``) call it; every other site waits on its own
    stream or event, or goes through ``arena.synchronize``."""
    import ast
    import pathlib

    pkg = pathlib.Path(tarena.__file__).resolve().parents[1]
    found = []
    for path in sorted(pkg.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and ast.unparse(node.func) == "torch.cuda.synchronize":
                    found.append((str(path.relative_to(pkg)), fn.name))
    allowed = {("engine/arena.py", "synchronize"), ("engine/arena.py", "_give_back"),
               ("engine/graphs.py", "release_cached_memory")}
    assert set(found) == allowed, sorted(set(found) - allowed)
    src = (pkg / "engine" / "graphs.py").read_text()
    body = src[src.index("def release_cached_memory"):src.index("#: glibc's")]
    assert "excluding_captures()" in body.split("torch.cuda.synchronize()")[0]

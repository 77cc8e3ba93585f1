"""The port's tensor-parallel serving against its own single-device path
and against the JAX package, on a two-rank mesh whose ranks share the
CPU (``cpu,cpu``), in float32 on the tiny Llama and the tiny Gemma.

What is held to what:

* the rank slices ``params_from_jax(mesh=)`` cuts equal what the JAX
  package's ``NamedSharding`` places on each device of a 2-device mesh,
  and the pool's per-rank shape equals the JAX pool's shard shape;
* ``prefill``, ``prefill_continue``, both ``decode_step`` branches and
  ``mixed_step`` at tp=2 give the logits and the KV pages of tp=1 and of
  the JAX functions. Tolerance 2e-4 (atol and rtol) in float32: the same
  math with the row-parallel products summed in two halves;
* the tp=2 engine's greedy tokens equal the tp=1 port engine's and the
  JAX single-device engine's, bucketed and packed;
* level-1 and level-2 sleep/wake on the mesh: same tokens after the wake,
  every shard back in the tensor object and on the device it left, and
  ``bytes_offloaded`` equal to the JAX ``SleepManager``'s on a 2-device
  mesh (the global size: replicated norms count once);
* ``ragged_paged_attention_sharded`` (its plain version: these are CPU
  tensors) against the JAX Pallas kernel in interpret mode called once
  per head slice, which is what ``shard_map`` runs. Tolerances are the
  reference's own: 2e-5 in float32, 3e-2 in bf16, on valid rows;
* the collectives are deterministic, and what is not ported raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.engine import sleep as jsleep
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu.ops.pallas import ragged_paged_attention_pallas
from llm_d_fast_model_actuation_tpu.parallel import mesh as jmesh
from llm_d_fast_model_actuation_tpu.utils.compat import pallas_interpret_supported
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import kv_cache as tkv
from llm_d_fast_model_actuation_tpu_torch.engine import sleep as tsleep
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models.convert import (
    config_from_jax,
    params_from_jax,
)
from llm_d_fast_model_actuation_tpu_torch.ops import attention as tattn
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import ragged as tragged
from llm_d_fast_model_actuation_tpu_torch.ops.rope import rope_table
from llm_d_fast_model_actuation_tpu_torch.parallel import mesh as tmesh

TOL = 2e-4  # float32 logits and pages, tp=2 against tp=1 and against JAX
PS, PPS = 8, 4  # page size, pages per sequence
NAMES = ["tiny", "tiny_gemma"]


def _mesh(tp=2):
    return tmesh.serving_mesh(tp, ["cpu"] * tp)


def _jax_cfg(name, impl="grouped"):
    base = jllama.LlamaConfig.tiny_gemma() if name == "tiny_gemma" else jllama.LlamaConfig.tiny()
    if name == "tiny_qwen":
        base = dataclasses.replace(base, attn_bias=True)
    return dataclasses.replace(base, dtype=jnp.float32, attention_impl=impl)


def _tree(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(7)
    for name, leaf in tree["layers"].items():
        # random norms and biases, so a slice taken from the wrong place shows
        if "norm" in name or name in ("bq", "bk", "bv"):
            tree["layers"][name] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
    return tree


def _models(name, impl="grouped"):
    """(jax cfg, jax params, the port's tp=1 model, its tp=2 model), all
    holding the same numbers."""
    jcfg = _jax_cfg(name, impl)
    tree = _tree(jcfg)
    cfg = config_from_jax(jcfg)
    one = tllama.Llama(cfg, "cpu")
    one.load_state_dict(params_from_jax(tree), strict=True)
    mesh = _mesh()
    two = tllama.ShardedLlama(cfg, mesh)
    two.load_state_dict(params_from_jax(tree, mesh=mesh, cfg=cfg), strict=True)
    return jcfg, jax.tree.map(jnp.asarray, tree), one, two


def _pools(cfg, num_pages, rng=None):
    """The same pool for JAX, for tp=1 and, split on kv_heads, for tp=2."""
    shape = (cfg.num_layers, num_pages, PS, cfg.num_kv_heads, cfg.head_dim)
    k, v = (np.zeros(shape, np.float32) if rng is None else rng.standard_normal(shape).astype(np.float32)
            for _ in range(2))
    half = cfg.num_kv_heads // 2
    return (
        (jnp.asarray(k), jnp.asarray(v)),
        (torch.from_numpy(k.copy()), torch.from_numpy(v.copy())),
        [tuple(torch.from_numpy(a[:, :, :, r * half:(r + 1) * half].copy()) for a in (k, v)) for r in range(2)],
    )


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=TOL)


def _pools_close(jcache, cache1, cache2):
    """tp=2's shards joined on kv_heads equal tp=1's pool and JAX's, on
    every page but the null page 0 (where the port sends the writes the
    reference drops)."""
    for i in range(2):
        joined = torch.cat([pair[i] for pair in cache2], dim=3)
        _close(joined[:, 1:], cache1[i][:, 1:])
        _close(joined[:, 1:], np.asarray(jcache[i])[:, 1:])


def _table(b):
    return np.arange(1, 1 + b * PPS, dtype=np.int32).reshape(b, PPS)


# -- (a) slices and shapes -------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mesh2(devices8):
    return jmesh.make_mesh(jmesh.MeshPlan(tp=2), devices8[:2])


@pytest.mark.parametrize("name", NAMES + ["tiny_qwen"])
def test_rank_slices_equal_the_jax_shards(name, jax_mesh2):
    jcfg = _jax_cfg(name)
    cfg = config_from_jax(jcfg)
    assert tllama.param_logical_axes(cfg) == jllama.param_logical_axes(jcfg)
    tree = _tree(jcfg)
    placed = jmesh.shard_pytree(
        jax.tree.map(jnp.asarray, tree), jax_mesh2, jllama.param_logical_axes(jcfg)
    )
    state = params_from_jax(tree, mesh=_mesh(), cfg=cfg)
    order = list(jax_mesh2.devices.reshape(-1))
    flat = {f"layers.{k}": v for k, v in placed["layers"].items()}
    flat.update({k: v for k, v in placed.items() if k != "layers"})
    assert len(state) == 2 * len(flat)
    split = 0
    for pname, arr in flat.items():
        shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for r in range(2):
            got = state[f"ranks.{r}.{pname}"]
            np.testing.assert_array_equal(got.numpy(), shards[order[r]])
            assert got.is_contiguous()
        split += shards[order[0]].shape != arr.shape
    # the split parameters are those the logical-axes table sends to tp
    assert split == sum("tp" in s for s in tllama.param_specs(cfg).values()) >= 8


def test_pool_shard_shape_equals_the_jax_pool(jax_mesh2):
    jcfg = _jax_cfg("tiny")
    ecfg = jengine.EngineConfig(model=jcfg, max_batch=2, page_size=8, num_pages=32, max_seq_len=64)
    jeng = jengine.InferenceEngine(ecfg, mesh=jax_mesh2, seed=0)
    kp = jeng.pool.k_pages
    pool = tkv.PagePool.create(
        jcfg.num_layers, 32, 8, jcfg.num_kv_heads, jcfg.head_dim, dtype=torch.float32, mesh=_mesh()
    )
    assert len(pool.shards) == 2 and len(pool.tensors()) == 4
    for k, v in pool.shards:
        assert tuple(k.shape) == tuple(v.shape) == tuple(kp.sharding.shard_shape(kp.shape))
        assert k.is_contiguous() and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
    # the byte helpers keep the global figures
    assert pool.nbytes() == tkv.PagePool.estimate_nbytes(
        jcfg.num_layers, 32, 8, jcfg.num_kv_heads, jcfg.head_dim, dtype=torch.float32
    ) == kp.nbytes + jeng.pool.v_pages.nbytes
    assert pool.as_tuple() is pool.shards


def test_a_seed_gives_a_mesh_the_numbers_it_gives_one_device():
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny_gemma(), dtype=torch.float32)
    mesh = _mesh()
    one = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    two = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu", mesh=mesh)
    want = tllama.shard_params(one.state_dict(), cfg, mesh)
    got = two.state_dict()
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert two.ranks[0].cfg == tllama.shard_config(cfg, 2)
    assert two.ranks[1].layers["wq"].shape[-1] == cfg.q_dim // 2
    # replicated parameters of rank 1: every norm, nothing else
    assert len(two.replicas()) == sum("norm" in n for n in tllama.param_shapes(cfg))


# -- (b) the forwards ------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_last_only_prefills_give_the_sampled_row(name):
    """``last_only``: a prefill's and a suffix prefill's logits at each
    row's last valid position alone, [b, 1, vocab], equal to that row of
    the JAX logits on one rank and on two; the pages are written as by a
    full prefill."""
    jcfg, jparams, one, two = _models(name)
    rng = np.random.default_rng(2)
    b, rows = 2, np.arange(2)
    tokens = rng.integers(0, jcfg.vocab_size, (b, 16)).astype(np.int32)
    lens, suf_lens = np.array([8, 5], dtype=np.int32), np.array([8, 3], dtype=np.int32)
    pt = _table(b)
    jcache, c1, c2 = _pools(jcfg, b * PPS + 1)
    T = torch.from_numpy

    jl, jcache = jllama.prefill(jparams, jcfg, jnp.asarray(tokens[:, :8]), jnp.asarray(lens), jcache, jnp.asarray(pt))
    for model, cache in ((one, c1), (two, c2)):
        got = tllama.prefill(model, T(tokens[:, :8]), T(lens), cache, T(pt), last_only=True)
        assert got.shape == (b, 1, jcfg.vocab_size) and got.dtype == torch.float32
        _close(got[:, 0], np.asarray(jl)[rows, lens - 1])
    _pools_close(jcache, c1, c2)

    suf = np.zeros((b, 8), dtype=np.int32)
    for r in range(b):
        suf[r, : suf_lens[r]] = tokens[r, lens[r] : lens[r] + suf_lens[r]]
    jl, jcache = jllama.prefill_continue(
        jparams, jcfg, jnp.asarray(suf), jnp.asarray(lens), jnp.asarray(suf_lens), jcache, jnp.asarray(pt)
    )
    for model, cache in ((one, c1), (two, c2)):
        got = tllama.prefill_continue(model, T(suf), T(lens), T(suf_lens), cache, T(pt), last_only=True)
        assert got.shape == (b, 1, jcfg.vocab_size)
        _close(got[:, 0], np.asarray(jl)[rows, suf_lens - 1])
    _pools_close(jcache, c1, c2)


@pytest.mark.parametrize("name", NAMES + ["tiny_qwen"])
def test_prefill_continue_and_decode_tp2_match_tp1_and_jax(name):
    jcfg, jparams, one, two = _models(name)
    rng = np.random.default_rng(0)
    b = 2
    tokens = rng.integers(0, jcfg.vocab_size, (b, 16)).astype(np.int32)
    lens = np.array([16, 9], dtype=np.int32)
    pt = _table(b)
    jcache, c1, c2 = _pools(jcfg, b * PPS + 1)
    T = torch.from_numpy

    eight = np.array([8, 8], dtype=np.int32)
    jl, jcache = jllama.prefill(jparams, jcfg, jnp.asarray(tokens[:, :8]), jnp.asarray(eight), jcache, jnp.asarray(pt))
    l1 = tllama.prefill(one, T(tokens[:, :8]), T(eight), c1, T(pt))
    l2 = tllama.prefill(two, T(tokens[:, :8]), T(eight), c2, T(pt))
    assert l2.shape == (b, 8, jcfg.vocab_size) and l2.dtype == torch.float32
    _close(l2, l1)
    _close(l2, jl)
    _pools_close(jcache, c1, c2)

    suf, suf_lens = tokens[:, 8:16].copy(), lens - 8
    jl, jcache = jllama.prefill_continue(
        jparams, jcfg, jnp.asarray(suf), jnp.asarray(eight), jnp.asarray(suf_lens), jcache, jnp.asarray(pt)
    )
    l1 = tllama.prefill_continue(one, T(suf), T(eight), T(suf_lens), c1, T(pt))
    l2 = tllama.prefill_continue(two, T(suf), T(eight), T(suf_lens), c2, T(pt))
    for r in range(b):  # padding queries are garbage on every side
        _close(l2[r, : suf_lens[r]], l1[r, : suf_lens[r]])
        _close(l2[r, : suf_lens[r]], np.asarray(jl)[r, : suf_lens[r]])
    _pools_close(jcache, c1, c2)

    nxt, pos = np.array([5, 7], dtype=np.int32), lens.copy()
    for active in (None, np.array([True, False])):
        ja = None if active is None else jnp.asarray(active)
        ta = None if active is None else T(active)
        jl, jcache = jllama.decode_step(jparams, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jcache, jnp.asarray(pt), ja)
        l1 = tllama.decode_step(one, T(nxt), T(pos), c1, T(pt), ta)
        l2 = tllama.decode_step(two, T(nxt), T(pos), c2, T(pt), ta)
        _close(l2, l1)
        _close(l2, jl)
        _pools_close(jcache, c1, c2)
        pos = pos + 1


@pytest.mark.parametrize("name", NAMES)
def test_scatter_first_decode_step_tp2_matches_tp1_and_jax(name):
    jcfg, jparams, one, two = _models(name, impl="reference")
    rng = np.random.default_rng(5)
    b = 3
    jcache, c1, c2 = _pools(jcfg, b * PPS + 1, rng)
    pt = _table(b)
    pos = np.array([0, 9, 30], dtype=np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, b).astype(np.int32)
    T = torch.from_numpy
    for active in (None, np.array([True, False, True])):
        ja = None if active is None else jnp.asarray(active)
        ta = None if active is None else T(active)
        jl, jcache = jllama.decode_step(jparams, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jcache, jnp.asarray(pt), ja)
        l1 = tllama.decode_step(one, T(nxt), T(pos), c1, T(pt), ta)
        l2 = tllama.decode_step(two, T(nxt), T(pos), c2, T(pt), ta)
        _close(l2, l1)
        _close(l2, jl)
        _pools_close(jcache, c1, c2)
        pos = pos + 1


def _packed_rows(rng, vocab):
    """tests/test_ragged.py's packing layout: three sequences' rows in a
    40-row buffer of 8-row blocks."""
    row_slot = np.full(40, -1, np.int32)
    positions = np.zeros(40, np.int32)
    row_slot[0:11], positions[0:11] = 0, np.arange(11)  # a cold segment across a page
    row_slot[16], positions[16] = 1, 13  # a decode row on a partial page
    row_slot[24:29], positions[24:29] = 2, 7 + np.arange(5)  # a suffix from position 7
    return rng.integers(0, vocab, 40).astype(np.int32), row_slot, positions


@pytest.mark.parametrize("name", NAMES)
def test_mixed_step_tp2_matches_tp1_and_jax(name, monkeypatch):
    jcfg, jparams, one, two = _models(name)
    rng = np.random.default_rng(4)
    tokens, row_slot, positions = _packed_rows(rng, jcfg.vocab_size)
    pt = _table(3)
    jcache, c1, c2 = _pools(jcfg, 3 * PPS + 1, rng)
    T = torch.from_numpy
    calls = []
    real = tllama.ragged_paged_attention_sharded
    monkeypatch.setattr(
        tllama, "ragged_paged_attention_sharded", lambda mesh, q, *a: calls.append([x.shape for x in q]) or real(mesh, q, *a)
    )
    jl, jcache = jllama.mixed_step(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(row_slot), jnp.asarray(positions), jcache, jnp.asarray(pt)
    )
    # the port gets the table cut to the width the step needs (positions < 16)
    l1 = tllama.mixed_step(one, T(tokens), T(row_slot), T(positions), c1, T(pt)[:, :2])
    l2 = tllama.mixed_step(two, T(tokens), T(row_slot), T(positions), c2, T(pt)[:, :2])
    valid = row_slot >= 0
    _close(l2[T(valid)], l1[T(valid)])
    _close(l2[T(valid)], np.asarray(jl)[valid])
    _pools_close(jcache, c1, c2)
    # the mesh's attention is the sharded op, once per layer, on each rank's heads
    per_rank = torch.Size((40, jcfg.num_heads // 2, jcfg.head_dim))
    assert calls == [[per_rank, per_rank]] * jcfg.num_layers


def test_a_sharded_model_takes_one_cache_pair_per_rank():
    _, _, _, two = _models("tiny")
    _, c1, _ = _pools(two.cfg, 5)
    with pytest.raises(ValueError, match="per rank"):
        tllama.decode_step(
            two, torch.tensor([1], dtype=torch.int32), torch.tensor([0], dtype=torch.int32), c1,
            torch.ones((1, PPS), dtype=torch.int32),
        )


# -- (c) the engine --------------------------------------------------------------


def _ecfgs(name="tiny", **kw):
    jm = _jax_cfg(name, impl="reference")  # the JAX config's own default
    base = dict(max_batch=2, page_size=8, num_pages=32, max_seq_len=64, **kw)
    return jengine.EngineConfig(model=jm, **base), tengine.EngineConfig(model=config_from_jax(jm), **base)


def _engines(name="tiny", **kw):
    """(the JAX single-device engine, the port's tp=1 engine, its tp=2
    engine), on the JAX engine's weights."""
    jcfg, tcfg = _ecfgs(name, **kw)
    jeng = jengine.InferenceEngine(jcfg, seed=0)
    tree = jax.tree.map(np.asarray, jeng.params)
    mesh = _mesh()
    one = tengine.InferenceEngine(tcfg, params=params_from_jax(tree), device="cpu")
    two = tengine.InferenceEngine(tcfg, params=params_from_jax(tree, mesh=mesh, cfg=tcfg.model), mesh=mesh)
    return jeng, one, two


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
@pytest.mark.parametrize("name", NAMES)
def test_tp2_engine_matches_single_device_and_jax(name, packed):
    jeng, _, _ = _engines(name)
    _, one, two = _engines(name, packed_serving=packed)
    gold = jeng.generate([[5, 6, 7, 8]], max_new_tokens=5)[0]
    assert one.generate([[5, 6, 7, 8]], max_new_tokens=5)[0] == gold
    assert two.generate([[5, 6, 7, 8]], max_new_tokens=5)[0] == gold
    assert (two.packed_steps > 0) == packed
    assert two.mixed_impl == "ragged_sharded" and one.mixed_impl == "ragged"
    assert isinstance(two.model, tllama.ShardedLlama) and two.device == torch.device("cpu")


MIXED_PROMPTS = [
    [1, 2, 3, 4, 5],
    [9, 8, 7],
    [4] * 16,  # two full pages at page_size 8
    [7, 6, 5, 4, 3, 2, 1] * 3,
]


def _port(mesh, **kw):
    m = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    cfg = tengine.EngineConfig(model=m, max_batch=2, page_size=8, num_pages=32, max_seq_len=64, **kw)
    if mesh is None:
        return tengine.InferenceEngine(cfg, seed=0, device="cpu")
    return tengine.InferenceEngine(cfg, seed=0, mesh=mesh)


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
def test_mixed_lengths_through_two_slots_on_the_mesh(packed):
    """Four prompts through two slots (retire and re-admit edges, a
    page-boundary prompt), seeded weights: the mesh engine's tokens equal
    the single-device engine's on the same path."""
    gold = _port(None, packed_serving=packed).generate(MIXED_PROMPTS, max_new_tokens=8)
    eng = _port(_mesh(), packed_serving=packed)
    assert eng.generate(MIXED_PROMPTS, max_new_tokens=8) == gold
    assert (eng.packed_steps > 0) == packed


def test_chunked_prefill_prefix_hit_and_penalties_on_the_mesh():
    def run(mesh):
        eng = _port(mesh, max_prefill_tokens=6)
        shared = list(range(100, 124))
        out = [eng.generate([shared + [1, 2]], max_new_tokens=6)[0]]
        ids = [
            eng.add_request(shared + [3], 6, presence_penalty=0.5, frequency_penalty=0.3),
            eng.add_request([2, 7, 1, 8, 2, 8], 8, temperature=0.8, seed=11),
        ]
        done = {}
        while eng.has_work():
            for r in eng.step():
                done[r.seq_id] = r.out_tokens
        assert eng.prefix_cache.stats()["hits"] >= 1
        return out + [done[i] for i in ids]

    assert run(_mesh()) == run(None)


def test_four_ranks_and_the_engine_checks_its_mesh():
    # tiny has 2 KV heads: tp=4 cannot split them
    with pytest.raises(ValueError, match="num_kv_heads"):
        _port(_mesh(4))
    m = dataclasses.replace(
        tllama.LlamaConfig.tiny(), dtype=torch.float32, num_heads=8, num_kv_heads=4
    )
    cfg = tengine.EngineConfig(model=m, max_batch=2, page_size=8, num_pages=32, max_seq_len=64)
    gold = tengine.InferenceEngine(cfg, seed=0, device="cpu").generate([[5, 6, 7, 8]], max_new_tokens=5)
    assert tengine.InferenceEngine(cfg, seed=0, mesh=_mesh(4)).generate([[5, 6, 7, 8]], max_new_tokens=5) == gold
    # a single-device model cannot be handed to a mesh engine, nor the reverse
    with pytest.raises(ValueError, match="mesh"):
        tengine.InferenceEngine(cfg, params=tllama.Llama(m, "cpu"), mesh=_mesh())
    with pytest.raises(ValueError, match="mesh"):
        tengine.InferenceEngine(cfg, params=tllama.ShardedLlama(m, _mesh()), device="cpu")
    with pytest.raises(ValueError, match="rank 0"):
        tengine.InferenceEngine(cfg, device="cuda:1", mesh=_mesh())


# -- (d) sleep and wake ----------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
def test_sharded_sleep_wake(packed, jax_mesh2):
    jcfg, tcfg = _ecfgs(packed_serving=packed)
    jeng = jengine.InferenceEngine(jcfg, mesh=jax_mesh2, seed=0)
    mesh = _mesh()
    eng = tengine.InferenceEngine(
        tcfg, params=params_from_jax(jax.tree.map(np.asarray, jeng.params), mesh=mesh, cfg=tcfg.model), mesh=mesh
    )
    gold = eng.generate([[3, 1, 4]], max_new_tokens=4)[0]
    objects = list(eng.model.parameters()) + eng.pool.tensors()
    before = [(id(t), t.device, tuple(t.shape), t.data_ptr()) for t in objects]
    mgr = tsleep.attach_sleep(eng)
    info = mgr.sleep(1)
    # every rank's device memory is released, the RoPE tables' too
    assert eng.asleep and all(a.mapped_bytes == 0 for a in eng.arenas.values())
    # the global size, as the reference counts a sharded state: the same
    # figure as on one device, replicated norms counted once
    assert info["bytes_offloaded"] == jsleep.attach_sleep(jeng).sleep(1)["bytes_offloaded"] > 0
    _, one, _ = _engines()
    assert info["bytes_offloaded"] == tsleep.attach_sleep(one).sleep(1)["bytes_offloaded"]
    # what the host really holds is one copy more of every replicated tensor
    held = sum(t.numel() * t.element_size() for t in mgr._host)
    assert held == info["bytes_offloaded"] + sum(tsleep._nbytes(h) for h, t in zip(mgr._host, mgr._leaves)
                                                 if any(t is r for r in eng.model.replicas()))
    mgr.wake_up()
    # each shard back where it was, at the same address
    assert [(id(t), t.device, tuple(t.shape), t.data_ptr()) for t in objects] == before
    assert eng.model.ranks[1].layers["wq"].shape[-1] == tcfg.model.q_dim // 2
    assert all(torch.equal(m.rope_cos, rope_table(m.cfg.max_seq_len, m.cfg.head_dim, m.cfg.rope_theta, m.cfg.rope_scaling)[0])
               for m in eng.model.ranks)
    assert eng.generate([[3, 1, 4]], max_new_tokens=4)[0] == gold


def test_level1_sleep_mid_generation_and_level2_reinit_on_the_mesh():
    gold = _port(None).generate([[5, 9, 200, 3, 77]], max_new_tokens=20)[0]
    eng = _port(_mesh())
    eng.add_request([5, 9, 200, 3, 77], max_new_tokens=20)
    eng.step()
    assert eng.has_work()
    mgr = tsleep.attach_sleep(eng, bucket_bytes=4096)
    mgr.sleep(1)
    with pytest.raises(tengine.EngineAsleep):
        eng.step()
    mgr.wake_up()
    outs = []
    while eng.has_work():
        outs.extend(eng.step())
    assert outs[0].out_tokens == gold
    # level 2: weights drawn anew from the seed, sliced per rank again
    mgr.sleep(2)
    eng.abort_all("level-2 sleep discarded state")
    mgr.wake_up(reinit=lambda: tsleep.fresh_state(eng))
    assert eng.generate([[5, 9, 200, 3, 77]], max_new_tokens=20)[0] == gold


# -- (e) the sharded ragged op ----------------------------------------------------

RAGGED_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture
def interpret():
    if not pallas_interpret_supported():
        pytest.skip("this jaxlib cannot run Pallas interpret mode on CPU")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "heads,kv_heads,head_dim,page_size,pages_per_seq",
    [(4, 2, 16, 8, 4), (8, 8, 32, 16, 2), (8, 2, 64, 8, 3)],
)
def test_ragged_sharded_matches_pallas_per_head_slice(
    interpret, heads, kv_heads, head_dim, page_size, pages_per_seq, dtype
):
    rng = np.random.default_rng(1)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)

    def draw(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.array(jnp.asarray(a, jd).astype(jnp.float32))  # exact in the io dtype

    num_pages = 3 * pages_per_seq + 1
    q = draw(40, heads, head_dim)
    kp, vp = draw(num_pages, page_size, kv_heads, head_dim), draw(num_pages, page_size, kv_heads, head_dim)
    pt = np.arange(1, num_pages, dtype=np.int32).reshape(3, pages_per_seq)
    _, row_slot, positions = _packed_rows(rng, 10)
    positions[16] = min(13, page_size * pages_per_seq - 1)
    mesh, tp = _mesh(), 2
    hs, ks = heads // tp, kv_heads // tp
    T = torch.from_numpy
    shards = lambda a, n, dim: [  # noqa: E731
        T(a).to(td).narrow(dim, r * n, n).contiguous() for r in range(tp)
    ]
    before = tragged.ragged_paged_attention_sharded.launches
    got = tragged.ragged_paged_attention_sharded(
        mesh, shards(q, hs, 1), shards(kp, ks, 2), shards(vp, ks, 2), T(pt), T(row_slot), T(positions)
    )
    assert tragged.ragged_paged_attention_sharded.launches == before  # CPU tensors: no kernel launch
    valid = row_slot >= 0
    for r in range(tp):
        # what shard_map runs on shard r: the unmodified kernel on its head slice
        want = ragged_paged_attention_pallas(
            jnp.asarray(q[:, r * hs:(r + 1) * hs], jd), jnp.asarray(kp[:, :, r * ks:(r + 1) * ks], jd),
            jnp.asarray(vp[:, :, r * ks:(r + 1) * ks], jd), jnp.asarray(pt), jnp.asarray(row_slot),
            jnp.asarray(positions), block_rows=tragged.RAGGED_BLOCK, interpret=True,
        )
        assert got[r].shape == (40, hs, head_dim) and got[r].dtype == td
        np.testing.assert_allclose(
            got[r].float().numpy()[valid], np.asarray(want, np.float32)[valid],
            atol=RAGGED_TOL[dtype], rtol=RAGGED_TOL[dtype],
        )
    # joined on the head axis it is the unsharded op, bit for bit: a head's
    # arithmetic does not depend on which rank runs it
    whole = tragged.ragged_paged_attention(T(q).to(td), T(kp).to(td), T(vp).to(td), T(pt), T(row_slot), T(positions))
    assert torch.equal(torch.cat(got, dim=1), whole)


def test_ragged_sharded_checks_its_shards_and_routes_by_mesh():
    mesh = _mesh()
    q = [torch.zeros(8, 2, 16)] * 2
    kv = [torch.zeros(3, 8, 1, 16)] * 2
    meta = (torch.ones((1, 2), dtype=torch.int32), torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="shards for a mesh of 2"):
        tragged.ragged_paged_attention_sharded(mesh, q[:1], kv, kv, *meta)
    with pytest.raises(ValueError, match="per-rank tensors"):
        tragged.ragged_paged_attention_sharded(mesh, q, kv, kv, [meta[0]], meta[1], meta[2])
    out = tragged.ragged_paged_attention_sharded(mesh, q, kv, kv, [meta[0]] * 2, meta[1], meta[2])
    assert len(out) == 2 and out[0].shape == (8, 2, 16)
    for impl in ("reference", "grouped", "pallas"):
        assert tattn.resolve_ragged_impl(impl, None) == "ragged"
        assert tattn.resolve_ragged_impl(impl, mesh) == "ragged_sharded"


# -- (f) what is refused -----------------------------------------------------------


@pytest.mark.parametrize("field", ["num_kv_heads", "intermediate_size", "vocab_size"])
def test_indivisible_sizes_raise(field):
    cfg = tllama.LlamaConfig.tiny()
    bad = dataclasses.replace(cfg, **{field: getattr(cfg, field) + 1})
    if field == "num_kv_heads":
        bad = dataclasses.replace(cfg, num_heads=3, num_kv_heads=3)
    with pytest.raises(ValueError, match=field):
        tllama.shard_config(bad, 2)
    with pytest.raises(ValueError, match=field):
        tllama.ShardedLlama(bad, _mesh())
    assert tllama.shard_config(cfg, 1) == cfg


@pytest.mark.parametrize("axis", ["dp", "pp", "sp", "ep"])
def test_only_tp_is_realised(axis):
    """A dense serving model splits over tp and, in pipeline stages, over
    pp (tests/test_torch_pp.py): the model refuses dp and sp (training
    axes) and ep (it has no experts)."""
    plan = tmesh.MeshPlan(**{axis: 2})
    assert plan.size == 2 and plan.describe() == f"{axis}=2"
    mesh = tmesh.make_mesh(plan, ["cpu", "cpu"])
    if axis == "pp":
        staged = tllama.ShardedLlama(tllama.LlamaConfig.tiny(), mesh)
        assert [m.cfg.num_layers for m in staged.ranks] == [1, 1] and mesh.tp == 1
        return
    assert mesh.shape[axis] == 2 and mesh.tp == 1 and mesh.size == 2
    with pytest.raises(ValueError, match="splits experts" if axis == "ep" else "tp and ep only"):
        tllama.ShardedLlama(tllama.LlamaConfig.tiny(), mesh)


def test_serving_mesh_needs_its_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        tmesh.serving_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.serving_mesh(2)
    with pytest.raises(ValueError):
        tmesh.serving_mesh(0)
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.serving_mesh(2, ["cpu"])  # an explicit list must have tp entries
    mesh = tmesh.serving_mesh(2, ["cpu", "cpu"])  # and may repeat a device
    assert mesh.tp == 2 and mesh.distinct_devices() == [torch.device("cpu")]


def test_tables_and_plans_equal_the_reference():
    assert tmesh.AXES == jmesh.AXES
    assert tmesh.LOGICAL_RULES == jmesh.LOGICAL_RULES
    assert dataclasses.asdict(tmesh.MeshPlan()) == dataclasses.asdict(jmesh.MeshPlan())
    for n, kw in ((8, {}), (4, {"tp": 2}), (6, {}), (8, {"tp": 2, "pp": 2})):
        assert dataclasses.asdict(tmesh.plan_for_devices(n, **kw)) == dataclasses.asdict(jmesh.plan_for_devices(n, **kw))
    with pytest.raises(ValueError):
        tmesh.plan_for_devices(6, tp=4)
    for axes in (("layers", "embed", "heads"), ("vocab", "embed"), ("embed",), ("layers", None)):
        assert tmesh.spec_for(axes) == tuple(jmesh.spec_for(axes))
    assert tmesh.spec_for(("layers", "embed", "heads")).index("tp") == 2
    assert tmesh.spec_for(("vocab", "embed")).index("tp") == 0
    assert "tp" not in tmesh.spec_for(("layers", "embed"))
    with pytest.raises(ValueError, match="more than one dimension"):
        tmesh.shard_for(np.zeros((2, 4)), tmesh.spec_for(("heads", "mlp")), tmesh.serving_mesh(2, ["cpu"] * 2), 0)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard(np.zeros((3, 4)), 0, 0, 2)


# -- (g) the collectives -----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
def test_all_reduce_sum_is_the_rank_order_sum_bit_for_bit(tp, dtype):
    mesh = _mesh(tp)
    rng = np.random.default_rng(tp)
    parts = [torch.from_numpy(rng.standard_normal((5, 33)).astype(np.float32)).to(dtype) * 10 ** r for r in range(tp)]
    want = parts[0]
    for p in parts[1:]:
        want = want + p  # rank order, in the tensors' own dtype
    kept = [p.clone() for p in parts]
    for _ in range(2):  # twice in a row: the same bits
        got = mesh.all_reduce_sum(parts)
        assert len(got) == tp and all(g.dtype == dtype and torch.equal(g, want) for g in got)
    assert all(torch.equal(p, k) for p, k in zip(parts, kept))  # the partials are left alone
    with pytest.raises(ValueError):
        mesh.all_reduce_sum(parts[:1])


def test_gather_joins_in_rank_order_and_one_rank_is_the_identity():
    mesh = _mesh(2)
    parts = [torch.arange(6.0).reshape(2, 3), 10 + torch.arange(6.0).reshape(2, 3)]
    want = torch.cat(parts, dim=-1)
    assert torch.equal(mesh.gather(parts, dim=-1), want)
    assert all(torch.equal(g, want) for g in mesh.all_gather(parts, dim=-1))
    assert torch.equal(mesh.gather(parts, dim=0), torch.cat(parts, dim=0))
    solo = _mesh(1)
    x = torch.ones(3)
    assert solo.all_reduce_sum([x])[0] is x and solo.gather([x], 0) is x
    assert mesh.replicate(x)[0] is x and mesh.replicate(x)[1] is x  # one device: no copy
    assert mesh.replicate([x, x]) == [x, x]

"""The pipeline axis ``pp`` in the port, on the CPU, against the JAX package
and against the port on one rank, at ``LlamaConfig.tiny()`` with four
layers (and ``MoeConfig.tiny_moe()`` with four), in float32.

The reference's ``pp`` is a sharding rule (``"layers": "pp"``): each
device holds its stage's slice of every layer stack and XLA gathers it.
The port runs it as stages: the ranks at ``pp`` coordinate ``s`` hold
layers ``[s L/pp, (s+1) L/pp)`` of the weights and of the pool, and a
forward walks the stages, handing the residual stream on at each
boundary. What is held to what:

* the mesh: each stage's ranks, its own mesh of the other axes, the
  hand-off's values and its gradient (``gradcheck``), the layer ranges
  and the refusal of a ``pp`` that does not divide the layers (as the
  JAX package's placement refuses it);
* the rank slices equal the JAX ``NamedSharding`` shards on the same
  plan, and a seed draws on a ``pp`` mesh the numbers it draws on one
  device (int8 too);
* every forward on ``pp`` 2 equal BIT FOR BIT to one rank (each layer runs
  the same functions at the same shapes), and on ``pp`` 2 and ``pp`` 2 x
  ``tp`` 2 within the tp tests' 2e-4 (atol and rtol, float32) of the JAX
  functions; the pools joined over the stages (and heads) likewise;
* the engine on ``pp`` 2 and ``pp`` 2 x ``tp`` 2, bucketed and packed:
  greedy tokens equal the JAX ``InferenceEngine``'s on the same
  ``MeshPlan`` and the port's one-rank engine's; int8 serves on ``pp`` as
  the JAX package does; a level-1 sleep's ``bytes_offloaded`` equals the
  JAX ``SleepManager``'s on the same mesh and the port's at ``pp`` 1,
  with every state address kept and the tokens unchanged after the wake;
* ``tiny_moe`` on ``pp`` 2 and ``pp`` 2 x ``ep`` 2 against the JAX engine;
* ``train_step`` on ``pp`` 2, ``pp`` 2 x ``tp`` 2 and ``dp`` 2 x ``pp`` 2
  against the JAX step on one device, to ``tests/test_torch_train.py``'s
  tolerances;
* an ``hf:`` directory and an Orbax checkpoint placed on a ``pp`` mesh:
  each stage receives only its layers, the one-rank model's slices.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.engine import sleep as jsleep
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu.models import moe as jmoe
from llm_d_fast_model_actuation_tpu.models import train as jtrain
from llm_d_fast_model_actuation_tpu.models.registry import init_params_for
from llm_d_fast_model_actuation_tpu.parallel import mesh as jmesh
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import kv_cache as tkv
from llm_d_fast_model_actuation_tpu_torch.engine import sleep as tsleep
from llm_d_fast_model_actuation_tpu_torch.models import checkpoint as tck
from llm_d_fast_model_actuation_tpu_torch.models import hf as thf
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models import moe as tmoe
from llm_d_fast_model_actuation_tpu_torch.models import train as ttrain
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.parallel import mesh as tmesh
from tests.conftest import build_sharded_hf_model_dir
from tests.test_torch_train import LOGITS_ATOL, LOSS_RTOL, _compare_state, _grads_near_zero, _np

TOL = 2e-4  # float32, as tests/test_torch_parallel.py states for tp
PS, PPS = 8, 4  # page size, pages per sequence
L = 4
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [3, 1, 4]]
PLANS = {"pp2": dict(pp=2), "pp2tp2": dict(pp=2, tp=2)}


def _mesh(**plan):
    p = tmesh.MeshPlan(**plan)
    return tmesh.make_mesh(p, ["cpu"] * p.size)


def _jax_cfg(impl="grouped", quantization="", moe=False):
    base = jmoe.MoeConfig.tiny_moe() if moe else jllama.LlamaConfig.tiny()
    return dataclasses.replace(base, num_layers=L, dtype=jnp.float32, attention_impl=impl, quantization=quantization)


def _tree(jcfg, seed=0):
    """The JAX package's draw, with random norms so a layer or a slice
    taken from the wrong stage shows."""
    tree = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(7)
    for name, leaf in tree["layers"].items():
        if "norm" in name:
            tree["layers"][name] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
    tree["final_norm"] = (tree["final_norm"] + 0.1 * rng.standard_normal(tree["final_norm"].shape)).astype(np.float32)
    return tree


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=TOL)


def _table(b):
    return np.arange(1, 1 + b * PPS, dtype=np.int32).reshape(b, PPS)


# -- the mesh --------------------------------------------------------------------

MESH_PLANS = [dict(pp=2), dict(pp=2, tp=2), dict(dp=2, pp=2), dict(pp=4), dict(pp=2, ep=2), dict(pp=2, sp=2)]


def _ids(p):
    return ",".join(f"{k}={v}" for k, v in p.items())


@pytest.mark.parametrize("plan", MESH_PLANS, ids=_ids)
def test_stages_follow_the_references_device_layout(plan, devices8):
    """Rank r sits where the JAX mesh puts the r-th device; a stage's ranks
    are those at its ``pp`` coordinate, in rank order, and its own mesh
    gives its j-th rank the coordinates off ``pp`` of the stage's j-th."""
    mesh = _mesh(**plan)
    jp = jmesh.MeshPlan(**plan)
    jm = jmesh.make_mesh(jp, devices8[: jp.size])
    ids = [d.id for d in devices8[: jp.size]]
    for r in range(mesh.size):
        idx = tuple(mesh.coords(r)[a] for a in tmesh.AXES)
        assert jm.devices[idx].id == ids[r]
    seen = []
    for s in range(mesh.pp):
        ranks = mesh.stage_ranks(s)
        sm = mesh.stage_mesh(s)
        assert sm is mesh.stage_mesh(s) and sm.pp == 1 and sm.size == mesh.size // mesh.pp
        for j, r in enumerate(ranks):
            assert mesh.stage(r) == s
            assert sm.coords(j) == dict(mesh.coords(r), pp=0)
        seen += ranks
    assert sorted(seen) == list(range(mesh.size))
    # a stage's tp group is a tp group of the whole mesh
    s_last = mesh.stage_ranks(mesh.pp - 1)
    assert [[s_last[j] for j in g] for g in mesh.stage_mesh(mesh.pp - 1).groups("tp")] == [
        g for g in mesh.groups("tp") if g[0] in s_last
    ]


def test_without_pp_a_stage_is_the_mesh_itself():
    mesh = _mesh(tp=2)
    assert mesh.pp == 1 and mesh.stage_mesh(0) is mesh and mesh.stage_ranks(0) == [0, 1]


@pytest.mark.parametrize("plan", [dict(pp=2), dict(pp=4), dict(dp=2, pp=2)], ids=_ids)
def test_hand_off_moves_each_stage_to_the_next(plan):
    mesh = _mesh(**plan)
    parts = [torch.full((3,), float(r)) for r in range(mesh.size)]
    out = mesh.hand_off(parts)
    for g in mesh.groups("pp"):
        assert out[g[0]] is None  # the first stage receives nothing
        for src, dst in zip(g, g[1:]):
            assert out[dst] is parts[src]  # one device: the same tensor, no copy
    with pytest.raises(ValueError, match="per-rank tensors"):
        mesh.hand_off(parts[:1])


def test_hand_off_is_differentiable():
    mesh = _mesh(pp=2)

    def f(a, b):
        out = mesh.hand_off([a, b])
        return out[1] * 3.0

    a = torch.randn(4, dtype=torch.float64, requires_grad=True)
    b = torch.randn(4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(f, (a, b))
    f(a, b).sum().backward()
    assert torch.equal(a.grad, torch.full((4,), 3.0, dtype=torch.float64)) and b.grad is None


def test_stage_layers_cut_the_layers_as_the_layers_rule():
    assert [tmesh.stage_layers(8, 4, s) for s in range(4)] == [range(0, 2), range(2, 4), range(4, 6), range(6, 8)]
    assert tmesh.stage_layers(32, 1, 0) == range(32)
    with pytest.raises(ValueError, match="num_layers=3 is not divisible by pp=2"):
        tmesh.stage_layers(3, 2, 0)


def test_a_pp_that_does_not_divide_the_layers_is_refused_as_the_reference_refuses_it(devices8):
    # the JAX package: MeshPlan(pp=4) on the two-layer tiny model fails its placement
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    ecfg = jengine.EngineConfig(model=jcfg, max_batch=2, page_size=8, num_pages=32, max_seq_len=64)
    with pytest.raises(ValueError):
        jengine.InferenceEngine(ecfg, mesh=jmesh.make_mesh(jmesh.MeshPlan(pp=4), devices8[:4]), seed=0)
    cfg = config_from_jax(jcfg)
    tcfg = tengine.EngineConfig(model=cfg, max_batch=2, page_size=8, num_pages=32, max_seq_len=64)
    with pytest.raises(ValueError, match="num_layers=2 is not divisible by pp=4"):
        tengine.InferenceEngine(tcfg, seed=0, mesh=_mesh(pp=4))
    with pytest.raises(ValueError, match="num_layers=2 is not divisible by pp=4"):
        tllama.ShardedLlama(cfg, _mesh(pp=4))
    with pytest.raises(ValueError, match="num_layers=2 is not divisible by pp=4"):
        tllama.shard_config(cfg, 1, pp=4)
    with pytest.raises(ValueError, match="num_layers=2 is not divisible by pp=4"):
        tkv.PagePool.create(2, 8, 8, 2, 16, mesh=_mesh(pp=4))
    # and what divides is built: pp 2 over the same two layers, one each
    two = tllama.ShardedLlama(cfg, _mesh(pp=2))
    assert [m.cfg.num_layers for m in two.ranks] == [1, 1]


def test_dp_and_sp_stay_refused_by_the_serving_model():
    for axis in ("dp", "sp"):
        with pytest.raises(ValueError, match="pp, tp and ep only"):
            tllama.ShardedLlama(tllama.LlamaConfig.tiny(), _mesh(pp=2, **{axis: 2}))


# -- the model -------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pp_meshes(devices8):
    return {k: jmesh.make_mesh(jmesh.MeshPlan(**p), devices8[: jmesh.MeshPlan(**p).size]) for k, p in PLANS.items()}


@pytest.mark.parametrize("plan", list(PLANS))
def test_rank_slices_equal_the_jax_shards(plan, jax_pp_meshes):
    jcfg = _jax_cfg()
    cfg = config_from_jax(jcfg)
    tree = _tree(jcfg)
    jm = jax_pp_meshes[plan]
    placed = jmesh.shard_pytree(jax.tree.map(jnp.asarray, tree), jm, jllama.param_logical_axes(jcfg))
    mesh = _mesh(**PLANS[plan])
    state = params_from_jax(tree, mesh=mesh, cfg=cfg)
    order = list(jm.devices.reshape(-1))
    flat = {f"layers.{k}": v for k, v in placed["layers"].items()}
    flat.update({k: v for k, v in placed.items() if k != "layers"})
    for pname, arr in flat.items():
        shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for r in range(mesh.size):
            np.testing.assert_array_equal(state[f"ranks.{r}.{pname}"].numpy(), shards[order[r]])
    model = tllama.ShardedLlama(cfg, mesh)
    model.load_state_dict(state, strict=True)
    for r, m in enumerate(model.ranks):
        assert m.layers["wq"].shape[0] == L // 2 and m.cfg.num_layers == L // 2
        start = mesh.stage(r) * (L // 2)
        want = tree["layers"]["attn_norm"][start:start + L // 2]
        np.testing.assert_array_equal(m.layers["attn_norm"].numpy(), want)


@pytest.mark.parametrize("quantization", ["", "int8"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_a_seed_gives_a_pipeline_the_numbers_it_gives_one_device(plan, quantization):
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), num_layers=L, quantization=quantization,
                              dtype=torch.bfloat16 if quantization else torch.float32)
    mesh = _mesh(**PLANS[plan])
    one = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    many = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu", mesh=mesh)
    want = tllama.shard_params(one.state_dict(), cfg, mesh)
    got = many.state_dict()
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # the replicas are the leaves no layer stack holds, past the first stage
    # (and every norm past the first tp rank)
    reps = {id(p) for p in many.replicas()}
    for r, m in many.ranks.held():
        for name, p in m.named_parameters():
            if mesh.stage(r) > 0 and not name.startswith("layers."):
                assert id(p) in reps, (r, name)
            if name.startswith("layers.") and mesh.index(r, "tp") == 0:
                assert id(p) not in reps, (r, name)


def _models(plan, impl="grouped"):
    jcfg = _jax_cfg(impl)
    tree = _tree(jcfg)
    cfg = config_from_jax(jcfg)
    one = tllama.Llama(cfg, "cpu")
    one.load_state_dict(params_from_jax(tree), strict=True)
    mesh = _mesh(**PLANS[plan])
    many = tllama.ShardedLlama(cfg, mesh)
    many.load_state_dict(params_from_jax(tree, mesh=mesh, cfg=cfg), strict=True)
    return jcfg, jax.tree.map(jnp.asarray, tree), one, many


def _pools(cfg, num_pages, mesh, rng=None):
    """The same pool for JAX, for one rank and, cut into each rank's stage
    layers and KV-head slice, for the mesh."""
    shape = (cfg.num_layers, num_pages, PS, cfg.num_kv_heads, cfg.head_dim)
    k, v = (np.zeros(shape, np.float32) if rng is None else rng.standard_normal(shape).astype(np.float32)
            for _ in range(2))
    per, heads = cfg.num_layers // mesh.pp, cfg.num_kv_heads // mesh.tp
    shards = []
    for r in range(mesh.size):
        s, t = mesh.stage(r), mesh.index(r, "tp")
        shards.append(tuple(torch.from_numpy(a[s * per:(s + 1) * per, :, :, t * heads:(t + 1) * heads].copy())
                            for a in (k, v)))
    return (jnp.asarray(k), jnp.asarray(v)), (torch.from_numpy(k.copy()), torch.from_numpy(v.copy())), shards


def _joined(mesh, shards, i):
    """Direction ``i`` (k or v) of a mesh's pool, joined over the stages'
    layers and the tp ranks' heads."""
    stages = []
    for s in range(mesh.pp):
        ranks = [r for r in mesh.stage_ranks(s) if mesh.index(r, "ep") == 0]
        stages.append(torch.cat([shards[r][i] for r in ranks], dim=3))
    return torch.cat(stages, dim=0)


def _pools_close(mesh, jcache, c1, cm, exact):
    for i in range(2):
        joined = _joined(mesh, cm, i)
        if exact:
            assert torch.equal(joined[:, 1:], c1[i][:, 1:])
        _close(joined[:, 1:], c1[i][:, 1:])
        _close(joined[:, 1:], np.asarray(jcache[i])[:, 1:])


def _same(got, one, exact):
    if exact:
        assert torch.equal(got, one)
    _close(got, one)


@pytest.mark.parametrize("plan", list(PLANS))
def test_prefill_suffix_and_decode_match_one_rank_and_jax(plan):
    """pp 2 is bit-equal to one rank; pp 2 x tp 2 sums its row-parallel
    products in two halves, as tp 2 does. Both within 2e-4 of JAX."""
    jcfg, jparams, one, many = _models(plan)
    mesh, exact = many.mesh, plan == "pp2"
    rng = np.random.default_rng(0)
    b = 2
    tokens = rng.integers(0, jcfg.vocab_size, (b, 16)).astype(np.int32)
    lens = np.array([16, 9], dtype=np.int32)
    pt = _table(b)
    jcache, c1, cm = _pools(jcfg, b * PPS + 1, mesh)
    T = torch.from_numpy

    eight = np.array([8, 8], dtype=np.int32)
    jl, jcache = jllama.prefill(jparams, jcfg, jnp.asarray(tokens[:, :8]), jnp.asarray(eight), jcache, jnp.asarray(pt))
    l1 = tllama.prefill(one, T(tokens[:, :8]), T(eight), c1, T(pt))
    lm = tllama.prefill(many, T(tokens[:, :8]), T(eight), cm, T(pt))
    assert lm.shape == (b, 8, jcfg.vocab_size) and lm.dtype == torch.float32
    _same(lm, l1, exact)
    _close(lm, jl)
    _pools_close(mesh, jcache, c1, cm, exact)
    last = tllama.prefill(many, T(tokens[:, :8]), T(eight), [tuple(t.clone() for t in c) for c in cm], T(pt),
                          last_only=True)
    _same(last[:, 0], lm[:, 7], exact)

    suf, suf_lens = tokens[:, 8:16].copy(), lens - 8
    jl, jcache = jllama.prefill_continue(
        jparams, jcfg, jnp.asarray(suf), jnp.asarray(eight), jnp.asarray(suf_lens), jcache, jnp.asarray(pt)
    )
    l1 = tllama.prefill_continue(one, T(suf), T(eight), T(suf_lens), c1, T(pt))
    lm = tllama.prefill_continue(many, T(suf), T(eight), T(suf_lens), cm, T(pt))
    for r in range(b):  # padding queries are garbage on every side
        _same(lm[r, : suf_lens[r]], l1[r, : suf_lens[r]], exact)
        _close(lm[r, : suf_lens[r]], np.asarray(jl)[r, : suf_lens[r]])
    _pools_close(mesh, jcache, c1, cm, exact)

    nxt, pos = np.array([5, 7], dtype=np.int32), lens.copy()
    for active in (None, np.array([True, False])):
        ja = None if active is None else jnp.asarray(active)
        ta = None if active is None else T(active)
        jl, jcache = jllama.decode_step(jparams, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jcache, jnp.asarray(pt), ja)
        l1 = tllama.decode_step(one, T(nxt), T(pos), c1, T(pt), ta)
        lm = tllama.decode_step(many, T(nxt), T(pos), cm, T(pt), ta)
        _same(lm, l1, exact)
        _close(lm, jl)
        _pools_close(mesh, jcache, c1, cm, exact)
        pos = pos + 1


@pytest.mark.parametrize("plan", list(PLANS))
def test_scatter_first_decode_step_matches_one_rank_and_jax(plan):
    jcfg, jparams, one, many = _models(plan, impl="reference")
    mesh, exact = many.mesh, plan == "pp2"
    rng = np.random.default_rng(5)
    b = 3
    jcache, c1, cm = _pools(jcfg, b * PPS + 1, mesh, rng)
    pt = _table(b)
    pos = np.array([0, 9, 30], dtype=np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, b).astype(np.int32)
    T = torch.from_numpy
    for active in (None, np.array([True, False, True])):
        ja = None if active is None else jnp.asarray(active)
        ta = None if active is None else T(active)
        jl, jcache = jllama.decode_step(jparams, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jcache, jnp.asarray(pt), ja)
        l1 = tllama.decode_step(one, T(nxt), T(pos), c1, T(pt), ta)
        lm = tllama.decode_step(many, T(nxt), T(pos), cm, T(pt), ta)
        _same(lm, l1, exact)
        _close(lm, jl)
        _pools_close(mesh, jcache, c1, cm, exact)
        pos = pos + 1


@pytest.mark.parametrize("plan", list(PLANS))
def test_mixed_step_matches_one_rank_and_jax(plan, monkeypatch):
    jcfg, jparams, one, many = _models(plan)
    mesh, exact = many.mesh, plan == "pp2"
    rng = np.random.default_rng(4)
    row_slot = np.full(40, -1, np.int32)
    positions = np.zeros(40, np.int32)
    row_slot[0:11], positions[0:11] = 0, np.arange(11)  # a cold segment across a page
    row_slot[16], positions[16] = 1, 13  # a decode row on a partial page
    row_slot[24:29], positions[24:29] = 2, 7 + np.arange(5)  # a suffix from position 7
    tokens = rng.integers(0, jcfg.vocab_size, 40).astype(np.int32)
    pt = _table(3)
    jcache, c1, cm = _pools(jcfg, 3 * PPS + 1, mesh, rng)
    T = torch.from_numpy
    calls = []
    real = tllama.ragged_paged_attention_sharded
    monkeypatch.setattr(tllama, "ragged_paged_attention_sharded",
                        lambda m, q, *a: calls.append((m.size, m.pp)) or real(m, q, *a))
    jl, jcache = jllama.mixed_step(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(row_slot), jnp.asarray(positions), jcache, jnp.asarray(pt)
    )
    l1 = tllama.mixed_step(one, T(tokens), T(row_slot), T(positions), c1, T(pt)[:, :2])
    lm = tllama.mixed_step(many, T(tokens), T(row_slot), T(positions), cm, T(pt)[:, :2])
    valid = T(row_slot >= 0)
    _same(lm[valid], l1[valid], exact)
    _close(lm[valid], np.asarray(jl)[row_slot >= 0])
    _pools_close(mesh, jcache, c1, cm, exact)
    # with tp, once per layer on the stage's own mesh of its tp ranks; a
    # stage of one rank runs the kernel itself, as one device does
    assert calls == ([(mesh.tp, 1)] * L if mesh.tp > 1 else [])


# -- the engine ------------------------------------------------------------------


def _ecfgs(moe=False, quantization="", **kw):
    jm = _jax_cfg(impl="reference", moe=moe, quantization=quantization)  # the JAX config's own default
    base = dict(max_batch=2, page_size=8, num_pages=32, max_seq_len=64, **kw)
    return jengine.EngineConfig(model=jm, **base), tengine.EngineConfig(model=config_from_jax(jm), **base)


@pytest.fixture(scope="module")
def jax_engines(devices8):
    """The JAX engines this file holds the port to, built once: one device,
    and ``pp`` 2 and ``pp`` 2 x ``tp`` 2 (bucketed and packed), with their
    greedy tokens and their level-1 sleep bytes."""
    out = {}
    for key, plan, kw in (("one", None, {}), ("pp2", PLANS["pp2"], {}), ("pp2tp2", PLANS["pp2tp2"], {}),
                          ("pp2-packed", PLANS["pp2"], dict(packed_serving=True))):
        jcfg, _ = _ecfgs(**kw)
        jp = None if plan is None else jmesh.MeshPlan(**plan)
        mesh = None if jp is None else jmesh.make_mesh(jp, devices8[: jp.size])
        eng = jengine.InferenceEngine(jcfg, mesh=mesh, seed=0)
        tree = jax.tree.map(np.asarray, eng.params)
        tokens = eng.generate(PROMPTS, max_new_tokens=6)
        out[key] = dict(tree=tree, tokens=tokens, sleep=jsleep.attach_sleep(eng).sleep(1)["bytes_offloaded"])
    return out


def _port_engine(plan, tree, **kw):
    _, tcfg = _ecfgs(**kw)
    if plan is None:
        return tengine.InferenceEngine(tcfg, params=params_from_jax(tree), device="cpu")
    mesh = _mesh(**plan)
    return tengine.InferenceEngine(tcfg, params=params_from_jax(tree, mesh=mesh, cfg=tcfg.model), mesh=mesh)


def test_the_jax_engines_agree_across_their_meshes(jax_engines):
    gold = jax_engines["one"]["tokens"]
    assert len(set(map(tuple, gold))) == 2 and len(set(gold[0])) > 1  # not a degenerate run
    for key in ("pp2", "pp2tp2", "pp2-packed"):
        assert jax_engines[key]["tokens"] == gold, key


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_the_engine_on_pp_gives_the_jax_engines_tokens(plan, packed, jax_engines):
    key = plan + ("-packed" if packed and plan == "pp2" else "")
    want = jax_engines[key]["tokens"] if key in jax_engines else jax_engines["one"]["tokens"]
    tree = jax_engines["one"]["tree"]
    eng = _port_engine(PLANS[plan], tree, packed_serving=packed)
    assert isinstance(eng.model, tllama.ShardedLlama) and eng.model.mesh.pp == 2
    assert eng.generate(PROMPTS, max_new_tokens=6) == want
    assert (eng.packed_steps > 0) == packed
    assert eng.mixed_impl == ("ragged" if plan == "pp2" else "ragged_sharded")
    assert _port_engine(None, tree, packed_serving=packed).generate(PROMPTS, max_new_tokens=6) == want
    # the pool holds each stage's layers: the global size once
    for r, (k, v) in enumerate(eng.pool.shards):
        assert k.shape[0] == L // 2 and k.shape[3] == 2 // PLANS[plan].get("tp", 1)
    assert eng.pool.nbytes() == tkv.PagePool.estimate_nbytes(L, 32, 8, 2, 16, dtype=torch.float32)


MIXED_PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [4] * 16, [7, 6, 5, 4, 3, 2, 1] * 3]


def _seeded(plan, **kw):
    m = dataclasses.replace(tllama.LlamaConfig.tiny(), num_layers=L, dtype=torch.float32)
    cfg = tengine.EngineConfig(model=m, max_batch=2, page_size=8, num_pages=32, max_seq_len=64, **kw)
    if plan is None:
        return tengine.InferenceEngine(cfg, seed=0, device="cpu")
    return tengine.InferenceEngine(cfg, seed=0, mesh=_mesh(**plan))


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_retires_readmits_prefix_hits_and_penalties_on_pp_equal_one_rank(plan, packed):
    """Four prompts through two slots, a chunked prefill with a prefix-cache
    hit and sampling penalties: the pipeline's tokens equal one rank's."""
    def run(p):
        eng = _seeded(p, packed_serving=packed, max_prefill_tokens=6)
        out = eng.generate(MIXED_PROMPTS, max_new_tokens=8)
        shared = list(range(100, 124))
        out.append(eng.generate([shared + [1, 2]], max_new_tokens=6)[0])
        ids = [eng.add_request(shared + [3], 6, presence_penalty=0.5, frequency_penalty=0.3),
               eng.add_request([2, 7, 1, 8, 2, 8], 8, temperature=0.8, seed=11)]
        done = {}
        while eng.has_work():
            for r in eng.step():
                done[r.seq_id] = r.out_tokens
        assert eng.prefix_cache.stats()["hits"] >= 1
        return out + [done[i] for i in ids]

    assert run(PLANS[plan]) == run(None)


@pytest.mark.parametrize("plan", list(PLANS))
def test_level1_sleep_on_pp_counts_the_references_bytes(plan, jax_engines):
    tree = jax_engines["one"]["tree"]
    eng = _port_engine(PLANS[plan], tree)
    gold = eng.generate(PROMPTS, max_new_tokens=6)
    objects = list(eng.model.parameters()) + eng.pool.tensors()
    before = [(id(t), t.device, tuple(t.shape), t.data_ptr()) for t in objects]
    mgr = tsleep.attach_sleep(eng)
    info = mgr.sleep(1)
    assert eng.asleep and all(a.mapped_bytes == 0 for a in eng.arenas.values())
    # the JAX SleepManager's on the same mesh, and the port's on one rank
    assert info["bytes_offloaded"] == jax_engines[plan]["sleep"] == jax_engines["one"]["sleep"] > 0
    assert info["bytes_offloaded"] == tsleep.attach_sleep(_port_engine(None, tree)).sleep(1)["bytes_offloaded"]
    mgr.wake_up()
    assert [(id(t), t.device, tuple(t.shape), t.data_ptr()) for t in objects] == before
    assert eng.generate(PROMPTS, max_new_tokens=6) == gold
    # level 2: the weights drawn anew from the seed, each stage its own layers
    seeded = _seeded(PLANS[plan])
    gold = seeded.generate(PROMPTS, max_new_tokens=6)
    mgr = tsleep.attach_sleep(seeded)
    mgr.sleep(2)
    seeded.abort_all("level-2 sleep discarded state")
    mgr.wake_up(reinit=lambda: tsleep.fresh_state(seeded))
    assert seeded.generate(PROMPTS, max_new_tokens=6) == gold


@pytest.mark.parametrize("plan", list(PLANS))
def test_int8_serves_on_pp_as_the_jax_package_does(plan, devices8):
    jcfg, tcfg = _ecfgs(quantization="int8")
    jp = jmesh.MeshPlan(**PLANS[plan])
    jeng = jengine.InferenceEngine(jcfg, mesh=jmesh.make_mesh(jp, devices8[: jp.size]), seed=0)
    want = jeng.generate(PROMPTS, max_new_tokens=6)
    tree = jax.tree.map(np.asarray, jeng.params)
    mesh = _mesh(**PLANS[plan])
    eng = tengine.InferenceEngine(tcfg, params=params_from_jax(tree, mesh=mesh, cfg=tcfg.model), mesh=mesh)
    for m in eng.model.ranks:
        assert m.layers["wq"]["q"].dtype == torch.int8 and m.layers["wq"]["q"].shape[0] == L // 2
        assert m.layers["wq"]["s"].shape[0] == L // 2
    assert eng.generate(PROMPTS, max_new_tokens=6) == want
    one = tengine.InferenceEngine(tcfg, params=params_from_jax(tree), device="cpu")
    assert one.generate(PROMPTS, max_new_tokens=6) == want
    assert tsleep.attach_sleep(eng).sleep(1)["bytes_offloaded"] == jsleep.attach_sleep(jeng).sleep(1)["bytes_offloaded"]


@pytest.mark.parametrize("plan", [dict(pp=2), dict(pp=2, ep=2)], ids=_ids)
def test_moe_on_pp_and_ep_gives_the_jax_engines_tokens(plan, devices8):
    jcfg, tcfg = _ecfgs(moe=True)
    jeng = jengine.InferenceEngine(jcfg, seed=0)
    gold = jeng.generate(PROMPTS, max_new_tokens=6)
    tree = jax.tree.map(np.asarray, jeng.params)
    jp = jmesh.MeshPlan(**plan)
    jpp = jengine.InferenceEngine(jcfg, mesh=jmesh.make_mesh(jp, devices8[: jp.size]), seed=0)
    assert jpp.generate(PROMPTS, max_new_tokens=6) == gold
    mesh = _mesh(**plan)
    for packed in (False, True):
        cfg = dataclasses.replace(tcfg, packed_serving=packed)
        eng = tengine.InferenceEngine(cfg, params=params_from_jax(tree, mesh=mesh, cfg=tcfg.model), mesh=mesh)
        for r, m in enumerate(eng.model.ranks):
            assert m.layers["w_gate"].shape[:2] == (L // 2, 4 // plan.get("ep", 1))
        assert eng.generate(PROMPTS, max_new_tokens=6) == gold, packed


# -- training --------------------------------------------------------------------

TRAIN_MESHES = [dict(pp=2), dict(pp=2, tp=2), dict(dp=2, pp=2)]


@pytest.fixture(scope="module")
def jax_step():
    jc = dataclasses.replace(jllama.LlamaConfig.tiny(), num_layers=L, dtype=jnp.float32)
    jp = init_params_for(jax.random.key(6), jc)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jc.vocab_size, (4, 16)).astype(np.int32)
    seq_lens = np.asarray([16, 11, 8, 3], np.int32)
    opt = jtrain.make_optimizer()
    js, jm = jtrain.train_step(jtrain.make_train_state(jp, opt), jc, jnp.asarray(tokens), jnp.asarray(seq_lens), opt)
    logits = jtrain.forward_train(jp, jc, jnp.asarray(tokens), jnp.asarray(seq_lens))
    return dict(jc=jc, jp=jp, tokens=tokens, seq_lens=seq_lens, js=js, jm=jm, logits=logits,
                near_zero=_grads_near_zero(jp, jc, tokens, seq_lens))


@pytest.mark.parametrize("copies", [False, True], ids=["shared", "copies"])
@pytest.mark.parametrize("plan", TRAIN_MESHES, ids=_ids)
def test_train_step_on_pp_matches_the_reference_on_one_device(plan, copies, jax_step):
    j = jax_step
    tc = config_from_jax(j["jc"])
    mplan = tmesh.MeshPlan(**plan)
    mesh = tmesh.make_mesh(mplan, ["cpu"] * mplan.size)
    sharded = ttrain.shard_train_params(params_from_jax(_np(j["jp"])), tc, mesh)
    if copies:  # every rank its own tensor, as ranks on separate cards hold them
        sharded = {k: [t.clone() for t in v] for k, v in sharded.items()}
    for r in range(mesh.size):  # each rank holds its stage's layers
        assert sharded["layers.wq"][r].shape[0] == L // 2
    tokens, seq_lens = torch.from_numpy(j["tokens"]), torch.from_numpy(j["seq_lens"])
    logits = ttrain.forward_train(sharded, tc, tokens, seq_lens, mesh=mesh)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j["logits"]), atol=LOGITS_ATOL, rtol=0)
    loss = ttrain.lm_loss(sharded, tc, tokens, seq_lens, mesh=mesh)
    assert loss.device == mesh.devices[0]
    ts, tm = ttrain.train_step(ttrain.make_train_state(sharded), tc, tokens, seq_lens, mesh=mesh)
    np.testing.assert_allclose(float(tm["loss"]), float(j["jm"]["loss"]), rtol=LOSS_RTOL)
    whole = ttrain.TrainState(
        step=ts.step,
        params=ttrain.unshard_train_params(ts.params, tc, mesh, "cpu"),
        opt_state=ttrain.AdamState(ts.opt_state.count, ttrain.unshard_train_params(ts.opt_state.mu, tc, mesh, "cpu"),
                                   ttrain.unshard_train_params(ts.opt_state.nu, tc, mesh, "cpu")),
    )
    _compare_state(whole, j["js"], f"tiny {mplan.describe()}", near_zero=j["near_zero"])
    # the replicas of a weight stay equal to each other after the step: the
    # embedding and head of both stages too
    for k, per in ts.params.items():
        spec = tllama.param_specs(tc)[k]
        for r in range(mesh.size):
            assert torch.equal(per[r], per[tmesh.replica_of(spec, mesh, r)]), (k, r)


# -- checkpoints onto a pipeline ---------------------------------------------------


@pytest.mark.parametrize("quantization", ["", "int8"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_an_hf_directory_lands_on_pp_as_one_ranks_slices(tmp_path, plan, quantization):
    d = build_sharded_hf_model_dir(str(tmp_path / "m"))
    cfg = dataclasses.replace(thf.config_from_hf(d), quantization=quantization)
    assert cfg.num_layers == L
    one = tllama.Llama(cfg, "cpu")
    thf.load_params(d, one)
    mesh = _mesh(**PLANS[plan])
    many = tllama.ShardedLlama(cfg, mesh)
    thf.load_params(d, many)
    want = tllama.shard_params(one.state_dict(), cfg, mesh)
    got = many.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert thf.model_digests(many) == thf.model_digests(one)


def test_an_orbax_checkpoint_restores_onto_pp_as_one_ranks_slices(tmp_path):
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), num_layers=L, dtype=torch.float32)
    src = tllama.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    d = str(tmp_path / "ck")
    tck.save_params(d, cfg, src)
    assert os.path.isdir(d)
    state = src.state_dict()
    specs = tllama.param_specs(cfg)
    for plan in PLANS.values():
        mesh = _mesh(**plan)
        model = tllama.ShardedLlama(cfg, mesh)
        tck.load_params(d, model)
        for r, rank in enumerate(model.ranks):
            for name, t in rank.named_parameters():
                assert torch.equal(t, tmesh.shard_for(state[name], specs[name], mesh, r)), (r, name)
        # and written back from the pipeline, the same checkpoint
        again = str(tmp_path / f"again-{mesh.size}")
        tck.save_params(again, cfg, model)
        back = tllama.Llama(cfg, "cpu")
        tck.load_params(again, back)
        assert all(torch.equal(back.state_dict()[k], state[k]) for k in state)

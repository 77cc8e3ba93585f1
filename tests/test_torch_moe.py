"""The port's MoE family (models/moe.py) against the JAX package's, on
the CPU, at ``tiny_moe`` size.

* The config, its presets and parameter count, the parameter layout and
  logical axes, field for field.
* ``moe_ffn`` on numpy-seeded inputs against the reference's: fp32 within
  1e-5 of the largest output (another summation order), bf16 within one
  bf16 step (2^-7) of it (both round the same products once each); a
  router whose logits tie exactly picks the lower expert index, as
  ``jax.lax.top_k`` does.
* The engine on the reference's own weights (``params_from_jax``) at fp32,
  where bf16 near-ties cannot decide a greedy token: its tokens equal the
  JAX engine's, batched equals single; routing depends on the input; a
  level-1 and a level-2 cycle give the same tokens; a ``--sleep-quant
  int8`` cycle moves the reference's payload bits; packed serving
  against bucketed; tp 2 on a ``cpu,cpu`` mesh against tp 1; ``pp``
  and an uneven ``ep`` refused, naming what they wait on (``ep`` itself:
  ``tests/test_torch_moe_ep.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.engine import sleep as jsleep
from llm_d_fast_model_actuation_tpu.models import moe as jmoe
from llm_d_fast_model_actuation_tpu.models.registry import init_params_for, logical_axes_for
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import sleep as tsleep
from llm_d_fast_model_actuation_tpu_torch.models import hf as thf
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models import moe as tmoe
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.parallel import mesh as tmesh
from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import serving_mesh

PROMPTS = [[5, 9, 200, 3, 77], list(range(10, 31)), [42]]


def _torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _cfgs(dtype=jnp.float32, **kw):
    jm = dataclasses.replace(jmoe.MoeConfig.tiny_moe(), dtype=dtype)
    base = dict(max_batch=4, page_size=8, num_pages=48, max_seq_len=64)
    base.update(kw)
    return jengine.EngineConfig(model=jm, **base), tengine.EngineConfig(model=config_from_jax(jm), **base)


def _engines(dtype=jnp.float32, **kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    jeng = jengine.InferenceEngine(jcfg, seed=0)
    state = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    return jeng, tengine.InferenceEngine(tcfg, params=state, device="cpu")


def _port(dtype=torch.float32, **kw):
    m = dataclasses.replace(tmoe.MoeConfig.tiny_moe(), dtype=dtype)
    base = dict(max_batch=4, page_size=8, num_pages=64, max_seq_len=128)
    base.update(kw)
    return tengine.InferenceEngine(tengine.EngineConfig(model=m, **base), seed=0, device="cpu")


@pytest.mark.parametrize("preset", ["tiny_moe", "mixtral_8x7b"])
def test_config_presets_and_parameter_count_equal_the_references(preset):
    want = getattr(jmoe.MoeConfig, preset)()
    got = getattr(tmoe.MoeConfig, preset)()
    assert config_from_jax(want) == got and tllama.is_moe(got)
    assert got.num_params() == want.num_params()
    shapes = tllama.param_shapes(got)
    assert sum(int(np.prod(s)) for s in shapes.values()) == got.num_params()
    assert not tllama.is_moe(tllama.LlamaConfig.tiny())


def test_parameter_layout_and_axes_equal_the_references():
    cfg = jmoe.MoeConfig.tiny_moe()
    tree = init_params_for(jax.random.key(0), cfg)
    want = {}
    for name, leaf in tree.items():
        for key, sub in ({f"layers.{k}": v for k, v in leaf.items()} if name == "layers" else {name: leaf}).items():
            want[key] = tuple(sub.shape)
    assert tllama.param_shapes(config_from_jax(cfg)) == want
    assert tllama.param_logical_axes(config_from_jax(cfg)) == logical_axes_for(cfg)
    specs = tllama.param_specs(config_from_jax(cfg))
    assert "tp" not in specs["layers.router"] and specs["layers.w_gate"].index("tp") == 3
    assert specs["layers.w_down"].index("tp") == 2


def _ffn_inputs(dtype, rows=6, seed=0):
    cfg = dataclasses.replace(jmoe.MoeConfig.tiny_moe(), dtype=jnp.dtype(dtype))
    h, f, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) * fan_in**-0.5).astype(np_dt)

    lp = {"router": w(h, E, fan_in=h), "w_gate": w(E, h, f, fan_in=h), "w_up": w(E, h, f, fan_in=h),
          "w_down": w(E, f, h, fan_in=f)}
    x = rng.standard_normal((2, rows, h)).astype(np_dt)
    return cfg, lp, x


def _both(cfg, lp, x):
    want = np.asarray(jmoe.moe_ffn(cfg, jax.tree.map(jnp.asarray, lp), jnp.asarray(x))).astype(np.float32)
    got = tmoe.moe_ffn(config_from_jax(cfg), {k: _torch(v) for k, v in lp.items()}, _torch(x))
    assert got.dtype == _torch(x).dtype and tuple(got.shape) == x.shape
    return got.float().numpy(), want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_the_reference(dtype):
    cfg, lp, x = _ffn_inputs(dtype)
    got, want = _both(cfg, lp, x)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        assert np.abs(got - want).max() <= 2**-7 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_router_tie_picks_the_lower_expert_index(dtype):
    """Experts 1 and 3 get the same router column, so every token's logits
    tie exactly between them; with k = 2 and both in the top two for some
    tokens, the lower index must win wherever only one of them fits."""
    cfg, lp, x = _ffn_inputs(dtype, rows=16, seed=3)
    lp["router"][:, 3] = lp["router"][:, 1]
    lp["router"][:, 0] = lp["router"][:, 1] - 0.5 * np.abs(lp["router"][:, 1])  # below the tie, sometimes
    logits = jnp.asarray(x) @ jnp.asarray(lp["router"])
    ties = np.asarray(logits.astype(jnp.float32))
    assert (ties[..., 1] == ties[..., 3]).all()
    want_idx = np.asarray(jax.lax.top_k(logits.astype(jnp.float32), cfg.experts_per_token)[1])
    got_idx, _ = tmoe.route(config_from_jax(cfg), _torch(lp["router"]), _torch(x))
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    # a tie decides: some token picks 1 over 3 as its second expert
    assert ((want_idx[..., 1] == 1) & (ties[..., 0] > ties[..., 1])).any()
    got, want = _both(cfg, lp, x)
    assert np.abs(got - want).max() <= (1e-5 if dtype == "float32" else 2**-7) * np.abs(want).max()


def test_routing_depends_on_the_input():
    eng = _port()
    lp = eng.model.layer(0)
    x = torch.randn((8, eng.cfg.model.hidden_size), generator=torch.Generator().manual_seed(3))
    idx, probs = tmoe.route(eng.cfg.model, lp["router"], x)
    assert len({tuple(sorted(r)) for r in idx.tolist()}) > 1
    torch.testing.assert_close(probs.sum(-1), torch.ones(8))


def test_greedy_streams_match_the_jax_engine_and_batch_equals_single():
    jeng, teng = _engines()
    want = jeng.generate(PROMPTS, max_new_tokens=12)
    got = teng.generate(PROMPTS, max_new_tokens=12)
    assert got == want
    assert [teng.generate([p], max_new_tokens=12)[0] for p in PROMPTS] == got


def test_parameter_and_sleep_bytes_equal_the_references():
    jeng, teng = _engines(jnp.bfloat16)
    want = sum(x.nbytes for x in jax.tree.leaves(jeng.params))
    got = sum(p.numel() * p.element_size() for p in teng.model.parameters())
    assert got == want == thf.estimate_param_bytes(teng.cfg.model)
    gold = teng.generate([[3, 1, 4]], max_new_tokens=6)[0]
    jinfo = jsleep.attach_sleep(jeng).sleep(1)
    mgr = tsleep.attach_sleep(teng)
    assert mgr.sleep(1)["bytes_offloaded"] == jinfo["bytes_offloaded"] > 0
    mgr.wake_up()
    assert teng.generate([[3, 1, 4]], max_new_tokens=6)[0] == gold


def test_level1_and_level2_cycles_keep_the_tokens_and_the_addresses():
    eng = _port(torch.bfloat16)
    gold = eng.generate(PROMPTS, max_new_tokens=8)
    ptrs = [p.data_ptr() for p in eng.model.parameters()]
    mgr = tsleep.attach_sleep(eng)
    mgr.sleep(1)
    assert all(a.mapped_bytes == 0 for a in eng.arenas.values())
    mgr.wake_up()
    assert eng.generate(PROMPTS, max_new_tokens=8) == gold
    assert mgr.sleep(2)["bytes_offloaded"] == 0
    eng.abort_all("level-2 sleep discarded state")
    mgr.wake_up(reinit=lambda: tsleep.fresh_state(eng))
    assert eng.generate(PROMPTS, max_new_tokens=8) == gold
    assert [p.data_ptr() for p in eng.model.parameters()] == ptrs


def test_a_sleep_quant_int8_cycle_moves_the_references_payload():
    """A bf16 MoE engine slept under ``--sleep-quant int8``: the expert
    stacks (4-D) quantize with a scale per layer and expert, the router
    does not; the bytes and the weights after the wake are the
    reference's, bit for bit, and later cycles repeat them."""
    jeng, teng = _engines(jnp.bfloat16, max_batch=2, num_pages=24)
    jmgr = jsleep.attach_sleep(jeng, quant_mode="int8")
    tmgr = tsleep.attach_sleep(teng, quant_mode="int8")
    want, got = jmgr.sleep(1), tmgr.sleep(1)
    assert (got["bytes_offloaded"], got["bytes_offloaded_full"]) == (
        want["bytes_offloaded"], want["bytes_offloaded_full"])
    assert got["bytes_offloaded"] < got["bytes_offloaded_full"]
    jmgr.wake_up()
    tmgr.wake_up()
    flat, _ = jax.tree_util.tree_flatten_with_path(jeng.params)
    ref = {"/".join(str(k.key) for k in path): np.asarray(leaf) for path, leaf in flat}
    mine = thf.model_leaves(teng.model)
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        assert np.array_equal(mine[k].contiguous().view(torch.uint8).numpy().reshape(-1),
                              np.ascontiguousarray(v).view(np.uint8).reshape(-1)), k
    before = {k: v.clone() for k, v in mine.items()}
    tmgr.sleep(1)
    tmgr.wake_up()
    after = thf.model_leaves(teng.model)
    assert all(torch.equal(after[k].view(torch.uint8), before[k].view(torch.uint8)) for k in before)


def test_packed_serving_equals_bucketed():
    prompts = PROMPTS + [[11, 13, 17, 19] * 6]
    want = _port().generate(prompts, max_new_tokens=8)
    eng = _port(packed_serving=True)
    assert eng.generate(prompts, max_new_tokens=8) == want
    assert eng.packed_steps > 0 and eng.cold_prefills == 0


def test_tp2_on_a_cpu_mesh_matches_tp1():
    one = _port(max_batch=2)
    two = tengine.InferenceEngine(dataclasses.replace(one.cfg), seed=0, mesh=serving_mesh(2, ["cpu", "cpu"]))
    prompts = [[5, 6, 7, 8], [2, 4]]
    assert two.generate(prompts, max_new_tokens=8) == one.generate(prompts, max_new_tokens=8)
    r0, r1 = two.model.ranks
    assert torch.equal(r0.layers["router"], one.model.layers["router"])
    assert torch.equal(r1.layers["router"], one.model.layers["router"])
    for name, dim in (("w_gate", 3), ("w_up", 3), ("w_down", 2)):  # each expert's f split
        assert torch.equal(torch.cat([r0.layers[name], r1.layers[name]], dim=dim), one.model.layers[name])


def test_expert_parallelism_is_refused_naming_its_item():
    """ep is realised (tests/test_torch_moe_ep.py), and with pp in one
    process (tests/test_torch_pp.py); what stays refused names its item:
    pp across a gang's processes (queue 1 item 15), and ep over a model
    whose experts it cannot split evenly."""
    staged = tllama.ShardedLlama(tmoe.MoeConfig.tiny_moe(), tmesh.make_mesh(tmesh.MeshPlan(pp=2, ep=2), ["cpu"] * 4))
    assert [(m.cfg.num_layers, m.cfg.num_experts) for m in staged.ranks] == [(1, 2)] * 4
    with pytest.raises(NotImplementedError, match="item 15"):
        tmesh.make_mesh(tmesh.MeshPlan(pp=2, ep=2), ["cpu"] * 2, group=object())
    mesh = tmesh.make_mesh(tmesh.MeshPlan(ep=2), ["cpu", "cpu"])
    bad = dataclasses.replace(tmoe.MoeConfig.tiny_moe(), num_experts=3)
    with pytest.raises(ValueError, match="num_experts=3 is not divisible by ep=2"):
        tllama.ShardedLlama(bad, mesh)

"""Expert parallelism (``ep``) for MoE serving, on the CPU, at
``tiny_moe`` size: the port's engine on ``MeshPlan(ep=2)`` and
``MeshPlan(tp=2, ep=2)`` meshes of ``cpu`` ranks.

* The reference's ``test_moe_expert_parallel_matches_single_device``:
  greedy tokens at ep 2 equal one device's (f32, where bf16 near-ties
  cannot decide a token), and equal the JAX engine's on its own weights.
* The reference's ``test_moe_int8_sharded_over_ep``: a quantized stack's
  ``q`` and ``s`` split over ``ep`` (each rank's the single-device model's
  slice), and two identical sharded engines agree.
* The FFN's ranks: each rank's f32 partial over its E/ep experts,
  summed and rounded once, is the whole FFN (f32 within 1e-6 of its
  largest output; bf16 within one bf16 step of it); a bf16 layer's
  tail on ``ShardedLlama`` at ep 2 and 4 equal to one device's but for
  at most 1% of its outputs, each one bf16 step off (a rounding of each
  partial before the sum moves about 10%); the W8A16 expert
  product's plain version at E/ep experts is the whole product's slice,
  bit for bit, and the reference's ``_qeinsum`` on those experts.
* What the engine refuses on a mesh (dp, sp, pp); a Mixtral checkpoint
  loaded onto ep meshes (plain and int8) as one device's slices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.models import moe as jmoe
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.models import hf as thf
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models import moe as tmoe
from llm_d_fast_model_actuation_tpu_torch.models import quant as tquant
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import w8a16
from llm_d_fast_model_actuation_tpu_torch.parallel import mesh as tmesh

PROMPTS = [[1, 2, 3], [4, 5, 6]]


def _mesh(**plan):
    p = tmesh.MeshPlan(**plan)
    return tmesh.make_mesh(p, ["cpu"] * p.size)


def _cfg(dtype=torch.float32, quantization="", **kw):
    m = dataclasses.replace(tmoe.MoeConfig.tiny_moe(), dtype=dtype, quantization=quantization)
    base = dict(max_batch=4, page_size=8, num_pages=48, max_seq_len=64)
    base.update(kw)
    return tengine.EngineConfig(model=m, **base)


@pytest.mark.parametrize("plan", [dict(ep=2), dict(tp=2, ep=2), dict(ep=4)], ids=["ep2", "tp2ep2", "ep4"])
def test_expert_parallel_greedy_tokens_equal_one_devices(plan):
    gold = tengine.InferenceEngine(_cfg(), seed=0, device="cpu").generate(PROMPTS, max_new_tokens=5)
    mesh = _mesh(**plan)
    eng = tengine.InferenceEngine(_cfg(), seed=0, mesh=mesh)
    E = tmoe.MoeConfig.tiny_moe().num_experts
    for m in eng.model.ranks:
        assert m.layers["w_gate"].shape[1] == E // plan["ep"]
        assert m.layers["router"].shape[-1] == E  # the router stays whole
    assert eng.generate(PROMPTS, max_new_tokens=5) == gold


def test_expert_parallel_serves_the_references_weights_as_the_jax_engine():
    jm = dataclasses.replace(jmoe.MoeConfig.tiny_moe(), dtype=jnp.float32)
    base = dict(max_batch=4, page_size=8, num_pages=48, max_seq_len=64)
    jeng = jengine.InferenceEngine(jengine.EngineConfig(model=jm, **base), seed=0)
    gold = jeng.generate(PROMPTS, max_new_tokens=6)
    mesh = _mesh(tp=2, ep=2)
    tcfg = config_from_jax(jm)
    state = params_from_jax(jax.tree.map(np.asarray, jeng.params), mesh=mesh, cfg=tcfg)
    eng = tengine.InferenceEngine(tengine.EngineConfig(model=tcfg, **base), params=state, mesh=mesh)
    assert eng.generate(PROMPTS, max_new_tokens=6) == gold


def test_int8_expert_stacks_split_q_and_s_over_ep():
    one = tengine.InferenceEngine(_cfg(torch.bfloat16, "int8", max_batch=2, num_pages=32), seed=0, device="cpu")
    mesh = _mesh(tp=2, ep=2)
    cfg = _cfg(torch.bfloat16, "int8", max_batch=2, num_pages=32)
    a = tengine.InferenceEngine(cfg, seed=0, mesh=mesh)
    for r, m in enumerate(a.model.ranks):
        e, t = mesh.index(r, "ep"), mesh.index(r, "tp")
        for name, tp_dim in (("w_gate", 3), ("w_up", 3), ("w_down", 2)):
            whole_q, whole_s = one.model.layers[name]["q"], one.model.layers[name]["s"]
            q, s = m.layers[name]["q"], m.layers[name]["s"]
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            want_q = whole_q[:, 2 * e:2 * e + 2].chunk(2, dim=tp_dim)[t]
            want_s = whole_s[:, 2 * e:2 * e + 2]
            if tp_dim == 3:  # column-parallel: the scale splits with q's output axis
                want_s = want_s.chunk(2, dim=3)[t]
            assert torch.equal(q, want_q) and torch.equal(s, want_s), (name, r)
    out = a.generate([[4, 5, 6]], max_new_tokens=4)[0]
    assert len(out) == 4
    b = tengine.InferenceEngine(cfg, seed=0, mesh=mesh)
    assert b.generate([[4, 5, 6]], max_new_tokens=4)[0] == out


def _ffn_weights(dtype, seed=0):
    cfg = dataclasses.replace(tmoe.MoeConfig.tiny_moe(), dtype=dtype)
    h, f, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    gen = torch.Generator().manual_seed(seed)

    def w(*shape, fan_in):
        return (torch.randn(shape, generator=gen) * fan_in**-0.5).to(dtype)

    lp = {"router": w(h, E, fan_in=h), "w_gate": w(E, h, f, fan_in=h), "w_up": w(E, h, f, fan_in=h),
          "w_down": w(E, f, h, fan_in=f)}
    return cfg, lp, torch.randn((5, h), generator=gen).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ep_partials_summed_and_rounded_once_are_the_whole_ffn(dtype):
    cfg, lp, x = _ffn_weights(dtype)
    whole = tmoe.moe_ffn(cfg, lp, x)
    ep = 2
    local = tllama.shard_config(cfg, 1, ep)
    assert local.num_experts == 2 and local.router_experts == 4
    per = cfg.num_experts // ep
    parts = []
    for e in range(ep):
        lpe = {k: (v if k == "router" else v[e * per:(e + 1) * per]) for k, v in lp.items()}
        p = tmoe.moe_ffn(local, lpe, x, expert0=e * per, partial=True)
        assert p.dtype == torch.float32
        parts.append(p)
    got = (parts[0] + parts[1]).to(dtype)
    scale = float(whole.float().abs().max())
    if dtype == torch.float32:
        assert float((got - whole).abs().max()) <= 1e-6 * scale
    else:
        assert float((got.float() - whole.float()).abs().max()) <= 2**-7 * scale


def _bf16_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in bf16 steps (units in the last place) of the larger
    of the two magnitudes."""
    big = torch.maximum(got.float().abs(), want.float().abs())
    _, e = torch.frexp(big)
    return (got.float() - want.float()).abs() / torch.ldexp(torch.ones_like(big), e - 8)


#: the share of a bf16 layer's outputs that may differ from one device's at
#: ep > 1: the ranks' f32 partials are added in another order than one
#: device's f32 sum over E, which moves a bf16 rounding only where the f32
#: sum lies within a few f32 steps of a rounding boundary (about 2^-15 of
#: the elements); a second rounding (each partial to bf16 before the sum)
#: moves a large share
EP_BF16_MISMATCH_SHARE = 0.01


@pytest.mark.parametrize("ep", [2, 4])
def test_a_bf16_layer_on_an_ep_mesh_rounds_the_ffn_once_as_one_device(ep):
    """``ShardedLlama`` at ep 2 and 4 (tp 1), bf16: every layer's tail
    (``llama._layer_tail``: ``wo``, the residual, the MoE FFN and its
    reduction) on the same input as one device. At most
    ``EP_BF16_MISMATCH_SHARE`` of the outputs differ, each by at most one
    bf16 step, and every rank holds the same output."""
    cfg = dataclasses.replace(tmoe.MoeConfig.tiny_moe(), dtype=torch.bfloat16)
    one = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = _mesh(ep=ep)
    model = tllama.ShardedLlama(cfg, mesh)
    model.load_state_dict(tllama.shard_params(one.state_dict(), cfg, mesh))
    ranks = list(model.ranks)
    gen = torch.Generator().manual_seed(1)
    rows = 256
    with torch.no_grad():
        for i in range(cfg.num_layers):
            x = torch.randn((rows, cfg.hidden_size), generator=gen).to(cfg.dtype)
            attn = torch.randn((rows, cfg.q_dim), generator=gen).to(cfg.dtype)
            want = tllama._layer_tail(None, [one], [one.layer(i)], [x], [attn])[0]
            got = tllama._layer_tail(mesh, ranks, [m.layer(i) for m in ranks], mesh.replicate(x), mesh.replicate(attn))
            assert all(torch.equal(g, got[0]) for g in got)
            steps = _bf16_steps(got[0], want)
            assert float(steps.max()) <= 1.0, (i, float(steps.max()))
            assert int((steps > 0).sum()) <= EP_BF16_MISMATCH_SHARE * want.numel(), (i, int((steps > 0).sum()))


def test_the_w8a16_expert_products_plain_version_at_e_over_ep():
    """The rank's E/ep experts (E = 2 of tiny_moe's 4): the plain version
    on the slice is the whole product's slice bit for bit, and the
    reference's ``_qeinsum`` on those experts (bf16, within one bf16 step
    of the largest output)."""
    cfg, lp, x = _ffn_weights(torch.bfloat16, seed=1)
    qd = tquant.quantize_weight(lp["w_gate"])
    whole = w8a16.w8a16_matmul_experts_plain(x, qd["q"], qd["s"])
    for e in range(2):
        q, s = qd["q"][2 * e:2 * e + 2], qd["s"][2 * e:2 * e + 2]
        got = w8a16.w8a16_matmul_experts_plain(x, q, s)
        assert got.shape == (2, x.shape[0], cfg.intermediate_size)
        assert torch.equal(got, whole[2 * e:2 * e + 2])
        assert torch.equal(tquant.qeinsum(x, {"q": q, "s": s}), got)
        jw = {"q": jnp.asarray(q.numpy()), "s": jnp.asarray(s.numpy())}
        jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        want = np.asarray(jmoe._qeinsum("...h,ehf->...ef", jx, jw).astype(jnp.float32))  # [rows, E, f]
        ref = np.moveaxis(want, 1, 0)
        assert np.abs(got.float().numpy() - ref).max() <= 2**-7 * np.abs(ref).max()


@pytest.mark.parametrize("axis", ["dp", "sp"])
def test_the_engine_refuses_training_axes_saying_why(axis):
    mesh = _mesh(**{axis: 2})
    with pytest.raises(ValueError, match=f"tp x ep mesh; {axis}=2 refused"):
        tengine.InferenceEngine(_cfg(), seed=0, mesh=mesh)


def test_replicas_on_an_ep_mesh_are_every_ep_ranks_attention():
    """The sleep code counts a replicated weight once: on tp 2 x ep 2 the
    replicas are the norms and router of ranks 1..3 and, on the two ep
    ranks past the first, their tp slice of attention, embedding and
    head."""
    mesh = _mesh(tp=2, ep=2)
    model = tllama.ShardedLlama(dataclasses.replace(tmoe.MoeConfig.tiny_moe(), dtype=torch.float32), mesh)
    reps = {id(t) for t in model.replicas()}
    r1, r2, r3 = list(model.ranks)[1:]
    assert id(r1.layers["wq"]) in reps and id(r3.layers["wq"]) in reps and id(r2.layers["wq"]) not in reps
    assert id(r2.layers["router"]) in reps and id(r1.embed) in reps
    assert not any(id(m.layers["w_gate"]) in reps for m in model.ranks)


def _mixtral_dir(tmp_path) -> str:
    """A tiny Mixtral checkpoint (four experts) in two safetensors shards."""
    import transformers

    torch.manual_seed(0)
    cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=128, num_local_experts=4, num_experts_per_tok=2)
    d = str(tmp_path / "mixtral")
    transformers.MixtralForCausalLM(cfg).save_pretrained(d, max_shard_size="300KB")
    return d


@pytest.mark.parametrize("quantization", ["", "int8"])
@pytest.mark.parametrize("plan", [dict(ep=2), dict(tp=2, ep=2)], ids=["ep2", "tp2ep2"])
def test_a_checkpoint_loads_onto_an_ep_mesh_as_one_devices_slices(tmp_path, plan, quantization):
    """A Mixtral checkpoint loaded onto an ep mesh (each expert to the ep
    ranks that hold it; int8: quantized a layer at a time, then cut)
    gives every rank the slice of the one-device load that
    ``shard_params`` cuts, and the digests' view joins them back into the
    one-device leaves."""
    d = _mixtral_dir(tmp_path)
    cfg = thf.config_from_hf(d, dtype=torch.bfloat16, quantization=quantization)
    one = tllama.Llama(cfg, "cpu")
    thf.load_params(d, one)
    mesh = _mesh(**plan)
    model = tllama.ShardedLlama(cfg, mesh)
    thf.load_params(d, model, workers=2)
    want = tllama.shard_params(one.state_dict(), cfg, mesh)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want), [k for k in want if not torch.equal(got[k], want[k])]
    leaves = thf.model_leaves(model)
    for name, t in one.state_dict().items():
        assert torch.equal(leaves[name.replace(".", "/")], t), name
    assert thf.model_digests(model) == thf.model_digests(one)

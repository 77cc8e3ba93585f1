"""The MoE family through the port's serving surfaces, against the JAX
package's on the CPU, at ``tiny_moe`` size.

* ``--quantization int8`` (the reference's ``tests/test_quant.py:133``):
  the expert stacks quantize with a scale per expert and output channel
  (``[L, E, 1, f]``), bit-equal to the reference's ``quantize_params``,
  the router stays in the model dtype; a quantized engine on the
  reference's own quantized tree gives the JAX engine's greedy tokens at
  fp32; a random-init quantized model holds the plain model's weights
  quantized; ``qeinsum``'s plain version against the reference's
  ``_qeinsum`` (fp32: 1e-5 of the largest output, another summation
  order; bf16: one bf16 step, 2^-7, of it).
* The batched W8A16 kernel's launch plan at Mixtral-8x7B's expert
  stacks, and its plain version against the 2-D product expert by
  expert (the kernel runs only on the card: ``chip_smoke.py``).
* The server: its presets are the reference's, ``--model tiny-moe
  --device cpu`` serves completions, ``--model mixtral-8x7b`` without a
  card raises; a swap tiny <-> tiny-moe moves the bytes ``/v1/costs``
  priced, and the reference's service prices and moves the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu.models import moe as jmoe
from llm_d_fast_model_actuation_tpu.models import quant as jquant
from llm_d_fast_model_actuation_tpu.models.registry import init_params_for
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.models import hf as thf
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models import moe as tmoe
from llm_d_fast_model_actuation_tpu_torch.models import quant as tquant
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import w8a16

PROMPTS = [[5, 9, 200, 3, 77], list(range(10, 31)), [42]]


def _torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tree(tree):
    return {k: ({n: _torch(np.asarray(v)) for n, v in t.items()} if isinstance(t, dict) else _torch(np.asarray(t)))
            for k, t in tree.items()}


def test_quantize_params_of_an_moe_tree_is_bit_equal_to_the_references():
    cfg = jmoe.MoeConfig.tiny_moe()
    tree = jax.tree.map(np.asarray, init_params_for(jax.random.key(0), cfg))
    want = jax.tree.map(np.asarray, jquant.quantize_params(jax.tree.map(jnp.asarray, tree)))
    got = tquant.quantize_params(_tree(tree))
    L, E, f = cfg.num_layers, cfg.num_experts, cfg.intermediate_size
    assert tuple(got["layers"]["w_gate"]["s"].shape) == (L, E, 1, f)
    assert tuple(got["layers"]["w_down"]["s"].shape) == (L, E, 1, cfg.hidden_size)
    assert not tquant.is_quantized(got["layers"]["router"]) and not tquant.is_quantized(want["layers"]["router"])
    for name in tquant.LAYER_WEIGHTS:
        for leaf in ("q", "s"):
            np.testing.assert_array_equal(got["layers"][name][leaf].numpy(), want["layers"][name][leaf])
    np.testing.assert_array_equal(got["layers"]["router"].view(torch.int16).numpy(),
                                  want["layers"]["router"].view(np.int16))
    # the shapes an int8 MoE model holds are the quantized tree's
    shapes = tllama.param_shapes(dataclasses.replace(config_from_jax(cfg), quantization="int8"))
    assert shapes["layers.w_gate.s"] == (L, E, 1, f) and "layers.router" in shapes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [True, False], ids=["one-x", "x-per-expert"])
def test_qeinsum_plain_version_matches_the_references(dtype, shared):
    rng = np.random.default_rng(2)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    E, K, N, M = 4, 64, 48, 5
    w = (rng.standard_normal((E, K, N)) * 0.05).astype(np_dt)
    x = rng.standard_normal((M, K) if shared else (E, M, K)).astype(np_dt)
    qw = jquant.quantize_weight(jnp.asarray(w))
    spec = "mh,ehf->mef" if shared else "emh,ehf->mef"
    from llm_d_fast_model_actuation_tpu.models.moe import _qeinsum

    # the reference's layout is token major ([M, E, N]); the port's expert major
    want = np.asarray(_qeinsum(spec, jnp.asarray(x), {"q": qw["q"], "s": qw["s"]})).astype(np.float32)
    tw = {"q": _torch(np.asarray(qw["q"])), "s": _torch(np.asarray(qw["s"]))}
    got = tquant.qeinsum(_torch(x), tw)
    assert got.dtype == _torch(x).dtype and tuple(got.shape) == (E, M, N)
    got = got.float().numpy().transpose(1, 0, 2)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        assert np.abs(got - want).max() <= 2**-7 * np.abs(want).max()
    # the kernel's wrapper takes its plain version on the CPU, which is the
    # 2-D product expert by expert
    plain = w8a16.w8a16_matmul_experts_plain(_torch(x), tw["q"], tw["s"])
    assert torch.equal(w8a16.w8a16_matmul_experts(_torch(x), tw["q"], tw["s"]), plain)
    for e in range(E):
        xe = _torch(x) if shared else _torch(x)[e]
        assert torch.equal(plain[e], w8a16.w8a16_matmul_plain(xe, tw["q"][e], tw["s"][e]))
    # a plain stack is a plain product
    pw = _torch(w).float()
    torch.testing.assert_close(tquant.qeinsum(_torch(x).float(), pw), torch.matmul(_torch(x).float(), pw))


@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096)])
@pytest.mark.parametrize("M", [1, 3, 8, 16, 32, 64, 128])
def test_the_batched_launch_plan_covers_mixtral(K, N, M):
    E = 8
    mb, k_split, splits = w8a16.launch_plan(M, K, N, E)
    assert mb in (8, 16, 32) and (mb >= M or mb == w8a16.MAX_MB) and (mb == 8 or mb // 2 < M)
    assert k_split % w8a16.K_STEP == 0 and k_split * (splits - 1) < K <= k_split * splits
    assert k_split >= min(K, w8a16.MIN_SPLIT_K)
    tiles = -(-N // w8a16.TILE_N) * E
    # at least half a wave of CTAs, counting every expert's column tiles
    assert tiles * splits >= min(w8a16.SMS * w8a16.RESIDENT[mb] // 2, tiles * (K // w8a16.MIN_SPLIT_K))
    # one row takes decode's plan (no two long splits at one row)
    if M <= 8:
        assert w8a16.launch_plan(M, K, N, E) == w8a16.launch_plan(8, K, N, E)
    # one expert is the 2-D plan
    assert w8a16.launch_plan(M, K, N, 1) == w8a16.launch_plan(M, K, N)
    with pytest.raises(ValueError):
        w8a16.launch_plan(M, K, N, 0)


def _cfgs(dtype=jnp.float32, **kw):
    jm = dataclasses.replace(jmoe.MoeConfig.tiny_moe(), dtype=dtype, quantization="int8")
    base = dict(max_batch=4, page_size=8, num_pages=48, max_seq_len=64)
    base.update(kw)
    return jengine.EngineConfig(model=jm, **base), tengine.EngineConfig(model=config_from_jax(jm), **base)


def test_a_quantized_moe_engine_matches_the_jax_engine_at_fp32():
    jcfg, tcfg = _cfgs()
    jeng = jengine.InferenceEngine(jcfg, seed=0)
    teng = tengine.InferenceEngine(tcfg, params=params_from_jax(jax.tree.map(np.asarray, jeng.params)), device="cpu")
    lp = teng.model.layer(0)
    assert tquant.is_quantized(lp["wq"]) and tquant.is_quantized(lp["w_gate"]) and not tquant.is_quantized(lp["router"])
    assert tuple(lp["w_gate"]["s"].shape) == (tcfg.model.num_experts, 1, tcfg.model.intermediate_size)
    want = jeng.generate(PROMPTS, max_new_tokens=10)
    assert teng.generate(PROMPTS, max_new_tokens=10) == want
    got = sum(p.numel() * p.element_size() for p in teng.model.parameters())
    assert got == sum(x.nbytes for x in jax.tree.leaves(jeng.params)) == thf.estimate_param_bytes(tcfg.model)


def test_random_init_quantizes_the_plain_moe_models_weights():
    cfg = dataclasses.replace(tmoe.MoeConfig.tiny_moe(), dtype=torch.float32)
    plain = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    quant = tllama.init_params(dataclasses.replace(cfg, quantization="int8"), torch.Generator().manual_seed(3), "cpu")
    for name in tquant.LAYER_WEIGHTS:
        want = tquant.quantize_weight(plain.layers[name].data)
        got = quant.layer(1)[name]
        assert torch.equal(got["q"], want["q"][1]) and torch.equal(got["s"], want["s"][1])
    assert torch.equal(quant.layers["router"], plain.layers["router"])
    want = tquant.quantize_weight(plain.lm_head.data)
    assert torch.equal(quant.head()["q"], want["q"]) and torch.equal(quant.head()["s"], want["s"])


def test_the_servers_presets_are_the_references():
    assert set(tserver.MODEL_CONFIGS) == set(jserver.MODEL_CONFIGS)
    for name in ("tiny-moe", "mixtral-8x7b"):
        assert tserver.MODEL_CONFIGS[name]() == config_from_jax(jserver.MODEL_CONFIGS[name]())


OPTS = "--num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0 --swap-bucket-mib 1"


def test_the_server_serves_tiny_moe_on_the_cpu_and_mixtral_needs_a_card(monkeypatch):
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model tiny-moe {OPTS} --device cpu"))
    try:
        assert tllama.is_moe(svc.engine.cfg.model)
        out = svc.submit(prompt=[1, 2, 3], max_new_tokens=4).result(timeout=120).out_tokens
        assert len(out) == 4 and all(0 <= t < 256 for t in out)
    finally:
        svc.shutdown()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tserver.EngineService(tserver.parse_engine_options("--model mixtral-8x7b --quantization int8"))


def _row(view, model):
    return next(c for c in view["candidates"] if c["model"] == model)


def test_a_swap_between_tiny_and_tiny_moe_is_priced_to_the_byte():
    """tiny -> tiny-moe (cold) -> tiny (pool) -> tiny-moe (pool) through
    both services: each swap's bytes equal the ``predicted_bytes`` read
    just before it, and the two packages price and move the same bytes;
    each model's tokens come back unchanged."""
    t = tserver.EngineService(tserver.parse_engine_options(f"--model tiny {OPTS} --device cpu"))
    j = jserver.EngineService(jserver.parse_engine_options(f"--model tiny {OPTS}"))
    try:
        gold = {"tiny": t.submit(prompt=[1, 2, 3], max_new_tokens=4).result(timeout=120).out_tokens}
        for model in ("tiny-moe", "tiny", "tiny-moe"):
            tv, jv = t.costs_report([model]), j.costs_view([(model, "")])
            priced = _row(tv, model)
            assert priced["predicted_bytes"] == _row(jv, model)["predicted_bytes"]
            got, want = t.swap(model), j.swap(model)
            assert got["bytes_moved"] == priced["predicted_bytes"] == want["bytes_moved"] > 0
            assert got["tier"] == want["tier"]
            tokens = t.submit(prompt=[1, 2, 3], max_new_tokens=4).result(timeout=120).out_tokens
            assert gold.setdefault(model, tokens) == tokens
        assert tllama.is_moe(t.engine.cfg.model)
    finally:
        t.shutdown()
        j.shutdown()

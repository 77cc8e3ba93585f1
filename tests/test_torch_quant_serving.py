"""Weight-only int8 serving (``--quantization int8``, W8A16) of the port
against the JAX package's, on the CPU.

* ``quantize_weight`` / ``quantize_params``: the port's ``q`` and ``s``
  bit-equal to the reference's on the same bf16 and fp32 weights (inputs
  from a numpy seed); ``qmat``'s plain version against the reference's
  ``qmat`` (fp32: 1e-5 relative, a different summation order; bf16: one
  bf16 step, 2^-7, of the largest output, both round the product once
  and the scaled product once).
* The W8A16 kernel's launch plan at Llama-3-8B's five products and 1-64
  rows (the kernel itself runs only on the card: ``chip_smoke.py``).
* A quantized engine's greedy tokens equal the JAX engine's at fp32 on
  the reference's own quantized tree (``params_from_jax``), its parameter
  and level-1 sleep bytes equal the reference's, a random-init quantized
  model holds the plain model's weights quantized, and a tp 2 engine on a
  ``cpu,cpu`` mesh equals tp 1, with each row-parallel scale taken over
  the whole fan-in and held whole on both ranks.
* A quantized ``hf:`` load bit-equal to the reference's quantized load,
  and a swap sequence through the port's service against the reference's
  service at fp32; the three refusals in the reference's words.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu.engine import sleep as jsleep
from llm_d_fast_model_actuation_tpu.models import hf as jhf
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu.models import quant as jquant
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.engine import sleep as tsleep
from llm_d_fast_model_actuation_tpu_torch.models import hf as thf
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models import quant as tquant
from llm_d_fast_model_actuation_tpu_torch.models import registry as tregistry
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import w8a16
from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import serving_mesh
from tests.conftest import build_tiny_hf_model_dir

PROMPTS = [[5, 9, 200, 3, 77], list(range(10, 31)), [42]]


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(64, 32), (3, 48, 40)])
def test_quantize_weight_is_bit_equal_to_the_jax_package(dtype, shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.05).astype(getattr(ml_dtypes, dtype, np.float32) if dtype == "bfloat16"
                                                   else np.float32)
    want = jquant.quantize_weight(jnp.asarray(w))
    got = tquant.quantize_weight(_to_torch(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert tuple(got["s"].shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


def test_quantize_params_is_bit_equal_to_the_jax_package():
    cfg = jllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(0), cfg))
    want = jax.tree.map(np.asarray, jquant.quantize_params(jax.tree.map(jnp.asarray, tree)))
    got = tquant.quantize_params({k: ({n: _to_torch(v) for n, v in t.items()} if isinstance(t, dict) else _to_torch(t))
                                  for k, t in tree.items()})
    for name in tquant.LAYER_WEIGHTS:
        assert tquant.is_quantized(got["layers"][name])
        for leaf in ("q", "s"):
            np.testing.assert_array_equal(got["layers"][name][leaf].numpy(), want["layers"][name][leaf])
    for leaf in ("q", "s"):
        np.testing.assert_array_equal(got["lm_head"][leaf].numpy(), want["lm_head"][leaf])
    # the embedding and the norms are left as they are
    assert got["embed"].dtype == torch.bfloat16 and not tquant.is_quantized(got["layers"]["attn_norm"])
    # the registry's maybe_quantize: the same tree, and a plain config's untouched
    qcfg = config_from_jax(dataclasses.replace(cfg, quantization="int8"))
    again = tregistry.maybe_quantize(qcfg, {"layers": dict(got["layers"]), "lm_head": got["lm_head"]})
    assert again["lm_head"] is got["lm_head"]
    plain = {"layers": {"wq": torch.zeros(2, 4, 4)}}
    assert tregistry.maybe_quantize(config_from_jax(cfg), plain) is plain
    with pytest.raises(ValueError, match="unknown quantization"):
        tregistry.maybe_quantize(dataclasses.replace(qcfg, quantization="int4"), plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmat_plain_version_matches_the_jax_qmat(dtype):
    rng = np.random.default_rng(1)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x = rng.standard_normal((8, 64)).astype(np_dt)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np_dt)
    qw = jquant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jquant.qmat(jnp.asarray(x), qw)).astype(np.float32)
    tw = {"q": torch.from_numpy(np.array(qw["q"])), "s": torch.from_numpy(np.array(qw["s"]))}
    got = tquant.qmat(_to_torch(x), tw)
    assert got.dtype == _to_torch(x).dtype
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        assert np.abs(got - want).max() <= 2**-7 * np.abs(want).max()
    # a plain weight is a plain product
    np.testing.assert_allclose(tquant.qmat(_to_torch(x).float(), _to_torch(w).float()).numpy(),
                               x.astype(np.float32) @ w.astype(np.float32), rtol=1e-5, atol=1e-5)
    # the kernel's wrapper takes its plain version on the CPU
    assert torch.equal(w8a16.w8a16_matmul(_to_torch(x), tw["q"], tw["s"]),
                       w8a16.w8a16_matmul_plain(_to_torch(x), tw["q"], tw["s"]))


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)])
@pytest.mark.parametrize("M", [1, 3, 8, 16, 32, 64, 128])
def test_w8a16_launch_plan_covers_llama3_8b(K, N, M):
    mb, k_split, splits = w8a16.launch_plan(M, K, N)
    # rows a pass: the fewest n-tiles of 8 (one, two or four) that hold M
    assert mb in (8, 16, 32) and (mb >= M or mb == w8a16.MAX_MB) and (mb == 8 or mb // 2 < M)
    assert k_split % w8a16.K_STEP == 0 and k_split * (splits - 1) < K <= k_split * splits
    assert k_split >= min(K, w8a16.MIN_SPLIT_K)
    tiles = -(-N // w8a16.TILE_N)
    # at least half a wave of CTAs where K allows it
    assert tiles * splits >= min(w8a16.SMS * w8a16.RESIDENT[mb] // 2, tiles * (K // w8a16.MIN_SPLIT_K))
    # every row count of one pass takes decode's plan: one row no longer
    # falls back to two long splits
    if M <= 8:
        assert w8a16.launch_plan(M, K, N) == w8a16.launch_plan(8, K, N)
    with pytest.raises(ValueError):
        w8a16.launch_plan(M, K + 8, N)


def _cfgs(quantization="int8", **kw):
    jm = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32, quantization=quantization)
    base = dict(dict(max_batch=4, page_size=8, num_pages=48, max_seq_len=64), **kw)
    return jengine.EngineConfig(model=jm, **base), tengine.EngineConfig(model=config_from_jax(jm), **base)


def _engines(**kw):
    jcfg, tcfg = _cfgs(**kw)
    jeng = jengine.InferenceEngine(jcfg, seed=0)
    state = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    return jeng, tengine.InferenceEngine(tcfg, params=state, device="cpu")


def test_quantized_engine_matches_the_jax_engine_at_fp32():
    jeng, teng = _engines()
    assert tquant.is_quantized(teng.model.layer(0)["wq"]) and tquant.is_quantized(teng.model.head())
    want = jeng.generate(PROMPTS, max_new_tokens=12)
    assert teng.generate(PROMPTS, max_new_tokens=12) == want
    # the chunk's T=1 tail and the bucketed prefill both ran quantized
    assert teng.decode_steps > 0 and teng.cold_prefills == len(PROMPTS)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_parameter_and_sleep_bytes_equal_the_references(dtype):
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, dtype=dtype))
    tcfg = dataclasses.replace(tcfg, model=config_from_jax(jcfg.model))
    jeng = jengine.InferenceEngine(jcfg, seed=0)
    teng = tengine.InferenceEngine(tcfg, params=params_from_jax(jax.tree.map(np.asarray, jeng.params)),
                                   device="cpu")
    want = sum(x.nbytes for x in jax.tree.leaves(jeng.params))
    got = sum(p.numel() * p.element_size() for p in teng.model.parameters())
    assert got == want == thf.estimate_param_bytes(tcfg.model)
    assert {n: tuple(s) for n, s in tllama.param_shapes(tcfg.model).items()} == {
        n: tuple(p.shape) for n, p in teng.model.named_parameters()}
    jinfo = jsleep.attach_sleep(jeng).sleep(1)
    mgr = tsleep.attach_sleep(teng)
    gold = teng.generate([[3, 1, 4]], max_new_tokens=6)[0]
    tinfo = mgr.sleep(1)
    assert tinfo["bytes_offloaded"] == jinfo["bytes_offloaded"] > 0
    mgr.wake_up()
    assert teng.generate([[3, 1, 4]], max_new_tokens=6)[0] == gold


def test_a_level2_wake_requantizes_in_place():
    """A level-2 cycle of a quantized engine drops the state and redraws
    the weights into the same tensors, quantized as at the start: the
    same tokens, every parameter at its address."""
    _, tcfg = _cfgs()
    eng = tengine.InferenceEngine(tcfg, seed=0, device="cpu")
    gold = eng.generate([[3, 1, 4]], max_new_tokens=6)[0]
    ptrs = [p.data_ptr() for p in eng.model.parameters()]
    mgr = tsleep.attach_sleep(eng)
    assert mgr.sleep(2)["bytes_offloaded"] == 0
    eng.abort_all("level-2 sleep discarded state")
    mgr.wake_up(reinit=lambda: tsleep.fresh_state(eng))
    assert eng.generate([[3, 1, 4]], max_new_tokens=6)[0] == gold
    assert [p.data_ptr() for p in eng.model.parameters()] == ptrs
    assert eng.model.layers["wq"]["q"].dtype == torch.int8


def test_random_init_quantizes_the_plain_models_weights():
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    plain = tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    quant = tllama.init_params(dataclasses.replace(cfg, quantization="int8"), torch.Generator().manual_seed(3), "cpu")
    for name in tquant.LAYER_WEIGHTS:
        want = tquant.quantize_weight(plain.layers[name].data)
        got = quant.layer(0)[name]
        assert torch.equal(got["q"], want["q"][0]) and torch.equal(got["s"], want["s"][0])
    want = tquant.quantize_weight(plain.lm_head.data)
    assert torch.equal(quant.head()["q"], want["q"]) and torch.equal(quant.head()["s"], want["s"])
    assert torch.equal(quant.embed, plain.embed)


def test_tp2_quantized_engine_on_a_cpu_mesh_matches_tp1():
    _, tcfg = _cfgs(max_batch=2)
    one = tengine.InferenceEngine(tcfg, seed=0, device="cpu")
    two = tengine.InferenceEngine(tcfg, seed=0, mesh=serving_mesh(2, ["cpu", "cpu"]))
    prompts = [[5, 6, 7, 8], [2, 4]]
    assert two.generate(prompts, max_new_tokens=8) == one.generate(prompts, max_new_tokens=8)
    r0, r1 = two.model.ranks
    for name in ("wo", "w_down"):  # row-parallel: q split on the fan-in, one scale over all of it
        s = one.model.layers[name]["s"]
        assert torch.equal(r0.layers[name]["s"], s) and torch.equal(r1.layers[name]["s"], s)
        assert torch.equal(torch.cat([r0.layers[name]["q"], r1.layers[name]["q"]], dim=1), one.model.layers[name]["q"])
    for name in ("wq", "w_gate"):  # column-parallel: q and s split on the output axis
        for leaf in ("q", "s"):
            assert torch.equal(torch.cat([r0.layers[name][leaf], r1.layers[name][leaf]], dim=2),
                               one.model.layers[name][leaf])
    assert torch.equal(torch.cat([r0.lm_head["s"], r1.lm_head["s"]], dim=1), one.model.lm_head["s"])


OPTS = "--num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0 --swap-bucket-mib 1"
BYTE_KEYS = ("tier", "pool_hit", "swapped", "bytes_out", "bytes_in", "bytes_moved", "bytes_deduped", "deduped_leaves")


@pytest.fixture(scope="module")
def siblings(tmp_path_factory):
    """Two tiny HF directories that share every tensor but ``lm_head``."""
    from safetensors.torch import load_file, save_file

    tmp_path = tmp_path_factory.mktemp("hf")
    a = build_tiny_hf_model_dir(str(tmp_path / "a"))
    b = str(tmp_path / "b")
    shutil.copytree(a, b)
    tensors = load_file(os.path.join(b, "model.safetensors"))
    tensors["lm_head.weight"] = tensors["lm_head.weight"].flip(0).contiguous()
    save_file(tensors, os.path.join(b, "model.safetensors"), metadata={"format": "pt"})
    return a, b


def test_quantized_hf_load_is_bit_equal_to_the_references(siblings):
    d = siblings[0]
    jcfg = jhf.config_from_hf(d, quantization="int8")
    want = params_from_jax(jax.tree.map(np.asarray, jhf.load_params(d, jcfg)))
    tcfg = thf.config_from_hf(d, quantization="int8")
    assert tcfg.quantization == "int8"
    model = tllama.Llama(tcfg, "cpu")
    st = thf.load_params(d, model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the bytes that crossed are the staged bf16 checkpoint's
    assert st.bytes_h2d == thf.estimate_param_bytes(dataclasses.replace(tcfg, quantization=""))


def test_quantized_swap_sequence_equals_the_reference_service(siblings, monkeypatch):
    """A -> B (cold) -> A (pool) at int8 through both services, fp32 so
    greedy tokens sit off bf16's near-ties: the same tiers and bytes (no
    delta: content hashing is off), the same tokens, bit-equal across the
    swap back; ``/v1/costs`` priced the pool swap's bytes exactly."""
    a, b = siblings
    jcfg, tcfg = jhf.config_from_hf, thf.config_from_hf
    monkeypatch.setattr(jhf, "config_from_hf", lambda path, **kw: jcfg(path, **dict(kw, dtype=jnp.float32)))
    monkeypatch.setattr(thf, "config_from_hf", lambda path, **kw: tcfg(path, **dict(kw, dtype=torch.float32)))

    def run(svc, gen, price=None):
        out = [("start", gen(svc))]
        for model in (f"hf:{b}", f"hf:{a}"):
            priced = price(model) if price else None
            got = svc.swap(model)
            if priced is not None and got["tier"] == "pool":
                assert priced == got["bytes_moved"]
            out.append(({k: got[k] for k in BYTE_KEYS}, gen(svc)))
        return out

    j = jserver.EngineService(jserver.parse_engine_options(f"--model hf:{a} {OPTS} --quantization int8"))
    try:
        want = run(j, lambda s: s.submit([1, 2, 3], 4, 0.0).result(timeout=120).out_tokens)
    finally:
        j.shutdown()
    t = tserver.EngineService(tserver.parse_engine_options(f"--model hf:{a} {OPTS} --device cpu --quantization int8"))
    try:
        assert not t._content_hash and tquant.is_quantized(t.engine.model.head())
        got = run(t, lambda s: s.submit(prompt=[1, 2, 3], max_new_tokens=4).result(timeout=120).out_tokens,
                  price=lambda m: t.price_swap(m)["predicted_bytes"])
        assert [s[0]["tier"] for s in got[1:]] == ["cold", "pool"]
        assert got == want
        assert got[0][1] == got[2][1] != got[1][1]
        assert got[2][0]["bytes_deduped"] == 0
    finally:
        t.shutdown()


@pytest.mark.parametrize("opts", [
    "--packed-serving on --pipeline-decode on",
    "--quantization int8 --resident-variants 2 --packed-serving on",
    "--quantization int8 --sleep-quant int8",
])
def test_the_three_refusals_in_the_references_words(opts):
    with pytest.raises(ValueError) as want:
        jserver.parse_engine_options(f"--model tiny {opts}")
    with pytest.raises(ValueError) as got:
        tserver.parse_engine_options(f"--model tiny {opts} --device cpu")
    assert str(got.value) == str(want.value)


def test_an_exec_pool_key_carries_the_quantization():
    from llm_d_fast_model_actuation_tpu_torch.engine.exec_pool import exec_key

    assert exec_key("hf:/m", "chunk", 8) == "hf:/m/chunk@8"
    assert exec_key("hf:/m", "chunk", 8, "int8") != exec_key("hf:/m", "chunk", 8)

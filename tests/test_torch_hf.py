"""The port's Hugging Face checkpoint import (models/hf.py) and its own
safetensors reader (models/safetensors.py), held against the JAX
package's models/hf.py on the same directories, built here by
tests/conftest.py: configs field for field, the same refusals, weights
written into the port's model bit-equal to the reference's tree carried
across by models/convert.py:params_from_jax, digests string for string;
and logits and greedy tokens against transformers at fp32."""

import contextlib
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import transformers

from llm_d_fast_model_actuation_tpu.models import hf as jhf
from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from llm_d_fast_model_actuation_tpu_torch.models import hf as thf
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models import safetensors as tst
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import serving_mesh
from tests.conftest import build_sharded_hf_model_dir

TINY = dict(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
)

#: (config class, model class, extra config fields) of each family
FAMILIES = {
    "llama": (transformers.LlamaConfig, transformers.LlamaForCausalLM, {}),
    "llama_tied": (transformers.LlamaConfig, transformers.LlamaForCausalLM, {"tie_word_embeddings": True}),
    "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM, {}),
    "qwen3": (transformers.Qwen3Config, transformers.Qwen3ForCausalLM, {"head_dim": 16}),
    "gemma": (transformers.GemmaConfig, transformers.GemmaForCausalLM, {"head_dim": 16}),
    "llama31_rope": (transformers.LlamaConfig, transformers.LlamaForCausalLM, {"rope_scaling": {
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 32}}),
    "mistral_window": (transformers.MistralConfig, transformers.MistralForCausalLM, {"sliding_window": 64}),
    "mixtral": (transformers.MixtralConfig, transformers.MixtralForCausalLM,
                {"num_local_experts": 4, "num_experts_per_tok": 2}),
}


def _save(tmp_path, family="llama", safe=True, **kw):
    cfg_cls, model_cls, extra = FAMILIES[family]
    torch.manual_seed(0)
    m = model_cls(cfg_cls(**{**TINY, **extra, **kw})).eval()
    d = str(tmp_path / family)
    m.save_pretrained(d, safe_serialization=safe)
    return d, m


def _jax_state(d, cfg_j, **kw):
    """The reference's load, carried across to a port state dict."""
    return params_from_jax(jax.tree.map(np.asarray, jhf.load_params(d, cfg_j, **kw)))


def _edit_config(d, **fields):
    with open(os.path.join(d, "config.json")) as f:
        c = json.load(f)
    c.update(fields)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(c, f)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_from_hf_matches_the_reference(tmp_path, family):
    d, _ = _save(tmp_path, family)
    assert thf.config_from_hf(d) == config_from_jax(jhf.config_from_hf(d))
    assert thf.eos_token_ids_from_hf(d) == jhf.eos_token_ids_from_hf(d)


def test_eos_ids_from_config_and_generation_config(tmp_path):
    d, _ = _save(tmp_path, eos_token_id=[7, 9])
    with open(os.path.join(d, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [9, 11]}, f)
    assert thf.eos_token_ids_from_hf(d) == jhf.eos_token_ids_from_hf(d) == [7, 9, 11]
    assert thf.eos_token_id_from_hf(d) == 7


def _break(d, how):
    """Damage a saved directory the way each refusal test names."""
    import safetensors.torch as st

    fn = next((f for f in sorted(os.listdir(d)) if f.endswith(".safetensors")), None)
    if how == "unknown_architecture":
        _edit_config(d, architectures=["FalconForCausalLM"])
    elif how == "rope_scaling":
        _edit_config(d, rope_scaling={"rope_type": "yarn", "factor": 4.0})
    elif how == "no_weights":
        for f in os.listdir(d):
            if f.endswith(".safetensors"):
                os.remove(os.path.join(d, f))
    elif how in ("missing_layer_slice", "unrecognized_tensor", "unrecognized_expert_tensor", "missing_expert_slice"):
        sd = st.load_file(os.path.join(d, fn))
        if how == "missing_layer_slice":
            del sd["model.layers.1.mlp.gate_proj.weight"]
        elif how == "unrecognized_tensor":
            sd["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(TINY["hidden_size"])
        elif how == "missing_expert_slice":
            del sd["model.layers.1.block_sparse_moe.experts.2.w3.weight"]
        else:
            sd["model.layers.0.block_sparse_moe.experts.1.w4.weight"] = torch.zeros(4, 4)
        st.save_file(sd, os.path.join(d, fn))
    elif how == "missing_declared_shard":
        with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
            json.dump({"weight_map": {"model.embed_tokens.weight": fn,
                                      "model.norm.weight": "model-00099-of-00099.safetensors"}}, f)


@pytest.mark.parametrize("how,error,match", [
    ("unknown_architecture", ValueError, "unsupported architecture"),
    ("rope_scaling", ValueError, "rope_scaling"),
    ("no_weights", FileNotFoundError, "safetensors"),
    ("missing_layer_slice", ValueError, "slices never staged"),
    ("missing_declared_shard", FileNotFoundError, "not present"),
    ("unrecognized_tensor", ValueError, "no place in the model config"),
    ("unrecognized_expert_tensor", ValueError, "unrecognized expert tensor"),
    ("missing_expert_slice", ValueError, "slices never staged"),
])
def test_refusals_match_the_reference(tmp_path, how, error, match):
    """Each broken directory is refused by the port as by the reference
    (the expert cases on a Mixtral directory), and a refused load writes
    nothing into the model."""
    d, _ = _save(tmp_path, "mixtral" if "expert" in how else "llama")
    _break(d, how)
    if how in ("unknown_architecture", "rope_scaling"):
        with pytest.raises(error, match=match):
            thf.config_from_hf(d)
        with pytest.raises(error, match=match):
            jhf.config_from_hf(d)
        return
    cfg = thf.config_from_hf(d)
    model = tllama.Llama(cfg, "cpu")
    for p in model.parameters():
        p.fill_(7.0)
    with pytest.raises(error, match=match):
        thf.load_params(d, model)
    with pytest.raises(error, match=match):
        jhf.load_params(d, jhf.config_from_hf(d))
    assert all(bool((p == 7.0).all()) for p in model.parameters())


@pytest.mark.parametrize("layout", ["single_fp32", "sharded_fp32", "sharded_bf16", "bin", "qwen2", "qwen3",
                                    "gemma", "llama_tied", "mixtral"])
def test_load_params_is_bit_equal_to_the_reference(tmp_path, layout):
    """The port's load into a bf16 model equals the reference's tree in
    bf16, bit for bit: fp32 checkpoints cast on the way (round to nearest
    even), bf16 ones copied; one safetensors file, an indexed set of
    shards, a pytorch_model.bin; every family's names and knobs, Mixtral's
    router and expert slices too."""
    if layout.startswith("sharded"):
        d = build_sharded_hf_model_dir(str(tmp_path / "m"),
                                       torch_dtype=torch.bfloat16 if layout.endswith("bf16") else None)
    elif layout in FAMILIES:
        d, _ = _save(tmp_path, layout)
    else:
        d, _ = _save(tmp_path, safe=layout != "bin")
    if layout == "bin":
        assert any(f.endswith(".bin") for f in os.listdir(d))
    cfg_j = jhf.config_from_hf(d)
    ref = _jax_state(d, cfg_j)
    cfg = thf.config_from_hf(d)
    assert cfg.dtype == torch.bfloat16
    model = tllama.Llama(cfg, "cpu")
    stats = thf.load_params(d, model)
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k].view(torch.int16), ref[k].view(torch.int16)), k
    assert stats.tensors > 0 and stats.bytes_h2d == stats.bytes_read > 0 and stats.total_s > 0


def test_digests_equal_the_reference_strings(tmp_path):
    d = build_sharded_hf_model_dir(str(tmp_path / "m"))
    ref = jhf.LoadStats()
    jhf.load_params(d, jhf.config_from_hf(d), stats=ref, want_digests=True)
    model = tllama.Llama(thf.config_from_hf(d), "cpu")
    got = thf.load_params(d, model, want_digests=True)
    assert got.digests == ref.digests and len(got.digests) == 12
    assert thf.load_params(d, model).digests == {}  # off by default


def test_two_ranks_joined_equal_one_rank(tmp_path):
    """A load into a two-rank model on ``cpu,cpu`` gives each rank the
    slice of the one-rank model's weights that shard_params cuts."""
    d = build_sharded_hf_model_dir(str(tmp_path / "m"))
    cfg = thf.config_from_hf(d)
    one = tllama.Llama(cfg, "cpu")
    thf.load_params(d, one)
    mesh = serving_mesh(2, ["cpu", "cpu"])
    two = tllama.ShardedLlama(cfg, mesh)
    thf.load_params(d, two)
    want = tllama.shard_params(one.state_dict(), cfg, mesh)
    got = two.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert thf.model_digests(two) == thf.model_digests(one)


def test_a_load_keeps_every_state_address(tmp_path):
    """The engine's loader writes into its arena tensors in place: a
    reload (what a level-2 wake runs) changes no ``data_ptr()`` and gives
    the same bits."""
    d, _ = _save(tmp_path)
    cfg = thf.config_from_hf(d)
    eng = InferenceEngine(EngineConfig(model=cfg, max_batch=2, page_size=8, num_pages=16, max_seq_len=64),
                          params=lambda model: thf.load_params(d, model), device="cpu")
    tensors = list(eng.model.parameters()) + list(eng.model.buffers()) + eng.pool.tensors()
    ptrs = [t.data_ptr() for t in tensors]
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    for p in eng.model.parameters():
        p.zero_()
    eng.reload_params()
    assert [t.data_ptr() for t in tensors] == ptrs
    assert all(torch.equal(v, before[k]) for k, v in eng.model.state_dict().items())


def test_safetensors_reader_matches_safe_open(tmp_path):
    """The port's reader against the safetensors package on the files
    transformers wrote (fp32 and bf16), and on a file it wrote itself."""
    from safetensors import safe_open

    dirs = [build_sharded_hf_model_dir(str(tmp_path / "f32")),
            build_sharded_hf_model_dir(str(tmp_path / "bf16"), torch_dtype=torch.bfloat16)]
    mine = str(tmp_path / "mine.safetensors")
    tst.save_file({"a": torch.randn(3, 5).to(torch.bfloat16), "b": torch.randn(7).half(), "c": torch.zeros(0, 2)},
                  mine, metadata={"format": "pt"})
    files = [os.path.join(d, f) for d in dirs for f in sorted(os.listdir(d)) if f.endswith(".safetensors")] + [mine]
    for path in files:
        ours = tst.SafetensorsFile(path)
        with safe_open(path, framework="pt") as f:
            assert ours.keys() == list(f.keys()) or sorted(ours.keys()) == sorted(f.keys())
            assert ours.metadata == (f.metadata() or {})
            for k in f.keys():
                want, got = f.get_tensor(k), ours.get(k)
                assert got.dtype == want.dtype and got.shape == want.shape
                assert torch.equal(got.view(torch.uint8) if got.numel() else got,
                                   want.view(torch.uint8) if want.numel() else want), (path, k)


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    import safetensors.torch as st

    path = str(tmp_path / "i8.safetensors")
    st.save_file({"x": torch.zeros(4, dtype=torch.int8)}, path)
    with pytest.raises(ValueError, match="'I8'"):
        tst.SafetensorsFile(path)


def _hf_logits_and_tokens(model, cfg, prompt, new):
    """The port's fp32 prefill logits over ``prompt`` and its greedy
    ``new`` tokens, through the engine."""
    num_pages, ps = 16, 8
    shape = (cfg.num_layers, num_pages, ps, cfg.num_kv_heads, cfg.head_dim)
    cache = (torch.zeros(shape), torch.zeros(shape))
    pages = -(-len(prompt) // ps)
    table = torch.arange(1, pages + 1, dtype=torch.int32)[None]
    logits = tllama.prefill(model, torch.tensor([prompt], dtype=torch.int32),
                            torch.tensor([len(prompt)], dtype=torch.int32), cache, table)[0]
    eng = InferenceEngine(EngineConfig(model=cfg, max_batch=2, page_size=8, num_pages=32, max_seq_len=64),
                          params=model, device="cpu")
    return logits, eng.generate([prompt], max_new_tokens=new)[0]


@pytest.mark.parametrize("family", ["llama", "qwen2", "gemma", "mixtral"])
def test_logits_and_greedy_tokens_match_transformers_fp32(tmp_path, family):
    """At fp32, the loaded model's logits equal transformers' to 2e-3
    (the reference test's tolerance: fp32 sums in another order) and its
    eight greedy tokens are transformers' own."""
    d, m = _save(tmp_path, family)
    cfg = thf.config_from_hf(d, dtype=torch.float32)
    model = tllama.Llama(cfg, "cpu")
    thf.load_params(d, model)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    with torch.no_grad():
        ref = m(torch.tensor([prompt])).logits[0].float()
        want = m.generate(torch.tensor([prompt[:8]]), max_new_tokens=8, do_sample=False, eos_token_id=None,
                          pad_token_id=0)[0, 8:].tolist()
    logits, _ = _hf_logits_and_tokens(model, cfg, prompt, 1)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=2e-3, atol=2e-3)
    _, tokens = _hf_logits_and_tokens(model, cfg, prompt[:8], 8)
    assert tokens == want


def test_load_stats_are_the_reference_names():
    names = {f.name for f in dataclasses.fields(thf.LoadStats)}
    ref = {f.name for f in dataclasses.fields(jhf.LoadStats)}
    assert {"total_s", "read_s", "convert_s", "h2d_s", "bytes_read", "bytes_h2d", "shards", "digests"} <= names & ref


def test_stager_records_on_the_destination_cards_stream(monkeypatch):
    """A stager for a card that is not the current one (a second rank, or
    ``--device cuda:1``) records the events that time its copies and free
    its buffers on its copy stream on that card, where the copies run; an
    event on the current card's stream would let a buffer be refilled
    while its transfer is still in flight. It waits on those events only,
    never on the whole card. The card's calls are stand-ins here, the
    copies the CPU's own."""
    recorded = []

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self, stream=None):
            recorded.append(stream if stream is not None else ("stream", torch.device("cuda", 0)))

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 0.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())

    def no_device_sync(device=None):
        raise AssertionError("the stager waited on the whole card")

    monkeypatch.setattr(torch.cuda, "synchronize", no_device_sync)
    stager = thf._Stager(torch.device("cpu"), 64)
    stager.device, stager.cuda, stager.stream = torch.device("cuda", 1), True, ("stream", torch.device("cuda", 1))
    src = torch.arange(40 * 4, dtype=torch.float32).view(40, 4)
    dest = torch.zeros(4, 40)
    assert stager.put(src, dest, transpose=True) == src.numel() * 4
    stager.finish()
    assert torch.equal(dest, src.T)
    assert len(recorded) == 3 * 10 and set(recorded) == {("stream", torch.device("cuda", 1))}

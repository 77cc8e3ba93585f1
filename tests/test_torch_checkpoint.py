"""The port's Orbax checkpoints (``models/checkpoint.py`` over
``models/ocdbt.py``) against the JAX package's, on the CPU.

* Either package's ``save_params`` -> the other's ``load_params``, bit
  for bit (the bf16 bits through a uint16 view), for ``LlamaConfig.tiny``,
  ``tiny_gemma`` and ``MoeConfig.tiny_moe``, each with a chunk grid of
  more than one chunk (the JAX side writes a chunk per shard of a ``tp``
  2 array; the port's writer cuts chunks along the first axis), and the
  two manifests' digests equal.
* The reader's checks: a CRC-32C, a length, a magic, a frame that does
  not decode, refused; a shape mismatch refused with the reference's
  message; a quantized config restored bf16 and quantized on the way in.
* The mirrors of ``tests/test_checkpoint.py``'s five cases (round trip,
  shape mismatch, an engine serving the checkpoint's weights, a restore
  onto a ``cpu,cpu`` mesh, the level-2 wake rereading the checkpoint) and
  of ``tests/test_moe.py::test_moe_checkpoint_roundtrip``.
* The service: ``--checkpoint-dir``, a swap between two checkpoints that
  differ in ``lm_head`` (cold, then a pool hit that moves only that
  leaf's bytes and the KV), a co-resident attach of a checkpoint's model,
  each held to the JAX package's ``EngineService`` at fp32 (the named
  ``tiny`` config's dtype patched to float32 on both sides, so greedy
  tokens are off the bf16 near-tie edge).

Tolerance: none. Every comparison is exact (bits, digests, tokens).
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import server as jserver
from llm_d_fast_model_actuation_tpu.models import checkpoint as jck
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu.models import moe as jmoe
from llm_d_fast_model_actuation_tpu.models.registry import init_params_for
from llm_d_fast_model_actuation_tpu_torch.engine import EngineConfig, InferenceEngine
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.models import checkpoint as tck
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models import ocdbt
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.models.quant import quantize_weight
from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import MeshPlan, make_mesh, shard_for

CONFIGS = {
    "tiny": jllama.LlamaConfig.tiny,
    "tiny_gemma": jllama.LlamaConfig.tiny_gemma,
    "tiny_moe": jmoe.MoeConfig.tiny_moe,
}
OPTS = "--num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0 --swap-bucket-mib 1"
#: the byte keys both services report for every swap
BYTE_KEYS = ("tier", "pool_hit", "swapped", "bytes_out", "bytes_in", "bytes_moved", "bytes_deduped", "deduped_leaves")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (bf16 through a uint16 view), from either package."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()).copy()
    a = np.asarray(x)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _assert_same(jtree, ttree) -> None:
    j, t = dict(_flat(jtree)), dict(_flat(ttree))
    assert sorted(j) == sorted(t)
    for k in j:
        a, b = _bits(j[k]), _bits(t[k])
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), k


def _chunk_counts(directory: str) -> dict:
    db = ocdbt.Database(os.path.join(directory, tck.PARAMS_DIR))
    names = sorted(k[: -len("/.zarray")] for k in db.entries if k.endswith("/.zarray"))
    return {n: len(list(ocdbt.ZarrArray(db, n).grid())) for n in names}


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory, devices8):
    """Each config's params written by the JAX package: once whole, once
    with every leaf of rank >= 2 sharded over a tp-2 mesh (a chunk per
    shard)."""
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = jax.sharding.Mesh(np.array(devices8[:2]), ("tp",))
    out = {}
    for name, make in CONFIGS.items():
        cfg = make()
        params = init_params_for(jax.random.key(7), cfg)
        whole = str(tmp_path_factory.mktemp(f"jax-{name}"))
        jck.save_params(whole, cfg, params)
        sharded = jax.tree.map(
            lambda a: jax.device_put(a, NamedSharding(mesh, PartitionSpec(*([None] * (a.ndim - 1) + ["tp"]))))
            if a.ndim >= 2 and a.shape[-1] % 2 == 0 else a, params)
        chunked = str(tmp_path_factory.mktemp(f"jax-{name}-chunked"))
        jck.save_params(chunked, cfg, sharded)
        out[name] = (cfg, params, whole, chunked)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("layout", ["whole", "chunked"])
def test_the_jax_packages_checkpoint_loads_bit_exact(jax_saved, name, layout):
    cfg, params, whole, chunked = jax_saved[name]
    directory = whole if layout == "whole" else chunked
    if layout == "chunked":
        assert max(_chunk_counts(directory).values()) > 1
    tree = tck.load_params(directory, config_from_jax(cfg))
    _assert_same(params, tree)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_ports_checkpoint_loads_bit_exact_in_the_jax_package(jax_saved, tmp_path, name, monkeypatch):
    cfg, params, whole, _ = jax_saved[name]
    tree = tck.load_params(whole, config_from_jax(cfg))
    monkeypatch.setattr(tck, "CHUNK_BYTES", 4096)
    got = tck.save_params(str(tmp_path / "port"), config_from_jax(cfg), tree)
    assert max(_chunk_counts(str(tmp_path / "port")).values()) > 1
    assert got["bytes"] == sum(np.asarray(x).nbytes for x in jax.tree.leaves(params))
    _assert_same(params, jck.load_params(str(tmp_path / "port"), cfg))
    # the JAX package's shape check accepts the port's config.json
    jck.validate_config(str(tmp_path / "port"), cfg)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_both_manifests_hold_the_same_digests(jax_saved, tmp_path, name):
    cfg, params, whole, _ = jax_saved[name]
    tck.save_params(str(tmp_path / "port"), config_from_jax(cfg), tck.load_params(whole, config_from_jax(cfg)))
    theirs = json.load(open(os.path.join(whole, tck.MANIFEST_FILE)))
    mine = json.load(open(tmp_path / "port" / tck.MANIFEST_FILE))
    assert mine == theirs and mine["format"] == 1 and len(mine["digests"]) == len(jax.tree.leaves(params))
    assert tck.read_manifest(whole) == theirs["digests"]


def test_shape_mismatch_fails_loudly_with_the_references_message(jax_saved):
    cfg, _, whole, _ = jax_saved["tiny"]
    wrong = dataclasses.replace(config_from_jax(cfg), hidden_size=cfg.hidden_size * 2)
    with pytest.raises(ValueError, match="different model shape") as port:
        tck.load_params(whole, wrong)
    with pytest.raises(ValueError, match="different model shape") as ref:
        jck.load_params(whole, dataclasses.replace(cfg, hidden_size=cfg.hidden_size * 2))
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="different model shape"):
        tck.load_params(whole, config_from_jax(jax_saved["tiny_gemma"][0]))
    with pytest.raises(FileNotFoundError, match="no checkpoint config"):
        tck.load_params(os.path.dirname(whole), config_from_jax(cfg))


def _corrupt(src: str, dst: str, rel: str, at: int) -> str:
    shutil.copytree(src, dst)
    path = os.path.join(dst, tck.PARAMS_DIR, rel)
    blob = bytearray(open(path, "rb").read())
    blob[at] ^= 0x40
    open(path, "wb").write(bytes(blob))
    return dst


def test_a_corrupted_file_is_refused(jax_saved, tmp_path):
    cfg, _, whole, _ = jax_saved["tiny"]
    tcfg = config_from_jax(cfg)
    # a byte of the manifest's body: its CRC-32C no longer checks
    bad = _corrupt(whole, str(tmp_path / "crc"), ocdbt.MANIFEST_FILE, 20)
    with pytest.raises(ocdbt.FormatError, match="CRC-32C"):
        tck.load_params(bad, tcfg)
    # the length field
    bad = _corrupt(whole, str(tmp_path / "len"), ocdbt.MANIFEST_FILE, 4)
    with pytest.raises(ocdbt.FormatError, match="header says"):
        tck.load_params(bad, tcfg)
    # the magic
    bad = _corrupt(whole, str(tmp_path / "magic"), ocdbt.MANIFEST_FILE, 0)
    with pytest.raises(ocdbt.FormatError, match="magic"):
        tck.load_params(bad, tcfg)
    # a truncated node file: its length no longer checks
    db = ocdbt.Database(os.path.join(whole, tck.PARAMS_DIR))
    shutil.copytree(whole, tmp_path / "trunc")
    node = [f for f in os.listdir(tmp_path / "trunc" / tck.PARAMS_DIR / "d")][0]
    path = tmp_path / "trunc" / tck.PARAMS_DIR / "d" / node
    open(path, "wb").write(open(path, "rb").read()[:-1])
    with pytest.raises(ocdbt.FormatError):
        tck.load_params(str(tmp_path / "trunc"), tcfg)
    # a chunk whose frame no longer decodes
    v = db.entries["layers.wq/0.0.0"]
    shutil.copytree(whole, tmp_path / "frame")
    path = tmp_path / "frame" / tck.PARAMS_DIR / v.path
    blob = bytearray(open(path, "rb").read())
    blob[v.offset + v.length // 2] ^= 0xFF
    blob[v.offset + 1] ^= 0xFF  # the frame's magic
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ocdbt.FormatError, match="layers.wq"):
        tck.load_params(str(tmp_path / "frame"), tcfg)


def test_crc32c_is_castagnolis():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    assert ocdbt.crc32c(b"") == 0
    data = bytes(range(256)) * 3 + b"tail"
    assert ocdbt.crc32c(data[100:], ocdbt.crc32c(data[:100])) == ocdbt.crc32c(data)


def test_a_quantized_config_restores_bf16_and_quantizes_on_the_way_in(jax_saved):
    cfg, params, whole, _ = jax_saved["tiny"]
    qcfg = dataclasses.replace(config_from_jax(cfg), quantization="int8")
    model = tllama.Llama(qcfg, "cpu")
    tck.load_params(whole, model)
    state = params_from_jax(jax.tree.map(np.asarray, params))
    for name in tllama.quantized_names(qcfg):
        want = quantize_weight(state[name]) if state[name].dim() == 2 else None
        got_q, got_s = model.get_parameter(f"{name}.q"), model.get_parameter(f"{name}.s")
        for i in range(state[name].shape[0] if state[name].dim() >= 3 else 1):
            w = quantize_weight(state[name][i]) if want is None else want
            q, s = (got_q[i], got_s[i]) if want is None else (got_q, got_s)
            assert torch.equal(q, w["q"]) and torch.equal(s, w["s"]), name
    for name, t in model.named_parameters():
        base = name.rpartition(".")[0]
        if base not in tllama.quantized_names(qcfg):
            assert torch.equal(t, state[name]), name


# -- the mirrors of tests/test_checkpoint.py and test_moe.py's round trip ------


def test_roundtrip_bitexact(tmp_path):
    cfg = tllama.LlamaConfig.tiny()
    model = tllama.init_params(cfg, torch.Generator().manual_seed(42), "cpu")
    tck.save_params(str(tmp_path), cfg, model)
    restored = tllama.Llama(cfg, "cpu")
    st = tck.load_params(str(tmp_path), restored)
    for (name, a), (_, b) in zip(model.named_parameters(), restored.named_parameters()):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), name
    assert st.bytes_h2d == sum(t.numel() * t.element_size() for t in model.parameters())
    assert st.digests == tck.read_manifest(str(tmp_path)) and len(st.digests) == len(list(model.parameters()))


def test_shape_mismatch_fails_loudly(tmp_path):
    cfg = tllama.LlamaConfig.tiny()
    tck.save_params(str(tmp_path), cfg, tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(ValueError, match="different model shape"):
        tck.load_params(str(tmp_path), dataclasses.replace(cfg, hidden_size=cfg.hidden_size * 2))


def test_engine_serves_checkpoint_weights(jax_saved, tmp_path):
    """An engine loading the checkpoint generates what an engine holding
    the original weights generates, and what the JAX engine does (fp32)."""
    from llm_d_fast_model_actuation_tpu.engine import engine as jengine

    jm = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    params = jllama.init_params(jax.random.key(42), jm)
    jck.save_params(str(tmp_path), jm, params)
    base = dict(max_batch=2, page_size=8, num_pages=32, max_seq_len=64)
    gold = jengine.InferenceEngine(jengine.EngineConfig(model=jm, **base), params=params, seed=0).generate(
        [[1, 2, 3]], max_new_tokens=6)
    tcfg = EngineConfig(model=config_from_jax(jm), **base)
    held = InferenceEngine(tcfg, params=params_from_jax(jax.tree.map(np.asarray, params)), device="cpu")
    loaded = InferenceEngine(tcfg, params=lambda m: tck.load_params(str(tmp_path), m), device="cpu")
    assert held.generate([[1, 2, 3]], max_new_tokens=6) == gold
    assert loaded.generate([[1, 2, 3]], max_new_tokens=6) == gold


def test_sharded_restore_lands_on_mesh(jax_saved):
    """Each rank of a tp-2 ``cpu,cpu`` mesh gets its own slice of every
    chunk, as ``param_specs`` cuts it (and the JAX package's sharded
    restore holds the same numbers). Called with the reference's
    signature: ``mesh`` the model's own, ``stats_out`` filled in place."""
    cfg, params, _, chunked = jax_saved["tiny"]
    tcfg = config_from_jax(cfg)
    mesh = make_mesh(MeshPlan(tp=2), [torch.device("cpu")] * 2)
    model = tllama.ShardedLlama(tcfg, mesh)
    with pytest.raises(ValueError, match="mesh must be the target model's own"):
        tck.load_params(chunked, model, mesh=make_mesh(MeshPlan(tp=2), [torch.device("cpu")] * 2))
    out = {}
    tck.load_params(chunked, model, mesh=mesh, stats_out=out)
    assert out["bytes"] == sum(np.asarray(x).nbytes for x in jax.tree.leaves(params)) and out["restore_s"] > 0
    assert out["digests"] == json.load(open(os.path.join(chunked, "manifest.json")))["digests"]
    state = params_from_jax(jax.tree.map(np.asarray, params))
    specs = tllama.param_specs(tcfg)
    split = 0
    for r, rank in enumerate(model.ranks):
        for name, t in rank.named_parameters():
            want = shard_for(state[name], specs[name], mesh, r)
            split += t.shape != state[name].shape
            assert torch.equal(t, want), (r, name)
    assert split


def test_moe_sharded_restore_lands_on_an_ep_mesh(jax_saved):
    cfg, params, whole, _ = jax_saved["tiny_moe"]
    tcfg = config_from_jax(cfg)
    mesh = make_mesh(MeshPlan(tp=2, ep=2), [torch.device("cpu")] * 4)
    model = tllama.ShardedLlama(tcfg, mesh)
    tck.load_params(whole, model)
    state = params_from_jax(jax.tree.map(np.asarray, params))
    specs = tllama.param_specs(tcfg)
    for r, rank in enumerate(model.ranks):
        for name, t in rank.named_parameters():
            assert torch.equal(t, shard_for(state[name], specs[name], mesh, r)), (r, name)


def test_moe_checkpoint_roundtrip(tmp_path, monkeypatch):
    mcfg = config_from_jax(jmoe.MoeConfig.tiny_moe())
    model = tllama.init_params(mcfg, torch.Generator().manual_seed(7), "cpu")
    monkeypatch.setattr(tck, "CHUNK_BYTES", 1024)
    tck.save_params(str(tmp_path), mcfg, model)
    tree = tck.load_params(str(tmp_path), mcfg)
    for name, t in model.named_parameters():
        node = tree
        for part in name.split("."):
            node = node[part]
        assert torch.equal(node, t), name


def test_the_seeding_cli_writes_what_the_jax_package_restores(tmp_path, capsys):
    out = str(tmp_path / "seeded")
    assert tck.main(["--model", "tiny", "--out", out, "--seed", "3", "--device", "cpu"]) == 0
    assert "wrote tiny" in capsys.readouterr().out
    restored = jck.load_params(out, jllama.LlamaConfig.tiny())
    want = tllama.init_params(tllama.LlamaConfig.tiny(), torch.Generator().manual_seed(3), "cpu")
    for name, t in want.named_parameters():
        node = restored
        for part in name.split("."):
            node = node[part]
        assert np.array_equal(_bits(node), _bits(t)), name


# -- the service ---------------------------------------------------------------


@pytest.fixture
def fp32_tiny(monkeypatch):
    """The named ``tiny`` config at float32 in both services."""
    j = lambda: dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)  # noqa: E731
    monkeypatch.setitem(jserver.MODEL_CONFIGS, "tiny", j)
    monkeypatch.setitem(tserver.MODEL_CONFIGS, "tiny", lambda: config_from_jax(j()))
    return j


@pytest.fixture
def sibling_ckpts(fp32_tiny, tmp_path):
    """Two fp32 ``tiny`` checkpoints written by the JAX package that
    differ in ``lm_head`` only."""
    cfg = fp32_tiny()
    params = jllama.init_params(jax.random.key(42), cfg)
    dirs = []
    for i in range(2):
        p = dict(params)
        if i:
            p["lm_head"] = params["lm_head"][:, ::-1]
        d = str(tmp_path / f"sib-{i}")
        jck.save_params(d, cfg, p)
        dirs.append(d)
    return dirs


def _tokens(svc, prompt=(1, 2, 3), n=6) -> list:
    return list(svc.submit(prompt=list(prompt), max_new_tokens=n).result(timeout=120).out_tokens)


def _jtokens(svc, prompt=(1, 2, 3), n=6) -> list:
    return list(svc.submit(list(prompt), n, 0.0).result(timeout=120).out_tokens)


def test_level2_wake_reloads_from_checkpoint(sibling_ckpts):
    """--checkpoint-dir: a level-2 sleep discards the weights, the wake
    reads the checkpoint again and serves what it served, and what the
    JAX package's service serves."""
    d = sibling_ckpts[0]
    opts = f"--model tiny {OPTS} --checkpoint-dir {d} --sleep-release-devices never"
    ref = jserver.EngineService(jserver.parse_engine_options(opts))
    svc = tserver.EngineService(tserver.parse_engine_options(opts + " --device cpu"))
    try:
        want = _jtokens(ref)
        out1 = _tokens(svc)
        loads = svc._runtime.loads
        svc.sleep(2)
        assert svc.sleeper.level == 2
        svc.wake_up()
        out2 = _tokens(svc)
        assert out1 == out2 == want
        assert svc._runtime.loads == loads + 1 and svc.checkpoint_dir == d
        assert svc._runtime.digests == tck.read_manifest(d)
    finally:
        svc.shutdown()
        ref.shutdown()


def test_a_swap_between_checkpoints_moves_only_the_differing_leaf(sibling_ckpts):
    """tiny@A -> tiny@B (cold) -> tiny@A (a pool hit: the manifests'
    digests leave every leaf but lm_head in place) -> tiny@B, through both
    services: the tiers and the pool hits the reference's, greedy tokens
    the reference's, the delta swap's bytes two lm_heads and two KV pools."""
    a, b = sibling_ckpts
    opts = f"--model tiny {OPTS} --checkpoint-dir {a} --model-pool-mib 64"
    ref = jserver.EngineService(jserver.parse_engine_options(opts))
    svc = tserver.EngineService(tserver.parse_engine_options(opts + " --device cpu"))
    try:
        assert _tokens(svc) == _jtokens(ref)
        steps = []
        for ckpt in (b, a, b):
            got, want = svc.swap("tiny", checkpoint_dir=ckpt), ref.swap("tiny", checkpoint_dir=ckpt)
            assert {k: got[k] for k in BYTE_KEYS} == {k: want[k] for k in BYTE_KEYS}
            assert got["checkpoint_dir"] == want["checkpoint_dir"] == ckpt
            assert _tokens(svc) == _jtokens(ref), ckpt
            steps.append(got)
        assert [s["tier"] for s in steps] == ["cold", "pool", "pool"]
        head = svc.engine.model.get_parameter("lm_head")
        kv = svc.engine.pool.nbytes()
        for s in steps[1:]:
            assert s["bytes_moved"] == 2 * (head.numel() * head.element_size() + kv)
            assert s["deduped_leaves"] == len(list(svc.engine.model.parameters())) - 1
        # a swap naming no checkpoint takes the model from any source: the
        # one pooled (tiny@A), never a random-weights cold build
        out = svc.swap("tiny")
        assert out["swapped"] is False and out["checkpoint_dir"] == b
    finally:
        svc.shutdown()
        ref.shutdown()


def test_serving_the_sibling_differs_where_lm_head_does(sibling_ckpts):
    a, b = sibling_ckpts
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model tiny {OPTS} --checkpoint-dir {a} --device cpu"))
    try:
        first = _tokens(svc, n=1)
        svc.swap("tiny", checkpoint_dir=b)
        # lm_head's columns reversed: the vocabulary mirrored
        assert _tokens(svc, n=1) == [svc.engine.cfg.model.vocab_size - 1 - first[0]]
    finally:
        svc.shutdown()


def test_a_checkpoints_model_attaches_as_a_resident(sibling_ckpts):
    """Swap to tiny@B and back pools B with its manifest's digests: an
    attach of ``tiny`` at B's checkpoint then moves only its lm_head, and
    a request routed to ``tiny@B`` gets the tokens the JAX package's
    service serving B gives (the reference's own attach fails here:
    ``test_torch_coresident.py:test_the_references_attach_fails_today``)."""
    a, b = sibling_ckpts
    svc = tserver.EngineService(tserver.parse_engine_options(
        f"--model tiny {OPTS} --checkpoint-dir {a} --device cpu --packed-serving on --resident-variants 3 "
        "--num-pages 64"))
    ref_b = jserver.EngineService(jserver.parse_engine_options(f"--model tiny {OPTS} --checkpoint-dir {b}"))
    try:
        svc.swap("tiny", checkpoint_dir=b)
        svc.swap("tiny", checkpoint_dir=a)
        out = svc.attach_resident("tiny", checkpoint_dir=b)
        head = svc.engine.model.get_parameter("lm_head")
        assert out["attached"] and out["model"] == f"tiny@{b}" and out["residents"][f"tiny@{b}"]["delta_leaves"] == 1
        assert out["wire_bytes"] == head.numel() * head.element_size()
        handle = svc.resolve_request_model(f"tiny@{b}")
        assert handle == out["handle"] and svc.resolve_request_model("tiny") == 0
        routed = svc.submit(prompt=[1, 2, 3], max_new_tokens=6, variant=handle).result(timeout=120).out_tokens
        assert list(routed) == _jtokens(ref_b)
        with pytest.raises(ValueError, match="base model"):
            svc.attach_resident("tiny", checkpoint_dir=a)
        svc.detach_resident("tiny", checkpoint_dir=b)
    finally:
        svc.shutdown()
        ref_b.shutdown()


def test_the_prefetch_refuses_a_checkpoint_as_the_reference_does(sibling_ckpts):
    a, _ = sibling_ckpts
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model tiny {OPTS} --checkpoint-dir {a} --device cpu"))
    ref = jserver.EngineService(jserver.parse_engine_options(f"--model tiny {OPTS} --checkpoint-dir {a}"))
    try:
        with pytest.raises(ValueError, match="prefetch cannot stage an Orbax checkpoint_dir") as port:
            svc.prefetch("hf:/x", checkpoint_dir=a)
        with pytest.raises(ValueError, match="prefetch cannot stage an Orbax checkpoint_dir") as theirs:
            ref.prefetch("hf:/x", checkpoint_dir=a)
        assert str(port.value) == str(theirs.value)
    finally:
        svc.shutdown()
        ref.shutdown()

"""Compressed actuation in the port (``--sleep-quant``: ``models/quant.py``
and ``engine/sleep.py``) held against the JAX package's on the same seeded
inputs, on the CPU.

  * quantize and dequantize bit for bit (payload, scale, dequantized
    weights) at int8 and fp8, from bf16 and from f32: an all-zero column,
    values exactly between two int8 steps, the fp8 overflow that
    ``ml_dtypes`` turns into NaN where torch saturates, and a
    re-quantization with the cached scale;
  * the same plan, wire bytes, transfer digests and quant-aware
    ``estimate_param_bytes`` (a tiny config and Llama-3-8B, shapes only);
  * a sleep manager pair and an engine pair with the same weights: a
    quantized level-1 cycle gives the same bytes and the same bits in
    both packages, and three more cycles change nothing (lossy once);
    greedy tokens after the wake equal the JAX engine's (fp32, off the
    bf16 knife edge), and with the hot head off the logprobs drift at most
    the reference's documented 0.25;
  * quantized swaps: bytes equal to both packages' ``plan_swap``, a
    full-precision entry's host-staged copy, the delta composing with
    digests, a rollback at a fault point leaving both models bit-exact, a
    rolled-back first quantized offload keeping its scales;
  * ``q:`` chunks spill and reload content-verified; the refusals (a mesh
    names ROADMAP item 14, an unknown mode) and the level-2 escalation.
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
from llm_d_fast_model_actuation_tpu.engine.chunk_store import digest_tree as jdigest_tree
from llm_d_fast_model_actuation_tpu.models import hf as jhf
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu.models import quant as jq
from llm_d_fast_model_actuation_tpu.utils import faults as jfaults
from llm_d_fast_model_actuation_tpu_torch.engine import arena as tarena
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import server as tserver
from llm_d_fast_model_actuation_tpu_torch.engine import sleep as tsleep
from llm_d_fast_model_actuation_tpu_torch.engine.chunk_store import ChunkStore, flatten_state, leaf_digest
from llm_d_fast_model_actuation_tpu_torch.models import hf as thf
from llm_d_fast_model_actuation_tpu_torch.models import quant as tq
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax
from llm_d_fast_model_actuation_tpu_torch.utils import faults

BYTE_KEYS = ("bytes_out", "bytes_in", "bytes_moved", "bytes_deduped", "deduped_leaves", "buckets_out",
             "buckets_in", "bytes_full", "bucket_bytes", "quant", "quant_leaves", "bytes_saved_quant")
MODES = ("int8", "fp8")
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def _torch(a: np.ndarray) -> torch.Tensor:
    """The same bits as a torch tensor (bf16 through its int16 view)."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    """Raw bytes of a numpy array, a jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def _weights(dtype: str, seed: int = 0) -> np.ndarray:
    """A (3, 64, 48) stack with the edge cases of the quantization: an
    all-zero column, a column of exact half steps (amax 127, so the scale
    is exactly 1 and 0.5, 1.5, 2.5 ... round half to even), and the fp8
    overflow values."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((3, 64, 48)) * 0.05).astype(np.float32)
    w[1, :, 5] = 0.0
    w[0, :, 7] = np.concatenate([[127.0], np.arange(63) + 0.5]) * np.where(np.arange(64) % 2, -1, 1)
    w[0, 0, 0], w[2, 3, 3], w[2, 4, 4], w[1, 2, 9] = 470.0, -600.0, 3.3e38, 464.0
    return np.asarray(jnp.asarray(w, dtype=jnp.dtype(_np_dtype(dtype))))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_quantize_and_dequantize_bit_exact_against_the_reference(mode, dtype):
    w = _weights(dtype)
    wt = _torch(w)
    want_p, want_m = jq.quantize_leaf_np(w, mode)
    want_dev, _ = jq.quantize_leaf(jnp.asarray(w), mode)
    got_p, got_m = tq.quantize_leaf(wt, mode)
    host_p, host_m = tq.quantize_leaf_host(wt, mode)
    for p in (got_p, host_p):
        assert np.array_equal(_bits(p), _bits(want_p)) and np.array_equal(_bits(p), _bits(want_dev))
    assert got_m.orig_dtype == want_m.orig_dtype == dtype
    if mode == "int8":
        assert np.array_equal(_bits(got_m.scale), _bits(want_m.scale))
        assert got_m.scale[1, 0, 5].item() == np.float32(1e-8)  # the all-zero column's floor
        assert got_m.scale[0, 0, 7].item() == 1.0
        assert [int(v) for v in got_p[0, 1:6, 7]] == [0, 2, -2, 4, -4]  # -0.5, 1.5, -2.5, 3.5, -4.5: half to even
    else:
        assert got_m.scale is None and host_m.scale is None
    want_w = jq.dequantize_leaf(jnp.asarray(want_p), want_m)
    got_w = tq.dequantize_leaf(got_p, got_m)
    assert np.array_equal(_bits(got_w), _bits(want_w))
    assert np.array_equal(_bits(tq.dequantize_leaf_host(host_p, host_m)), _bits(want_w))
    # a re-quantization of the dequantized weights with the cached scale
    # gives the same payload (lossy once), as the reference's does
    again, _ = tq.quantize_leaf(got_w, mode, scale=got_m.scale)
    want_again, _ = jq.quantize_leaf_np(np.asarray(want_w), mode, scale=want_m.scale)
    assert np.array_equal(_bits(again), _bits(got_p)) and np.array_equal(_bits(again), _bits(want_again))
    assert tq.transfer_digest(got_p, got_m) == jq.transfer_digest(want_p, want_m)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_dequantize_into_writes_the_reference_weights_in_place(mode, dtype):
    """The one dequantization every wake, swap, rollback and staged
    placement runs: into the leaf's own tensor, the reference's bits."""
    w = _weights(dtype)
    want_p, want_m = jq.quantize_leaf_np(w, mode)
    want_w = jq.dequantize_leaf(jnp.asarray(want_p), want_m)
    p, m = tq.quantize_leaf_host(_torch(w), mode)
    dest = torch.full_like(_torch(w), float("nan"))
    ptr = dest.data_ptr()
    tq.dequantize_into(dest, p, m)
    assert dest.data_ptr() == ptr and np.array_equal(_bits(dest), _bits(want_w))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fp8_overflow_is_nan_as_the_reference(dtype):
    """torch saturates past 448; the reference (``ml_dtypes``) gives NaN
    with the value's sign for |x| > 464, and so does the port, on both
    paths: 470 -> 0x7f, -600 -> 0xff, 3.3e38 -> 0x7f, 464 -> 448 (0x7e)."""
    vals = np.array([470.0, -600.0, 3.3e38, 464.0, -448.0, np.nan], np.float32).reshape(1, 6)
    w = np.asarray(jnp.asarray(vals, dtype=jnp.dtype(_np_dtype(dtype))))
    want, _ = jq.quantize_leaf_np(w, "fp8")
    for fn in (tq.quantize_leaf, tq.quantize_leaf_host):
        got, meta = fn(_torch(w), "fp8")
        assert list(_bits(got)) == list(_bits(want)) == [0x7F, 0xFF, 0x7F, 0x7E, 0xFE, 0x7F]
        back = tq.dequantize_leaf(got, meta)
        assert np.array_equal(_bits(back), _bits(jq.dequantize_leaf_np(want, jq.TransferQuant("fp8", dtype))))


def _params(seed: int, dtype=np.float32, perturb: bool = False):
    """The reference test's llama-shaped tree: two quantizable stacks, the
    hot head, and a norm stack that never quantizes."""
    rng = np.random.default_rng(seed)
    p = {
        "embed": rng.standard_normal((64, 32)).astype(np.float32),
        "layers": {
            "wq": rng.standard_normal((2, 32, 32)).astype(np.float32),
            "w_up": rng.standard_normal((2, 32, 64)).astype(np.float32),
            "attn_norm": rng.standard_normal((2, 32)).astype(np.float32),
        },
        "final_norm": rng.standard_normal((32,)).astype(np.float32),
        "lm_head": rng.standard_normal((32, 64)).astype(np.float32),
    }
    if perturb:
        p["lm_head"] = p["lm_head"] * 1.5 + 0.25
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype=jnp.dtype(dtype))), p)


def _kv(seed: int):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, 8, 16)).astype(np.float32) for _ in range(2))


def _jmgr(params, kv_seed: int, **kw):
    box = {"state": jax.device_put({"params": params, "kv": _kv(kv_seed)}, jax.devices()[0])}
    return jsleep.SleepManager(lambda: box["state"], lambda s: box.__setitem__("state", s), **kw), box


def _in_arena(tree, arena):
    if isinstance(tree, dict):
        return {k: _in_arena(v, arena) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_in_arena(v, arena) for v in tree)
    src = _torch(tree)
    return arena.empty(tuple(src.shape), src.dtype, "offload").copy_(src)


def _tmgr(params, kv_seed: int, **kw):
    arena = tarena.Arena("cpu")
    state = _in_arena({"params": params, "kv": _kv(kv_seed)}, arena)
    return tsleep.SleepManager(lambda: state, lambda s: None, "cpu", [arena], **kw), state


def _same_leaves(torch_leaves, jax_leaves) -> bool:
    torch_leaves, jax_leaves = list(torch_leaves), list(jax_leaves)
    return len(torch_leaves) == len(jax_leaves) and all(
        np.array_equal(_bits(a), _bits(b)) for a, b in zip(torch_leaves, jax_leaves)
    )


def test_plan_payload_bytes_and_estimate_equal_the_reference():
    state = {"params": _params(0), "kv": _kv(1)}
    for hot_head in (True, False):
        want = jq.transfer_quant_plan(state, hot_head=hot_head)
        got = tq.transfer_quant_plan(_in_arena(state, tarena.Arena("cpu")), hot_head=hot_head)
        assert got == want and any(got)
    for shape in ((2, 32, 32), (64, 32), (3, 2, 16, 8)):
        for mode in MODES:
            assert tq.payload_nbytes(shape, mode) == jq.payload_nbytes(shape, mode)
    for name in ("tiny", "llama3_8b"):
        jcfg = getattr(jllama.LlamaConfig, name)()
        tcfg = config_from_jax(jcfg)
        for mode in ("off",) + MODES:
            for hot_head in (True, False):
                assert thf.estimate_param_bytes(tcfg, mode, hot_head) == jhf.estimate_param_bytes(jcfg, mode, hot_head)
    # a Llama-3-8B prefetch staged at int8 with the hot head: the layer
    # stacks' payloads and scales, the rest in bf16
    assert thf.estimate_param_bytes(config_from_jax(jllama.LlamaConfig.llama3_8b()), "int8") == 9_086_705_664


@pytest.mark.parametrize("mode", MODES)
def test_manager_cycles_equal_the_reference_and_are_lossy_once(mode):
    """A quantized level-1 sleep: the same wire and full bytes, the same
    payload bits and transfer digests; after the wake the same weights;
    three more cycles leave the bits as the first wake left them."""
    params = _params(3, dtype=ml_dtypes.bfloat16)
    jm, jbox = _jmgr(params, 1, quant_mode=mode)
    tm, tstate = _tmgr(params, 1, quant_mode=mode)
    want, got = jm.sleep(1), tm.sleep(1)
    for k in ("bytes_offloaded", "bytes_offloaded_full", "quant"):
        assert got[k] == want[k]
    assert got["bytes_offloaded"] < got["bytes_offloaded_full"] and got["quant"] == mode
    assert _same_leaves(tm._host, jax.tree.leaves(jm._host_state))
    assert tq.transfer_digest_map(tm._host_state, tm._quant_meta) == jq.transfer_digest_map(jm._host_state, jm._quant_meta)
    jm.wake_up()
    tm.wake_up()
    first = [t.clone() for t in flatten_state(tstate)]
    assert _same_leaves(first, jax.tree.leaves(jbox["state"]))
    for _ in range(3):
        tm.sleep(1)
        tm.wake_up()
    assert _same_leaves(flatten_state(tstate), first)


def test_escalation_drops_the_quant_metadata():
    tm, _ = _tmgr(_params(4), 2, quant_mode="int8")
    tm.sleep(1)
    tm.wake_up()
    tm.sleep(1)
    assert tm._quant_meta is not None and tm._quant_scales is not None and tm.quant_state() == "int8"
    out = tm.sleep(2)
    assert tm._quant_meta is None and tm._quant_scales is None and tm._host is None
    assert out["quant"] == "off" and out["bytes_offloaded"] == 0


def _engine_pair(dtype, mode, hot_head=True):
    jm = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=dtype)
    base = dict(max_batch=2, page_size=8, num_pages=24, max_seq_len=64)
    jeng = jengine.InferenceEngine(jengine.EngineConfig(model=jm, **base), seed=0)
    teng = tengine.InferenceEngine(
        tengine.EngineConfig(model=config_from_jax(jm), **base),
        params=params_from_jax(jax.tree.map(np.asarray, jeng.params)), device="cpu",
    )
    jmgr = jsleep.attach_sleep(jeng, quant_mode=mode, quant_hot_head=hot_head)
    tmgr = tsleep.attach_sleep(teng, quant_mode=mode, quant_hot_head=hot_head)
    return (jeng, jmgr), (teng, tmgr)


def _flat_jax(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _engine_bits_equal(jeng, teng) -> bool:
    want = _flat_jax(jeng.params)
    got = thf.model_leaves(teng.model)
    return sorted(got) == sorted(want) and all(np.array_equal(_bits(got[k]), _bits(want[k])) for k in want)


@pytest.mark.parametrize("mode", MODES)
def test_engine_cycle_bit_equal_across_the_packages(mode):
    (jeng, jmgr), (teng, tmgr) = _engine_pair(jnp.bfloat16, mode)
    want, got = jmgr.sleep(1), tmgr.sleep(1)
    assert (got["bytes_offloaded"], got["bytes_offloaded_full"]) == (want["bytes_offloaded"], want["bytes_offloaded_full"])
    jmgr.wake_up()
    tmgr.wake_up()
    assert _engine_bits_equal(jeng, teng)
    before = {k: v.clone() for k, v in thf.model_leaves(teng.model).items()}
    for _ in range(3):
        tmgr.sleep(1)
        tmgr.wake_up()
    after = thf.model_leaves(teng.model)
    assert all(torch.equal(after[k].view(torch.uint8), before[k].view(torch.uint8)) for k in before)


def _greedy(eng, prompt, n=8):
    sid = eng.add_request(prompt, n, 0.0)
    while eng.has_work():
        for req in eng.step():
            if req.seq_id == sid:
                return req.out_tokens, req.out_logprobs
    raise AssertionError("request did not finish")


def test_greedy_tokens_after_a_quantized_wake_equal_the_reference():
    prompts = [[5, 9, 200, 3, 77], list(range(10, 31))]
    (jeng, jmgr), (teng, tmgr) = _engine_pair(jnp.float32, "int8")
    for m in (jmgr, tmgr):
        m.sleep(1)
        m.wake_up()
    assert teng.generate(prompts, max_new_tokens=8) == jeng.generate(prompts, max_new_tokens=8)


def test_logprob_drift_with_the_hot_head_off_within_the_reference_bound():
    """The reference documents at most 0.25 of logprob drift for a
    quantized cycle with the hot head off; the port's tiny engine keeps
    to it (tokens compared only where both runs chose the same one)."""
    (_, _), (teng, tmgr) = _engine_pair(jnp.float32, "int8", hot_head=False)
    prompt = [5, 9, 200, 3, 77]
    toks0, lps0 = _greedy(teng, prompt)
    tmgr.sleep(1)
    tmgr.wake_up()
    toks1, lps1 = _greedy(teng, prompt)
    same = [i for i, (a, b) in enumerate(zip(toks0, toks1)) if a == b]
    assert same and max(abs(lps0[i] - lps1[i]) for i in same) <= 0.25


def _pair(mode_a="int8", mode_b="int8", perturb=False, dtype=np.float32):
    pa, pb = _params(7, dtype), _params(7 if perturb else 8, dtype, perturb=perturb)
    ja, ja_box = _jmgr(pa, 1, quant_mode=mode_a)
    jb, jb_box = _jmgr(pb, 2, quant_mode=mode_b)
    ta, ta_state = _tmgr(pa, 1, quant_mode=mode_a)
    tb, tb_state = _tmgr(pb, 2, quant_mode=mode_b)
    jb.sleep(1)
    tb.sleep(1)
    return (ja, ja_box, jb, jb_box), (ta, ta_state, tb, tb_state), jdigest_tree(pa), jdigest_tree(pb)


@pytest.mark.parametrize("incoming", ["int8", "off"], ids=["slept-quantized", "slept-fp"])
@pytest.mark.parametrize("delta", [False, True], ids=["full", "digests"])
def test_quantized_swap_bytes_and_bits_equal_the_reference(incoming, delta):
    """Both directions quantized (or the incoming full-precision entry
    staged as a host-quantized copy), with and without digests: the plan
    equals the swap in bytes and both equal the reference's; the woken
    weights and the outgoing payloads are the reference's bits."""
    (ja, _, jb, jb_box), (ta, _, tb, tb_state), dga, dgb = _pair(mode_b=incoming, perturb=delta)
    kw = dict(bucket_bytes=4096, out_digests=dga if delta else None, in_digests=dgb if delta else None, quant="int8")
    want_plan, got_plan = jsleep.plan_swap(ja, jb, **kw), tsleep.plan_swap(ta, tb, **kw)
    want, got = jsleep.swap_states(ja, jb, **kw), tsleep.swap_states(ta, tb, **kw)
    assert got_plan == want_plan
    assert {k: got[k] for k in BYTE_KEYS} == {k: want[k] for k in BYTE_KEYS} == {k: got_plan[k] for k in BYTE_KEYS}
    assert got["quant"] == "int8" and got["bytes_saved_quant"] > 0
    if delta:
        assert got["deduped_leaves"] >= 3 and got["bytes_deduped"] > 0
    assert _same_leaves(flatten_state(tb_state), jax.tree.leaves(jb_box["state"]))
    assert _same_leaves(ta._host, jax.tree.leaves(ja._host_state))
    assert ta.quant_state() == ja.quant_state() and not tb.is_sleeping


@pytest.mark.parametrize("point", ["swap.h2d", "swap.d2h"])
def test_quantized_swap_rollback_leaves_both_models_bit_exact(point):
    """A fault mid-swap (sequential schedule: every outgoing bucket has
    landed and been released before the first incoming one) rolls back:
    the outgoing model, already quantized once, comes back bit-exact from
    its payloads; the full-precision entry is untouched by its staging."""
    (_, _, _, _), (ta, ta_state, tb, _), _, _ = _pair(mode_b="off")
    ta.sleep(1)
    ta.wake_up()
    awake = [t.clone() for t in flatten_state(ta_state)]
    slept = [h.clone() for h in tb._host]
    faults.arm(point, mode="fail", count=1)
    with pytest.raises(tsleep.SwapRolledBack):
        tsleep.swap_states(ta, tb, bucket_bytes=2048, overlapped=False, quant="int8")
    assert _same_leaves(flatten_state(ta_state), awake)
    assert _same_leaves(tb._host, slept) and tb._quant_meta is None
    assert not ta.is_sleeping and tb.is_sleeping
    m = tsleep.swap_states(ta, tb, bucket_bytes=2048, quant="int8")
    assert m["quant"] == "int8" and not tb.is_sleeping


def test_rollback_of_a_first_quantized_offload_keeps_its_scales():
    (_, _, _, _), (ta, ta_state, tb, _), _, _ = _pair(mode_b="off", dtype=ml_dtypes.bfloat16)
    assert ta._quant_scales is None
    faults.arm("swap.h2d", mode="fail", count=1)
    with pytest.raises(tsleep.SwapRolledBack):
        tsleep.swap_states(ta, tb, bucket_bytes=2048, overlapped=False, quant="int8")
    assert ta._quant_scales is not None and all(
        s is None or s.device.type == "cpu" for s in ta._quant_scales
    )
    rolled = [t.clone() for t in flatten_state(ta_state)]
    ta.sleep(1)
    ta.wake_up()
    assert _same_leaves(flatten_state(ta_state), rolled)


def test_quant_chunks_spill_and_reload_content_verified(tmp_path):
    store = ChunkStore(disk_dir=str(tmp_path / "tier"), disk_budget_bytes=1 << 20)
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 8)).astype(np.float32))
    p, m = tq.quantize_leaf_host(w, "int8")
    qd, fd = tq.transfer_digest(p, m), leaf_digest(w)
    assert qd.startswith("q:") and qd != fd and qd != leaf_digest(p)
    assert tq.transfer_digest(p, tq.TransferQuant("int8", m.orig_dtype, scale=m.scale * 2)) != qd
    store.intern(qd, p)
    assert store.release(qd, spill=True) == p.numel()
    got = store.fetch(qd)
    assert got is not None and torch.equal(got, p) and store.verify_failures == 0
    fp8, fm = tq.quantize_leaf_host(w, "fp8")
    store.intern(tq.transfer_digest(fp8, fm), fp8)
    store.release(tq.transfer_digest(fp8, fm), spill=True)
    assert torch.equal(store.fetch(tq.transfer_digest(fp8, fm)).view(torch.uint8), fp8.view(torch.uint8))


def test_refusals():
    base = "--model tiny --device cpu"
    for mode in MODES:
        assert tserver.parse_engine_options(f"{base} --sleep-quant {mode}").sleep_quant == mode
    with pytest.raises(ValueError, match="item 14"):
        tserver.parse_engine_options(f"{base},cpu --sleep-quant int8 --tensor-parallel-size 2")
    with pytest.raises(ValueError):
        tserver.parse_engine_options(f"{base} --sleep-quant int4")
    assert tq.transfer_quant_supported("int4") and tq.transfer_quant_supported("off") is None
    with pytest.raises(ValueError, match="unknown"):
        tsleep.SleepManager(lambda: {}, lambda s: None, "cpu", [], quant_mode="int4")


OPTS = "--num-pages 24 --page-size 8 --max-batch 2 --max-model-len 64 --seed 0 --swap-bucket-mib 1 --device cpu"


def test_service_quantized_cycles_swaps_and_pool_accounting():
    """The reference's service sequence on the port: a quantized sleep and
    wake over the admin calls, pool-tier swaps both ways quantized with
    tokens stable from the first wake on, the quantized entry pooled at
    payload bytes under transfer digests."""
    svc = tserver.EngineService(tserver.parse_engine_options(f"--model tiny {OPTS} --sleep-quant int8"))
    try:
        def gen():
            return svc.submit(prompt=[1, 2, 3], max_new_tokens=4).result(timeout=60).out_tokens

        gen()
        info = svc.sleep(1)
        assert info["quant"] == "int8" and info["bytes_offloaded"] < info["bytes_offloaded_full"]
        svc.wake_up()
        t1 = gen()
        svc.swap("tiny-gemma")
        entry = svc.model_pool.peek("tiny")
        assert entry.nbytes == entry.runtime.sleeper.stats.bytes_offloaded < entry.runtime.sleeper.stats.bytes_offloaded_full
        assert svc.model_pool.bytes_used <= entry.nbytes
        out = svc.swap("tiny")
        assert out["tier"] == "pool" and out["quant"] == "int8" and out["bytes_saved_quant"] > 0
        assert gen() == t1
        svc.swap("tiny-gemma")
        assert svc.swap("tiny")["quant"] == "int8" and gen() == t1
        stats = svc.stats()["quant"]
        assert stats["mode"] == "int8" and stats["last_swap"]["quant"] == "int8"
    finally:
        svc.shutdown()

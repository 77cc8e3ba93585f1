"""The port's delta-aware hot-swap (``engine/sleep.py:swap_states`` and
``plan_swap``) held against the reference's on the same seeded unit pair
(two sibling variants that differ in ``head`` only, over
``{"params", "kv"}`` as an engine's state): the same byte keys, the same
bits after the swap, with digests and without, overlapped and
sequential; the plan equal to the swap it prices; the matched leaves'
memory handed over at their own addresses; and the rollbacks (a fault at
the first outgoing bucket, at an incoming bucket, at a handover) leaving
both models bit-exact."""

import jax
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import sleep as jsleep
from llm_d_fast_model_actuation_tpu.engine.chunk_store import digest_tree as jdigest_tree
from llm_d_fast_model_actuation_tpu.utils import faults as jfaults
from llm_d_fast_model_actuation_tpu_torch.engine import arena as tarena
from llm_d_fast_model_actuation_tpu_torch.engine import sleep as tsleep
from llm_d_fast_model_actuation_tpu_torch.engine.chunk_store import digest_tree, flatten_state
from llm_d_fast_model_actuation_tpu_torch.utils import faults

#: the byte keys of a swap's metrics that the port must report as the reference does
BYTE_KEYS = ("bytes_out", "bytes_in", "bytes_moved", "bytes_deduped", "deduped_leaves", "buckets_out",
             "buckets_in", "bytes_full", "bucket_bytes", "quant", "quant_leaves", "bytes_saved_quant")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _variant_params(seed: int, perturb: bool):
    """The reference test's two fine-tune variants of one base:
    identical except ``head``."""
    rng = np.random.default_rng(seed)
    base = {
        "embed": rng.standard_normal((64, 32)).astype(np.float32),
        "layers": {
            "wq": rng.standard_normal((2, 32, 32)).astype(np.float32),
            "wk": rng.standard_normal((2, 32, 16)).astype(np.float32),
        },
        "head": rng.standard_normal((32, 64)).astype(np.float32),
    }
    if perturb:
        base["head"] = base["head"] * 1.5 + 0.25
    return base


def _kv(seed: int):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, 8, 16)).astype(np.float32) for _ in range(2))


def _jmgr(params, kv_seed: int):
    box = {"state": jax.device_put({"params": params, "kv": _kv(kv_seed)}, jax.devices()[0])}
    return jsleep.SleepManager(lambda: box["state"], lambda s: box.__setitem__("state", s)), box


def _in_arena(tree, arena):
    if isinstance(tree, dict):
        return {k: _in_arena(v, arena) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_in_arena(v, arena) for v in tree)
    t = arena.empty(tree.shape, torch.float32, "offload")
    return t.copy_(torch.from_numpy(tree))


def _tmgr(params, kv_seed: int):
    """An awake port SleepManager over the same state, each tensor an
    allocation of its own CPU arena."""
    arena = tarena.Arena("cpu")
    state = _in_arena({"params": params, "kv": _kv(kv_seed)}, arena)
    return tsleep.SleepManager(lambda: state, lambda s: None, "cpu", [arena]), state


def _pairs():
    """Both packages' (awake A, slept B) managers and the digest maps."""
    pa, pb = _variant_params(0, False), _variant_params(0, True)
    ja, ja_box = _jmgr(pa, 1)
    jb, jb_box = _jmgr(pb, 2)
    ta, ta_state = _tmgr(pa, 1)
    tb, tb_state = _tmgr(pb, 2)
    jb.sleep(1)
    tb.sleep(1)
    return (ja, ja_box, jb, jb_box), (ta, ta_state, tb, tb_state), jdigest_tree(pa), jdigest_tree(pb)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _t_leaves(tree):
    return [t.numpy().copy() for t in flatten_state(tree)]


@pytest.mark.parametrize("overlapped", [True, False], ids=["overlapped", "sequential"])
@pytest.mark.parametrize("delta", [True, False], ids=["digests", "no-digests"])
def test_unit_pair_equals_the_reference(delta, overlapped):
    (ja, _, jb, jb_box), (ta, _, tb, tb_state), dga, dgb = _pairs()
    kw = dict(bucket_bytes=4096, out_digests=dga if delta else None, in_digests=dgb if delta else None)
    assert digest_tree({k: torch.from_numpy(v) if not isinstance(v, dict) else
                        {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in _variant_params(0, False).items()}) == dga
    want_plan, got_plan = jsleep.plan_swap(ja, jb, **kw), tsleep.plan_swap(ta, tb, **kw)
    want = jsleep.swap_states(ja, jb, overlapped=overlapped, **kw)
    got = tsleep.swap_states(ta, tb, overlapped=overlapped, **kw)
    assert {k: got[k] for k in BYTE_KEYS} == {k: want[k] for k in BYTE_KEYS}
    assert got_plan == {k: v for k, v in want_plan.items()}
    assert {k: got[k] for k in BYTE_KEYS} == {k: got_plan[k] for k in BYTE_KEYS}
    if delta:
        assert got["deduped_leaves"] == 3 and 0 < got["bytes_moved"] < got["bytes_out"] + got["bytes_in"]
    else:
        assert got["bytes_deduped"] == 0 and got["bytes_moved"] == got["bytes_out"] + got["bytes_in"]
    # the same bits: B awake, A's host copies
    for a, b in zip(_t_leaves(tb_state), _np_leaves(jb_box["state"])):
        assert np.array_equal(a, b)
    for a, b in zip(ta._host, _np_leaves(ja._host_state)):
        assert np.array_equal(a.numpy(), b)
    assert ta.level == tsleep.SleepLevel.L1_HOST_OFFLOAD and not tb.is_sleeping and tb._host is None
    assert 0.0 <= got["overlap_frac"] <= 1.0 and got["peak_bytes_in_flight"] > 0


def test_delta_handover_keeps_addresses_and_round_trips():
    """A matched incoming leaf keeps its own address and holds the
    outgoing leaf's bytes; the outgoing one is released (its host copy is
    the incoming one's); swapping back restores both bit-exact."""
    _, (ta, ta_state, tb, tb_state), dga, dgb = _pairs()
    a0 = _t_leaves(ta_state)
    ptrs = [t.data_ptr() for t in flatten_state(ta_state) + flatten_state(tb_state)]
    tsleep.swap_states(ta, tb, bucket_bytes=4096, out_digests=dga, in_digests=dgb)
    arena_a, arena_b = ta.arenas[0], tb.arenas[0]
    b_embed, a_embed = tb_state["params"]["embed"], ta_state["params"]["embed"]
    assert arena_b.block(b_embed).mapped and not arena_a.block(a_embed).mapped
    assert torch.equal(b_embed, torch.from_numpy(_variant_params(0, False)["embed"]))
    assert arena_a.mapped_bytes == 0
    tsleep.swap_states(tb, ta, bucket_bytes=4096, out_digests=dgb, in_digests=dga)
    for a, b in zip(_t_leaves(ta_state), a0):
        assert np.array_equal(a, b)
    assert ptrs == [t.data_ptr() for t in flatten_state(ta_state) + flatten_state(tb_state)]


def test_shape_mismatch_never_matches():
    pa, pb = {"w": np.zeros((4, 4), np.float32)}, {"w": np.zeros((16,), np.float32)}
    out_mgr, _ = _tmgr(pa, 1)
    in_mgr, _ = _tmgr(pb, 2)
    in_mgr.sleep(1)
    fake = {"w": "same-digest"}
    m = tsleep.swap_states(out_mgr, in_mgr, out_digests=fake, in_digests=fake)
    assert m["deduped_leaves"] == 0 and m["bytes_deduped"] == 0


@pytest.mark.parametrize("point", ["swap.d2h", "swap.h2d", "handover"])
def test_rollback_leaves_both_models_intact(point, monkeypatch):
    """A fault at the first outgoing bucket, at an incoming bucket, or at
    the second handover of the commit rolls back: both models as they
    began, the handed-over blocks back; the retry then swaps."""
    (ja, ja_box, jb, _), (ta, ta_state, tb, tb_state), dga, dgb = _pairs()
    awake, slept = _t_leaves(ta_state), [h.numpy().copy() for h in tb._host]
    if point == "handover":
        real, calls = tsleep.hand_over, []

        def flaky(*args):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("injected handover failure")
            return real(*args)

        monkeypatch.setattr(tsleep, "hand_over", flaky)
    else:
        faults.arm(point, mode="fail", count=1)
        jfaults.arm(point, mode="fail", count=1)
        with pytest.raises(jsleep.SwapRolledBack):
            jsleep.swap_states(ja, jb, bucket_bytes=4096, out_digests=dga, in_digests=dgb)
    with pytest.raises(tsleep.SwapRolledBack):
        tsleep.swap_states(ta, tb, bucket_bytes=4096, out_digests=dga, in_digests=dgb)
    for a, b in zip(_t_leaves(ta_state), awake):
        assert np.array_equal(a, b), "outgoing model corrupted"
    for a, b in zip(tb._host, slept):
        assert np.array_equal(a.numpy(), b), "incoming pool entry corrupted"
    assert not ta.is_sleeping and tb.is_sleeping and tb.arenas[0].mapped_bytes == 0
    m = tsleep.swap_states(ta, tb, bucket_bytes=4096, out_digests=dga, in_digests=dgb)
    assert m["deduped_leaves"] == 3 and not tb.is_sleeping


def test_refusals():
    _, (ta, _, tb, _), _, _ = _pairs()
    # a quantized swap runs, with the planner's bytes: the outgoing manager
    # has no mode of its own, so (as in the reference) only the incoming
    # full-precision entry's two stacks cross as a host-staged int8 copy
    planned = tsleep.plan_swap(ta, tb, quant="int8")
    got = tsleep.swap_states(ta, tb, quant="int8")
    assert {k: got[k] for k in BYTE_KEYS} == {k: planned[k] for k in BYTE_KEYS}
    assert got["quant"] == "int8" and got["quant_leaves"] == 2 and got["bytes_saved_quant"] > 0
    assert ta.is_sleeping and not tb.is_sleeping and tb._quant_scales is not None
    _, (ta, _, tb, _), _, _ = _pairs()
    with pytest.raises(ValueError, match="awake"):
        tsleep.swap_states(tb, ta)
    tb.sleep(2)
    with pytest.raises(ValueError, match="level 1"):
        tsleep.swap_states(ta, tb)
    _, (ta, _, tb, _), _, _ = _pairs()
    ta._replicas = lambda: []  # a mesh's state
    with pytest.raises(ValueError, match="item 14"):
        tsleep.plan_swap(ta, tb)
    # a quantized swap on a mesh is refused too, never silently fp
    with pytest.raises(ValueError, match="item 14"):
        tsleep.plan_swap(ta, tb, quant="int8")
    with pytest.raises(ValueError, match="item 14"):
        tsleep.swap_states(ta, tb, quant="int8")
    with pytest.raises(ValueError, match="item 14"):
        tsleep.SleepManager(lambda: {}, lambda s: None, "cpu", [], replicas=lambda: [], quant_mode="int8")

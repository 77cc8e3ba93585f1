"""The port's packed serving path against the JAX package's.

Kernel level: the plain versions beside the ragged and the scatter-first
decode kernels are held against the JAX Pallas kernels in interpret mode,
on the packing scenario of tests/test_ragged.py (a cold segment crossing
a page, a decode row on a partial page, a suffix from position 7,
alignment gaps and a padded tail). Tolerances are the reference's own:
2e-5 in float32, 3e-2 in bf16 (test_ragged.py:248-252), on valid rows.

Model level: port ``mixed_step`` and the scatter-first ``decode_step``
against JAX's on converted float32 weights, to 1e-5 on logits and written
pages.

Engine level (float32 tiny, CPU): port packed greedy == port bucketed
greedy, which tests/test_torch_engine.py already holds to the JAX engine;
the JAX engine's own packed output is not the oracle (some of
test_ragged.py's packed-greedy tests flip tokens on some machines).
Sampled requests agree in logprob to 0.05 up to the first divergent
token, as test_ragged.py:296-326 does.

Sleep/wake determinism: level-1 sleep and wake in the middle of a
two-prompt run, five times over, with packed serving off and on; every
continuation equals a fresh engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu.ops.pallas import (
    paged_decode_attention_pallas,
    ragged_paged_attention_pallas,
)
from llm_d_fast_model_actuation_tpu.utils.compat import pallas_interpret_supported
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import sleep as tsleep
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models.convert import (
    config_from_jax,
    params_from_jax,
)
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import decode as tdecode
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import ragged as tragged

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
MODEL_TOL = 1e-5


@pytest.fixture
def interpret():
    if not pallas_interpret_supported():
        pytest.skip("this jaxlib cannot run Pallas interpret mode on CPU")


def _np(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # bf16-exact
    return a


def _both(a, dtype):
    """The same values as a JAX array and a torch CPU tensor."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _pack_scenario(rng, heads, kv_heads, head_dim, page_size, pages_per_seq, dtype):
    """tests/test_ragged.py's packing layout, drawn with numpy: three
    sequences' rows in a 40-row buffer of 8-row blocks."""
    rows = 3
    num_pages = rows * pages_per_seq + 1
    kp = _np(rng, (num_pages, page_size, kv_heads, head_dim), dtype)
    vp = _np(rng, (num_pages, page_size, kv_heads, head_dim), dtype)
    pt = np.arange(1, 1 + rows * pages_per_seq, dtype=np.int32).reshape(rows, pages_per_seq)
    T = 40
    max_len = page_size * pages_per_seq
    row_slot = np.full(T, -1, np.int32)
    positions = np.zeros(T, np.int32)
    row_slot[0:11] = 0  # an 11-token cold segment from 0 (crosses a page)
    positions[0:11] = np.arange(11)
    row_slot[16] = 1  # one decode row on a partial last page
    positions[16] = min(13, max_len - 1)
    row_slot[24:29] = 2  # a 5-token suffix continuation from position 7
    positions[24:29] = 7 + np.arange(5)
    q = _np(rng, (T, heads, head_dim), dtype)
    return q, kp, vp, pt, row_slot, positions


GEOMETRIES = [
    (4, 2, 16, 8, 4),
    (8, 8, 32, 16, 2),  # MHA (group 1)
    (8, 2, 64, 8, 3),  # GQA 4x
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,kv_heads,head_dim,page_size,pages_per_seq", GEOMETRIES)
def test_ragged_plain_matches_pallas(interpret, heads, kv_heads, head_dim, page_size, pages_per_seq, dtype):
    rng = np.random.default_rng(1)
    q, kp, vp, pt, row_slot, positions = _pack_scenario(
        rng, heads, kv_heads, head_dim, page_size, pages_per_seq, dtype
    )
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kp, vp))
    want = ragged_paged_attention_pallas(
        jq, jk, jv, jnp.asarray(pt), jnp.asarray(row_slot), jnp.asarray(positions),
        block_rows=tragged.RAGGED_BLOCK, interpret=True,
    )
    got = tragged.ragged_paged_attention(
        tq, tk, tv, torch.from_numpy(pt), torch.from_numpy(row_slot), torch.from_numpy(positions)
    )
    assert got.dtype == tq.dtype and got.shape == tq.shape
    valid = row_slot >= 0
    np.testing.assert_allclose(
        got.float().numpy()[valid], np.asarray(want, np.float32)[valid],
        atol=TOL[dtype], rtol=TOL[dtype],
    )
    # padding rows are zeros in the port; the fully padded tail block is
    # zeros in the Pallas kernel too
    assert (got.float().numpy()[~valid] == 0).all()
    assert (np.asarray(want, np.float32)[32:] == 0).all()


def test_ragged_plain_reads_a_column_slice_of_the_table():
    """The engine hands the model the table's first kvp columns (a view
    that is not contiguous): same result as a contiguous copy, and as the
    full table."""
    rng = np.random.default_rng(2)
    q, kp, vp, pt, row_slot, positions = _pack_scenario(rng, 4, 2, 16, 8, 4, "float32")
    wide = np.concatenate([pt, np.zeros_like(pt)], axis=1)
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    rs, pos = torch.from_numpy(row_slot), torch.from_numpy(positions)
    view = torch.from_numpy(wide)[:, :2]  # positions < 16 need 2 pages of 8
    assert not view.is_contiguous()
    got = tragged.ragged_paged_attention(*args, view, rs, pos)
    full = tragged.ragged_paged_attention(*args, torch.from_numpy(pt), rs, pos)
    assert torch.equal(got, tragged.ragged_paged_attention(*args, view.contiguous(), rs, pos))
    torch.testing.assert_close(got, full, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (8, 2)])
def test_scatter_first_decode_plain_matches_pallas(interpret, heads, kv_heads, dtype):
    rng = np.random.default_rng(3)
    b, d, ps, pps = 5, 16, 8, 3
    num_pages = b * pps + 1
    q = _np(rng, (b, heads, d), dtype)
    kp = _np(rng, (num_pages, ps, kv_heads, d), dtype)
    vp = _np(rng, (num_pages, ps, kv_heads, d), dtype)
    pt = (rng.permutation(num_pages - 1) + 1).astype(np.int32).reshape(b, pps)
    # no cache (zeros in both), one token, a partial page, a page boundary, full
    lens = np.array([0, 1, 5, ps, ps * pps], dtype=np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kp, vp))
    want = paged_decode_attention_pallas(
        jq, jk, jv, jnp.asarray(pt), jnp.asarray(lens), interpret=True
    )
    got = tdecode.paged_decode_attention(tq, tk, tv, torch.from_numpy(pt), torch.from_numpy(lens))
    assert got.dtype == tq.dtype and got.shape == (b, heads, d)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=TOL[dtype]
    )
    assert (got[0] == 0).all()


# -- model level ---------------------------------------------------------------


def _setup(impl):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32, attention_impl=impl)
    params = jllama.init_params(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = tllama.Llama(config_from_jax(jcfg), "cpu")
    model.load_state_dict(params_from_jax(tree), strict=True)
    return jcfg, params, model


def _pools(rng, cfg, num_pages, page_size):
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(k), jnp.asarray(v)), (torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))


def _close(j, t, tol=MODEL_TOL):
    return float(np.max(np.abs(np.asarray(j) - t.numpy()))) <= tol


def _pools_close(jcache, tcache):
    """Every page but the null page 0, where the port sends the writes the
    reference drops."""
    return all(_close(np.asarray(j)[:, 1:], t[:, 1:]) for j, t in zip(jcache, tcache))


def test_mixed_step_matches_jax():
    jcfg, jparams, model = _setup("grouped")
    rng = np.random.default_rng(4)
    ps, pps, rows = 8, 4, 3
    _, kp, vp, pt, row_slot, positions = _pack_scenario(rng, 4, 2, 16, ps, pps, "float32")
    tokens = rng.integers(0, jcfg.vocab_size, row_slot.shape[0]).astype(np.int32)
    jcache, tcache = _pools(rng, jcfg, rows * pps + 1, ps)
    jl, jcache = jllama.mixed_step(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(row_slot), jnp.asarray(positions),
        jcache, jnp.asarray(pt),
    )
    # the port gets the table cut to the width the step needs, as the
    # engine passes it (positions < 16: two pages)
    tl = tllama.mixed_step(
        model, torch.from_numpy(tokens), torch.from_numpy(row_slot), torch.from_numpy(positions),
        tcache, torch.from_numpy(pt)[:, :2],
    )
    valid = row_slot >= 0
    assert _close(np.asarray(jl)[valid], tl[torch.from_numpy(valid)])
    assert _pools_close(jcache, tcache)


def test_scatter_first_decode_step_matches_jax():
    jcfg, jparams, model = _setup("reference")
    assert model.cfg.attention_impl == "reference"
    rng = np.random.default_rng(5)
    b, ps, pps = 3, 8, 4
    jcache, tcache = _pools(rng, jcfg, b * pps + 1, ps)
    pt = np.arange(1, 1 + b * pps, dtype=np.int32).reshape(b, pps)
    pos = np.array([0, 9, 30], dtype=np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, b).astype(np.int32)
    for active in (None, np.array([True, False, True])):
        ja = None if active is None else jnp.asarray(active)
        ta = None if active is None else torch.from_numpy(active)
        jl, jcache = jllama.decode_step(
            jparams, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jcache, jnp.asarray(pt), ja
        )
        tl = tllama.decode_step(
            model, torch.from_numpy(nxt), torch.from_numpy(pos), tcache, torch.from_numpy(pt), ta
        )
        assert _close(jl, tl)
        assert _pools_close(jcache, tcache)
        pos = pos + 1


# -- engine level --------------------------------------------------------------

PROMPTS = [
    [1, 2, 3, 4, 5],
    [9, 8, 7],
    [4] * 16,  # exactly two pages at page_size 8
    [7, 6, 5, 4, 3, 2, 1] * 3,
]


@pytest.fixture
def packing_contract(monkeypatch):
    """Hold every buffer the engine hands the ragged op to the kernel's
    packing contract (ops/pallas/ragged.py:15-24), which the plain version
    the CPU runs does not need: T % RAGGED_BLOCK == 0, and in every block
    the valid rows are a prefix of ONE sequence at consecutive positions.
    Yields the list of buffer sizes seen."""
    seen = []
    real = tllama.ragged_paged_attention

    def checked(q, k_pages, v_pages, page_table, row_slot, positions):
        qb = tragged.RAGGED_BLOCK
        assert q.shape[0] % qb == 0
        slots = row_slot.reshape(-1, qb).numpy()
        pos = positions.reshape(-1, qb).numpy()
        for bs, bp in zip(slots, pos):
            n = int((bs >= 0).sum())
            assert (bs[:n] >= 0).all() and (bs[n:] < 0).all()
            assert (bs[:n] == bs[0]).all()
            assert (bp[:n] == bp[0] + np.arange(n)).all()
        seen.append(q.shape[0])
        return real(q, k_pages, v_pages, page_table, row_slot, positions)

    monkeypatch.setattr(tllama, "ragged_paged_attention", checked)
    return seen


def _engine(packed, **kw):
    m = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    base = dict(model=m, max_batch=4, page_size=8, num_pages=64, max_seq_len=128)
    base.update(kw)
    return tengine.InferenceEngine(tengine.EngineConfig(packed_serving=packed, **base), seed=0, device="cpu")


@pytest.mark.parametrize(
    "prompts,kw",
    [
        (PROMPTS, {}),
        (PROMPTS + [[11, 13, 17, 19] * 12], {"max_prefill_tokens": 6}),  # chunked, 48 tokens
        (PROMPTS + [[11, 13, 17, 19] * 12], {"token_budget": 48}),  # 48 > the small buffer
    ],
)
def test_packed_greedy_equals_bucketed(packing_contract, prompts, kw):
    want = _engine(False, **kw).generate(prompts, max_new_tokens=8)
    eng = _engine(True, **kw)
    got = eng.generate(prompts, max_new_tokens=8)
    assert got == want
    assert eng.packed_steps > 0 and eng.cold_prefills == 0
    assert eng.dispatch_tokens["packed"] == eng.packed_tokens_total > 0
    # one launch per layer and packed step, at the engine's buffer shapes
    assert len(packing_contract) == eng.packed_steps * eng.cfg.model.num_layers
    assert set(packing_contract) <= set(tengine.packed_budget_shapes(eng.cfg))


def test_packed_mid_batch_admission_and_retire(packing_contract):
    """A short request admitted while a long one is mid-prefill (chunked)
    rides the same packed steps and finishes first; the long request's
    output equals the bucketed run's."""
    long_p, short_p = [5, 4, 3, 2, 1] * 8, [1, 2, 3]

    def run(packed):
        eng = _engine(packed, max_prefill_tokens=6)
        out = {}
        a = eng.add_request(long_p, 6)
        for _ in range(2):  # the long prompt is mid-prefill after two steps
            for r in eng.step():
                out[r.seq_id] = r.out_tokens
        if packed:
            assert eng._any_prefilling()
        b = eng.add_request(short_p, 2)
        order = []
        while eng.has_work():
            for r in eng.step():
                out[r.seq_id] = r.out_tokens
                order.append(r.seq_id)
        return out[a], out[b], order, eng

    want_a, want_b, _, _ = run(False)
    got_a, got_b, order, eng = run(True)
    assert (got_a, got_b) == (want_a, want_b)
    assert order[0] == 2  # the short request retired first
    assert eng.last_step_stats is None or eng.last_step_stats["mode"] == "packed"


def test_packed_sampled_logprob_tolerance():
    def run(packed):
        eng = _engine(packed)
        ids = [
            eng.add_request(p, 8, temperature=0.8, top_p=0.9, seed=42 + i)
            for i, p in enumerate(PROMPTS)
        ]
        out = {}
        while eng.has_work():
            for r in eng.step():
                out[r.seq_id] = (r.out_tokens, r.out_logprobs)
        return [out[i] for i in ids]

    full_matches = 0
    for (rt, rl), (gt, gl) in zip(run(False), run(True)):
        assert len(gt) == len(rt)
        for i in range(len(rt)):
            if rt[i] != gt[i]:
                break  # the draws diverged at a near-tie
            assert abs(rl[i] - gl[i]) < 0.05
        else:
            full_matches += 1
    assert full_matches >= 1


def test_packed_penalties_and_prefix_hit_equal_bucketed():
    """Penalties over a cached prefix (the exact edge that uploads every
    mirror) and a fresh admission beside running decode rows (the slot's
    rows zeroed on the device) give the bucketed path's tokens."""
    shared = list(range(30, 54))  # three pages of 8

    def run(packed):
        eng = _engine(packed)
        first = eng.generate([shared + [1, 2]], max_new_tokens=6)
        ids = [
            eng.add_request(shared + [3], 6, frequency_penalty=0.7, presence_penalty=0.3),
            eng.add_request([5, 6, 7], 6, frequency_penalty=0.5),
        ]
        out = {}
        while eng.has_work():
            for r in eng.step():
                out[r.seq_id] = r.out_tokens
        late = eng.add_request([8, 9], 4, presence_penalty=1.0)
        eng.step()  # admits while nothing else runs
        while eng.has_work():
            for r in eng.step():
                out[r.seq_id] = r.out_tokens
        assert eng.prefix_cache.stats()["hits"] >= 1
        return first, [out[i] for i in ids + [late]]

    assert run(True) == run(False)


def test_packed_shapes_match_the_reference():
    jm = jllama.LlamaConfig.tiny()
    tm = tllama.LlamaConfig.tiny()
    for max_batch in (1, 4, 8, 16, 40):
        for budget in (0, 7, 64, 100, 256, 1000):
            kw = dict(max_batch=max_batch, token_budget=budget, packed_serving=True)
            jcfg = jengine.EngineConfig(model=jm, **kw)
            tcfg = tengine.EngineConfig(model=tm, **kw)
            assert tcfg.packed_token_budget == jcfg.packed_token_budget
            assert tengine.packed_budget_shapes(tcfg) == jengine.packed_budget_shapes(jcfg)
    for ps in (8, 16):
        for pps in (1, 4, 64, 512):
            for max_kv in range(1, 700, 3):
                assert tengine.kv_pages_bucket(max_kv, ps, pps) == jengine.kv_pages_bucket(max_kv, ps, pps)


# -- sleep/wake determinism ------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_level1_sleep_wake_is_deterministic_over_five_repeats(packed):
    """Two prompts, one step, level-1 sleep, wake, generate to the end, then
    the same prompts again (prefix-cache hits): five repeats, each equal to
    an engine that never slept. bf16, the serving dtype."""
    prompts = [list(range(40, 61)), [3, 1, 4, 1, 5, 9, 2, 6]]

    def run(sleep):
        eng = tengine.InferenceEngine(
            tengine.EngineConfig(
                model=tllama.LlamaConfig.tiny(), max_batch=4, page_size=8, num_pages=48,
                max_seq_len=64, packed_serving=packed,
            ),
            seed=0, device="cpu",
        )
        ids = [eng.add_request(p, 12) for p in prompts]
        out = {}
        for r in eng.step():
            out[r.seq_id] = r.out_tokens
        assert eng.has_work()
        if sleep:
            mgr = tsleep.attach_sleep(eng)
            mgr.sleep(1)
            mgr.wake_up()
        while eng.has_work():
            for r in eng.step():
                out[r.seq_id] = r.out_tokens
        return [out[i] for i in ids], eng.generate(prompts, max_new_tokens=12)

    gold = run(sleep=False)
    for _ in range(5):
        assert run(sleep=True) == gold

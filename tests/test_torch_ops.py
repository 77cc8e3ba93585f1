"""The port's kernel modules and ops against the JAX package.

The plain PyTorch versions beside the CUDA kernels (what a CPU tensor
runs) are held against the JAX Pallas kernels in interpret mode, as
tests/test_pallas_ops.py runs them; norm, rope and the paged suffix
attention against their JAX functions. Inputs are made with numpy from a
seed and handed to both sides.

Tolerances: float32 inputs <= 1e-4 max abs (the sums run in another
order); bf16 inputs <= 2e-2 (about two bf16 ulps near 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.ops import attention as jattn
from llm_d_fast_model_actuation_tpu.ops import norm as jnorm
from llm_d_fast_model_actuation_tpu.ops import rope as jrope
from llm_d_fast_model_actuation_tpu.ops.pallas import (
    causal_prefill_attention_pallas,
    paged_decode_attention_inline_pallas,
)
from llm_d_fast_model_actuation_tpu.utils.compat import pallas_interpret_supported
from llm_d_fast_model_actuation_tpu_torch.ops import attention as tattn
from llm_d_fast_model_actuation_tpu_torch.ops import norm as tnorm
from llm_d_fast_model_actuation_tpu_torch.ops import rope as trope
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import build as tbuild
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import decode as tdecode
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import prefill as tprefill
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import ragged as tragged

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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


def _maxerr(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "heads,kv_heads",
    [(4, 4), (4, 2), (8, 2)],  # GQA ratios 1, 2, 4
)
def test_inline_decode_plain_matches_pallas(interpret, heads, kv_heads, dtype):
    rng = np.random.default_rng(0)
    b, d, ps, pps = 4, 16, 8, 3
    num_pages = b * pps + 1
    q = _np(rng, (b, heads, d), dtype)
    kp = _np(rng, (num_pages, ps, kv_heads, d), dtype)
    vp = _np(rng, (num_pages, ps, kv_heads, d), dtype)
    kn = _np(rng, (b, kv_heads, d), dtype)
    vn = _np(rng, (b, kv_heads, d), dtype)
    pt = (rng.permutation(num_pages - 1) + 1).astype(np.int32).reshape(b, pps)
    # pos 0 (no page read), a partial last page, a page boundary, full
    pos = np.array([0, 5, ps, ps * pps - 1], dtype=np.int32)
    jargs = [_both(a, dtype)[0] for a in (q, kp, vp, kn, vn)]
    targs = [_both(a, dtype)[1] for a in (q, kp, vp, kn, vn)]
    want = paged_decode_attention_inline_pallas(
        *jargs, jnp.asarray(pt), jnp.asarray(pos), interpret=True
    )
    got = tdecode.paged_decode_attention_inline(
        *targs, torch.from_numpy(pt), torch.from_numpy(pos)
    )
    assert got.dtype == targs[0].dtype and got.shape == (b, heads, d)
    assert _maxerr(want, got) <= TOL[dtype]
    # pos == 0 attends to the inline token alone
    np.testing.assert_allclose(
        got[0].float().numpy(),
        np.repeat(targs[4][0].float().numpy(), heads // kv_heads, axis=0),
        atol=TOL[dtype],
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "seq,heads,kv_heads,seq_lens",
    [
        (32, 4, 4, [32, 13]),  # MHA, one padded row
        (16, 4, 2, [16, 1]),  # GQA 2, a one-token prompt
        (64, 8, 2, [61, 40]),  # GQA 4, padded rows in every sequence
    ],
)
def test_prefill_plain_matches_pallas(interpret, seq, heads, kv_heads, seq_lens, dtype):
    rng = np.random.default_rng(1)
    b, d = len(seq_lens), 16
    q = _np(rng, (b, seq, heads, d), dtype)
    k = _np(rng, (b, seq, kv_heads, d), dtype)
    v = _np(rng, (b, seq, kv_heads, d), dtype)
    lens = np.array(seq_lens, dtype=np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    block_q = next(bq for bq in (128, 64, 32, 16, 8) if seq % bq == 0)
    want = causal_prefill_attention_pallas(
        jq, jk, jv, jnp.asarray(lens), block_q=block_q, interpret=True
    )
    got = tprefill.causal_prefill_attention(tq, tk, tv, torch.from_numpy(lens))
    # every row, padded ones included: rows past seq_len attend to the
    # valid keys in both
    assert _maxerr(want, got) <= TOL[dtype]


def test_wrappers_dispatch_by_device_and_count_only_kernel_launches():
    """A CPU tensor runs the plain version (no launch counted); a tensor on
    another device is refused, never computed on the CPU."""
    q = torch.zeros(1, 16, 2, 16)
    k = torch.zeros(1, 16, 2, 16)
    lens = torch.tensor([16], dtype=torch.int32)
    pages = torch.zeros(3, 8, 2, 16)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    q8 = torch.zeros(8, 2, 16)
    slots = torch.tensor([0] * 3 + [-1] * 5, dtype=torch.int32)
    pos = torch.tensor([4, 5, 6] + [0] * 5, dtype=torch.int32)
    probe = torch.zeros(8, 128)
    calls = {
        tprefill.causal_prefill_attention: (q, k, k, lens),
        tdecode.paged_decode_attention_inline: (q[:, 0], pages, pages, k[:, 0], k[:, 0], table, lens),
        tdecode.paged_decode_attention: (q[:, 0], pages, pages, table, lens),
        tragged.ragged_paged_attention: (q8, pages, pages, table, slots, pos),
        tbuild.launch_probe: (probe,),
    }
    counters = [(fn, fn.launches) for fn in calls]
    for fn, args in calls.items():
        fn(*args)
        with pytest.raises(ValueError):
            fn(args[0].to("meta"), *args[1:])
    assert [fn.launches for fn, _ in counters] == [n for _, n in counters]
    assert tragged.ragged_paged_attention.launches_by_rows == {}
    # a packed buffer that is not RAGGED_BLOCK-aligned is refused, never
    # served by another path
    with pytest.raises(ValueError, match="RAGGED_BLOCK"):
        tragged.ragged_paged_attention(q8[:6].to("meta"), pages, pages, table, slots[:6], pos[:6])
    assert torch.equal(tbuild.launch_probe(probe + 3), probe + 3)


def test_paged_suffix_attention_matches_jax():
    rng = np.random.default_rng(2)
    b, s, h, kvh, d, ps, pps = 2, 8, 4, 2, 16, 8, 4
    num_pages = b * pps + 1
    q = _np(rng, (b, s, h, d), "float32")
    kp = _np(rng, (num_pages, ps, kvh, d), "float32")
    vp = _np(rng, (num_pages, ps, kvh, d), "float32")
    pt = (np.arange(1, num_pages, dtype=np.int32)).reshape(b, pps)
    start = np.array([0, 11], dtype=np.int32)
    want = jattn.paged_suffix_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt), jnp.asarray(start)
    )
    got = tattn.paged_suffix_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pt), torch.from_numpy(start),
    )
    assert _maxerr(want, got) <= TOL["float32"]


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches_jax(offset):
    rng = np.random.default_rng(3)
    x = _np(rng, (3, 5, 64), "float32")
    w = _np(rng, (64,), "float32")
    want = jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset=offset)
    got = tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, offset=offset)
    assert _maxerr(want, got) <= 1e-5


@pytest.mark.parametrize(
    "scaling", [None, ("linear", 4.0), ("llama3", 8.0, 1.0, 4.0, 64)]
)
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(4)
    jcos, jsin = jrope.rope_table(128, 16, 10000.0, scaling)
    tcos, tsin = trope.rope_table(128, 16, 10000.0, scaling)
    assert _maxerr(jcos, tcos) <= 1e-4 and _maxerr(jsin, tsin) <= 1e-4
    x = _np(rng, (2, 7, 4, 16), "float32")
    pos = rng.integers(0, 128, (2, 7)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcos, jsin)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(), tcos, tsin)
    assert _maxerr(want, got) <= 1e-4

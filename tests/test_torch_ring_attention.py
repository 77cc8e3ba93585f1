"""The port's ring attention (ops/ring_attention.py) and training's dense
attention (ops/attention.py:dense_causal_attention) against the JAX
package, on the CPU, in f32.

The reference's own ring cannot run at sp > 1 under this JAX (its
``shard_map(..., check_rep=False)`` is refused), so the port's ring is
held against what does run: the whole ring against the reference's
``causal_prefill_attention`` (its XLA branch) at the reference test's
three parametrisations, atol 1e-5 on every valid row; one fold against
the reference's ``_chunk_attend``, atol 1e-6; the ring's input
gradients against ``jax.grad`` of the dense reference, atol 1e-5. The
query sequence is split over ``sp`` ranks of a ``cpu`` mesh, rank i
holding positions ``i*chunk ..``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.ops import attention as jattn
from llm_d_fast_model_actuation_tpu.ops import ring_attention as jring
from llm_d_fast_model_actuation_tpu_torch.ops import attention as tattn
from llm_d_fast_model_actuation_tpu_torch.ops import ring_attention as tring
from llm_d_fast_model_actuation_tpu_torch.parallel import mesh as tmesh

CASES = [
    (2, 2, 32, 4, 2, 16),
    (4, 1, 64, 8, 8, 32),  # MHA
    (8, 2, 64, 8, 2, 16),  # GQA 4x, full ring
]


def _inputs(seed, batch, seq, heads, kvh, d, sp):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, seq, heads, d), dtype=np.float32)
    k = rng.standard_normal((batch, seq, kvh, d), dtype=np.float32)
    v = rng.standard_normal((batch, seq, kvh, d), dtype=np.float32)
    # ragged: one full row, one ending mid-chunk (the reference test's lengths)
    seq_lens = np.asarray([seq, seq - seq // sp - 3][:batch], dtype=np.int32)
    return q, k, v, seq_lens


def _chunks(x: np.ndarray, mesh, requires_grad=False):
    n = mesh.shape["sp"]
    c = x.shape[1] // n
    out = []
    for r in range(mesh.size):
        i = mesh.index(r, "sp")
        t = torch.from_numpy(np.ascontiguousarray(x[:, i * c:(i + 1) * c]))
        out.append(t.requires_grad_(requires_grad))
    return out


def _ring(q, k, v, seq_lens, sp, requires_grad=False):
    mesh = tmesh.make_mesh(tmesh.MeshPlan(sp=sp), ["cpu"] * sp)
    qs, ks, vs = (_chunks(a, mesh, requires_grad) for a in (q, k, v))
    lens = mesh.replicate(torch.from_numpy(seq_lens))
    out = tring.ring_prefill_attention(qs, ks, vs, lens, mesh)
    return mesh, (qs, ks, vs), out


@pytest.mark.parametrize("sp,batch,seq,heads,kvh,d", CASES)
def test_ring_matches_the_references_dense_attention(sp, batch, seq, heads, kvh, d):
    q, k, v, seq_lens = _inputs(0, batch, seq, heads, kvh, d, sp)
    want = np.asarray(jattn.causal_prefill_attention(q, k, v, jnp.asarray(seq_lens), impl="reference"))
    _, _, out = _ring(q, k, v, seq_lens, sp)
    got = torch.cat(out, dim=1).numpy()
    for b in range(batch):
        n = int(seq_lens[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5, rtol=0)


@pytest.mark.parametrize("sp,batch,seq,heads,kvh,d", CASES)
def test_dense_attention_matches_the_references_xla_branch(sp, batch, seq, heads, kvh, d):
    """Every row, padding rows too: training's attention is the
    reference's function, not only on its valid rows."""
    q, k, v, seq_lens = _inputs(1, batch, seq, heads, kvh, d, sp)
    want = np.asarray(jattn.causal_prefill_attention(q, k, v, jnp.asarray(seq_lens), impl="reference"))
    got = tattn.dense_causal_attention(*(torch.from_numpy(a) for a in (q, k, v, seq_lens))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_ring_at_sp_1_is_the_dense_function():
    q, k, v, seq_lens = _inputs(2, 1, 16, 4, 2, 8, 1)
    _, _, out = _ring(q, k, v, seq_lens, 1)
    dense = tattn.dense_causal_attention(*(torch.from_numpy(a) for a in (q, k, v, seq_lens)))
    assert len(out) == 1 and torch.equal(out[0], dense)
    want = np.asarray(jring.ring_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seq_lens),
        jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("sp",)),
    ))
    np.testing.assert_allclose(out[0].numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("src", [0, 1, 2])
def test_one_fold_matches_the_references_chunk_attend(src):
    """A query chunk at position 2*C folding the chunk at ``src*C`` into a
    state with a prior fold: the causal mask cuts all of chunk 2's upper
    triangle, none of chunk 0's; row 1's seq_len ends inside chunk 1."""
    rng = np.random.default_rng(3 + src)
    b, c, h, kvh, d = 2, 8, 4, 2, 16
    q = rng.standard_normal((b, c, h, d), dtype=np.float32)
    k = rng.standard_normal((b, c, kvh, d), dtype=np.float32)
    v = rng.standard_normal((b, c, kvh, d), dtype=np.float32)
    q_pos = (2 * c + np.arange(c)).astype(np.int32)
    k_pos = (src * c + np.arange(c)).astype(np.int32)
    seq_lens = np.asarray([3 * c, c + 5], np.int32)
    g = h // kvh
    m = rng.standard_normal((b, kvh, g, c, 1), dtype=np.float32)
    l = rng.uniform(0.5, 2.0, (b, kvh, g, c, 1)).astype(np.float32)
    acc = rng.standard_normal((b, kvh, g, c, d), dtype=np.float32)
    want = jring._chunk_attend(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos, seq_lens, m, l, acc)))
    got = tring.chunk_attend(*(torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos, seq_lens, m, l, acc)))
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("sp,batch,seq,heads,kvh,d", CASES[:2])
def test_ring_gradients_match_jax_grad_of_the_dense_reference(sp, batch, seq, heads, kvh, d):
    """d/d(q, k, v) of a weighted sum over the valid rows, through the
    ring (autograd through the folds and the shifts) against ``jax.grad``
    of the reference's dense function."""
    q, k, v, seq_lens = _inputs(4, batch, seq, heads, kvh, d, sp)
    w = np.random.default_rng(5).standard_normal((batch, seq, heads, d), dtype=np.float32)
    valid = (np.arange(seq)[None, :] < seq_lens[:, None]).astype(np.float32)[:, :, None, None]

    def jloss(q, k, v):
        o = jattn.causal_prefill_attention(q, k, v, jnp.asarray(seq_lens), impl="reference")
        return (o * w * valid).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    mesh, (qs, ks, vs), out = _ring(q, k, v, seq_lens, sp, requires_grad=True)
    got = torch.cat(out, dim=1)
    (got * torch.from_numpy(w * valid)).sum().backward()
    for name, wg, parts in zip("qkv", want, (qs, ks, vs)):
        tg = torch.cat([p.grad for p in parts], dim=1).numpy()
        np.testing.assert_allclose(tg, np.asarray(wg), atol=1e-5, rtol=0, err_msg=name)

"""The port's Llama forward against the JAX package's, on shared weights.

Parameters are drawn by the JAX package, carried across with
``models/convert.py:params_from_jax`` and run through ``prefill``,
``prefill_continue`` and ``decode_step`` on both sides, in float32 on the
CPU, on the tiny Llama, tiny Gemma and a tiny Qwen-style (q/k/v bias)
config. Tolerance: 1e-4 max abs on logits and on the written KV pages
(the same float32 math, summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu_torch.models import llama as tllama
from llm_d_fast_model_actuation_tpu_torch.models.convert import (
    config_from_jax,
    params_from_jax,
)

TOL = 1e-4
PS = 8  # page size
PPS = 4  # pages per sequence


def _jax_cfg(name):
    base = jllama.LlamaConfig.tiny_gemma() if name == "tiny_gemma" else jllama.LlamaConfig.tiny()
    if name == "tiny_qwen":
        base = dataclasses.replace(base, attn_bias=True)
    # "grouped": the reference's inline, deferred-scatter decode branch
    return dataclasses.replace(base, dtype=jnp.float32, attention_impl="grouped")


def _setup(name):
    jcfg = _jax_cfg(name)
    params = jllama.init_params(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    if jcfg.attn_bias:  # random biases, so the test sees them
        rng = np.random.default_rng(7)
        for b in ("bq", "bk", "bv"):
            tree["layers"][b] = rng.standard_normal(tree["layers"][b].shape).astype(np.float32) * 0.1
        params = jax.tree.map(jnp.asarray, tree)
    model = tllama.Llama(config_from_jax(jcfg), "cpu")
    model.load_state_dict(params_from_jax(tree), strict=True)
    return jcfg, params, model


def _pools(cfg, num_pages):
    shape = (cfg.num_layers, num_pages, PS, cfg.num_kv_heads, cfg.head_dim)
    j = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    t = (torch.zeros(shape), torch.zeros(shape))
    return j, t


def _close(j, t, tol=TOL):
    return float(np.max(np.abs(np.asarray(j) - t.numpy()))) <= tol


def _pools_close(jcache, tcache):
    """The pools agree on every page but the null page 0: the reference
    drops padding and inactive rows' writes, the port sends them there."""
    return all(_close(np.asarray(j)[:, 1:], t[:, 1:]) for j, t in zip(jcache, tcache))


def _table(b):
    return np.arange(1, 1 + b * PPS, dtype=np.int32).reshape(b, PPS)


@pytest.mark.parametrize("name", ["tiny", "tiny_gemma", "tiny_qwen"])
def test_prefill_continue_and_decode_match_jax(name):
    jcfg, jparams, model = _setup(name)
    rng = np.random.default_rng(0)
    b, s = 2, 16
    tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    lens = np.array([16, 9], dtype=np.int32)
    pt = _table(b)
    jcache, tcache = _pools(jcfg, b * PPS + 1)

    # prefill of the first 8 tokens of every row
    jl, jcache = jllama.prefill(
        jparams, jcfg, jnp.asarray(tokens[:, :8]), jnp.asarray([8, 8]), jcache, jnp.asarray(pt)
    )
    tl = tllama.prefill(
        model, torch.from_numpy(tokens[:, :8]), torch.tensor([8, 8], dtype=torch.int32),
        tcache, torch.from_numpy(pt),
    )
    assert _close(jl, tl)
    assert _pools_close(jcache, tcache)

    # the suffix [8, lens) through the paged continue path
    suf = np.zeros((b, 8), dtype=np.int32)
    suf[:, :] = tokens[:, 8:16]
    suf_lens = lens - 8
    start = np.array([8, 8], dtype=np.int32)
    jl, jcache = jllama.prefill_continue(
        jparams, jcfg, jnp.asarray(suf), jnp.asarray(start), jnp.asarray(suf_lens), jcache,
        jnp.asarray(pt),
    )
    tl = tllama.prefill_continue(
        model, torch.from_numpy(suf), torch.from_numpy(start), torch.from_numpy(suf_lens),
        tcache, torch.from_numpy(pt),
    )
    for r in range(b):  # padding queries are garbage on both sides
        assert _close(jl[r, : suf_lens[r]], tl[r, : suf_lens[r]])
    assert _pools_close(jcache, tcache)

    # two decode steps; row 1 inactive on the second (writes only the null page)
    nxt = np.array([5, 7], dtype=np.int32)
    pos = lens.copy()
    for active in (None, np.array([True, False])):
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


@pytest.mark.parametrize("name", ["tiny", "tiny_gemma"])
def test_decode_equals_prefill_and_rows_are_isolated(name):
    jcfg, _, model = _setup(name)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab_size, 12).astype(np.int32)
    other = rng.integers(0, jcfg.vocab_size, 12).astype(np.int32)
    pt = _table(2)
    _, cache = _pools(jcfg, 2 * PPS + 1)

    # decode of token 11 after a prefill of tokens [0, 11) == prefill of all 12
    full = tllama.prefill(
        model, torch.from_numpy(prompt[None]), torch.tensor([12], dtype=torch.int32),
        _pools(jcfg, 2 * PPS + 1)[1], torch.from_numpy(pt[:1]),
    )
    tllama.prefill(
        model, torch.from_numpy(prompt[None, :11]), torch.tensor([11], dtype=torch.int32),
        cache, torch.from_numpy(pt[:1]),
    )
    dec = tllama.decode_step(
        model, torch.from_numpy(prompt[11:12]), torch.tensor([11], dtype=torch.int32),
        cache, torch.from_numpy(pt[:1]),
    )
    assert float((dec[0] - full[0, 11]).abs().max()) <= TOL

    # a batch of two prompts gives each row what it gives alone
    both = tllama.prefill(
        model, torch.from_numpy(np.stack([prompt, other])), torch.tensor([12, 7], dtype=torch.int32),
        _pools(jcfg, 2 * PPS + 1)[1], torch.from_numpy(pt),
    )
    alone = tllama.prefill(
        model, torch.from_numpy(other[None, :7]), torch.tensor([7], dtype=torch.int32),
        _pools(jcfg, 2 * PPS + 1)[1], torch.from_numpy(pt[1:]),
    )
    assert float((both[0] - full[0]).abs().max()) <= TOL
    assert float((both[1, :7] - alone[0]).abs().max()) <= TOL

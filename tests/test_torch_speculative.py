"""N-gram (prompt-lookup) speculative decoding (``speculative_ngram``) of
the port against the JAX engine's, on the CPU.

The reference's five cases (``tests/test_speculative.py``), each run by
both engines on the same converted tiny Llama at fp32, where greedy
decoding is off bf16's near-ties: the tokens and the ``spec_proposed`` /
``spec_accepted`` counters equal the JAX engine's exactly, and the
reference's own assertions hold. Plus the port's residents: a request
routed to a co-resident variant never speculates (the verify forward
runs the base's weights).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.models import llama as jllama
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.models.convert import config_from_jax, params_from_jax


def _pair(spec=0, **kw):
    """(JAX engine, port engine) of one config and the same weights."""
    jm = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    base = dict(max_batch=2, page_size=8, num_pages=32, max_seq_len=128, speculative_ngram=spec, **kw)
    jeng = jengine.InferenceEngine(jengine.EngineConfig(model=jm, **base), seed=0)
    state = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    return jeng, tengine.InferenceEngine(tengine.EngineConfig(model=config_from_jax(jm), **base), params=state,
                                         device="cpu")


def _run(eng, requests):
    """Add ``requests`` (add_request kwargs), step until idle; the tokens
    by request order, the finish reasons and the steps taken."""
    ids = [eng.add_request(**r) for r in requests]
    done, steps = {}, 0
    while eng.has_work():
        for r in eng.step():
            done[r.seq_id] = r
        steps += 1
    return [done[i].out_tokens for i in ids], [done[i].finish_reason for i in ids], steps


def _counters(eng):
    return eng.spec_proposed, eng.spec_accepted


def test_speculative_deterministic_and_proposing():
    prompt = [7, 8, 9, 7, 8, 9, 7, 8, 9, 5]
    jeng, teng = _pair(4)
    want = jeng.generate([prompt], max_new_tokens=20)[0]
    got = teng.generate([prompt], max_new_tokens=20)[0]
    assert got == want and len(got) == 20
    assert _counters(teng) == _counters(jeng) and teng.spec_proposed > 0
    assert teng.spec_rounds > 0
    _, again = _pair(4)
    assert again.generate([prompt], max_new_tokens=20)[0] == got
    jeng2, teng2 = _pair(4)
    prompt2 = list(range(1, 14))
    assert teng2.generate([prompt2], max_new_tokens=10)[0] == jeng2.generate([prompt2], max_new_tokens=10)[0]
    assert _counters(teng2) == _counters(jeng2)


def test_speculative_oracle_accepts_and_reduces_rounds():
    prompt = [3, 3, 3, 3, 3, 3]
    jbase, tbase = _pair(0)
    base = tbase.generate([prompt], max_new_tokens=16)[0]
    assert jbase.generate([prompt], max_new_tokens=16)[0] == base

    def oracle(req, k):
        done = len(req.out_tokens)
        return base[done : done + k]

    jeng, teng = _pair(4)
    jeng._propose_ngram = teng._propose_ngram = oracle
    want = _run(jeng, [dict(prompt=prompt, max_new_tokens=16)])
    got = _run(teng, [dict(prompt=prompt, max_new_tokens=16)])
    assert got == want and len(got[0][0]) == 16
    assert _counters(teng) == _counters(jeng)
    assert teng.spec_accepted > 0 and teng.spec_accepted >= teng.spec_proposed - 4
    assert got[2] <= 2 + -(-16 // 4)


def test_speculative_adversarial_proposals_all_rejected():
    prompt = [3, 3, 3, 3, 3, 3]
    _, tbase = _pair(0)
    base = tbase.generate([prompt], max_new_tokens=10)[0]

    def adversary(req, k):
        done = len(req.out_tokens)
        true_next = base[done] if done < len(base) else 0
        return [(true_next + 1) % 256] * min(k, 3)

    jeng, teng = _pair(4)
    jeng._propose_ngram = teng._propose_ngram = adversary
    got = teng.generate([prompt], max_new_tokens=10)[0]
    assert got == jeng.generate([prompt], max_new_tokens=10)[0] == base
    assert _counters(teng) == _counters(jeng)
    assert teng.spec_proposed > 0 and teng.spec_accepted <= 2


def test_speculative_disabled_for_batched_and_sampled():
    jeng, teng = _pair(4)
    reqs = [dict(prompt=[7, 8, 9, 7, 8, 9], max_new_tokens=6), dict(prompt=[1, 2, 3, 1, 2, 3], max_new_tokens=6)]
    assert _run(teng, reqs)[0] == _run(jeng, reqs)[0]
    assert _counters(teng) == _counters(jeng) == (0, 0)
    _, teng2 = _pair(4)
    out = teng2.generate([[7, 8, 9, 7, 8, 9]], max_new_tokens=6, temperature=0.8)[0]
    assert len(out) == 6 and teng2.spec_proposed == 0
    # a penalty or a bias moves the argmax the verify forward would not see
    _, teng3 = _pair(4)
    _run(teng3, [dict(prompt=[7, 8, 9, 7, 8, 9], max_new_tokens=6, presence_penalty=0.5),
                 dict(prompt=[7, 8, 9, 7, 8, 9], max_new_tokens=6, logit_bias={5: 1.0})])
    assert teng3.spec_proposed == 0


def test_speculative_respects_budget_eos_and_stop():
    prompt = [3, 3, 3, 3, 3, 3]
    _, tbase = _pair(0)
    base = tbase.generate([prompt], max_new_tokens=5)[0]
    jeng, teng = _pair(6)
    jeng._propose_ngram = teng._propose_ngram = lambda req, k: base[len(req.out_tokens) : len(req.out_tokens) + k]
    got = teng.generate([prompt], max_new_tokens=5)[0]
    assert got == jeng.generate([prompt], max_new_tokens=5)[0] and len(got) == 5
    assert _counters(teng) == _counters(jeng)

    base8 = tbase.generate([prompt], max_new_tokens=8)[0]
    stop_tok = base8[3]
    req = dict(prompt=prompt, max_new_tokens=8, stop_seqs=[(stop_tok,)])
    jeng3, teng3 = _pair(4)
    got = _run(teng3, [req])
    assert got[:2] == _run(jeng3, [req])[:2]
    assert stop_tok not in got[0][0] and got[1] == ["stop"]
    # eos: a speculative run stops at the eos token as the chunk does
    eos = base8[2]
    jeng4, teng4 = _pair(4, eos_token_id=eos)
    want = _run(jeng4, [dict(prompt=prompt, max_new_tokens=8)])
    assert _run(teng4, [dict(prompt=prompt, max_new_tokens=8)])[:2] == want[:2]


def test_a_routed_request_never_speculates():
    _, teng = _pair(4, packed_serving=True)
    delta = {"lm_head": torch.flip(teng.model.lm_head.detach(), dims=[1]).clone()}
    handle = teng.attach_variant(delta, label="mirrored")
    prompt = [7, 8, 9, 7, 8, 9, 7, 8, 9, 5]
    routed = _run(teng, [dict(prompt=prompt, max_new_tokens=12, variant=handle)])
    assert len(routed[0][0]) == 12 and teng.spec_proposed == 0
    base = _run(teng, [dict(prompt=prompt, max_new_tokens=12)])
    assert teng.spec_proposed > 0 and base[0] != routed[0]


@pytest.mark.parametrize("k", [1, 3])
def test_propose_ngram_is_the_references_lookup(k):
    """The proposer alone, on contexts longer than its window too."""
    jeng, teng = _pair(k)
    rng = np.random.default_rng(5)
    for n_prompt, n_out in ((6, 0), (40, 12), (1100, 30), (10, 1200)):
        prompt = [int(t) for t in rng.integers(0, 6, n_prompt)]
        out = [int(t) for t in rng.integers(0, 6, n_out)]
        jr = jengine.Request(seq_id=1, prompt=prompt, max_new_tokens=1)
        tr = tengine.Request(seq_id=1, prompt=prompt, max_new_tokens=1)
        jr.out_tokens, tr.out_tokens = list(out), list(out)
        assert teng._propose_ngram(tr, k) == jeng._propose_ngram(jr, k)

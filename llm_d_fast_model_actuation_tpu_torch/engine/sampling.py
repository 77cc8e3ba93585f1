"""Token sampling on the device (no host round trip per step).

Port of ``engine/sampling.py:sample``. Greedy when temperature == 0;
otherwise Gumbel-max sampling from the tempered distribution, with
per-row nucleus (top-p) sampling over the top ``TOP_P_CANDIDATES``
logits. The randomness is an ARGUMENT — Gumbel noise the caller draws
from its per-request generators — so a request's draws depend only on
its own generator, never on its batch neighbours, and tests can hand
both sides the same noise. The draws are not JAX's threefry stream.
"""

from __future__ import annotations

from typing import Optional

import torch

#: nucleus sampling truncates to this many candidates before the cumsum
TOP_P_CANDIDATES = 64


def noise_width(vocab_size: int) -> int:
    """Gumbel values one sampled row needs: the full vocabulary, then the
    nucleus candidates."""
    return vocab_size + min(TOP_P_CANDIDATES, vocab_size)


def gumbel(uniform: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) noise from uniforms in [0, 1)."""
    tiny = torch.finfo(uniform.dtype).tiny
    return -torch.log(-torch.log(uniform.clamp(min=tiny)))


def sample(
    logits: torch.Tensor,  # [b, vocab] fp32
    temperature: torch.Tensor,  # [b] fp32; 0 = greedy
    noise: Optional[torch.Tensor] = None,  # [b, noise_width(vocab)] Gumbel
    top_p: Optional[torch.Tensor] = None,  # [b] fp32; >= 1 = full distribution
    counts: Optional[torch.Tensor] = None,  # [b, vocab] int32 token counts
    presence_penalty: Optional[torch.Tensor] = None,  # [b] fp32
    frequency_penalty: Optional[torch.Tensor] = None,  # [b] fp32
    alt_k: int = 0,  # also return the top-k alternative logprobs
    bias: Optional[torch.Tensor] = None,  # [b, vocab] fp32 logit bias
):
    """Returns (token [b] int32, logprob [b] fp32 of the chosen token) —
    plus, when ``alt_k > 0``, (alt_logprobs [b, alt_k], alt_ids [b,
    alt_k] int32) of the same raw distribution.

    OpenAI-order chain, as in the reference: logit bias, then repetition
    penalties (subtract freq*count + pres*[count>0]), then temperature,
    then top-p truncation. The reported logprob is normalized over the
    biased and penalized logits before temperature and top-p. ``noise``
    may be None only when every row is greedy."""
    if bias is not None:
        logits = logits + bias
    if counts is not None:
        cf = counts.float()
        pen = torch.zeros_like(logits)
        if frequency_penalty is not None:
            pen = pen + frequency_penalty[:, None] * cf
        if presence_penalty is not None:
            pen = pen + presence_penalty[:, None] * (cf > 0)
        logits = logits - pen
    norm = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    greedy = torch.argmax(logits, dim=-1)
    if noise is None:
        tok = greedy
    else:
        vocab = logits.shape[-1]
        t = torch.clamp(temperature, min=1e-6)[:, None]
        sampled = torch.argmax(logits / t + noise[:, :vocab], dim=-1)
        if top_p is not None:
            c = min(TOP_P_CANDIDATES, vocab)
            vals, idx = torch.topk(logits, c, dim=-1)  # descending
            # nucleus membership over the TEMPERED distribution
            probs = torch.softmax(vals / t, dim=-1)
            csum = torch.cumsum(probs, dim=-1)
            # keep tokens whose PRECEDING mass is < p (the first is always kept)
            keep = (csum - probs) < top_p[:, None]
            masked = torch.where(keep, vals, torch.full_like(vals, float("-inf")))
            choice = torch.argmax(masked / t + noise[:, vocab : vocab + c], dim=-1)
            nucleus = torch.gather(idx, 1, choice[:, None])[:, 0]
            sampled = torch.where(top_p < 1.0, nucleus, sampled)
        tok = torch.where(temperature > 0, sampled, greedy)
    tok = tok.to(torch.int32)
    lp = torch.gather(norm, 1, tok.long()[:, None])[:, 0]
    if alt_k > 0:
        alt_lps, alt_ids = torch.topk(norm, alt_k, dim=-1)
        return tok, lp, alt_lps, alt_ids.to(torch.int32)
    return tok, lp

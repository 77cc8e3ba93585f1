"""Attention ops of the serving path: causal prefill, paged decode (inline
and scatter-first), ragged paged attention over a token-packed buffer, and
paged suffix attention.

Shapes (per layer), as in the JAX package's ``ops/attention.py``:
  k_pages, v_pages: [num_pages, page_size, kv_heads, head_dim]
  page_table:       [batch, pages_per_seq] int32
All softmax math is fp32 regardless of the io dtype.

Dispatch is by the device of the tensors: a CPU tensor runs the plain
PyTorch version, a CUDA tensor runs the hand-written kernel
(``ops/cuda/``) or raises. ``paged_suffix_attention`` has no kernel in
the reference either (it is XLA there), so it is plain PyTorch on both;
so is ``dense_causal_attention``, training's attention, for the reason
its docstring gives.
"""

from __future__ import annotations

import torch

from .cuda import (
    RAGGED_BLOCK,
    causal_prefill_attention,
    paged_decode_attention,
    paged_decode_attention_inline,
    ragged_paged_attention,
    ragged_paged_attention_sharded,
)

__all__ = [
    "RAGGED_BLOCK",
    "causal_prefill_attention",
    "dense_causal_attention",
    "paged_decode_attention",
    "paged_decode_attention_inline",
    "paged_suffix_attention",
    "ragged_paged_attention",
    "ragged_paged_attention_sharded",
    "resolve_ragged_impl",
]

NEG_INF = -1e30


def resolve_ragged_impl(impl: str, mesh) -> str:
    """What the packed path's attention runs as for an engine on ``mesh``
    (None = one device): the mesh leg of the reference's
    ``resolve_ragged_impl``, as far as the port has anything to route
    between. The port has ONE ragged implementation per device kind (the
    kernel on the card, its plain version on the CPU, picked by the
    tensors' device), whatever ``impl`` says, so the only decision left is
    the mesh's: ``"ragged"`` without one, or where each pipeline stage of
    the mesh is one rank (``pp`` alone: the kernel once per layer on the
    stage's rank), ``"ragged_sharded"`` (the kernel once per rank,
    ``ragged_paged_attention_sharded``) otherwise. The reference's
    interpret-mode column does not exist here."""
    del impl  # the cache-write strategy of the decode step only
    return "ragged" if mesh is None or mesh.size == mesh.pp else "ragged_sharded"


def dense_causal_attention(
    q: torch.Tensor,  # [batch, seq, heads, head_dim]
    k: torch.Tensor,  # [batch, seq, kv_heads, head_dim]
    v: torch.Tensor,  # [batch, seq, kv_heads, head_dim]
    seq_lens: torch.Tensor,  # [batch] int: valid prefix length per row
) -> torch.Tensor:
    """Causal self-attention over a right-padded batch, differentiable:
    the torch counterpart of the XLA branch of the reference's
    ``ops/attention.py:causal_prefill_attention`` (GQA by repeating K/V,
    the query scaled in f32, f32 logits masked to ``NEG_INF``, the
    softmax as ``exp(l - max) / sum``, the product with V in f32, the
    result rounded to ``q.dtype``).

    Training calls it (``models/train.py``), as the JAX package's
    training runs that XLA function: ``jax.grad`` cannot pass through its
    Pallas kernel (``pallas_call`` has no transpose rule, and no kernel
    there has a ``custom_vjp``). Serving keeps the hand-written prefill
    kernel (:func:`causal_prefill_attention`)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    k = k.repeat_interleave(h // kvh, dim=2)
    v = v.repeat_interleave(h // kvh, dim=2)
    qf = q.float() * d**-0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    pos = torch.arange(s, device=q.device)
    causal = pos[None, :, None] >= pos[None, None, :]  # [1, q, k]
    valid = pos[None, None, :] < seq_lens.to(q.device)[:, None, None]  # [b, 1, k]
    mask = (causal & valid)[:, None, :, :]  # [b, 1, q, k]
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=q.device))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def paged_suffix_attention(
    q: torch.Tensor,  # [batch, s, heads, head_dim] — suffix queries
    k_pages: torch.Tensor,  # [num_pages, page_size, kv_heads, head_dim]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32
    start: torch.Tensor,  # [batch] int32 — absolute position of query 0
) -> torch.Tensor:
    """Causal attention for a prompt SUFFIX over the paged cache (the
    prefix-cache hit path): query i at absolute position start+i attends
    to every cache slot <= its own position; the suffix's KV has already
    been written. Padding queries produce values the caller ignores.

    Arithmetic of the reference's grouped XLA version: the scaled query
    rounds to the io dtype, products accumulate in fp32, and the
    probabilities round to the io dtype before the product with V. Only
    the pages the longest row can see are gathered — exact, since the
    dropped entries are masked for every row."""
    b, s, h, d = q.shape
    kvh = k_pages.shape[2]
    g = h // kvh
    page_size = k_pages.shape[1]
    need = -(-(int(start.max()) + s) // page_size)
    pt = page_table[:, : min(need, page_table.shape[1])].long()
    ctx = pt.shape[1] * page_size

    k = k_pages[pt].reshape(b, ctx, kvh, d).float()
    v = v_pages[pt].reshape(b, ctx, kvh, d)
    qg = (q.float() * d**-0.5).to(q.dtype).float().reshape(b, s, kvh, g, d)
    logits = torch.einsum("bsngd,bknd->bsngk", qg, k)
    qpos = start.long()[:, None] + torch.arange(s, device=q.device)[None, :]
    mask = torch.arange(ctx, device=q.device)[None, None, :] <= qpos[:, :, None]
    logits = logits.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bsngk,bknd->bsngd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, s, h, d).to(q.dtype)

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
the reference either (it is XLA there), so it is plain PyTorch on both.
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
    the mesh's: ``"ragged"`` without one, ``"ragged_sharded"`` (the kernel
    once per rank, ``ragged_paged_attention_sharded``) with one. The
    reference's interpret-mode column does not exist here."""
    del impl  # the cache-write strategy of the decode step only
    return "ragged" if mesh is None else "ragged_sharded"


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

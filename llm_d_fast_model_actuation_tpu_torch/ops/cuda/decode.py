"""Paged decode attention: the CUDA kernel (``csrc/decode.cu``, two
variants) and the plain PyTorch version of each.

Ports of ``llm_d_fast_model_actuation_tpu/ops/pallas/decode.py``:

* :func:`paged_decode_attention_inline` (``_decode_kernel_inline``) — the
  new token's K/V are passed inline, not yet in the cache;
* :func:`paged_decode_attention` (``_decode_kernel``) — scatter-first: the
  new token is already in the cache and ``seq_lens`` counts it.

Layout contract (shared with the engine's pool):

  q:              [batch, heads, head_dim]
  k/v_pages:      [num_pages, page_size, kv_heads, head_dim] (one layer)
  k_new/v_new:    [batch, kv_heads, head_dim] — the new token (inline)
  page_table:     [batch, pages_per_seq] int32
  positions:      [batch] int32 — the new token's position; cache entries
                  at positions < pos are attended (inline)
  seq_lens:       [batch] int32 — cache entries < seq_len are attended
                  (scatter-first)

Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

_HEAD_DIMS = (64, 128, 256)


def paged_decode_attention_inline_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the Pallas kernel's
    arithmetic: q scaled by head_dim**-0.5 in fp32, K/V widened to fp32,
    one fp32 softmax over cache[< pos] plus the inline token."""
    b, h, d = q.shape
    kvh = k_pages.shape[2]
    g = h // kvh
    pps = page_table.shape[1]
    ps = k_pages.shape[1]
    ctx = pps * ps
    pt = page_table.long()
    k = k_pages[pt].reshape(b, ctx, kvh, d).float()
    v = v_pages[pt].reshape(b, ctx, kvh, d).float()
    qg = (q.float() * d**-0.5).reshape(b, kvh, g, d)
    logits = torch.einsum("bngd,bknd->bngk", qg, k)
    valid = torch.arange(ctx, device=q.device)[None, :] < positions[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    self_logit = torch.einsum("bngd,bnd->bng", qg, k_new.float())
    probs = torch.softmax(torch.cat([logits, self_logit[..., None]], dim=-1), dim=-1)
    out = torch.einsum("bngk,bknd->bngd", probs[..., :ctx], v)
    out = out + probs[..., ctx:] * v_new.float().reshape(b, kvh, 1, d)
    return out.reshape(b, h, d).to(q.dtype)


def paged_decode_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
) -> torch.Tensor:
    """The scatter-first kernel's function in plain PyTorch, with the
    Pallas kernel's arithmetic: one fp32 softmax over cache[< seq_len];
    a sequence with seq_len 0 gives zeros, as the kernel does."""
    b, h, d = q.shape
    kvh = k_pages.shape[2]
    g = h // kvh
    ctx = page_table.shape[1] * k_pages.shape[1]
    pt = page_table.long()
    k = k_pages[pt].reshape(b, ctx, kvh, d).float()
    v = v_pages[pt].reshape(b, ctx, kvh, d).float()
    qg = (q.float() * d**-0.5).reshape(b, kvh, g, d)
    logits = torch.einsum("bngd,bknd->bngk", qg, k)
    valid = torch.arange(ctx, device=q.device)[None, :] < seq_lens[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    out = torch.einsum("bngk,bknd->bngd", torch.softmax(logits, dim=-1), v)
    out = torch.where(seq_lens[:, None, None, None] > 0, out, 0.0)
    return out.reshape(b, h, d).to(q.dtype)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_common(q, k_pages, v_pages, page_table, lens, extra=()) -> None:
    b, h, d = q.shape
    num_pages, ps, kvh, _ = k_pages.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if h % kvh or h // kvh > 16:
        raise ValueError(f"decode kernel needs heads % kv_heads == 0 and a group <= 16 ({h}/{kvh})")
    bf16 = torch.bfloat16
    _check("q", q, bf16, (b, h, d))
    _check("k_pages", k_pages, bf16, (num_pages, ps, kvh, d))
    _check("v_pages", v_pages, bf16, (num_pages, ps, kvh, d))
    _check("page_table", page_table, torch.int32, (b, page_table.shape[1]))
    _check("lens", lens, torch.int32, (b,))
    for name, t in extra:
        _check(name, t, bf16, (b, kvh, d))
    for t in (k_pages, v_pages, page_table, lens, *(t for _, t in extra)):
        if t.device != q.device:
            raise ValueError("all decode inputs must be on one device")


def _call(symbol: str, argtypes, q, tensors, scalars) -> torch.Tensor:
    """Launch ``symbol`` of the decode library on q's current stream: the
    pointers of q, ``tensors`` and a new output, then ``scalars`` and the
    stream. Returns the output."""
    from .build import library

    fn = getattr(library("decode"), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, *tensors, out)]
    with torch.cuda.device(q.device):
        err = fn(*ptrs, *scalars, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: CUDA error {err}")
    return out


def _launch_inline(q, k_pages, v_pages, k_new, v_new, page_table, positions) -> torch.Tensor:
    _check_common(q, k_pages, v_pages, page_table, positions, (("k_new", k_new), ("v_new", v_new)))
    b, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    out = _call(
        "fma_paged_decode_inline_bf16",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
        q, (k_pages, v_pages, k_new, v_new, page_table, positions),
        (b, h, kvh, d, ps, page_table.shape[1], d**-0.5),
    )
    paged_decode_attention_inline.launches += 1
    return out


def _launch_scatter_first(q, k_pages, v_pages, page_table, seq_lens) -> torch.Tensor:
    _check_common(q, k_pages, v_pages, page_table, seq_lens)
    b, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    out = _call(
        "fma_paged_decode_bf16",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
        q, (k_pages, v_pages, page_table, seq_lens),
        (b, h, kvh, d, ps, page_table.shape[1], d**-0.5),
    )
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_inline(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """One decode step of GQA attention over the paged cache plus the
    inline new token. CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16 only) or raise. ``launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return paged_decode_attention_inline_plain(
            q, k_pages, v_pages, k_new, v_new, page_table, positions
        )
    return _launch_inline(q, k_pages, v_pages, k_new, v_new, page_table, positions)


paged_decode_attention_inline.launches = 0


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
) -> torch.Tensor:
    """One scatter-first decode step of GQA attention over the paged
    cache (the new token is already in it; ``seq_lens`` counts it). CPU
    tensors take the plain version; CUDA tensors launch the kernel (bf16
    only) or raise. ``launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, seq_lens)
    return _launch_scatter_first(q, k_pages, v_pages, page_table, seq_lens)


paged_decode_attention.launches = 0

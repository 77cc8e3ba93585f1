"""Paged decode attention with the new token inline: the CUDA kernel
(``csrc/decode.cu``) and its plain PyTorch version.

Port of ``llm_d_fast_model_actuation_tpu/ops/pallas/decode.py:
_decode_kernel_inline``. Layout contract (shared with the engine's pool):

  q:              [batch, heads, head_dim]
  k/v_pages:      [num_pages, page_size, kv_heads, head_dim] (one layer)
  k_new/v_new:    [batch, kv_heads, head_dim] — the new token, not yet in
                  the cache
  page_table:     [batch, pages_per_seq] int32
  positions:      [batch] int32 — the new token's position; cache entries
                  at positions < pos are attended

:func:`paged_decode_attention_inline` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors; it never falls back.
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


def _launch(q, k_pages, v_pages, k_new, v_new, page_table, positions) -> torch.Tensor:
    from .build import library

    b, h, d = q.shape
    num_pages, ps, kvh, _ = k_pages.shape
    pps = page_table.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if h % kvh or h // kvh > 16:
        raise ValueError(f"decode kernel needs heads % kv_heads == 0 and a group <= 16 ({h}/{kvh})")
    bf16 = torch.bfloat16
    _check("q", q, bf16, (b, h, d))
    _check("k_pages", k_pages, bf16, (num_pages, ps, kvh, d))
    _check("v_pages", v_pages, bf16, (num_pages, ps, kvh, d))
    _check("k_new", k_new, bf16, (b, kvh, d))
    _check("v_new", v_new, bf16, (b, kvh, d))
    _check("page_table", page_table, torch.int32, (b, pps))
    _check("positions", positions, torch.int32, (b,))
    for t in (k_pages, v_pages, k_new, v_new, page_table, positions):
        if t.device != q.device:
            raise ValueError("all decode inputs must be on one device")
    out = torch.empty_like(q)
    lib = library("decode")
    fn = lib.fma_paged_decode_inline_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), page_table.data_ptr(),
            positions.data_ptr(), out.data_ptr(),
            b, h, kvh, d, ps, pps, d**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: CUDA error {err}")
    paged_decode_attention_inline.launches += 1
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
    return _launch(q, k_pages, v_pages, k_new, v_new, page_table, positions)


paged_decode_attention_inline.launches = 0

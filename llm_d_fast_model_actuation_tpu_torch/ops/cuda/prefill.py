"""Causal (flash) prefill attention: the CUDA kernel (``csrc/prefill.cu``)
and its plain PyTorch version.

Port of ``llm_d_fast_model_actuation_tpu/ops/pallas/prefill.py:
_prefill_kernel`` over a right-padded batch:

  q:         [batch, seq, heads, head_dim]
  k, v:      [batch, seq, kv_heads, head_dim]
  seq_lens:  [batch] int32, >= 1 — valid prefix length per row

Query row i attends to keys j <= i with j < seq_len; rows past seq_len
attend to the valid keys (their output is computed, and ignored by the
model). :func:`causal_prefill_attention` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

_HEAD_DIMS = (64, 128, 256)


def causal_prefill_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_lens: torch.Tensor
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 logits of the
    d**-0.5-scaled queries, masked, one softmax, fp32 product with V."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    k = k.repeat_interleave(h // kvh, dim=2).float()
    v = v.repeat_interleave(h // kvh, dim=2).float()
    qf = q.float() * d**-0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k)
    pos = torch.arange(s, device=q.device)
    causal = pos[None, :, None] >= pos[None, None, :]  # [1, q, k]
    valid = pos[None, None, :] < seq_lens[:, None, None]  # [b, 1, k]
    mask = (causal & valid)[:, None, :, :]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.to(q.dtype)


def _check(name: str, t: torch.Tensor, device: torch.device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")


def _check_rows(name: str, t: torch.Tensor) -> None:
    # the kernel reads each head row as 16-byte vectors through the strides
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in head_dim")
    if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1]):
        raise ValueError(f"{name} rows must be 16-byte aligned")


def _launch(q, k, v, seq_lens) -> torch.Tensor:
    from .build import library

    if not q.is_cuda:
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"prefill kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if h % kvh:
        raise ValueError(f"heads ({h}) must be a multiple of kv_heads ({kvh})")
    bf16 = torch.bfloat16
    _check("q", q, q.device, bf16, (b, s, h, d))
    _check("k", k, q.device, bf16, (b, s, kvh, d))
    _check("v", v, q.device, bf16, (b, s, kvh, d))
    _check("seq_lens", seq_lens, q.device, torch.int32, (b,))
    if not seq_lens.is_contiguous():
        raise ValueError("seq_lens must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t)
    out = torch.empty((b, s, h, d), dtype=bf16, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    lib = library("prefill")
    fn = lib.fma_causal_prefill_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), b, s, h, kvh, d,
            ctypes.cast(strides, ctypes.c_void_p), d**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"prefill kernel launch failed: CUDA error {err}")
    causal_prefill_attention.launches += 1
    by_seq = causal_prefill_attention.launches_by_seq
    by_seq[s] = by_seq.get(s, 0) + 1
    return out


def causal_prefill_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_lens: torch.Tensor
) -> torch.Tensor:
    """Causal self-attention over a right-padded prefill batch. CPU
    tensors take the plain version; CUDA tensors launch the kernel (bf16
    only) or raise. ``launches`` counts kernel launches, and
    ``launches_by_seq`` counts them per padded sequence length."""
    if q.device.type == "cpu":
        return causal_prefill_attention_plain(q, k, v, seq_lens)
    return _launch(q, k, v, seq_lens)


causal_prefill_attention.launches = 0
causal_prefill_attention.launches_by_seq = {}

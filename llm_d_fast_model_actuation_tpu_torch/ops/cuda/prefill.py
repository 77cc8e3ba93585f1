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

The kernel's host side is planned here, in plain Python that the CPU
tests reach: tile sizes per head_dim (:data:`TILES`), shared-memory bytes,
the grid and its issue order (:func:`block_coords`), which key tiles a
query tile loads and masks (:func:`key_tile_kinds`), and the TMA tensor
maps of the views it is handed (:func:`tensor_map`). The library encodes
the maps with CUDA's ``cuTensorMapEncodeTiled``, which the wrapper looks
up in the ``libcuda.so.1`` PyTorch has loaded, so nothing links it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Tuple

import torch

from .build import count_launch

NEG_INF = -1e30

_HEAD_DIMS = (64, 128, 256)

#: query rows per CTA (two consumer warpgroups of 64), as kBlockQ in
#: csrc/prefill.cu
BLOCK_Q = 128
#: head_dim -> (key rows per tile, stages of the K/V ring), as Tiles<> in
#: csrc/prefill.cu; at 256 the O accumulator takes 128 registers a thread,
#: so the key tile is 64 rows
TILES = {64: (128, 4), 128: (128, 2), 256: (64, 2)}
#: the dynamic shared memory one block may use on Hopper
SMEM_LIMIT = 232_448
#: a TMA box under 128-byte swizzle is at most 128 bytes wide: 64 bf16
BOX_COLS = 64


def allowed_keys(seq: int, seq_lens: torch.Tensor) -> torch.Tensor:
    """``[batch, seq, seq]`` bool: query row i may attend to key j."""
    pos = torch.arange(seq, device=seq_lens.device)
    causal = pos[None, :, None] >= pos[None, None, :]  # [1, q, k]
    valid = pos[None, None, :] < seq_lens[:, None, None]  # [b, 1, k]
    return causal & valid


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
    mask = allowed_keys(s, seq_lens)[:, None, :, :]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.to(q.dtype)


# -- the kernel's plan ------------------------------------------------------


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block (``Smem<HEAD_DIM>::kBytes``):
    1024 bytes of alignment slack, the bf16 Q tile, the K and V stages,
    and 8 bytes for each of 1 + 3 x stages barriers."""
    block_k, stages = TILES[head_dim]
    tiles = BLOCK_Q * head_dim + 2 * stages * block_k * head_dim
    return 1024 + 2 * tiles + 8 * (1 + 3 * stages)


def grid_size(seq: int, heads: int, batch: int) -> int:
    """One block per (query tile, head, sequence)."""
    return -(-seq // BLOCK_Q) * heads * batch


def block_coords(block: int, seq: int, heads: int, batch: int) -> Tuple[int, int, int]:
    """(query tile, head, sequence) of block ``block`` — the map at the
    head of ``prefill_kernel``. Blocks are issued in index order, and the
    query tile is the slowest index, counted down from the last, so the
    tiles that see the most keys go first. Heads of one KV group are
    neighbours, so their K/V tiles are reused from L2."""
    n_qt = -(-seq // BLOCK_Q)
    rank, rest = divmod(block, heads * batch)
    return n_qt - 1 - rank, rest % heads, rest // heads


def key_tile_kinds(q_tile: int, seq: int, seq_len: int, head_dim: int) -> List[str]:
    """For each key tile of a padded sequence, what the block of query
    tile ``q_tile`` does with it: ``"skipped"`` (never loaded),
    ``"masked"`` (loaded, mask applied) or ``"full"`` (loaded, no mask).

    The kernel's rule: the block loads key tiles up to the last key any
    of its rows sees, ``min(q0 + BLOCK_Q - 1, seq - 1, seq_len - 1)``
    (``last_key`` and ``n_kt``, ``csrc/prefill.cu:175-176``; the producer
    and the consumers loop ``kt < n_kt``, ``:198`` and ``:235``), and
    masks a loaded tile unless every key in it is at or below the block's
    first row and below seq_len (``full`` in ``softmax_tile``, ``:107``)."""
    block_k = TILES[head_dim][0]
    sl = max(1, min(seq_len, seq))
    q0 = q_tile * BLOCK_Q
    last_key = min(q0 + BLOCK_Q - 1, seq - 1, sl - 1)
    n_kt = last_key // block_k + 1
    kinds = []
    for kt in range(-(-seq // block_k)):
        k0 = kt * block_k
        if kt >= n_kt:
            kinds.append("skipped")
        elif k0 + block_k - 1 <= q0 and k0 + block_k <= sl:
            kinds.append("full")
        else:
            kinds.append("masked")
    return kinds


def tensor_map(name: str, t: torch.Tensor, rows: int) -> List[int]:
    """The TMA map of a ``[batch, seq, heads, head_dim]`` bf16 view, as
    the kernel's launch encodes it: dims innermost first ``(head_dim,
    seq, heads, batch)``, the byte strides of seq, heads and batch, and a
    box of ``BOX_COLS`` columns by ``rows`` rows (a row of head_dim values
    is loaded as head_dim / 64 boxes). TMA reads from a 16-byte-aligned
    base through 16-byte-multiple strides; a view that breaks this is
    refused with ``ValueError`` — never copied."""
    b, s, h, d = t.shape
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in head_dim")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for TMA")
    # a dimension of size 1 is only ever read at 0: its stride is free
    dense = {1: h * d, 2: d, 0: s * h * d}
    strides = []
    for dim in (1, 2, 0):
        st = (t.stride(dim) if t.shape[dim] > 1 else dense[dim]) * t.element_size()
        if st % 16:
            raise ValueError(f"{name}'s stride of dim {dim} is {st} bytes, not a multiple of 16 (TMA)")
        strides.append(st)
    return [d, s, h, b, *strides, BOX_COLS, rows, 1, 1]


def launch_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor) -> List[int]:
    """The 41 integers the launch takes (``fma_causal_prefill_bf16``):
    block_q, block_k, stages, shared-memory bytes and grid size; the q, k
    and v tensor maps; out's element strides of batch, seq and head."""
    b, s, h, d = q.shape
    block_k, stages = TILES[d]
    return [
        BLOCK_Q, block_k, stages, smem_bytes(d), grid_size(s, h, b),
        *tensor_map("q", q, BLOCK_Q), *tensor_map("k", k, block_k), *tensor_map("v", v, block_k),
        *out.stride()[:3],
    ]


# -- the launch -------------------------------------------------------------


def _check(name: str, t: torch.Tensor, device: torch.device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")


_PLAN_LEN = 41
_kernel_fn = None
#: (shapes, strides) -> the plan as a ctypes array: a plan holds no
#: pointer, so one layout's plan serves every call with that layout
_plans: Dict[tuple, ctypes.Array] = {}


def _plan_array(q, k, v, out) -> ctypes.Array:
    """The launch plan of this call, from the cache of plans by layout.
    Bases are checked on every call (they change), strides when a layout
    is first seen; both raise ``ValueError`` through :func:`launch_plan`."""
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        launch_plan(q, k, v, out)  # raises, naming the tensor
    key = (q.shape, q.stride(), k.shape, k.stride(), v.stride(), out.stride())
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = (ctypes.c_longlong * _PLAN_LEN)(*launch_plan(q, k, v, out))
    return plan


def _kernel():
    """The library's launch function, built and bound on first use:
    argument types are set once, and the library is handed CUDA's
    tensor-map encoder."""
    global _kernel_fn
    if _kernel_fn is None:
        from .build import library

        lib = library("prefill")
        encode = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
        lib.fma_prefill_set_encoder.argtypes = [ctypes.c_void_p]
        lib.fma_prefill_set_encoder.restype = None
        lib.fma_prefill_set_encoder(ctypes.cast(encode, ctypes.c_void_p))
        fn = lib.fma_causal_prefill_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _launch(q, k, v, seq_lens) -> torch.Tensor:
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
    out = torch.empty((b, s, h, d), dtype=bf16, device=q.device)
    plan = _plan_array(q, k, v, out)
    fn = _kernel()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            b, s, h, kvh, d, plan, d**-0.5 * math.log2(math.e))  # exp2's scale
    # the launch goes to the runtime's current device: switch only if needed
    if q.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err >= 1000:
        raise RuntimeError(f"prefill kernel: a tensor map was refused (CUresult {err - 1000})")
    if err != 0:
        raise RuntimeError(f"prefill kernel launch failed: CUDA error {err}")
    count_launch(causal_prefill_attention, "launches_by_seq", s)
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

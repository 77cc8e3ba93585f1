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

The kernel's host-side plan is stated here in plain Python, mirroring
``csrc/decode.cu`` (the CPU tests hold the two together): the query heads
of a KV head are built in ``nsplit(group)`` splits of interleaved
:data:`TILE`-token tiles, one CTA per (sequence, KV head, split) -- two
splits a CTA at group 1 -- grouped into a cluster of
``cluster_size(group)`` CTAs, each with a ring of ``stages(head_dim,
group)`` shared-memory stages (:func:`launch_plan`).

Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from .build import count_launch

NEG_INF = -1e30

_HEAD_DIMS = (64, 128, 256)

#: tokens per tile, one per lane (kTile in csrc/decode.cu)
TILE = 32
#: warps over one (sequence, KV head): group x nsplit (kMaxWarps)
MAX_WARPS = 16
#: CTAs of one (sequence, KV head) at most: the portable cluster size
#: (kMaxCluster)
MAX_CLUSTER = 8
#: page-table entries a producer warp holds in shared memory at once
#: (kTableChunk)
TABLE_CHUNK = 1024
#: producer warps of a CTA, which copy the K/V rows (kProducers)
PRODUCERS = 2
#: head_dim -> tiles the K/V ring holds (Ring<>::kTiles)
RING_TILES = {64: 12, 128: 6, 256: 4}


def nsplit(group: int) -> int:
    """Splits of one (sequence, KV head): split s takes every nsplit-th
    tile from tile s."""
    return MAX_WARPS // group


def cluster_size(group: int) -> int:
    """CTAs of one (sequence, KV head), one cluster."""
    return min(nsplit(group), MAX_CLUSTER)


def splits_per_cta(group: int) -> int:
    return nsplit(group) // cluster_size(group)


def stages(head_dim: int, group: int) -> int:
    """Ring stages: a stage holds one tile per split of the CTA."""
    return RING_TILES[head_dim] // splits_per_cta(group)


def smem_bytes(head_dim: int, group: int) -> int:
    """Dynamic shared memory of one CTA: the K/V ring (bf16), each
    consumer warp's (m, l, acc) in fp32, each producer warp's page-table
    chunk, and a full and an empty mbarrier per stage."""
    spc, st = splits_per_cta(group), stages(head_dim, group)
    warps = group * spc
    return (st * 2 * spc * TILE * head_dim * 2 + warps * (2 + head_dim) * 4 + PRODUCERS * TABLE_CHUNK * 4
            + 2 * st * 8)


def launch_plan(batch: int, kv_heads: int, head_dim: int, group: int) -> dict:
    """The launch ``csrc/decode.cu`` makes: grid (cluster, kv_heads,
    batch) in clusters of (cluster, 1, 1), ``group x splits_per_cta``
    consumer warps and :data:`PRODUCERS` producer warps per CTA, and its
    shared memory."""
    c = cluster_size(group)
    return {
        "grid": (c, kv_heads, batch), "cluster": c, "nsplit": nsplit(group),
        "splits_per_cta": splits_per_cta(group), "stages": stages(head_dim, group),
        "threads": 32 * (group * splits_per_cta(group) + PRODUCERS), "smem": smem_bytes(head_dim, group),
    }


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
    if h % kvh or h // kvh > MAX_WARPS:
        raise ValueError(f"decode kernel needs heads % kv_heads == 0 and a group <= {MAX_WARPS} ({h}/{kvh})")
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


_fns = None


def _kernels():
    """The library's two launch functions, built and bound on first use:
    argument types are set once."""
    global _fns
    if _fns is None:
        from .build import library

        lib = library("decode")
        inline, scatter_first = lib.fma_paged_decode_inline_bf16, lib.fma_paged_decode_bf16
        inline.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        scatter_first.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        inline.restype = scatter_first.restype = ctypes.c_int
        _fns = inline, scatter_first
    return _fns


def _call(fn, q, tensors, scalars) -> torch.Tensor:
    """Launch ``fn`` on q's current stream: the pointers of q, ``tensors``
    and a new output, then ``scalars`` and the stream. Returns the
    output."""
    out = torch.empty_like(q)
    args = (q.data_ptr(), *(t.data_ptr() for t in tensors), out.data_ptr(), *scalars)
    # the launch goes to the runtime's current device: switch only if needed
    if q.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: CUDA error {err}")
    return out


def _launch_inline(q, k_pages, v_pages, k_new, v_new, page_table, positions) -> torch.Tensor:
    _check_common(q, k_pages, v_pages, page_table, positions, (("k_new", k_new), ("v_new", v_new)))
    b, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    out = _call(
        _kernels()[0], q, (k_pages, v_pages, k_new, v_new, page_table, positions),
        (b, h, kvh, d, ps, page_table.shape[1], d**-0.5),
    )
    count_launch(paged_decode_attention_inline)
    return out


def _launch_scatter_first(q, k_pages, v_pages, page_table, seq_lens) -> torch.Tensor:
    _check_common(q, k_pages, v_pages, page_table, seq_lens)
    b, h, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    out = _call(
        _kernels()[1], q, (k_pages, v_pages, page_table, seq_lens),
        (b, h, kvh, d, ps, page_table.shape[1], d**-0.5),
    )
    count_launch(paged_decode_attention)
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

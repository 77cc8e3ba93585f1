"""Ragged paged attention over a token-packed buffer: the CUDA kernel
(``csrc/ragged.cu``) and its plain PyTorch version.

Port of ``llm_d_fast_model_actuation_tpu/ops/pallas/ragged.py:
_ragged_kernel``. Layout contract (shared with the engine's packer):

  q:           [T, heads, head_dim] — one flat buffer of rows of many
               sequences; T % RAGGED_BLOCK == 0
  k/v_pages:   [num_pages, page_size, kv_heads, head_dim] (one layer); every
               row's own K/V is already in it (scatter-first)
  page_table:  [rows, pages] int32 — may be a column slice of a wider
               table (its row stride is passed to the kernel)
  row_slot:    [T] int32 — the page-table row of each token; -1 = padding
  positions:   [T] int32 — each token's absolute position

Each row attends over its own sequence's cache at positions <= its own;
padding rows give zeros. The kernel also needs the packing contract of
the reference (``ragged.py:15-24``): each sequence's rows are contiguous,
at consecutive positions, and start on a ``RAGGED_BLOCK`` boundary.

:func:`ragged_paged_attention` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; it never falls back. Unlike the JAX
dispatcher, which quietly takes its XLA twin for a buffer that is not a
multiple of ``RAGGED_BLOCK`` rows, it raises: the port's packer always
aligns, so such a buffer is a bug.

:func:`ragged_paged_attention_sharded` is the port of
``ops/pallas/ragged.py:ragged_paged_attention_pallas_sharded``, the same
kernel under ``shard_map`` over the ``tp`` mesh axis. As there, it is not
a new kernel body: each rank launches ``csrc/ragged.cu`` over its own
query heads and its own KV-head slice of the pool, with the page table
and the row metadata replicated. With GQA every softmax is complete
within the rank that owns its KV head, so no collective runs inside
attention, and the per-rank outputs stay split for the row-parallel
``wo`` that follows.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

NEG_INF = -1e30

#: token rows per kernel block (the reference's ``RAGGED_BLOCK``)
RAGGED_BLOCK = 8

_HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 8


def ragged_paged_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    row_slot: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the Pallas kernel's
    arithmetic: q scaled by head_dim**-0.5 in fp32, K/V widened to fp32,
    one fp32 softmax per row over its sequence's cache positions <= its
    own. Padding rows give zeros. Sequence by sequence, so the gather
    holds one sequence's context at a time."""
    t, h, d = q.shape
    kvh = k_pages.shape[2]
    g = h // kvh
    ctx = page_table.shape[1] * k_pages.shape[1]
    qs = (q.float() * d**-0.5).reshape(t, kvh, g, d)
    out = torch.zeros((t, kvh, g, d), dtype=torch.float32, device=q.device)
    slots = row_slot.long()
    for s in torch.unique(slots[slots >= 0]).tolist():
        rows = torch.nonzero(slots == s)[:, 0]
        pt = page_table[s].long()
        k = k_pages[pt].reshape(ctx, kvh, d).float()
        v = v_pages[pt].reshape(ctx, kvh, d).float()
        logits = torch.einsum("tngd,knd->tngk", qs[rows], k)
        seen = torch.arange(ctx, device=q.device)[None, :] <= positions[rows].long()[:, None]
        logits = logits.masked_fill(~seen[:, None, None, :], NEG_INF)
        out[rows] = torch.einsum("tngk,knd->tngd", torch.softmax(logits, dim=-1), v)
    return out.reshape(t, h, d).to(q.dtype)


def _launch(q, k_pages, v_pages, page_table, row_slot, positions) -> torch.Tensor:
    from .build import library
    from .prefill import _check

    t, h, d = q.shape
    num_pages, ps, kvh, _ = k_pages.shape
    if t % RAGGED_BLOCK:
        raise ValueError(
            f"the packed buffer has {t} rows, not a multiple of RAGGED_BLOCK "
            f"({RAGGED_BLOCK}): the packer must align it"
        )
    if not q.is_cuda:
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"ragged kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if h % kvh or h // kvh > _MAX_GROUP:
        raise ValueError(f"ragged kernel needs heads % kv_heads == 0 and a group <= {_MAX_GROUP} ({h}/{kvh})")
    bf16, i32, dev = torch.bfloat16, torch.int32, q.device
    for name, x, dtype, shape in (
        ("q", q, bf16, (t, h, d)),
        ("k_pages", k_pages, bf16, (num_pages, ps, kvh, d)),
        ("v_pages", v_pages, bf16, (num_pages, ps, kvh, d)),
        ("row_slot", row_slot, i32, (t,)),
        ("positions", positions, i32, (t,)),
    ):
        _check(name, x, dev, dtype, shape)
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dtype == bf16 and x.data_ptr() % 16:  # read as 16-byte pieces
            raise ValueError(f"{name} must be 16-byte aligned")
    if page_table.dim() != 2 or page_table.shape[0] < 1:
        raise ValueError(f"page_table must be [rows, pages], got {tuple(page_table.shape)}")
    _check("page_table", page_table, dev, i32, page_table.shape)
    if page_table.stride(1) != 1:
        raise ValueError("page_table rows must be contiguous")
    out = torch.empty_like(q)
    fn = library("ragged").fma_ragged_paged_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            row_slot.data_ptr(), positions.data_ptr(), out.data_ptr(),
            t, h, kvh, d, ps, page_table.stride(0), page_table.shape[0], d**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ragged kernel launch failed: CUDA error {err}")
    return out


def _count(wrapper, rows: int) -> None:
    wrapper.launches += 1
    wrapper.launches_by_rows[rows] = wrapper.launches_by_rows.get(rows, 0) + 1


def ragged_paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    row_slot: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Attention for a token-packed mixed batch over the paged cache. CPU
    tensors take the plain version; CUDA tensors launch the kernel (bf16
    only) or raise. ``launches`` counts kernel launches, and
    ``launches_by_rows`` counts them per buffer size T."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages, page_table, row_slot, positions)
    out = _launch(q, k_pages, v_pages, page_table, row_slot, positions)
    _count(ragged_paged_attention, q.shape[0])
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.launches_by_rows = {}


def _check_shards(mesh, q_shards, k_pages_shards, v_pages_shards) -> None:
    for name, shards in (("q", q_shards), ("k_pages", k_pages_shards), ("v_pages", v_pages_shards)):
        if len(shards) != mesh.tp:
            raise ValueError(f"{len(shards)} {name} shards for a mesh of {mesh.tp}")
        for r, x in enumerate(shards):
            if x.device != mesh.devices[r]:
                raise ValueError(f"rank {r}'s {name} shard is on {x.device}, its rank on {mesh.devices[r]}")


def ragged_paged_attention_sharded_plain(
    mesh,
    q_shards: Sequence[torch.Tensor],
    k_pages_shards: Sequence[torch.Tensor],
    v_pages_shards: Sequence[torch.Tensor],
    page_table,
    row_slot,
    positions,
) -> List[torch.Tensor]:
    """The sharded kernel's function in plain PyTorch: the plain version
    once per rank over the rank's head slice."""
    _check_shards(mesh, q_shards, k_pages_shards, v_pages_shards)
    pt, rs, pos = mesh.replicate(page_table), mesh.replicate(row_slot), mesh.replicate(positions)
    return [
        ragged_paged_attention_plain(q_shards[r], k_pages_shards[r], v_pages_shards[r], pt[r], rs[r], pos[r])
        for r in range(mesh.tp)
    ]


def ragged_paged_attention_sharded(
    mesh,
    q_shards: Sequence[torch.Tensor],  # per rank [T, heads/tp, head_dim]
    k_pages_shards: Sequence[torch.Tensor],  # per rank [num_pages, page_size, kv_heads/tp, head_dim]
    v_pages_shards: Sequence[torch.Tensor],
    page_table,  # [rows, pages] int32: one tensor, or a copy per rank
    row_slot,  # [T] int32, likewise
    positions,  # [T] int32, likewise
) -> List[torch.Tensor]:
    """Ragged paged attention on a tensor-parallel mesh (``parallel/mesh.py:
    TpMesh``): the ragged kernel launched once per rank, on that rank's
    device (its current stream), over the rank's query heads and KV-head
    slice of the pool. The page table and the row metadata are replicated (a copy
    per device). Returns the per-rank outputs ``[T, heads/tp, head_dim]``,
    not gathered. Ranks whose tensors are on the CPU take the plain
    version; CUDA tensors launch the kernel or raise. ``launches`` counts
    kernel launches (one per rank and call) and ``launches_by_rows``
    counts them per buffer size T."""
    _check_shards(mesh, q_shards, k_pages_shards, v_pages_shards)
    if all(q.device.type == "cpu" for q in q_shards):
        return ragged_paged_attention_sharded_plain(
            mesh, q_shards, k_pages_shards, v_pages_shards, page_table, row_slot, positions
        )
    pt, rs, pos = mesh.replicate(page_table), mesh.replicate(row_slot), mesh.replicate(positions)
    outs = []
    for r in range(mesh.tp):
        outs.append(_launch(q_shards[r], k_pages_shards[r], v_pages_shards[r], pt[r], rs[r], pos[r]))
        _count(ragged_paged_attention_sharded, q_shards[r].shape[0])
    return outs


ragged_paged_attention_sharded.launches = 0
ragged_paged_attention_sharded.launches_by_rows = {}

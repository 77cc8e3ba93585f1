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
at consecutive positions, and start on a ``RAGGED_BLOCK`` boundary; and a
page size in :data:`PAGE_SIZES` (one page of one KV head is one TMA box).

The kernel's host side is planned here, in plain Python that the CPU
tests reach: tile sizes and ring stages (:data:`TILE_ROWS`,
:data:`BLOCK_K`, :data:`STAGES`), tokens per CTA, the grid, shared-memory bytes, how the
kernel cuts a packed buffer into tiles of one run (:func:`work_items`),
and the pool's TMA tensor map (:func:`pool_tensor_map`). Plans are cached
per layout, encoded maps per pool base (:func:`pool_maps`). The wrapper
reads nothing back from the device: the kernel finds its tiles itself.

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
from typing import Dict, List, Sequence

import torch

from .build import count_launch

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


# -- the kernel's plan ------------------------------------------------------

#: query rows per CTA (two consumer warpgroups of 64), as kTileRows in
#: csrc/ragged.cu
TILE_ROWS = 128
#: cache positions per key tile, as kBlockK in csrc/ragged.cu
BLOCK_K = 64
#: head_dim -> stages of the K/V ring, as Stages<> in csrc/ragged.cu
STAGES = {64: 4, 128: 4, 256: 2}
#: the dynamic shared memory one block may use on Hopper
SMEM_LIMIT = 232_448
#: a TMA box under 128-byte swizzle is at most 128 bytes wide: 64 bf16
BOX_COLS = 64
#: page sizes the kernel takes: one page of one KV head is one TMA box of
#: whole 1024-byte swizzle atoms (8 rows of 128 bytes), and a key tile is
#: whole pages
PAGE_SIZES = (8, 16, 32, 64)


def tokens_per_cta(group: int) -> int:
    """Tokens of one run in one CTA: ``TILE_ROWS`` query rows flattened as
    (token, head of the group), rounded down to whole ``RAGGED_BLOCK``s
    (32 at group 4, 16 at group 8, 128 at group 1)."""
    return TILE_ROWS // group // RAGGED_BLOCK * RAGGED_BLOCK


def grid(tokens: int, kv_heads: int) -> tuple:
    """One CTA per (8-row block, KV head), from T alone: the CTA of a
    block that leads no tile exits at once (:func:`work_items`)."""
    return tokens // RAGGED_BLOCK, kv_heads


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block (``Smem<HEAD_DIM>::kBytes``): 1024
    bytes of alignment slack, the bf16 Q tile, the K and V stages, and 8
    bytes for each of 3 x stages barriers."""
    stages = STAGES[head_dim]
    return 1024 + 2 * head_dim * (TILE_ROWS + 2 * stages * BLOCK_K) + 8 * 3 * stages


def work_items(row_slot: torch.Tensor, positions: torch.Tensor, group: int) -> List[tuple]:
    """The kernel's decomposition of a packed buffer, restated in Python
    for the tests (the wrapper never calls it: it would read the device).

    Returns one ``(block, end, slot, pos0, ntok)`` per CTA that does work,
    for every KV head alike: the tile of 8-row blocks ``[block, end)`` of
    one run, its sequence's page-table row, its first position and its
    valid tokens; the tile walks cache positions ``[0, pos0 + ntok)``
    once. A fully padded block is ``(block, block + 1, -1, 0, 0)``: its
    CTA writes zeros. The rule (``csrc/ragged.cu``, ``ragged_kernel``):
    block j continues block j - 1's run when its first row is the same
    sequence as j - 1's last row, at the next position; runs are cut into
    tiles of ``tokens_per_cta(group) / 8`` blocks from their first block."""
    slots, pos = row_slot.tolist(), positions.tolist()
    nb = len(slots) // RAGGED_BLOCK
    bpc = tokens_per_cta(group) // RAGGED_BLOCK

    def cont(j):
        r = j * RAGGED_BLOCK
        return j > 0 and slots[r] >= 0 and slots[r - 1] == slots[r] and pos[r - 1] + 1 == pos[r]

    items, first = [], 0
    for b in range(nb):
        r = b * RAGGED_BLOCK
        if slots[r] < 0:
            items.append((b, b + 1, -1, 0, 0))
            continue
        if not cont(b):
            first = b
        if (b - first) % bpc:
            continue
        end = next((j for j in range(b + 1, min(b + bpc, nb)) if not cont(j)), min(b + bpc, nb))
        last = sum(s >= 0 for s in slots[(end - 1) * RAGGED_BLOCK : end * RAGGED_BLOCK])
        items.append((b, end, slots[r], pos[r], (end - 1 - b) * RAGGED_BLOCK + last))
    return items


def pool_tensor_map(name: str, t: torch.Tensor) -> List[int]:
    """The TMA map of a ``[pages, page_size, kv_heads, head_dim]`` bf16 pool
    view, as the kernel's producer reads it: dims innermost first
    ``(head_dim, kv_heads, page_size, pages)``, the byte strides of
    kv_heads, page_size and pages, and a box of one page of one KV head,
    ``BOX_COLS`` columns wide (a row of head_dim values is head_dim / 64
    boxes). A KV-head slice of a wider pool (a rank's) is read through its
    strides. TMA reads from a 16-byte-aligned base through 16-byte-multiple
    strides; a view that breaks this is refused with ``ValueError``, never
    copied."""
    pages, ps, kvh, d = t.shape
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in head_dim")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for TMA")
    # a dimension of size 1 is only ever read at 0: its stride is free
    dense = {2: d, 1: kvh * d, 0: ps * kvh * d}
    strides = []
    for dim in (2, 1, 0):
        st = (t.stride(dim) if t.shape[dim] > 1 else dense[dim]) * t.element_size()
        if st % 16:
            raise ValueError(f"{name}'s stride of dim {dim} is {st} bytes, not a multiple of 16 (TMA)")
        strides.append(st)
    return [d, kvh, ps, pages, *strides, BOX_COLS, 1, ps, 1]


def launch_plan(q: torch.Tensor, k_pages: torch.Tensor) -> List[int]:
    """The 18 integers the launch takes (``fma_ragged_paged_attention_bf16``):
    tile rows, key tile rows, stages, shared-memory bytes, the grid (x, y),
    tokens per CTA, and the pool's tensor map (K and V share it)."""
    t, h, d = q.shape
    kvh = k_pages.shape[2]
    return [TILE_ROWS, BLOCK_K, STAGES[d], smem_bytes(d), *grid(t, kvh), tokens_per_cta(h // kvh),
            *pool_tensor_map("k_pages", k_pages)]


# -- the launch -------------------------------------------------------------

_PLAN_LEN = 18
_kernel_fn = None
_lib = None
#: layout -> the plan as a ctypes array; a plan holds no pointer, so one
#: layout's plan serves every call with that layout
_plans: Dict[tuple, ctypes.Array] = {}
#: (K base, V base, pool layout) -> the two encoded tensor maps. A map holds its
#: pool's base address, so maps are keyed by base, never by shape alone. An
#: engine's pool keeps its base across a sleep and wake (engine/arena.py),
#: so its maps are encoded once; another pool encodes its own. Bounded:
#: cleared when full.
_maps: Dict[tuple, ctypes.Array] = {}
_MAPS_MAX = 1024


def _encode(k_pages: torch.Tensor, v_pages: torch.Tensor, plan: ctypes.Array) -> ctypes.Array:
    """The K and V pools' tensor maps, encoded by the library with CUDA's
    ``cuTensorMapEncodeTiled``."""
    _kernel()
    maps = (ctypes.c_ubyte * (2 * _lib.fma_ragged_map_bytes()))()
    err = _lib.fma_ragged_encode_maps(maps, k_pages.data_ptr(), v_pages.data_ptr(), plan)
    if err:
        raise RuntimeError(f"ragged kernel: a pool tensor map was refused (error {err})")
    return maps


def pool_maps(k_pages: torch.Tensor, v_pages: torch.Tensor, plan: ctypes.Array) -> ctypes.Array:
    """The encoded K and V maps of these pool views (``plan`` is their
    layout's), from the cache keyed by both bases and the pool's layout."""
    key = (k_pages.data_ptr(), v_pages.data_ptr(), k_pages.shape, k_pages.stride())
    maps = _maps.get(key)
    if maps is None:
        if len(_maps) >= _MAPS_MAX:
            _maps.clear()
        maps = _maps[key] = _encode(k_pages, v_pages, plan)
    return maps


def _plan_array(layout: tuple, q, k_pages, v_pages, page_table, row_slot, positions) -> ctypes.Array:
    """The launch plan of this layout, from the cache; a layout seen for the
    first time is checked whole (shapes, types, strides), and raises
    ``ValueError`` on what the kernel does not take."""
    plan = _plans.get(layout)
    if plan is not None:
        return plan
    from .prefill import _check

    t, h, d = q.shape
    num_pages, ps, kvh, _ = k_pages.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"ragged kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if h % kvh or h // kvh > _MAX_GROUP:
        raise ValueError(f"ragged kernel needs heads % kv_heads == 0 and a group <= {_MAX_GROUP} ({h}/{kvh})")
    if ps not in PAGE_SIZES:
        raise ValueError(f"ragged kernel takes page_size in {PAGE_SIZES}, got {ps}")
    bf16, i32, dev = torch.bfloat16, torch.int32, q.device
    for name, x, dtype, shape in (
        ("q", q, bf16, (t, h, d)),
        ("k_pages", k_pages, bf16, (num_pages, ps, kvh, d)),
        ("v_pages", v_pages, bf16, (num_pages, ps, kvh, d)),
        ("row_slot", row_slot, i32, (t,)),
        ("positions", positions, i32, (t,)),
    ):
        _check(name, x, dev, dtype, shape)
    for name, x in (("q", q), ("row_slot", row_slot), ("positions", positions)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v_pages.stride() != k_pages.stride():
        raise ValueError("k_pages and v_pages must have the same strides (one tensor map layout)")
    if page_table.dim() != 2 or page_table.shape[0] < 1:
        raise ValueError(f"page_table must be [rows, pages], got {tuple(page_table.shape)}")
    _check("page_table", page_table, dev, i32, page_table.shape)
    if page_table.stride(1) != 1:
        raise ValueError("page_table rows must be contiguous")
    plan = _plans[layout] = (ctypes.c_longlong * _PLAN_LEN)(*launch_plan(q, k_pages))
    return plan


def _kernel():
    """The library's launch function, built and bound on first use:
    argument types are set once, and the library is handed CUDA's
    tensor-map encoder."""
    global _kernel_fn, _lib
    if _kernel_fn is None:
        from .build import library

        lib = library("ragged")
        encode = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
        lib.fma_ragged_set_encoder.argtypes = [ctypes.c_void_p]
        lib.fma_ragged_set_encoder.restype = None
        lib.fma_ragged_set_encoder(ctypes.cast(encode, ctypes.c_void_p))
        lib.fma_ragged_map_bytes.argtypes = []
        lib.fma_ragged_map_bytes.restype = ctypes.c_int
        lib.fma_ragged_encode_maps.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.fma_ragged_encode_maps.restype = ctypes.c_int
        fn = lib.fma_ragged_paged_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib, _kernel_fn = lib, fn
    return _kernel_fn


def _launch(q, k_pages, v_pages, page_table, row_slot, positions) -> torch.Tensor:
    t, h, d = q.shape
    if t % RAGGED_BLOCK:
        raise ValueError(
            f"the packed buffer has {t} rows, not a multiple of RAGGED_BLOCK "
            f"({RAGGED_BLOCK}): the packer must align it"
        )
    if not q.is_cuda:
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    # what a layout fixes is checked once per layout; bases every call
    layout = (q.shape, q.stride(), q.dtype, k_pages.shape, k_pages.stride(), k_pages.dtype,
              v_pages.shape, v_pages.stride(), v_pages.dtype, page_table.shape, page_table.stride(),
              page_table.dtype, row_slot.shape, row_slot.stride(), row_slot.dtype,
              positions.shape, positions.stride(), positions.dtype,
              q.device, k_pages.device, v_pages.device, page_table.device, row_slot.device,
              positions.device)
    plan = _plan_array(layout, q, k_pages, v_pages, page_table, row_slot, positions)
    if (q.data_ptr() | k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError("q, k_pages and v_pages must start on 16-byte boundaries")
    fn = _kernel()
    maps = pool_maps(k_pages, v_pages, plan)
    out = torch.empty_like(q)
    args = (maps, q.data_ptr(), page_table.data_ptr(), row_slot.data_ptr(), positions.data_ptr(),
            out.data_ptr(), t, h, k_pages.shape[2], d, k_pages.shape[1], page_table.stride(0),
            page_table.shape[0], plan, d**-0.5)
    # the launch goes to the runtime's current device: switch only if needed
    if q.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged kernel launch failed: CUDA error {err}")
    return out


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
    count_launch(ragged_paged_attention, "launches_by_rows", q.shape[0])
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.launches_by_rows = {}


def _check_shards(mesh, q_shards, k_pages_shards, v_pages_shards) -> None:
    for name, shards in (("q", q_shards), ("k_pages", k_pages_shards), ("v_pages", v_pages_shards)):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} {name} shards for a mesh of {mesh.size}")
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
        for r in range(mesh.size)
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
    Mesh`` of ``tp``): the ragged kernel launched once per rank, on that rank's
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
    for r in range(mesh.size):
        outs.append(_launch(q_shards[r], k_pages_shards[r], v_pages_shards[r], pt[r], rs[r], pos[r]))
        count_launch(ragged_paged_attention_sharded, "launches_by_rows", q_shards[r].shape[0])
    return outs


ragged_paged_attention_sharded.launches = 0
ragged_paged_attention_sharded.launches_by_rows = {}

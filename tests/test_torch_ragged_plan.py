"""The ragged kernel's host-side plan and its work decomposition, on the CPU.

``ops/cuda/ragged.py`` states in plain Python what the launch of
``csrc/ragged.cu`` does: tile rows, key tile and ring stages, tokens per
CTA, the grid, shared memory, the pool's TMA tensor map (whole, or a
rank's KV-head slice), the cache of encoded maps, and how the kernel cuts
a packed buffer into tiles of one run (``work_items``). These tests hold
that statement to the kernel source, and hold an emulation of the
kernel's arithmetic, tile by tile as its CTAs split the work, to the
plain version and to the JAX Pallas kernel in interpret mode. Tolerance
of the emulation: float32, 1e-5 absolute and relative (an online softmax
over 64-key tiles against one softmax over the whole context).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.ops.pallas import ragged_paged_attention_pallas
from llm_d_fast_model_actuation_tpu.utils.compat import pallas_interpret_supported
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import ragged as R

CU = Path(R.__file__).resolve().parents[2] / "csrc" / "ragged.cu"
bf16 = torch.bfloat16
TOL = 1e-5


def test_sizes_match_the_kernel_source():
    src = CU.read_text()
    assert int(re.search(r"constexpr int kTileRows = (\d+);", src).group(1)) == R.TILE_ROWS
    assert int(re.search(r"constexpr int kBlockRows = (\d+);", src).group(1)) == R.RAGGED_BLOCK
    assert int(re.search(r"constexpr int kMaxGroup = (\d+);", src).group(1)) == R._MAX_GROUP
    assert int(re.search(r"constexpr int kBlockK = (\d+);", src).group(1)) == R.BLOCK_K
    stages = {
        int(d): int(st)
        for d, st in re.findall(r"struct Stages<(\d+)> \{ static constexpr int kStages = (\d+); \}", src)
    }
    assert stages == R.STAGES
    assert "const int bpc = kTileRows / group / kBlockRows;" in src  # tokens_per_cta's rule


@pytest.mark.parametrize("group", range(1, 9))
def test_tokens_per_cta(group):
    n = R.tokens_per_cta(group)
    assert n == {1: 128, 2: 64, 3: 40, 4: 32, 5: 24, 6: 16, 7: 16, 8: 16}[group]
    assert n % R.RAGGED_BLOCK == 0 and n * group <= R.TILE_ROWS
    assert (n + R.RAGGED_BLOCK) * group > R.TILE_ROWS  # the most whole blocks that fit


@pytest.mark.parametrize("tokens,kv_heads", [(8, 8), (72, 8), (256, 8), (256, 4), (4096, 2)])
def test_grid_is_sized_from_tokens_alone(tokens, kv_heads):
    """One CTA per (8-row block, KV head): no device read sizes it."""
    assert R.grid(tokens, kv_heads) == (tokens // R.RAGGED_BLOCK, kv_heads)
    q = torch.empty((tokens, 4 * kv_heads, 128), dtype=bf16, device="meta")
    pool = torch.empty((9, 16, kv_heads, 128), dtype=bf16, device="meta")
    plan = R.launch_plan(q, pool)
    assert plan[4:7] == [tokens // 8, kv_heads, 32]


@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_shared_memory_fits_a_block(head_dim):
    stages = R.STAGES[head_dim]
    assert stages >= 2  # a ring: one stage loads while another is read
    assert all(R.BLOCK_K % ps == 0 for ps in R.PAGE_SIZES)  # a key tile is whole pages
    assert R.smem_bytes(head_dim) <= R.SMEM_LIMIT
    tiles = 2 * head_dim * (R.TILE_ROWS + 2 * stages * R.BLOCK_K)  # Q, then K and V stages
    assert R.smem_bytes(head_dim) == 1024 + tiles + 8 * 3 * stages
    q = torch.empty((16, 8, head_dim), dtype=bf16, device="meta")
    pool = torch.empty((3, 16, 2, head_dim), dtype=bf16, device="meta")
    assert R.launch_plan(q, pool)[:4] == [R.TILE_ROWS, R.BLOCK_K, stages, R.smem_bytes(head_dim)]


@pytest.mark.parametrize("page_size", [8, 16])
def test_pool_tensor_map(page_size):
    pool = torch.empty((100, page_size, 8, 128), dtype=bf16, device="meta")
    assert R.pool_tensor_map("k", pool) == [
        128, 8, page_size, 100,  # dims, innermost first
        128 * 2, 8 * 128 * 2, page_size * 8 * 128 * 2,  # byte strides of kv_heads, rows, pages
        64, 1, page_size, 1,  # box: one page of one KV head, 64 columns
    ]


@pytest.mark.parametrize("tp", [2, 4])
def test_pool_tensor_map_of_a_rank_slice(tp):
    """A rank's KV-head slice of a wider pool is read through the pool's
    strides, from the slice's own base."""
    pool = torch.empty((50, 16, 8, 128), dtype=bf16)
    kvh = 8 // tp
    for r in range(tp):
        view = pool[:, :, r * kvh : (r + 1) * kvh]
        assert not view.is_contiguous()
        assert R.pool_tensor_map("k", view) == [128, kvh, 16, 50, 256, 8 * 256, 16 * 8 * 256, 64, 1, 16, 1]
        assert view.data_ptr() - pool.data_ptr() == r * kvh * 128 * 2
        assert view.data_ptr() % 16 == 0


def test_pool_tensor_map_refuses_what_tma_cannot_read():
    pool = torch.empty((4, 16, 2, 68), dtype=bf16)
    with pytest.raises(ValueError, match="multiple of 16"):
        R.pool_tensor_map("k", pool[:, :, :, :64])  # KV heads 136 bytes apart
    with pytest.raises(ValueError, match="16-byte boundary"):
        R.pool_tensor_map("k", pool.view(-1)[1:1 + 4 * 16 * 2 * 64].view(4, 16, 2, 64))
    with pytest.raises(ValueError, match="contiguous in head_dim"):
        R.pool_tensor_map("k", torch.empty((4, 16, 64, 2), dtype=bf16).transpose(2, 3))


def _layout_args(tokens=16, heads=8, kv_heads=2, head_dim=128, page_size=16):
    q = torch.empty((tokens, heads, head_dim), dtype=bf16, device="meta")
    pool = torch.empty((5, page_size, kv_heads, head_dim), dtype=bf16, device="meta")
    table = torch.empty((2, 4), dtype=torch.int32, device="meta")
    meta = torch.empty((tokens,), dtype=torch.int32, device="meta")
    return q, pool, pool, table, meta, meta


@pytest.mark.parametrize("page_size,head_dim,heads,match", [
    (4, 128, 8, "page_size"), (12, 128, 8, "page_size"), (128, 128, 8, "page_size"),
    (16, 96, 8, "head_dim"), (16, 128, 18, "group"),
])
def test_plan_refuses_what_the_kernel_does_not_take(page_size, head_dim, heads, match):
    args = _layout_args(heads=heads, head_dim=head_dim, page_size=page_size)
    with pytest.raises(ValueError, match=match):
        R._plan_array(("refused", page_size, head_dim, heads), *args)


def test_plan_is_cached_per_layout():
    args = _layout_args()
    a = R._plan_array(("cached",), *args)
    assert R._plan_array(("cached",), *args) is a
    assert list(a) == R.launch_plan(args[0], args[1])


def test_a_reallocated_pool_gets_a_new_map(monkeypatch):
    """Maps are keyed by base pointer and layout: a pool re-allocated at
    another address with the same shape (a level-1 wake) is encoded anew;
    the same pool again is served from the cache."""
    encoded = []
    monkeypatch.setattr(R, "_maps", {})
    monkeypatch.setattr(R, "_encode", lambda k, v, plan: encoded.append((k.data_ptr(), v.data_ptr())) or object())
    first = [torch.zeros((6, 16, 2, 64), dtype=bf16) for _ in range(2)]
    woken = [torch.zeros((6, 16, 2, 64), dtype=bf16) for _ in range(2)]
    plan = None
    a = R.pool_maps(*first, plan)
    assert R.pool_maps(*first, plan) is a
    b = R.pool_maps(*woken, plan)
    assert b is not a
    assert encoded == [(first[0].data_ptr(), first[1].data_ptr()), (woken[0].data_ptr(), woken[1].data_ptr())]
    # one tensor object given new storage, as engine/sleep.py's wake does
    k = first[0]
    k.data = torch.zeros_like(k)
    c = R.pool_maps(k, first[1], plan)
    assert c is not a and len(encoded) == 3
    # a KV-head slice of the same storage is another map
    R.pool_maps(woken[0][:, :, 1:], woken[1][:, :, 1:], plan)
    assert len(encoded) == 4


# -- the decomposition ------------------------------------------------------


def _pack(segments, rows):
    """The engine's packing layout: (slot, first position, tokens) runs,
    each from an 8-row boundary; the rest padding."""
    slot = np.full(rows, -1, np.int32)
    pos = np.zeros(rows, np.int32)
    r = 0
    for s, p0, n in segments:
        slot[r : r + n] = s
        pos[r : r + n] = np.arange(p0, p0 + n)
        r += -(-n // 8) * 8
    assert r <= rows
    return slot, pos


def _case(segments, rows, heads, kv_heads, head_dim, page_size, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    nseq = max([s for s, _, _ in segments], default=0) + 1
    width = max([-(-(p0 + n) // page_size) for _, p0, n in segments], default=1)
    num_pages = nseq * width + 1
    table = (rng.permutation(num_pages - 1) + 1).astype(np.int32).reshape(nseq, width)
    wide = np.concatenate([table, np.zeros((nseq, 3), np.int32)], axis=1)  # sliced as the engine does
    slot, pos = _pack(segments, rows)
    q = rng.standard_normal((rows, heads, head_dim)).astype(dtype)
    kp = rng.standard_normal((num_pages, page_size, kv_heads, head_dim)).astype(dtype)
    vp = rng.standard_normal((num_pages, page_size, kv_heads, head_dim)).astype(dtype)
    t = torch.from_numpy
    return t(q), t(kp), t(vp), t(wide)[:, :width], t(slot), t(pos)


def emulate(q, k_pages, v_pages, page_table, row_slot, positions, block_k=R.BLOCK_K):
    """The kernel's arithmetic in float32, CTA by CTA as ``work_items``
    splits the buffer: each tile of one run and one KV head walks its
    sequence's cache positions ``[0, pos0 + ntok)`` in key tiles through
    the page table (pages past the last needed one read as zeros), with the
    kernel's online softmax (scores scaled by head_dim**-0.5, hidden keys
    at NEG_INF, masks only on tiles holding a key past pos0,
    ``l * alpha + sum`` and ``o * alpha + P V``). Rows that no CTA writes
    stay NaN."""
    t, h, d = q.shape
    num_pages, ps, kvh, _ = k_pages.shape
    g = h // kvh
    out = torch.full((t, h, d), float("nan"))
    for b, end, slot, pos0, ntok in R.work_items(row_slot, positions, g):
        t0, tile_tok = b * R.RAGGED_BLOCK, (end - b) * R.RAGGED_BLOCK
        for kh in range(kvh):
            heads = slice(kh * g, (kh + 1) * g)
            out[t0 : t0 + tile_tok, heads] = 0.0  # padded rows of the tile, or a padded block
            if slot < 0:
                continue
            pt = page_table[min(slot, page_table.shape[0] - 1)].long()
            rows = q[t0 : t0 + ntok, heads].float().reshape(ntok * g, d)
            qpos = pos0 + torch.arange(ntok * g) // g
            nkeys = pos0 + ntok
            npages = -(-nkeys // ps)
            m = torch.full((ntok * g,), R.NEG_INF)
            l = torch.zeros(ntok * g)
            o = torch.zeros(ntok * g, d)
            for k0 in range(0, nkeys, block_k):
                keys = torch.arange(k0, k0 + block_k)
                page = keys // ps
                loaded = page < npages
                ids = pt[page.clamp(max=npages - 1)]
                kk = torch.where(loaded[:, None], k_pages[ids, keys % ps, kh].float(), 0.0)
                vv = torch.where(loaded[:, None], v_pages[ids, keys % ps, kh].float(), 0.0)
                x = (rows @ kk.T) * d**-0.5
                if k0 + block_k - 1 > pos0:
                    x = x.masked_fill(keys[None, :] > qpos[:, None], R.NEG_INF)
                m_new = torch.maximum(m, x.amax(1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(x - m_new[:, None])
                l = l * alpha + p.sum(1)
                o = o * alpha[:, None] + p @ vv
                m = m_new
            out[t0 : t0 + ntok, heads] = (o / l[:, None]).reshape(ntok, g, d)
    return out


DECODES = [(1, 20, 1), (2, 300, 1), (3, 150, 1)]
CASES = {
    # a 70-token run over three CTAs at group 4 (32 tokens each), after decode rows
    "run_over_ctas": (DECODES + [(0, 40, 70)], 104, 8, 2, 32, 16),
    # six decode blocks of six sequences inside one CTA's 32-token window
    "decodes_in_one_window": ([(s, 3 * s + 1, 1) for s in range(6)] + [(6, 0, 9)], 72, 8, 2, 32, 16),
    # a run that ends mid-block, then padding to the end of the buffer
    "padded_tail": ([(0, 5, 13), (1, 0, 3)], 64, 8, 2, 32, 16),
    "fully_padded": ([], 32, 8, 2, 32, 16),
    # page size 8: a 64-key tile spans 8 pages; pages past the run read zeros
    "page_size_8": (DECODES + [(0, 61, 30)], 64, 8, 2, 32, 8),
    # group 1 (128 tokens a CTA) and group 8 (16): a run of 150 tokens
    "group_1": ([(0, 10, 150), (1, 7, 1)], 168, 4, 4, 32, 16),
    "group_8": ([(0, 10, 150), (1, 7, 1)], 168, 16, 2, 32, 16),
    # the same sequence in two runs that do not continue each other
    "two_runs_of_one_slot": ([(0, 0, 8), (0, 100, 5)], 24, 8, 2, 32, 16),
}


# the kernel's key tile, and one twice as long: the split does not depend on it
@pytest.mark.parametrize("block_k", [R.BLOCK_K, 2 * R.BLOCK_K])
@pytest.mark.parametrize("name", sorted(CASES))
def test_decomposition_matches_the_plain_version(name, block_k):
    segments, rows, h, kvh, d, ps = CASES[name]
    args = _case(segments, rows, h, kvh, d, ps)
    got = emulate(*args, block_k=block_k)
    assert not torch.isnan(got).any()  # every row written exactly by some CTA
    want = R.ragged_paged_attention_plain(*args)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_work_items_cover_every_row_once(name):
    segments, rows, h, kvh, d, ps = CASES[name]
    slot, pos = (torch.from_numpy(a) for a in _pack(segments, rows))
    g = h // kvh
    seen = np.zeros(rows, np.int32)
    for b, end, s, pos0, ntok in R.work_items(slot, pos, g):
        t0 = b * R.RAGGED_BLOCK
        assert 0 < end - b <= R.tokens_per_cta(g) // R.RAGGED_BLOCK
        seen[t0 : end * R.RAGGED_BLOCK] += 1
        if s < 0:
            assert (slot[t0 : t0 + 8] < 0).all()
            continue
        assert (slot[t0 : t0 + ntok] == s).all() and (slot[t0 + ntok : end * 8] < 0).all()
        assert torch.equal(pos[t0 : t0 + ntok], torch.arange(pos0, pos0 + ntok, dtype=torch.int32))
    assert (seen == 1).all()


def test_work_items_cut_runs_from_their_first_block():
    slot, pos = (torch.from_numpy(a) for a in _pack(CASES["run_over_ctas"][0], 104))
    assert R.work_items(slot, pos, 4) == [
        (0, 1, 1, 20, 1), (1, 2, 2, 300, 1), (2, 3, 3, 150, 1),  # three decode rows, a CTA each
        (3, 7, 0, 40, 32), (7, 11, 0, 72, 32), (11, 12, 0, 104, 6),  # 70 tokens: 32 + 32 + 6
        (12, 13, -1, 0, 0),  # the padded block at the end
    ]
    # group 8: 16 tokens a CTA
    assert [w[4] for w in R.work_items(slot, pos, 8) if w[2] == 0] == [16, 16, 16, 16, 6]


@pytest.mark.parametrize("tp", [2, 4])
def test_decomposition_does_not_depend_on_the_heads_in_a_launch(tp):
    """The sharded op launches the kernel per rank over a head slice; the
    tiles, and so every row's arithmetic, are the same: bit-equal."""
    segments, rows, h, kvh, d, ps = CASES["run_over_ctas"]
    q, kp, vp, pt, slot, pos = _case(segments, rows, 16, 4, d, ps)
    whole = emulate(q, kp, vp, pt, slot, pos)
    hs, ks = 16 // tp, 4 // tp
    parts = [emulate(q[:, r * hs : (r + 1) * hs], kp[:, :, r * ks : (r + 1) * ks], vp[:, :, r * ks : (r + 1) * ks],
                     pt, slot, pos) for r in range(tp)]
    assert torch.equal(torch.cat(parts, dim=1), whole)


def test_decomposition_matches_the_pallas_kernel():
    if not pallas_interpret_supported():
        pytest.skip("this jaxlib cannot run Pallas interpret mode on CPU")
    segments, rows, h, kvh, d, ps = (DECODES[:2] + [(0, 3, 21)], 48, 8, 2, 16, 8)
    q, kp, vp, pt, slot, pos = _case(segments, rows, h, kvh, d, ps, seed=3)
    want = ragged_paged_attention_pallas(
        *(jnp.asarray(x.numpy()) for x in (q, kp, vp, pt.contiguous(), slot, pos)),
        block_rows=R.RAGGED_BLOCK, interpret=True,
    )
    got = emulate(q, kp, vp, pt, slot, pos)
    valid = slot.numpy() >= 0
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=TOL, rtol=TOL)
    assert (got.numpy()[~valid] == 0).all()

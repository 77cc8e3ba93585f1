"""The prefill kernel's host-side plan, on the CPU (no card needed).

``ops/cuda/prefill.py`` states in plain Python what the launch of
``csrc/prefill.cu`` does: tile sizes per head_dim, shared memory, the
grid and its issue order, which key tiles a query tile skips, masks or
takes whole, and the TMA tensor maps of the views it is handed. These
tests hold that statement to the kernel source and to the plain
version's mask. Views are ``meta`` tensors: only shapes, strides and
offsets matter.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu_torch.ops.cuda import prefill as P

CU = Path(P.__file__).resolve().parents[2] / "csrc" / "prefill.cu"
bf16 = torch.bfloat16


def test_tiles_match_the_kernel_source():
    src = CU.read_text()
    assert int(re.search(r"constexpr int kBlockQ = (\d+);", src).group(1)) == P.BLOCK_Q
    found = {
        int(d): (int(bk), int(st))
        for d, bk, st in re.findall(
            r"struct Tiles<(\d+)> \{ static constexpr int kBlockK = (\d+), kStages = (\d+); \}", src
        )
    }
    assert found == P.TILES


def test_key_tile_rule_is_stated_from_the_kernel():
    """The statements key_tile_kinds restates, at the lines it cites."""
    lines = CU.read_text().splitlines()
    for line, stmt in (
        (175, "const int last_key = min(min(q0 + kBlockQ - 1, seq - 1), sl - 1);"),
        (176, "const int n_kt = last_key / BK + 1;"),
        (198, "for (int kt = 0; kt < n_kt; ++kt) {"),
        (235, "for (int kt = 0; kt < n_kt; ++kt) {"),
        (107, "const bool full = k0 + BK - 1 <= q0 && k0 + BK <= sl;"),
    ):
        assert lines[line - 1].strip() == stmt
        assert str(line) in P.key_tile_kinds.__doc__


@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_shared_memory_fits_a_block(head_dim):
    block_k, stages = P.TILES[head_dim]
    assert stages >= 2  # a ring: one stage loads while another is read
    assert P.smem_bytes(head_dim) <= P.SMEM_LIMIT
    # Q plus the K and V stages, 1 KB of alignment slack, the barriers
    tiles = 2 * head_dim * (P.BLOCK_Q + 2 * stages * block_k)
    assert P.smem_bytes(head_dim) == 1024 + tiles + 8 * (1 + 3 * stages)


def test_head_dim_128_budget_is_the_designed_one():
    # Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB
    assert P.smem_bytes(128) - 1024 - 8 * 7 == 160 * 1024


@pytest.mark.parametrize(
    "seq,heads,batch", [(16, 4, 1), (200, 3, 3), (3000, 8, 2), (4096, 32, 1)]
)
def test_grid_covers_every_tile_once_heaviest_first(seq, heads, batch):
    n = P.grid_size(seq, heads, batch)
    coords = [P.block_coords(i, seq, heads, batch) for i in range(n)]
    n_qt = -(-seq // P.BLOCK_Q)
    want = {(t, h, b) for t in range(n_qt) for h in range(heads) for b in range(batch)}
    assert len(coords) == len(set(coords)) and set(coords) == want
    tiles = [c[0] for c in coords]
    # issued in index order: the last query tile (most keys) first
    assert tiles == sorted(tiles, reverse=True)
    assert tiles[0] == n_qt - 1 and tiles[-1] == 0


@pytest.mark.parametrize("head_dim", [64, 128, 256])
@pytest.mark.parametrize("s", [16, 32, 48, 512, 3000, 4096])
@pytest.mark.parametrize("which", ["one", "s-3", "s"])
def test_key_tile_rule_agrees_with_the_plain_mask(head_dim, s, which):
    """No allowed (row, key) pair lies in a skipped tile, and no masked
    pair in a tile marked full; the diagonal tile is always masked."""
    sl = {"one": 1, "s-3": s - 3, "s": s}[which]
    allowed = P.allowed_keys(s, torch.tensor([sl])).numpy()[0]
    block_k = P.TILES[head_dim][0]
    for qt in range(-(-s // P.BLOCK_Q)):
        kinds = P.key_tile_kinds(qt, s, sl, head_dim)
        assert len(kinds) == -(-s // block_k)
        rows = slice(qt * P.BLOCK_Q, min((qt + 1) * P.BLOCK_Q, s))
        for kt, kind in enumerate(kinds):
            part = allowed[rows, kt * block_k : min((kt + 1) * block_k, s)]
            if kind == "skipped":
                assert not part.any(), (qt, kt)
            elif kind == "full":
                assert part.all(), (qt, kt)
                assert (kt + 1) * block_k <= s  # no key past s read unmasked
        # key 0 is visible to every row, so the first tile is always loaded
        assert kinds[0] != "skipped"
        # loaded tiles are a prefix: the kernel loops kt < n_kt
        loaded = [k != "skipped" for k in kinds]
        assert loaded == sorted(loaded, reverse=True)


def test_key_tile_rule_loads_what_is_needed():
    # the last query tile at s = 4096 (d 128) loads every key tile; the
    # first loads one; a one-token prompt loads one tile per query tile
    assert P.key_tile_kinds(31, 4096, 4096, 128) == ["full"] * 31 + ["masked"]
    assert P.key_tile_kinds(0, 4096, 4096, 128) == ["masked"] + ["skipped"] * 31
    assert P.key_tile_kinds(20, 4096, 1, 128) == ["masked"] + ["skipped"] * 31
    # a bucket clamped to a length that is not a power of two
    kinds = P.key_tile_kinds(23, 3000, 2999, 128)
    assert kinds.count("skipped") == 0 and kinds[-1] == "masked"


def _meta(*shape):
    return torch.empty(shape, dtype=bf16, device="meta")


def test_tensor_map_of_contiguous_views():
    b, s, h, kvh, d = 2, 300, 32, 8, 128
    q, k = _meta(b, s, h, d), _meta(b, s, kvh, d)
    assert P.tensor_map("q", q, 128) == [d, s, h, b, h * d * 2, d * 2, s * h * d * 2, 64, 128, 1, 1]
    assert P.tensor_map("k", k, 64) == [d, s, kvh, b, kvh * d * 2, d * 2, s * kvh * d * 2, 64, 64, 1, 1]
    out = _meta(b, s, h, d)
    plan = P.launch_plan(q, k, k, out)
    assert len(plan) == 41
    assert plan[:5] == [128, 128, 2, P.smem_bytes(128), P.grid_size(s, h, b)]
    assert plan[38:] == list(out.stride()[:3])


def test_tensor_map_takes_aligned_strided_views():
    # a head slice of a wider projection: strides are not the dense ones
    # but are 16-byte multiples, so TMA reads it in place
    wide = _meta(1, 64, 12, 128)
    q = wide[:, :, 4:8]
    dims = P.tensor_map("q", q, 128)
    assert dims[:4] == [128, 64, 4, 1]
    assert dims[4:7] == [12 * 128 * 2, 128 * 2, 64 * 4 * 128 * 2]  # batch of 1: dense stride
    # a size-1 dim's stride is never used: an odd one is not refused
    one = _meta(1, 1, 2, 64).as_strided((1, 1, 2, 64), (7, 3, 64, 1))
    assert P.tensor_map("k", one, 64)[4:7] == [2 * 64 * 2, 64 * 2, 2 * 64 * 2]


@pytest.mark.parametrize(
    "view,match",
    [
        (lambda: _meta(2 * 16 * 4 * 64 + 1)[1:].view(2, 16, 4, 64), "16-byte boundary"),
        (lambda: _meta(2 * 16 * 4 * 64 + 8)[8:].view(2, 16, 4, 64)[:, :, :, :], None),
        (lambda: _meta(2, 16, 4, 65)[..., :64], "multiple of 16"),
        (lambda: _meta(2 * 17 * 256).as_strided((2, 16, 4, 64), (17 * 256, 256, 64, 1), 3), "16-byte boundary"),
        (lambda: _meta(2, 16, 64, 4).transpose(2, 3), "contiguous in head_dim"),
        (lambda: _meta(10000).as_strided((2, 16, 3, 64), (16 * 196, 196, 64, 1)), "multiple of 16"),
    ],
    ids=["base+2B", "base+16B-ok", "row-stride-130B", "offset-6B", "transposed", "seq-stride-392B"],
)
def test_misaligned_views_are_refused(view, match):
    t = view()
    if match is None:
        P.tensor_map("q", t, 128)  # 16-byte-aligned offset: accepted
        return
    with pytest.raises(ValueError, match=match):
        P.tensor_map("q", t, 128)
    q = _meta(*t.shape)
    with pytest.raises(ValueError, match=match):
        P.launch_plan(q, t, t, q)


def test_plan_is_cached_by_layout_and_bases_checked_every_call():
    q, k = _meta(1, 512, 32, 128), _meta(1, 512, 8, 128)
    first = P._plan_array(q, k, k, q)
    assert list(first) == P.launch_plan(q, k, k, q)
    # another tensor of the same layout reuses the plan: it holds no pointer
    assert P._plan_array(_meta(1, 512, 32, 128), k, k, q) is first
    # a base off by 2 bytes in a cached layout is still refused
    shifted = _meta(1 + 512 * 8 * 128)[1:].view(1, 512, 8, 128)
    with pytest.raises(ValueError, match="16-byte boundary"):
        P._plan_array(q, shifted, k, q)
    # a new layout gets its own plan
    assert P._plan_array(_meta(1, 256, 32, 128), _meta(1, 256, 8, 128), _meta(1, 256, 8, 128), q) is not first


def test_plain_version_uses_the_stated_mask():
    rng = np.random.default_rng(5)
    b, s, h, kvh, d = 2, 40, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    lens = torch.tensor([40, 7], dtype=torch.int32)
    out = P.causal_prefill_attention_plain(q, k, v, lens)
    allowed = P.allowed_keys(s, lens)
    kf = k.repeat_interleave(2, dim=2)
    vf = v.repeat_interleave(2, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * d**-0.5, kf)
    logits = logits.masked_fill(~allowed[:, None], float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), vf)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)

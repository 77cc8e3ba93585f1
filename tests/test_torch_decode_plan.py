"""The paged-decode kernel's host-side plan and its work decomposition, on the CPU.

``ops/cuda/decode.py`` states in plain Python how ``csrc/decode.cu`` cuts
a launch: 32-token tiles, ``nsplit = 16 / group`` splits of interleaved
tiles per (sequence, KV head), one CTA per split (two at group 1) in a
cluster of at most 8, a ring of K/V stages filled by producer warps
through page-table chunks, and the splits merged in order. These tests
hold that statement to the kernel source, and hold an emulation of the
kernel's arithmetic, CTA by CTA and step by step as its producer fills
the ring (rows it did not fill in a stage are NaN), to the plain versions
and to the JAX Pallas kernels in interpret mode, for both variants.
Tolerance of the emulation: float32, 1e-5 absolute and relative (online
softmaxes over 32-token tiles, merged over splits, against one softmax
over the whole context).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.ops.pallas import (
    paged_decode_attention_inline_pallas,
    paged_decode_attention_pallas,
)
from llm_d_fast_model_actuation_tpu.utils.compat import pallas_interpret_supported
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import decode as D
from llm_d_fast_model_actuation_tpu_torch.ops.cuda.ragged import SMEM_LIMIT

CU = Path(D.__file__).resolve().parents[2] / "csrc" / "decode.cu"
TOL = 1e-5


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_sizes_match_the_kernel_source():
    src = CU.read_text()
    assert _const(src, "kTile") == D.TILE
    assert _const(src, "kMaxWarps") == D.MAX_WARPS
    assert _const(src, "kMaxCluster") == D.MAX_CLUSTER
    assert _const(src, "kTableChunk") == D.TABLE_CHUNK
    assert _const(src, "kProducers") == D.PRODUCERS
    ring = {int(d): int(n) for d, n in re.findall(r"struct Ring<(\d+)> \{ static constexpr int kTiles = (\d+); \}", src)}
    assert ring == D.RING_TILES
    # the plan's rules, as the kernel states them
    for line in (
        "p.nsplit = kMaxWarps / group;",
        "p.cluster = p.nsplit < kMaxCluster ? p.nsplit : kMaxCluster;",
        "p.spc = p.nsplit / p.cluster;",
        "p.stages = Ring<HEAD_DIM>::kTiles / p.spc;",
        "p.warps = group * p.spc;",
        "p.smem = p.stages * 2 * p.spc * kTile * HEAD_DIM * 2",
        "+ p.warps * (2 + HEAD_DIM) * 4",
        "+ kProducers * kTableChunk * 4",
        "+ 2 * p.stages * 8;",
        "cfg.gridDim = dim3(p.cluster, num_kv_heads, batch);",
        "cfg.blockDim = dim3(32 * (p.warps + kProducers));",
        "mbar_init(full0 + 8 * st, 32 * kProducers);",  # every producer lane's copies land
        "attr[0].val.clusterDim.x = p.cluster;",
    ):
        assert line in src, line


@pytest.mark.parametrize("group", range(1, 17))
def test_splits_and_clusters(group):
    ns, c, spc = D.nsplit(group), D.cluster_size(group), D.splits_per_cta(group)
    assert ns == 16 // group and ns * group <= D.MAX_WARPS  # the parent's warps
    assert c * spc == ns and 1 <= c <= D.MAX_CLUSTER  # every split in one portable cluster
    assert spc == (2 if group == 1 else 1)
    plan = D.launch_plan(8, 8, 128, group)
    assert plan["grid"] == (c, 8, 8)
    assert plan["threads"] == 32 * (group * spc + D.PRODUCERS) <= 32 * (D.MAX_WARPS + D.PRODUCERS)


@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_shared_memory_fits_a_block(head_dim):
    for group in range(1, 17):
        st = D.stages(head_dim, group)
        assert st >= 2  # a ring: one stage fills while another is read
        assert D.smem_bytes(head_dim, group) <= SMEM_LIMIT
    # chip_smoke.py's shape, Llama-3-8B at group 4: two CTAs fit an SM
    assert 2 * D.smem_bytes(128, 4) <= SMEM_LIMIT
    assert D.launch_plan(8, 8, 128, 4)["grid"] == (4, 8, 8)  # 256 CTAs, where there were 64


# -- the decomposition ------------------------------------------------------


def emulate(q, k_pages, v_pages, page_table, lens, k_new=None, v_new=None, table_chunk=D.TABLE_CHUNK):
    """The kernel's arithmetic in float32, as its launch cuts the work:
    for each (sequence, KV head), each CTA of the cluster runs its steps;
    the producer fills a step's stage with the K and V rows of the step's
    tokens, read through a chunk of the page table (reloaded from the
    step's first page when the step's last page is past the chunk), and
    leaves the stage's other rows as they were (NaN at first); consumer
    warp (ls, head) takes tile ``first + ls + k * nsplit`` of step k with
    the online softmax (q scaled by head_dim**-0.5, logits past the tile's
    valid tokens at NEG_INF, ``l * alpha + sum p``, ``acc * alpha``, then
    ``p V`` with a select). Split 0 merges the splits in order and folds
    the inline token (``k_new``) or divides by the sum."""
    b, h, d = q.shape
    num_pages, ps, kvh, _ = k_pages.shape
    g = h // kvh
    ns, ctas, spc, st = D.nsplit(g), D.cluster_size(g), D.splits_per_cta(g), D.stages(d, g)
    tile = D.TILE
    out = torch.full((b, h, d), float("nan"))
    for bi in range(b):
        pos = int(lens[bi])
        ntiles = -(-pos // tile)
        npages = -(-pos // ps)
        for kh in range(kvh):
            heads = slice(kh * g, (kh + 1) * g)
            qv = q[bi, heads].float() * d**-0.5
            state = {}  # split -> (m, l, acc) of the g heads
            for rank in range(ctas):
                first = rank * spc
                steps = -(-(ntiles - first) // ns) if ntiles > first else 0
                ring_k = torch.full((st, spc * tile, d), float("nan"))
                ring_v = torch.full((st, spc * tile, d), float("nan"))
                base, table = -1, None
                m = torch.full((spc, g), D.NEG_INF)
                l = torch.zeros(spc, g)
                acc = torch.zeros(spc, g, d)
                for k in range(steps):
                    s = k % st
                    t_first = (first + k * ns) * tile
                    t_end = min(pos, t_first + spc * tile)
                    if base < 0 or (t_end - 1) // ps >= base + table_chunk:
                        base = t_first // ps
                        table = page_table[bi, base : min(base + table_chunk, npages)].long()
                    for t in range(t_first, t_end):
                        page = table[t // ps - base]
                        ring_k[s, t - t_first] = k_pages[page, t % ps, kh].float()
                        ring_v[s, t - t_first] = v_pages[page, t % ps, kh].float()
                    for ls in range(spc):
                        it = first + ls + k * ns
                        if it >= ntiles:
                            continue
                        nt = min(tile, pos - it * tile)
                        valid = torch.arange(tile) < nt
                        kk = ring_k[s, ls * tile : (ls + 1) * tile]
                        vv = ring_v[s, ls * tile : (ls + 1) * tile]
                        x = torch.where(valid[None, :], qv @ torch.nan_to_num(kk).T, D.NEG_INF)
                        m_new = torch.maximum(m[ls], x.amax(1))
                        alpha = torch.exp(m[ls] - m_new)
                        p = torch.where(valid[None, :], torch.exp(x - m_new[:, None]), 0.0)
                        l[ls] = l[ls] * alpha + p.sum(1)
                        pv = torch.where(valid[None, :, None], p[:, :, None] * vv[None], 0.0).sum(1)
                        acc[ls] = acc[ls] * alpha[:, None] + pv
                        m[ls] = m_new
                for ls in range(spc):
                    state[first + ls] = (m[ls], l[ls], acc[ls])
            M = torch.full((g,), D.NEG_INF)
            for s2 in range(ns):
                M = torch.maximum(M, state[s2][0])
            L = torch.zeros(g)
            A = torch.zeros(g, d)
            for s2 in range(ns):
                w = torch.exp(state[s2][0] - M)
                L = L + state[s2][1] * w
                A = A + state[s2][2] * w[:, None]
            if k_new is None:
                out[bi, heads] = torch.where(L[:, None] > 0, A / L.clamp_min(1e-30)[:, None], 0.0)
            else:
                logit = qv @ k_new[bi, kh].float()
                m_new = torch.maximum(M, logit)
                alpha = torch.exp(M - m_new)
                p_self = torch.exp(logit - m_new)
                L = L * alpha + p_self
                out[bi, heads] = (A * alpha[:, None] + p_self[:, None] * v_new[bi, kh].float()) / L[:, None]
    return out


def _case(group, head_dim, page_size, lens, kv_heads=2, seed=0):
    """float32 inputs: q, the pools, the new token's K/V, a shuffled page
    table with a few spare columns, the lengths."""
    rng = np.random.default_rng(seed)
    b, h = len(lens), group * kv_heads
    pps = -(-max(lens) // page_size) + 2
    num_pages = b * pps + 1
    t = torch.from_numpy
    q = rng.standard_normal((b, h, head_dim)).astype(np.float32)
    kp = rng.standard_normal((num_pages, page_size, kv_heads, head_dim)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page_size, kv_heads, head_dim)).astype(np.float32)
    kn = rng.standard_normal((b, kv_heads, head_dim)).astype(np.float32)
    vn = rng.standard_normal((b, kv_heads, head_dim)).astype(np.float32)
    pt = (rng.permutation(num_pages - 1) + 1).astype(np.int32)[: b * pps].reshape(b, pps)
    return t(q), t(kp), t(vp), t(kn), t(vn), t(pt), t(np.array(lens, np.int32))


# lengths: none (inline: the new token alone; scatter-first: zeros), one
# token, a partial tile, and 21 tiles with a partial last one: at group 1
# (16 splits, two a CTA) some CTAs run two steps and the last step of
# one holds a tile of its first split only
LENS = [0, 1, 45, 670]


@pytest.mark.parametrize("variant", ["inline", "scatter_first"])
@pytest.mark.parametrize("page_size", [8, 12, 16])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 7, 8])
def test_decomposition_matches_plain_and_pallas(group, head_dim, page_size, variant):
    q, kp, vp, kn, vn, pt, lens = _case(group, head_dim, page_size, LENS)
    if variant == "inline":
        got = emulate(q, kp, vp, pt, lens, kn, vn)
        want = D.paged_decode_attention_inline_plain(q, kp, vp, kn, vn, pt, lens)
    else:
        got = emulate(q, kp, vp, pt, lens)
        want = D.paged_decode_attention_plain(q, kp, vp, pt, lens)
        assert (got[0] == 0).all()  # seq_len 0: zeros
    assert not torch.isnan(got).any()  # every head written by split 0; NaN rows masked out
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    if not pallas_interpret_supported():
        pytest.skip("this jaxlib cannot run Pallas interpret mode on CPU")
    j = [jnp.asarray(x.numpy()) for x in (q, kp, vp, kn, vn, pt, lens)]
    if variant == "inline":
        ref = paged_decode_attention_inline_pallas(*j, interpret=True)
    else:
        ref = paged_decode_attention_pallas(*j[:3], j[5], j[6], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("page_size", [8, 12])
@pytest.mark.parametrize("group", [1, 4])
def test_page_table_chunks_reload_without_changing_a_bit(group, page_size):
    """A chunk of 16 entries instead of 1024: the producer reloads the
    table every few steps; every row lands where it did, so the output is
    bit-equal."""
    args = _case(group, 64, page_size, [5, 700, 333], seed=1)
    q, kp, vp, kn, vn, pt, lens = args
    whole = emulate(q, kp, vp, pt, lens, kn, vn)
    assert torch.equal(emulate(q, kp, vp, pt, lens, kn, vn, table_chunk=16), whole)
    # the most pages one step spans fits a chunk of 16
    assert max(math.ceil((t + 64) / page_size) - t // page_size for t in range(0, 700, 32)) <= 16


def test_splits_per_cta_do_not_change_a_bit(monkeypatch):
    """The CTA that holds a split does not enter its arithmetic: group 2
    with one split a CTA (clusters of 8) and with two (clusters of 4) give
    the same bits."""
    q, kp, vp, kn, vn, pt, lens = _case(2, 64, 16, [700, 31, 64], seed=2)
    one = emulate(q, kp, vp, pt, lens, kn, vn)
    monkeypatch.setattr(D, "MAX_CLUSTER", 4)
    assert D.splits_per_cta(2) == 2 and D.cluster_size(2) == 4
    assert torch.equal(emulate(q, kp, vp, pt, lens, kn, vn), one)

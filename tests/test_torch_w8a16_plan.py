"""The W8A16 kernel's host-side plan and its tensor-core decomposition, on the CPU.

``ops/cuda/w8a16.py:launch_plan`` states how ``csrc/w8a16.cu`` cuts a
launch: CTAs of 4 warps over 128 output channels and one split of K, the
warps taking the split's k16 steps in turn, ``mb`` rows of x a pass in
n-tiles of 8, the splits of K summed in split order by a second pass.
These tests
hold that statement to the kernel source, and hold an emulation of the
kernel lane by lane to the plain version and to the JAX package's
``qmat`` and ``moe._qeinsum``: each lane's 16-byte loads of 4 q rows, the
int8 -> bf16 conversion by byte permutes, the bf16x2 registers it packs
into the A fragments of 8 ``mma.m16n8k16`` tiles, its 8-byte B fragment
of x, the PTX fragment layout that places those registers in the tiles,
the warps' sums added in warp order, the split partials summed in split
order, and the reference's epilogue. Tolerances: the emulation's f32
sums are exact on integer-valued inputs (every product counted once);
on random bf16 inputs the outputs are within one bf16 step (2^-7) of
the largest output of the plain version and of the reference, which
round a sum taken in another order.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.models import quant as jquant
from llm_d_fast_model_actuation_tpu.models.moe import _qeinsum
from llm_d_fast_model_actuation_tpu_torch.models import quant as tquant
from llm_d_fast_model_actuation_tpu_torch.ops.cuda import w8a16 as W

CU = Path(W.__file__).resolve().parents[2] / "csrc" / "w8a16.cu"
TOL = 2.0**-7


def _const(src, name):
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)


def test_sizes_match_the_kernel_source():
    src = CU.read_text()
    assert int(_const(src, "kWarps")) == W.WARPS
    assert int(_const(src, "kChans")) * 8 == W.TILE_N and _const(src, "kTileN") == "8 * kChans"
    assert int(_const(src, "kStepK")) == W.STEP_K
    assert _const(src, "kSplitK") == "kWarps * kStepK" and W.K_STEP == W.WARPS * W.STEP_K
    # rows a pass: n-tiles of 8, the largest the plan's MAX_MB
    cases = {int(mb): int(nt) for mb, nt in re.findall(r"case (\d+): err = launch<(\d+)>", src)}
    assert cases == {8: 1, 16: 2, 32: 4} and max(cases) == W.MAX_MB
    # CTAs an SM holds, by rows a pass: the kernel's launch bounds
    bounds = re.search(r"__launch_bounds__\(kThreads, NT == 1 \? (\d+) : NT == 2 \? (\d+) : (\d+)\)", src)
    assert {8: int(bounds[1]), 16: int(bounds[2]), 32: int(bounds[3])} == W.RESIDENT
    # the decomposition the emulation below follows, as the kernel states it
    for line in (
        "const int n = blockIdx.x * kTileN + g * kChans;",
        "const int k0 = k_begin + warp * kStepK + 4 * t;",
        "const size_t q_step = static_cast<size_t>(kWarps) * kStepK * N;",
        "const int mine = steps > warp ? (steps - warp + kWarps - 1) / kWarps : 0;",
        "wq[r] = cols_in ? ld_q(qp + i * q_step + static_cast<size_t>(r) * N)",
        "xr[nt] + static_cast<size_t>(i) * kSplitK",
        "const int m = m0 + 8 * nt + g;",
        "const uint32_t a[4] = {pack_hi(f[0][c], f[1][c]), pack_hi(f[0][c + 1], f[1][c + 1]),",
        "pack_hi(f[2][c], f[3][c]), pack_hi(f[2][c + 1], f[3][c + 1])};",
        "mma_bf16(acc + (nt * 8 + 2 * w + h) * 4, a, wx[nt]);",
        "for (int i = 0; i < kAcc; ++i) acc[i] += red[(v * kAcc + i) * 32 + lane];",
        "const int m = m0 + 8 * nt + 2 * t + rr;",
        "v[2 * j] = acc[(nt * 8 + j) * 4 + rr];",
        "v[2 * j + 1] = acc[(nt * 8 + j) * 4 + 2 + rr];",
        "for (int sp = 0; sp < splits; ++sp) {",
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
    ):
        assert line in src, line
    # no scalar FMA loop over the rows is left
    assert "fmaf" not in src


# -- the conversion -----------------------------------------------------------


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm (selector nibbles 0-7, no sign mode) on uint32 arrays."""
    both = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(x), np.uint64)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * b)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _i8x4_to_f32(words):
    """The kernel's i8x4_to_f32: [..., 4] float32 of each uint32 word's bytes."""
    u = words ^ np.uint32(0x80808080)
    f = [_byte_perm(u, np.uint32(0x4B000000), sel).view(np.float32) - np.float32(8388736.0)
         for sel in (0x7540, 0x7541, 0x7542, 0x7543)]
    return np.stack(f, -1).astype(np.float32)


def _pack_hi(lo, hi):
    """The kernel's pack_hi: the bf16x2 bits of two exact floats."""
    return _byte_perm(lo.view(np.uint32), hi.view(np.uint32), 0x7632)


def test_the_int8_to_bf16_conversion_is_exact_for_every_byte():
    v = np.arange(-128, 128, dtype=np.int8)
    words = v.view(np.uint8).astype(np.uint32).reshape(-1, 4)
    words = words[:, 0] | words[:, 1] << 8 | words[:, 2] << 16 | words[:, 3] << 24
    f = _i8x4_to_f32(words.astype(np.uint32)).reshape(-1)
    np.testing.assert_array_equal(f, v.astype(np.float32))
    # the high halves are the bf16 values, exactly
    packed = _pack_hi(f[0::2].copy(), f[1::2].copy())
    got = np.stack([packed & 0xFFFF, packed >> 16], -1).reshape(-1).astype(np.uint16)
    np.testing.assert_array_equal(got, v.astype(ml_dtypes.bfloat16).view(np.uint16))


# -- the fragments ------------------------------------------------------------

LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3


def _ptx_a(reg, half):
    """(row, col) of A element (reg, half) of every lane: PTX's m16n8k16 layout for .bf16."""
    return G + 8 * (reg & 1), 2 * T + half + 8 * (reg >> 1)


def _ptx_b(reg, half):
    """(row k, col n) of B element (reg, half)."""
    return 2 * T + half + 8 * reg, G


def _ptx_c(i):
    """(row, col) of accumulator i."""
    return G + 8 * (i >> 1), 2 * T + (i & 1)


def _kernel_a(j, reg, half):
    """(channel within the CTA's 128, k within the step) that the kernel
    puts in A element (reg, half) of mma tile j: the lane's 16-byte load of
    row 4t + 2 (reg >> 1) + half, channel 2j + (reg & 1) of its 16."""
    return G * 16 + 2 * j + (reg & 1), 4 * T + 2 * (reg >> 1) + half


def _kernel_b(reg, half):
    """(k within the step, row within the n-tile) of the lane's 8-byte x load."""
    return 4 * T + 2 * reg + half, G


def _kernel_c(j, i):
    """(channel within the CTA's 128, row within the n-tile) the epilogue writes accumulator i of tile j to."""
    return G * 16 + 2 * j + (i >> 1), 2 * T + (i & 1)


def test_every_tile_element_is_held_once_in_one_k_order():
    # A: each (row, col) of each tile once; a tile's row is one channel and
    # its col one k, the same k for every row (the order B uses)
    sigma, pi = {}, {}
    held = np.zeros((8, 16, 16), int)
    for j in range(8):
        for reg in range(4):
            for half in range(2):
                row, col = _ptx_a(reg, half)
                chan, k = _kernel_a(j, reg, half)
                np.add.at(held[j], (row, col), 1)
                for r, c, ch, kk in zip(row, col, chan, k):
                    assert sigma.setdefault((j, r), ch) == ch
                    assert pi.setdefault(c, kk) == kk
    assert (held == 1).all()
    assert sorted(pi.values()) == list(range(16))
    assert sorted(sigma.values()) == list(range(128))  # the 8 tiles cover the CTA's 128 channels once
    # B: the same k order, and column n is x row n
    heldb = np.zeros((16, 8), int)
    for reg in range(2):
        for half in range(2):
            k_log, n = _ptx_b(reg, half)
            k, row = _kernel_b(reg, half)
            np.add.at(heldb, (k_log, n), 1)
            assert all(pi[a] == b for a, b in zip(k_log, k)) and (row == n).all()
    assert (heldb == 1).all()
    # C: each accumulator goes to its tile row's channel and its column's x row
    for j in range(8):
        for i in range(4):
            row, col = _ptx_c(i)
            chan, xrow = _kernel_c(j, i)
            assert all(sigma[(j, r)] == ch for r, ch in zip(row, chan)) and (xrow == col).all()


# -- the emulation ------------------------------------------------------------


def _bf16_bits(a: torch.Tensor) -> np.ndarray:
    return a.contiguous().view(torch.int16).numpy().view(np.uint16).astype(np.uint32)


def _epilogue(acc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    a = acc.to(torch.bfloat16).float()
    return (a * scale.to(torch.bfloat16).float()).to(torch.bfloat16)


def _warp_sums(x, q, e, n0, k_begin, k_len, warp, m0, nt_count):
    """One warp's f32 sums [32 lanes, NT * 32] over its steps of a split,
    built from its lanes' registers as the kernel builds them."""
    K, N = q.shape[1:]
    M = x.shape[-2]
    qe = q[e].numpy()
    xe = _bf16_bits(x[e] if x.shape[0] > 1 else x[0])
    acc = torch.zeros(32, nt_count * 32)
    steps = k_len // W.STEP_K
    cols = n0 + G[:, None] * 16 + np.arange(16)  # [lane, 16]: the lane's channels
    cols_in = (n0 + G * 16 < N)[:, None, None]
    for step in range(warp, steps, W.WARPS):
        kb = k_begin + step * W.STEP_K
        rows = kb + 4 * T[:, None] + np.arange(4)  # [lane, 4]: the lane's q rows and x columns
        # the lane's loads: 4 q rows x 16 channels (zero out of range), as words
        loaded = np.where(cols_in, qe[rows[:, :, None], np.minimum(cols, N - 1)[:, None, :]], 0).astype(np.int8)
        wq = np.ascontiguousarray(loaded).view(np.uint32)  # [lane, row, word]
        f = _i8x4_to_f32(wq)  # [lane, row, word, byte]
        for nt in range(nt_count):
            xrow = m0 + 8 * nt + G
            # the lane's 4 bf16 of x, as in its 8-byte load (zero past M)
            bx = np.where((xrow < M)[:, None], xe[np.minimum(xrow, M - 1)[:, None], rows], 0).astype(np.uint32)
            b_regs = [bx[:, 0] | bx[:, 1] << 16, bx[:, 2] | bx[:, 3] << 16]
            B = torch.zeros(16, 8)
            for reg in range(2):
                for half in range(2):
                    k_log, n_log = _ptx_b(reg, half)
                    B[_t(k_log), _t(n_log)] = _bits_to_f32((b_regs[reg] >> (16 * half)) & 0xFFFF)
            for w in range(4):
                for h in range(2):
                    c, j = 2 * h, 2 * w + h
                    a_regs = [_pack_hi(f[:, 0, w, c].copy(), f[:, 1, w, c].copy()),
                              _pack_hi(f[:, 0, w, c + 1].copy(), f[:, 1, w, c + 1].copy()),
                              _pack_hi(f[:, 2, w, c].copy(), f[:, 3, w, c].copy()),
                              _pack_hi(f[:, 2, w, c + 1].copy(), f[:, 3, w, c + 1].copy())]
                    A = torch.zeros(16, 16)
                    for reg in range(4):
                        for half in range(2):
                            row, col = _ptx_a(reg, half)
                            A[_t(row), _t(col)] = _bits_to_f32((a_regs[reg] >> (16 * half)) & 0xFFFF)
                    C = A @ B  # exact products, an f32 sum
                    for i in range(4):
                        row, col = _ptx_c(i)
                        acc[:, (nt * 8 + j) * 4 + i] += C[_t(row), _t(col)]
    return acc


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _bits_to_f32(bits) -> torch.Tensor:
    return torch.from_numpy((np.asarray(bits, np.uint32) << 16).view(np.float32).copy())


def emulate(x, q, s, plan):
    """The kernel lane by lane: x [1 or E, M, K] bf16, q [E, K, N] int8, s
    [E, N] f32 -> (y [E, M, N] bf16, the f32 sums before the epilogue)."""
    mb, k_split, splits = plan
    nt_count = mb // 8
    E, K, N = q.shape
    M = x.shape[-2]
    part = torch.zeros(splits, E, M, N)
    for e in range(E):
        for bx in range(-(-N // W.TILE_N)):
            for by in range(splits):
                k_begin = by * k_split
                k_len = min(k_split, K - k_begin)
                for m0 in range(0, M, mb):
                    sums = [_warp_sums(x, q, e, bx * W.TILE_N, k_begin, k_len, warp, m0, nt_count)
                            for warp in range(W.WARPS)]
                    acc = sums[0]
                    for v in sums[1:]:  # warp 0 adds warps 1..3 in order
                        acc = acc + v
                    for nt in range(nt_count):
                        for j in range(8):
                            for i in range(4):
                                chan, xrow = _kernel_c(j, i)
                                n = bx * W.TILE_N + chan
                                m = m0 + 8 * nt + xrow
                                keep = (n < N) & (m < M)
                                part[by, e, _t(m[keep]), _t(n[keep])] = acc[_t(keep), (nt * 8 + j) * 4 + i]
    total = part[0]
    for sp in range(1, splits):  # the split order
        total = total + part[sp]
    return _epilogue(total, s[:, None, :]), total


def _inputs(rng, E, M, K, N, shared, integer=False):
    q = rng.integers(-127, 128, (E, K, N)).astype(np.int8)
    if integer:
        x = rng.integers(-8, 9, ((1 if shared else E), M, K)).astype(np.float32)
    else:
        x = rng.standard_normal(((1 if shared else E), M, K)).astype(np.float32)
    s = ((rng.random((E, N)) + 3.0) * (K**-0.5 / 127)).astype(np.float32)
    xb = x.astype(ml_dtypes.bfloat16)
    tx = torch.from_numpy(xb.view(np.int16).copy()).view(torch.bfloat16)
    return xb, tx, torch.from_numpy(q), torch.from_numpy(s)


@pytest.mark.parametrize("M", [1, 3, 8, 16])
@pytest.mark.parametrize("E,shared", [(1, True), (4, True), (4, False)], ids=["2d", "E4-one-x", "E4-x-per-expert"])
def test_the_emulation_matches_the_plain_version_and_the_reference(M, E, shared):
    rng = np.random.default_rng(M * 10 + E + shared)
    # 49 k16 steps (three splits, the last short), two column tiles (the
    # second of 16 channels)
    K, N = 784, 144
    xb, tx, tq, ts = _inputs(rng, E, M, K, N, shared)
    plan = W.launch_plan(M, K, N, E)
    assert plan[2] > 1 and K % plan[1]  # the reduction pass runs
    y, _ = emulate(tx, tq, ts, plan)
    xin = tx[0] if shared else tx
    if E == 1:
        plain = W.w8a16_matmul_plain(xin, tq[0], ts[0][None])[None]
        want = np.asarray(jquant.qmat(jnp.asarray(xb[0]), {"q": jnp.asarray(tq[0].numpy()),
                                                            "s": jnp.asarray(ts[0][None].numpy())}))[None]
    else:
        plain = W.w8a16_matmul_experts_plain(xin, tq, ts[:, None])
        spec = "mh,ehf->mef" if shared else "emh,ehf->mef"
        want = np.asarray(_qeinsum(spec, jnp.asarray(xb[0] if shared else xb),
                                   {"q": jnp.asarray(tq.numpy()), "s": jnp.asarray(ts[:, None].numpy())}))
        want = want.transpose(1, 0, 2)  # the reference is token major
    got = y.float().numpy()
    top = np.abs(plain.float().numpy()).max()
    assert np.abs(got - plain.float().numpy()).max() <= TOL * top
    assert np.abs(got - want.astype(np.float32)).max() <= TOL * top


@pytest.mark.parametrize("plan", [(8, 256, 1), (16, 64, 4), (8, 128, 2), (32, 192, 2)],
                         ids=["one-split", "single-steps", "two-splits", "32-rows"])
@pytest.mark.parametrize("M", [3, 17])
def test_every_product_is_summed_once(plan, M):
    """On integer-valued inputs every f32 sum is exact: the emulation's sums
    equal the product, whatever the plan (one split, splits of one step per
    warp, rows in several passes)."""
    rng = np.random.default_rng(7 + M)
    K, N = 256, 144
    _, tx, tq, ts = _inputs(rng, 2, M, K, N, shared=False, integer=True)
    y, sums = emulate(tx, tq, ts, plan)
    exact = torch.matmul(tx.double(), tq.double())
    assert torch.equal(sums.double(), exact)
    assert torch.equal(y, _epilogue(exact.float(), ts[:, None, :]))


# -- the plan and the routing -------------------------------------------------


@pytest.mark.parametrize("M", [1, 2, 5, 8])
def test_every_row_count_of_one_pass_takes_decodes_plan(M):
    """One row runs the 8-row plan (the CUDA-core kernel's took two long
    splits of 14336 at one row), and the CTAs cover the SMs where K
    allows it."""
    for K, N, E in ((14336, 4096, 1), (14336, 4096, 8), (4096, 1024, 1), (4096, 128256, 1)):
        mb, k_split, splits = W.launch_plan(M, K, N, E)
        assert (mb, k_split, splits) == W.launch_plan(8, K, N, E)
        tiles = -(-N // W.TILE_N) * E
        assert tiles * splits >= min(W.SMS, tiles * (K // W.MIN_SPLIT_K))


def test_qmat_and_qeinsum_launch_the_kernel_exactly_up_to_the_row_cap(monkeypatch):
    calls = []
    monkeypatch.setattr(tquant, "_on_card", lambda x: True)
    monkeypatch.setattr(tquant, "w8a16_matmul", lambda x, q, s: calls.append(("2d", x.shape)) or
                        W.w8a16_matmul_plain(x, q, s))
    monkeypatch.setattr(tquant, "w8a16_matmul_experts", lambda x, q, s: calls.append(("experts", x.shape)) or
                        W.w8a16_matmul_experts_plain(x, q, s))
    cap = tquant.W8A16_MAX_ROWS
    assert cap >= 16  # a speculative verify window
    K, N, E = 32, 16, 2
    w = {"q": torch.ones(K, N, dtype=torch.int8), "s": torch.ones(1, N)}
    we = {"q": torch.ones(E, K, N, dtype=torch.int8), "s": torch.ones(E, 1, N)}
    for rows in (1, cap, cap + 1):
        for lead in ((rows,), (1, rows)):
            calls.clear()
            tquant.qmat(torch.ones(*lead, K, dtype=torch.bfloat16), w)
            assert calls == ([("2d", (*lead, K))] if rows <= cap else [])
        for shape in ((rows, K), (E, rows, K)):
            calls.clear()
            tquant.qeinsum(torch.ones(*shape, dtype=torch.bfloat16), we)
            assert calls == ([("experts", shape)] if rows <= cap else [])
    # float32 never launches it
    calls.clear()
    tquant.qmat(torch.ones(2, K), w)
    assert calls == []

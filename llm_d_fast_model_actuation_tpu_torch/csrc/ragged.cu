// Ragged paged attention over a token-packed mixed batch, for Hopper
// (sm_90a): a TMA producer that gathers pages through the page table,
// warp-specialised wgmma consumers, softmax in registers.
//
// Replaces the TPU kernel
//   llm_d_fast_model_actuation_tpu/ops/pallas/ragged.py:_ragged_kernel
//   (ragged_paged_attention_pallas)
// and computes the same function. One flat [T] buffer holds rows of many
// sequences: prefill segments, suffix continuations and decode rows. Each
// row's K/V is already in the paged cache (scatter-first), and each row
// attends over its OWN sequence's cache entries at positions <= its own,
// read through the page table. The packing contract (ragged.py:15-24):
// a sequence's rows are one run of consecutive positions that starts on
// an 8-row block boundary, so every 8-row block holds at most one
// sequence, with its valid rows a prefix of the block. Padded rows and
// fully padded blocks get zeros.
//
// What bounds it on an H100. A long prefill segment is bound by
// operations (rows x context), a decode row by bytes (its whole context
// for one token). The Pallas kernel's grid walks the context once per
// 8-row block; on Hopper that re-reads the same pages for every block of
// a segment (17.6x the unique bytes at the packed serve's 256 rows). The
// design:
//
// - Work: one CTA per (tile of up to 128 query rows of ONE run, KV head).
//   Rows are flattened as (token, head of the KV head's group), so a tile
//   holds tokens_per_cta = floor(128 / group) tokens rounded down to whole
//   8-row blocks (32 at group 4). Runs are cut into such tiles from their
//   first block. The tile walks its sequence's positions [0, last valid
//   position] once, so every query head of the group, and every token of
//   the tile, shares each page read (GQA is never materialised).
// - No host sync: the grid is one CTA per (8-row block, KV head), sized
//   from T alone. Each CTA reads row_slot and positions on the device,
//   finds the run its block belongs to (a block continues the previous
//   block's run when that block's last row is the same sequence at the
//   position before), and goes on only if its block is the first of a
//   tile; the others exit at once, or write zeros for a fully padded
//   block. ops/cuda/ragged.py:work_items states the same rule. Nothing in
//   it depends on the number of heads in the launch, so the sharded op
//   (one launch per rank over its head slice) is bit-equal to this launch.
// - A producer warp (warpgroup 0, registers given up with setmaxnreg)
//   reads the tile's page ids from the page table through its row stride,
//   32 at a time (one per lane), and issues one TMA box per (page, 64
//   columns): page_size rows of one KV head, 128-byte swizzle, into a ring
//   of 64-key K and V stages on mbarriers (Stages below), so the next
//   tiles' pages are in flight while one is computed. Pages past the last
//   needed position are read out of bounds, which the TMA unit fills with
//   zeros.
// - Two consumer warpgroups of 64 rows each (csrc/prefill.cu's consumer,
//   its pieces in csrc/hopper.cuh): S = Q K^T by wgmma from shared memory, the
//   online softmax in registers, masking only on tiles that hold a key
//   past the tile's first position, P fed from registers into RS-form P V
//   wgmma products, O in registers and written once. Q is loaded by the
//   consumers themselves (its base moves every call, so it has no tensor
//   map), swizzled as TMA would, with zeros in rows past the run; a
//   consumer with no valid rows only keeps the ring turning.
//
// Arithmetic: bit for bit that of the kernel this one replaced (one
// block per 8-row block, mma.sync through WMMA), so the redesign moves
// no output bit and every parity figure downstream stays as it was. S in
// the tensor cores' k16 steps (wgmma's k16 step rounds as mma.sync's
// does); x = S * scale; expf; the row sum in that kernel's order; P as its
// bf16 rounding plus the bf16 rounding of the rest (~16 bits, two
// products); each tile's P V summed on its own and added as O * alpha +
// PV; O / l at the end. Rows of one tile that see fewer keys than its last
// row walk fully hidden tiles, which leave O, l and m exactly as they are.
// The faster arithmetic of csrc/prefill.cu (exp2, P rounded to bf16 once,
// 128-key tiles, O rescaled in place) was measured at 0.65x this kernel's
// time (PERF.md); it moves outputs in their last bits, and chip_smoke.py's
// two-rank against one-rank parity, whose 2e-2 limit lies at the mean of
// its spread over prompts, then failed on its prompt.
//
// On a tensor-parallel mesh the same kernel also replaces
//   ragged.py:ragged_paged_attention_pallas_sharded
// (the kernel under shard_map over the tp axis): ops/cuda/ragged.py
// launches it once per rank over the rank's heads and KV-head slice of the
// pool. The pool's tensor map reads a KV-head slice through its strides.
//
// Sizes (tile rows, key tile, stages per head_dim) are stated once more in
// ops/cuda/ragged.py (TILE_ROWS, BLOCK_K, STAGES), which also plans the
// grid and the pool's tensor map; the launch refuses a plan whose sizes
// differ from these.

#include <cuda.h>  // CUtensorMap and the encoder's types; nothing from libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockRows = 8;   // RAGGED_BLOCK: the packing's row block
constexpr int kTileRows = 128;  // query rows per CTA: two consumers of 64
constexpr int kBlockK = 64;     // cache positions per key tile
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kMaxDevices = 64;
constexpr int kMaxGroup = 8;

// Ring stages per head_dim: as deep as shared memory allows beside the
// 128-row Q tile, up to 4.
template <int HEAD_DIM> struct Stages;
template <> struct Stages<64> { static constexpr int kStages = 4; };
template <> struct Stages<128> { static constexpr int kStages = 4; };
template <> struct Stages<256> { static constexpr int kStages = 2; };

// Dynamic shared memory, from a 1024-byte-aligned base: Q (d / 64 chunks
// of [128][64] bf16), the K stages, the V stages (each d / 64 chunks of
// [64][64]), then the barriers: k_full, v_full and empty per stage.
template <int HEAD_DIM>
struct Smem {
  static constexpr int kStages = Stages<HEAD_DIM>::kStages;
  static constexpr int kChunks = HEAD_DIM / 64;
  static constexpr uint32_t kQ = kTileRows * HEAD_DIM * 2;
  static constexpr uint32_t kKV = kBlockK * HEAD_DIM * 2;  // one K or V stage
  static constexpr uint32_t kBarriers = 8 * 3 * kStages;
  static constexpr size_t kBytes = 1024 + kQ + 2 * kStages * kKV + kBarriers;
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

// One 64-key tile of the online softmax, in registers and in place, in the
// arithmetic of the kernel this one replaced (8-row blocks, WMMA), step for
// step, so that every output keeps its bits: x = S * scale; key k is
// visible to a row at position qpos when k <= qpos, and a hidden key
// scores kNegInf (rows outside the run have qpos = -1); alpha = expf(m -
// m_new), p = expf(x - m_new); the row sum adds the pairs of keys (2L,
// 2L + 1) in the order of a 32-lane xor butterfly over L (offsets 16, 8,
// 4 in this thread's registers, then 2 and 1 across the quad), and l =
// l * alpha + sum. Only a tile holding a key past pos0 (the tile's first
// position, the smallest of its rows') is masked; the others have no
// hidden key.
__device__ __forceinline__ float pair_butterfly(const float (&s)[32], int half) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = s[4 * j + 2 * half] + s[4 * j + 2 * half + 1];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = v[j] + v[j + 4];
#pragma unroll
  for (int j = 0; j < 2; ++j) v[j] = v[j] + v[j + 2];
  float y = v[0] + v[1];
  y += __shfl_xor_sync(0xffffffffu, y, 2);
  y += __shfl_xor_sync(0xffffffffu, y, 1);
  return y;
}

__device__ __forceinline__ void softmax_tile(float (&s)[32], int k0, int pos0, int qpos_a, int qpos_b,
                                             int col_l, float scale, Rows& r, float& alpha0,
                                             float& alpha1) {
  const bool masked = k0 + 63 > pos0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = k0 + 8 * (i / 4) + col_l + (i % 2);
    s[i] = masked && key > (((i / 2) % 2) ? qpos_b : qpos_a) ? kNegInf : s[i] * scale;
  }
  float x0 = r.m0, x1 = r.m1;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if ((i / 2) % 2 == 0) x0 = fmaxf(x0, s[i]);
    else x1 = fmaxf(x1, s[i]);
  }
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
  alpha0 = expf(r.m0 - x0);
  alpha1 = expf(r.m1 - x1);
  r.m0 = x0;
  r.m1 = x1;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = expf(s[i] - (((i / 2) % 2) ? x1 : x0));
  r.l0 = fmaf(r.l0, alpha0, pair_butterfly(s, 0));
  r.l1 = fmaf(r.l1, alpha1, pair_butterfly(s, 1));
}

// P split into its bf16 rounding and the bf16 rounding of the rest, as
// A fragments: keys [16kk, 16kk + 16) are k-step kk, two values to a
// register (the accumulator and A-fragment layouts line up).
__device__ __forceinline__ void pack_p_split(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                             const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = s[8 * kk + 2 * j], b = s[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][j] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][j] = pack_bf16(a - __bfloat162float(h.x), b - __bfloat162float(h.y));
    }
}

// c = sum over the tile's k-steps of P_hi V + P_lo V (hi, then lo, step
// by step) for 64 columns of V (the chunk at sv_chunk), issued and
// committed; c must hold zeros.
__device__ __forceinline__ void issue_pv_chunk(float (&c)[32], uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4], uint32_t sv_chunk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = sw128_desc(sv_chunk + kk * 2048, kBlockK * 128, 1024);
    wgmma_rs(c, hi[kk], desc);
    wgmma_rs(c, lo[kk], desc);
  }
  wgmma_commit();
}

// Zeros into this KV head's query heads of token rows [t0, t0 + n).
template <int HEAD_DIM>
__device__ __forceinline__ void write_zeros(__nv_bfloat16* out, int t0, int n, int kh, int group,
                                            int num_heads) {
  constexpr int kPieces = HEAD_DIM / 8;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < n * group * kPieces; i += kThreads) {
    const int row = i / kPieces;
    const size_t at = ((size_t)(t0 + row / group) * num_heads + kh * group + row % group) * HEAD_DIM;
    *reinterpret_cast<uint4*>(out + at + (i % kPieces) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int HEAD_DIM>
__global__ void __launch_bounds__(kThreads, 1) ragged_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __nv_bfloat16* __restrict__ q,  // [T, h, d]
    const int* __restrict__ page_table,   // [rows, >= pages needed], row stride pt_stride
    const int* __restrict__ row_slot,     // [T]; -1 = padding row
    const int* __restrict__ positions,    // [T]
    __nv_bfloat16* __restrict__ out,      // [T, h, d]
    int tokens, int num_heads, int num_kv_heads, int page_size, int pt_stride, int num_rows,
    int oob_page, float scale) {
  using S = Smem<HEAD_DIM>;
  constexpr int BK = kBlockK;
  constexpr int ST = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int run_first, tile_end;

  const int group = num_heads / num_kv_heads;
  const int bpc = kTileRows / group / kBlockRows;  // 8-row blocks per tile
  const int nb = tokens / kBlockRows;
  const int b = blockIdx.x;  // this CTA's 8-row block
  const int kh = blockIdx.y;
  const int t0 = b * kBlockRows;
  const int slot0 = row_slot[t0];
  if (slot0 < 0) {  // a fully padded block (valid rows are a prefix)
    write_zeros<HEAD_DIM>(out, t0, kBlockRows, kh, group, num_heads);
    return;
  }

  // Which tile is this block in? Block j starts a run unless its first row
  // continues block j - 1's last (same sequence, next position). This
  // block leads a tile when it lies a multiple of bpc blocks after its
  // run's first block; the tile ends at the next block that does not
  // continue the run, or bpc blocks on. ops/cuda/ragged.py:work_items.
  const int hi = min(b + bpc, nb);
  if (threadIdx.x == 0) {
    run_first = 0;
    tile_end = hi;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < hi; j += kThreads) {
    const int sj = row_slot[j * kBlockRows];
    const bool cont = j > 0 && sj >= 0 && row_slot[j * kBlockRows - 1] == sj &&
                      positions[j * kBlockRows - 1] + 1 == positions[j * kBlockRows];
    if (j <= b) {
      if (sj >= 0 && !cont) atomicMax(&run_first, j);
    } else if (!cont) {
      atomicMin(&tile_end, j);
    }
  }
  __syncthreads();
  if ((b - run_first) % bpc != 0) return;  // another CTA leads this tile

  const int e = tile_end;  // the tile's blocks are [b, e)
  int last_valid = 0;
#pragma unroll
  for (int r = 0; r < kBlockRows; ++r) last_valid += row_slot[(e - 1) * kBlockRows + r] >= 0;
  const int ntok = (e - 1 - b) * kBlockRows + last_valid;  // valid tokens of the tile
  const int tile_tok = (e - b) * kBlockRows;               // its tokens, padding included
  const int pos0 = positions[t0];
  const int nkeys = pos0 + ntok;  // cache entries [0, nkeys): every row's context
  const int n_kt = (nkeys + BK - 1) / BK;
  const int npages = (nkeys + page_size - 1) / page_size;
  const int slot = min(slot0, num_rows - 1);

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // the same bytes, generic address
  const uint32_t sq = base;             // Q: kChunks x [kTileRows][64]
  const uint32_t sk = base + S::kQ;     // K stage st at sk + st * kKV
  const uint32_t sv = sk + ST * S::kKV; // V stage st at sv + st * kKV
  const uint32_t bars = sv + ST * S::kKV;  // k_full[ST], v_full[ST], empty[ST]
  const uint32_t k_full = bars, v_full = bars + 8 * ST, empty = bars + 16 * ST;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: warp 0 reads page ids, lane 0 issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int* pt = page_table + (size_t)slot * pt_stride;
      const int ppt = BK / page_size;  // pages per key tile, a divisor of 32
      const uint32_t box = page_size * 128;  // one page's rows of one 64-column chunk
      int ids = oob_page;                    // page ids [p, p + 32), one per lane
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % ST;
        const int p0 = kt * ppt;
        if (p0 % 32 == 0) ids = p0 + lane < npages ? pt[p0 + lane] : oob_page;
        mbar_wait(empty + 8 * st, ((kt / ST) & 1) ^ 1);  // round 0 passes
        if (lane == 0) mbar_expect_tx(k_full + 8 * st, S::kKV);
        for (int j = 0; j < ppt; ++j) {
          const int page = __shfl_sync(0xffffffffu, ids, (p0 + j) % 32);
          if (lane == 0) {
#pragma unroll
            for (int c = 0; c < S::kChunks; ++c)
              tma_load(sk + st * S::kKV + c * BK * 128 + j * box, &tk, k_full + 8 * st,
                       c * 64, kh, 0, page);
          }
        }
        if (lane == 0) mbar_expect_tx(v_full + 8 * st, S::kKV);
        for (int j = 0; j < ppt; ++j) {
          const int page = __shfl_sync(0xffffffffu, ids, (p0 + j) % 32);
          if (lane == 0) {
#pragma unroll
            for (int c = 0; c < S::kChunks; ++c)
              tma_load(sv + st * S::kKV + c * BK * 128 + j * box, &tv, v_full + 8 * st,
                       c * 64, kh, 0, page);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int valid_rows = ntok * group;

    // This warpgroup's 64 rows of Q into shared memory, in the 128-byte
    // swizzle the descriptors read (16-byte piece u of row r at
    // r * 128 + (u ^ r % 8) * 16 of its chunk); rows past the run are
    // zeros.
    constexpr int kPieces = HEAD_DIM / 8;
    for (int i = tid; i < 64 * kPieces; i += 128) {
      const int row = wg * 64 + i / kPieces;
      const int piece = i % kPieces;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < valid_rows) {
        const size_t at =
            ((size_t)(t0 + row / group) * num_heads + kh * group + row % group) * HEAD_DIM;
        val = *reinterpret_cast<const uint4*>(q + at + piece * 8);
      }
      *reinterpret_cast<uint4*>(gbase + (piece / 8) * kTileRows * 128 + row * 128 +
                                ((piece % 8) ^ (row % 8)) * 16) = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    // This thread's two rows (accumulator layout): row_a and row_a + 8.
    const int row_a = wg * 64 + warp * 16 + lane / 4;
    const int row_b = row_a + 8;
    const int qpos_a = row_a < valid_rows ? pos0 + row_a / group : -1;
    const int qpos_b = row_b < valid_rows ? pos0 + row_b / group : -1;
    const int col_l = 2 * (lane % 4);
    float o[HEAD_DIM / 2];
#pragma unroll
    for (int i = 0; i < HEAD_DIM / 2; ++i) o[i] = 0.f;
    Rows r{kNegInf, kNegInf, 0.f, 0.f};

    if (wg * 64 < valid_rows) {
      const uint32_t sq_wg = sq + wg * 64 * 128;  // this warpgroup's rows of chunk 0
      float s[BK / 2];
      uint32_t p[BK / 16][4], p_lo[BK / 16][4];
      float alpha0, alpha1;
      float c[32];  // one 64-column chunk of this tile's P V
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % ST;
        const uint32_t parity = (kt / ST) & 1;
        mbar_wait(k_full + 8 * st, parity);
        wgmma_fence();
        issue_qk<HEAD_DIM, BK, kTileRows>(s, sq_wg, sk + st * S::kKV);
        wgmma_wait<0>();
        pin(s);
        softmax_tile(s, kt * BK, pos0, qpos_a, qpos_b, col_l, scale, r, alpha0, alpha1);
        pack_p_split(p, p_lo, s);
        pin(p);
        pin(p_lo);
        mbar_wait(v_full + 8 * st, parity);
        // O = O * alpha + (this tile's P V), one 64-column chunk at a time
#pragma unroll
        for (int ch = 0; ch < S::kChunks; ++ch) {
#pragma unroll
          for (int i = 0; i < 32; ++i) c[i] = 0.f;
          wgmma_fence();
          issue_pv_chunk(c, p, p_lo, sv + st * S::kKV + ch * BK * 128);
          wgmma_wait<0>();
          pin(c);
          pin(p);
          pin(p_lo);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            o[32 * ch + i] = fmaf(o[32 * ch + i], ((i / 2) % 2) ? alpha1 : alpha0, c[i]);
        }
        if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp has read the stage
      }
    } else {
      // no valid rows here: keep the ring turning for the other consumer
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % ST;
        const uint32_t parity = (kt / ST) & 1;
        mbar_wait(k_full + 8 * st, parity);
        mbar_wait(v_full + 8 * st, parity);
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }
    }

    // Epilogue: normalise (l is the whole row's sum in every lane), store
    // the tile's rows: valid rows o / l, padded rows of its blocks zeros.
    const bool valid_a = row_a < valid_rows, valid_b = row_b < valid_rows;
    const size_t at_a =
        ((size_t)(t0 + row_a / group) * num_heads + kh * group + row_a % group) * HEAD_DIM;
    const size_t at_b =
        ((size_t)(t0 + row_b / group) * num_heads + kh * group + row_b % group) * HEAD_DIM;
    const bool store_a = row_a < tile_tok * group, store_b = row_b < tile_tok * group;
#pragma unroll
    for (int j = 0; j < HEAD_DIM / 8; ++j) {
      if (store_a)
        *reinterpret_cast<uint32_t*>(out + at_a + col_l + 8 * j) =
            valid_a ? pack_bf16(o[4 * j] / r.l0, o[4 * j + 1] / r.l0) : 0u;
      if (store_b)
        *reinterpret_cast<uint32_t*>(out + at_b + col_l + 8 * j) =
            valid_b ? pack_bf16(o[4 * j + 2] / r.l1, o[4 * j + 3] / r.l1) : 0u;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled g_encode = nullptr;

// The plan (ops/cuda/ragged.py:launch_plan), 18 integers:
//   [0..6]   tile rows, key tile rows, stages, shared-memory bytes, grid x
//            (8-row blocks), grid y (KV heads), tokens per CTA;
//   [7..17]  the pool's tensor map (K and V alike): dims (d, kv_heads,
//            page_size, pages), byte strides of kv_heads, page_size and
//            pages, box (64, 1, page_size, 1).
constexpr int kEncodeFailed = 1000;  // + the encoder's CUresult

template <int HEAD_DIM>
bool plan_matches(const long long* plan, int group) {
  using S = Smem<HEAD_DIM>;
  return plan[0] == kTileRows && plan[1] == kBlockK && plan[2] == S::kStages &&
         plan[3] == static_cast<long long>(S::kBytes) &&
         plan[6] == kTileRows / group / kBlockRows * kBlockRows;
}

template <int HEAD_DIM>
int launch(const void* maps, const void* q, const void* page_table, const void* row_slot,
           const void* positions, void* out, int tokens, int num_heads, int num_kv_heads,
           int page_size, int pt_stride, int num_rows, const long long* plan, float scale,
           cudaStream_t stream) {
  using S = Smem<HEAD_DIM>;
  if (!plan_matches<HEAD_DIM>(plan, num_heads / num_kv_heads))
    return static_cast<int>(cudaErrorInvalidValue);
  // Raise the kernel's shared-memory limit once per device.
  static int limit_set[kMaxDevices];  // 0: not yet, 1: done
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!limit_set[dev]) {
    err = cudaFuncSetAttribute(ragged_kernel<HEAD_DIM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set[dev] = 1;
  }
  CUtensorMap tk, tv;
  memcpy(&tk, maps, sizeof(CUtensorMap));
  memcpy(&tv, static_cast<const unsigned char*>(maps) + sizeof(CUtensorMap), sizeof(CUtensorMap));
  const dim3 grid((unsigned)plan[4], (unsigned)plan[5]);
  ragged_kernel<HEAD_DIM><<<grid, kThreads, S::kBytes, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(page_table),
      static_cast<const int*>(row_slot), static_cast<const int*>(positions),
      static_cast<__nv_bfloat16*>(out), tokens, num_heads, num_kv_heads, page_size, pt_stride,
      num_rows, (int)plan[10], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Hand the library cuTensorMapEncodeTiled, looked up in the libcuda that
// PyTorch has loaded (ops/cuda/ragged.py), so nothing links it.
extern "C" void fma_ragged_set_encoder(void* fn) { g_encode = reinterpret_cast<EncodeTiled>(fn); }

// The size of one encoded tensor map; maps_out below takes two.
extern "C" int fma_ragged_map_bytes() { return static_cast<int>(sizeof(CUtensorMap)); }

// Encode the K and V pools' tensor maps (the plan's [7..17], over the bases
// k_pages and v_pages) into maps_out, K then V. Returns 0, or 1000 + the
// CUresult of a map the encoder refused.
extern "C" int fma_ragged_encode_maps(void* maps_out, const void* k_pages, const void* v_pages,
                                      const long long* plan) {
  if (g_encode == nullptr) return static_cast<int>(cudaErrorInitializationError);
  const long long* p = plan + 7;
  const cuuint64_t dims[4] = {(cuuint64_t)p[0], (cuuint64_t)p[1], (cuuint64_t)p[2],
                              (cuuint64_t)p[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)p[4], (cuuint64_t)p[5], (cuuint64_t)p[6]};
  const cuuint32_t box[4] = {(cuuint32_t)p[7], (cuuint32_t)p[8], (cuuint32_t)p[9],
                             (cuuint32_t)p[10]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const void* bases[2] = {k_pages, v_pages};
  for (int t = 0; t < 2; ++t) {
    CUtensorMap map;
    const CUresult r = g_encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                const_cast<void*>(bases[t]), dims, strides, box, elem,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds reads 0
    if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
    memcpy(static_cast<unsigned char*>(maps_out) + t * sizeof(CUtensorMap), &map,
           sizeof(CUtensorMap));
  }
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for arguments or a plan this build does not take.
// Needs tokens % 8 == 0, num_heads / num_kv_heads in 1..8, head_dim in
// {64, 128, 256}, page_size a multiple of 8 dividing 64 (so it divides
// every key tile); page_table rows
// are pt_stride ints apart; maps are fma_ragged_encode_maps' output.
extern "C" int fma_ragged_paged_attention_bf16(
    const void* maps, const void* q, const void* page_table, const void* row_slot,
    const void* positions, void* out, int tokens, int num_heads, int num_kv_heads, int head_dim,
    int page_size, int pt_stride, int num_rows, const long long* plan, float scale,
    void* stream) {
  const int group = num_kv_heads > 0 ? num_heads / num_kv_heads : 0;
  if (tokens % kBlockRows != 0 || group < 1 || group * num_kv_heads != num_heads ||
      group > kMaxGroup || num_rows < 1 || page_size % 8 != 0 || kBlockK % page_size != 0 ||
      plan[4] != tokens / kBlockRows || plan[5] != num_kv_heads || plan[9] != page_size)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tokens == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FMA_RAGGED_ARGS                                                                       \
  maps, q, page_table, row_slot, positions, out, tokens, num_heads, num_kv_heads, page_size, \
      pt_stride, num_rows, plan, scale, s
  switch (head_dim) {
    case 64:
      return launch<64>(FMA_RAGGED_ARGS);
    case 128:
      return launch<128>(FMA_RAGGED_ARGS);
    case 256:
      return launch<256>(FMA_RAGGED_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FMA_RAGGED_ARGS
}

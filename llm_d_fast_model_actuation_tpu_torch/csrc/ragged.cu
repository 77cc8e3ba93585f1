// Ragged paged attention over a token-packed mixed batch, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   llm_d_fast_model_actuation_tpu/ops/pallas/ragged.py:_ragged_kernel
//   (ragged_paged_attention_pallas)
// and computes the same function. One flat [T] buffer holds rows of many
// sequences: prefill segments, suffix continuations and decode rows. Each
// row's K/V is already in the paged cache (scatter-first), and each row
// attends over its OWN sequence's cache entries at positions <= its own,
// read through the page table. The packing contract (ragged.py:15-24)
// makes every 8-row block hold at most one sequence, with its valid rows a
// prefix of the block at consecutive positions, so a block is described by
// (slot, pos0, nvalid). The Pallas kernel scalar-prefetches that
// metadata; Hopper has no scalar prefetch, so each block derives it from
// row_slot and positions itself. A block with nvalid == 0 reads no page
// and writes zeros; the padded rows of a partly valid block write zeros
// too (the Pallas kernel leaves finite garbage there, which nobody reads).
//
// Arithmetic follows the Pallas kernel: fp32 logits of the
// head_dim**-0.5-scaled queries, one fp32 online softmax per row, fp32
// accumulation. The products run on the tensor cores in bf16 with fp32
// accumulation: S = Q K^T is exact in fp32 up to summation order (bf16 x
// bf16 products are exact in fp32) and the scale is applied to S in fp32;
// P V splits the fp32 probabilities into a bf16 high part and a bf16
// residual, as csrc/prefill.cu does, which keeps ~16 bits of P.
//
// Design: one CUDA block per (8-row block, KV head). It holds the
// 8 x group query rows of that KV head (32 for Llama-3-8B), padded to
// 16-row MMA tiles, one tile per warp, so the group's query heads share
// every K/V tile read (GQA is never materialised). The block walks only
// the cache positions [0, pos0 + nvalid) that its last valid row can see,
// in tiles of 64 positions gathered row by row through the page table,
// and loads no position past that: the tile's row offsets are staged in
// shared memory first, then all of its K and V pieces are issued as
// asynchronous copies (cp.async), so a tile waits for two memory round
// trips, not one per piece. The page table is read through its row
// stride, so the engine's column slice of it needs no copy.
//
// What bounds it on an H100: a decode row is bound by bytes (it reads its
// whole context for 8 x group rows of work, 7 of 8 rows padding), a long
// prefill segment by operations (every 8-row block re-walks the
// sequence's context, so the work grows with rows x context while the
// unique bytes grow with context). The tensor cores serve the second
// case; the first wants fewer blocks re-reading the same pages (several
// 8-row blocks of one sequence in one CUDA block) and the next tile's
// copies in flight while this one is computed (a ring of tiles, TMA).
// Both are later work: a tile's copies and its products do not overlap.
//
// On a tensor-parallel mesh the same kernel also replaces
//   ragged.py:ragged_paged_attention_pallas_sharded
// (the kernel under shard_map over the tp axis): ops/cuda/ragged.py
// launches it once per rank, on the rank's device, with num_heads and
// num_kv_heads the RANK's (Llama-3-8B: 16/4 at tp 2, 8/2 at tp 4) over the
// rank's KV-head slice of the pool. Nothing here knows of ranks: a KV
// head's softmax is complete inside its block, so no rank needs another's
// data. The grid shrinks by tp per launch (T/8 x kv_heads/tp blocks), and
// a launch's time is set by its longest block, so one rank's launch takes
// well over 1/tp of the whole (0.61 of 0.89 ms at tp 2, 256 rows, H100).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kBlockRows = 8;      // RAGGED_BLOCK: token rows per block
constexpr int kBlockK = 64;        // cache positions per tile
constexpr int kMmaRows = 16;       // query rows per warp: one MMA tile
constexpr int kMaxWarps = 4;       // 8 rows x group <= 64 query rows

template <int HEAD_DIM>
struct RaggedSmem {
  static constexpr int kScratchCols = HEAD_DIM > kBlockK ? HEAD_DIM : kBlockK;
  static constexpr size_t kKV = (size_t)kBlockK * HEAD_DIM * 2;  // one K or V tile
  // per warp: its query tile, the S / P V scratch, and P's two bf16 parts
  static constexpr size_t kQ = (size_t)kMmaRows * HEAD_DIM * 2;
  static constexpr size_t kScratch = (size_t)kMmaRows * kScratchCols * 4;
  static constexpr size_t kP = (size_t)kMmaRows * kBlockK * 2;
  static constexpr size_t kPerWarp = kQ + kScratch + 2 * kP;
  static constexpr size_t bytes(int warps) { return 2 * kKV + warps * kPerWarp; }
};

// One 16-byte asynchronous copy global -> shared (sm_80+); with `valid`
// false it reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HEAD_DIM>
__global__ void __launch_bounds__(kMaxWarps * 32) ragged_kernel(
    const __nv_bfloat16* __restrict__ q,        // [T, h, d]
    const __nv_bfloat16* __restrict__ k_pages,  // [P, ps, kvh, d]
    const __nv_bfloat16* __restrict__ v_pages,  // [P, ps, kvh, d]
    const int* __restrict__ page_table,         // [rows, >= pages needed], row stride pt_stride
    const int* __restrict__ row_slot,           // [T]; -1 = padding row
    const int* __restrict__ positions,          // [T]
    __nv_bfloat16* __restrict__ out,            // [T, h, d]
    int num_heads, int num_kv_heads, int page_size, int pt_stride, int num_rows,
    float scale) {
  using Smem = RaggedSmem<HEAD_DIM>;
  constexpr int DPL = HEAD_DIM / 32;     // output columns per lane
  constexpr int CPR = HEAD_DIM * 2 / 16;  // 16-byte chunks per head row
  constexpr int SC = Smem::kScratchCols;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long rowoff[kBlockK];  // the tile's cache rows; -1 = none
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kKV);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* mine = smem + 2 * Smem::kKV + warp * Smem::kPerWarp;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mine);
  float* scr = reinterpret_cast<float*>(mine + Smem::kQ);
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(mine + Smem::kQ + Smem::kScratch);
  __nv_bfloat16* pl = ph + kMmaRows * kBlockK;

  const int t0 = blockIdx.x * kBlockRows;  // first token row of this block
  const int kvh = blockIdx.y;
  const int group = num_heads / num_kv_heads;
  const int qrows = kBlockRows * group;  // real query rows of the block

  // block metadata (the Pallas kernel's scalar prefetch): valid rows are a
  // prefix of one sequence at consecutive positions (the packing contract)
  int nvalid = 0;
#pragma unroll
  for (int r = 0; r < kBlockRows; ++r) nvalid += row_slot[t0 + r] >= 0 ? 1 : 0;
  const int slot = min(max(row_slot[t0], 0), num_rows - 1);
  const int pos0 = nvalid > 0 ? positions[t0] : 0;
  const int nkeys = nvalid > 0 ? pos0 + nvalid : 0;  // cache entries [0, nkeys)
  const int* pt = page_table + (size_t)slot * pt_stride;
  const long long tok_stride = (long long)num_kv_heads * HEAD_DIM;

  // This warp's 16 query rows: row r = token (r / group), query head
  // kvh * group + (r % group). Rows past qrows, and rows of padding
  // tokens, load zeros.
  for (int c = lane; c < kMmaRows * CPR; c += 32) {
    const int i = c / CPR;
    const int part = c % CPR;
    const int r = warp * kMmaRows + i;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < qrows && r / group < nvalid) {
      const size_t row = (size_t)(t0 + r / group) * num_heads + kvh * group + r % group;
      val = *reinterpret_cast<const uint4*>(q + row * HEAD_DIM + part * 8);
    }
    *reinterpret_cast<uint4*>(qs + i * HEAD_DIM + part * 8) = val;
  }

  // Every lane keeps the running max and sum of all 16 rows of its warp,
  // and output columns [lane * DPL, lane * DPL + DPL) of each of them.
  float m[kMmaRows], l[kMmaRows], o[kMmaRows][DPL];
#pragma unroll
  for (int r = 0; r < kMmaRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[r][j] = 0.f;
  }

  const int n_kt = (nkeys + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    // gather the tile's cache rows through the page table: first each
    // row's offset (one table read per row), then every 16-byte piece of
    // K and V as an asynchronous copy, all in flight at once. Positions at
    // or past nkeys are zero-filled and masked below.
    for (int kr = threadIdx.x; kr < kBlockK; kr += blockDim.x) {
      const int key = k0 + kr;
      rowoff[kr] = key < nkeys ? ((long long)pt[key / page_size] * page_size + key % page_size) *
                                         tok_stride + (long long)kvh * HEAD_DIM
                               : -1;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kBlockK * CPR; c += blockDim.x) {
      const int kr = c / CPR;
      const int part = c % CPR;
      const long long off = rowoff[kr];
      const bool valid = off >= 0;
      const long long src = valid ? off + part * 8 : 0;
      cp_async16(ks + kr * HEAD_DIM + part * 8, k_pages + src, valid);
      cp_async16(vs + kr * HEAD_DIM + part * 8, v_pages + src, valid);
    }
    cp_async_wait_all();
    __syncthreads();

    // S = Q_w K^T, [16, 64] fp32, into the warp's scratch (row stride 64)
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < HEAD_DIM / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, qs + kk * 16, HEAD_DIM);
        wmma::load_matrix_sync(bk, ks + (n * 16) * HEAD_DIM + kk * 16, HEAD_DIM);
        wmma::mma_sync(c, a, bk, c);
      }
      wmma::store_matrix_sync(scr + n * 16, c, kBlockK, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time; lane owns keys 2*lane, 2*lane+1.
    // A row sees cache positions <= its own; a padding row sees none (its
    // softmax runs over all-masked logits and is never written).
    float alpha[kMmaRows];
#pragma unroll
    for (int r = 0; r < kMmaRows; ++r) {
      const int tok = (warp * kMmaRows + r) / group;
      const int qpos = tok < nvalid ? pos0 + tok : -1;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 2 * lane + e;
        x[e] = k0 + kc <= qpos ? scr[r * kBlockK + kc] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x[0], x[1])));
      alpha[r] = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(x[e] - m_new);
        rs += p;
        const __nv_bfloat16 hi = __float2bfloat16(p);
        ph[r * kBlockK + 2 * lane + e] = hi;
        pl[r * kBlockK + 2 * lane + e] = __float2bfloat16(p - __bfloat162float(hi));
      }
      l[r] = l[r] * alpha[r] + warp_sum(rs);
      m[r] = m_new;
    }
    __syncwarp();

    // PV = (P_hi + P_lo) V, [16, HEAD_DIM] fp32, into the scratch (row
    // stride SC); S has been consumed above
#pragma unroll
    for (int n = 0; n < HEAD_DIM / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(bv, vs + (kk * 16) * HEAD_DIM + n * 16, HEAD_DIM);
        wmma::load_matrix_sync(a, ph + kk * 16, kBlockK);
        wmma::mma_sync(c, a, bv, c);
        wmma::load_matrix_sync(a, pl + kk * 16, kBlockK);
        wmma::mma_sync(c, a, bv, c);
      }
      wmma::store_matrix_sync(scr + n * 16, c, SC, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kMmaRows; ++r) {
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        o[r][j] = o[r][j] * alpha[r] + scr[r * SC + lane * DPL + j];
    }
    __syncwarp();  // the scratch is rewritten by the next tile's S
  }

  // Valid rows always see position 0, so their sum is > 0; padding rows
  // of the block write zeros.
#pragma unroll
  for (int r = 0; r < kMmaRows; ++r) {
    const int row = warp * kMmaRows + r;
    if (row < qrows) {
      const int tok = row / group;
      __nv_bfloat16* orow =
          out + ((size_t)(t0 + tok) * num_heads + kvh * group + row % group) * HEAD_DIM +
          lane * DPL;
      const bool valid = tok < nvalid;
#pragma unroll
      for (int j = 0; j < DPL; ++j) orow[j] = __float2bfloat16(valid ? o[r][j] / l[r] : 0.f);
    }
  }
}

template <int HEAD_DIM>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* page_table,
           const void* row_slot, const void* positions, void* out, int tokens,
           int num_heads, int num_kv_heads, int page_size, int pt_stride, int num_rows,
           float scale, cudaStream_t stream) {
  const int group = num_heads / num_kv_heads;
  const int warps = (kBlockRows * group + kMmaRows - 1) / kMmaRows;
  const size_t smem = RaggedSmem<HEAD_DIM>::bytes(warps);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel<HEAD_DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tokens / kBlockRows, num_kv_heads);
  ragged_kernel<HEAD_DIM><<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(row_slot), static_cast<const int*>(positions),
      static_cast<__nv_bfloat16*>(out), num_heads, num_kv_heads, page_size, pt_stride,
      num_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the first CUDA error (0 = launched).
// Needs tokens % 8 == 0, num_heads / num_kv_heads in 1..8, head_dim in
// {64, 128, 256}; page_table rows are pt_stride ints apart.
extern "C" int fma_ragged_paged_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages, const void* page_table,
    const void* row_slot, const void* positions, void* out, int tokens, int num_heads,
    int num_kv_heads, int head_dim, int page_size, int pt_stride, int num_rows,
    float scale, void* stream) {
  const int group = num_kv_heads > 0 ? num_heads / num_kv_heads : 0;
  if (tokens % kBlockRows != 0 || group < 1 || group * num_kv_heads != num_heads ||
      group * kBlockRows > kMaxWarps * kMmaRows || num_rows < 1 || page_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tokens == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FMA_RAGGED_ARGS                                                              \
  q, k_pages, v_pages, page_table, row_slot, positions, out, tokens, num_heads, \
      num_kv_heads, page_size, pt_stride, num_rows, scale, s
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

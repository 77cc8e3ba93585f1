// Blockwise causal (flash) prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   llm_d_fast_model_actuation_tpu/ops/pallas/prefill.py:_prefill_kernel
//   (causal_prefill_attention_pallas)
// and computes the same function over a right-padded [b, s, h, d] batch:
// query row i attends to keys j with j <= i and j < seq_len (padded rows
// past seq_len attend to the valid keys, as in the reference), GQA maps
// query head h to KV head h // group, and the softmax runs online in fp32
// so only one K/V tile is resident at a time. Tiles of keys above the
// diagonal, or wholly past seq_len, are skipped (they would contribute
// exact zeros). The inputs are read by their strides: the transposes of
// prefill.py:113-115 exist only for the TPU's tiling.
//
// What bounds it on an H100: operations. A 64-row query tile against a
// 64-key tile does 2 x 64 x 64 x d flops per 2 x 64 x d bytes of K and V,
// and the work grows with s^2 while the bytes grow with s, so at the
// power-of-two buckets the engine uses (16 ... 8192) the matrix units are
// the limit above a few hundred tokens. The design puts both products on
// the tensor cores with warp-level bf16 MMA (nvcuda::wmma, fp32
// accumulation): one block of 4 warps per (query tile of 64 rows, head,
// sequence), each warp owning 16 query rows. S = Q K^T is exact in fp32
// up to summation order (bf16 x bf16 products are exact in fp32); the
// scale d**-0.5 is applied to S in fp32. For P V the fp32 probabilities
// are split into a bf16 high part and a bf16 residual and both are
// multiplied, which keeps ~16 bits of P, so the result stays within fp32
// rounding of the reference's fp32 product instead of bf16's 8 bits.
// Running max, sum and the output accumulator stay in registers; the MMA
// results pass through a per-warp shared-memory scratch because the
// accumulator fragment's layout is opaque.
//
// Shared memory is dynamic (PrefillSmem): 96 KB at head_dim 128 and 176 KB
// at head_dim 256, both above the 48 KB a static allocation may take, so
// each launch first raises the kernel's limit with cudaFuncSetAttribute and
// returns that call's error if the card refuses.
//
// Not yet done (later work): wgmma and TMA, a pipelined K/V ring, and a
// persistent schedule. This kernel uses mma.sync-class tensor-core
// instructions and synchronous tile loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16: one MMA tile of rows

template <int HEAD_DIM>
struct PrefillSmem {
  static constexpr int kScratchCols = HEAD_DIM > kBlockK ? HEAD_DIM : kBlockK;
  static constexpr size_t kQ = (size_t)kBlockQ * HEAD_DIM * 2;
  static constexpr size_t kK = (size_t)kBlockK * HEAD_DIM * 2;
  static constexpr size_t kScratch = (size_t)kWarps * kRowsPerWarp * kScratchCols * 4;
  static constexpr size_t kP = (size_t)kWarps * kRowsPerWarp * kBlockK * 2;
  static constexpr size_t kBytes = kQ + 2 * kK + kScratch + 2 * kP;
};

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

// Copy `rows` rows of HEAD_DIM bf16 (row r at src + r * row_stride) into a
// dense [rows][HEAD_DIM] shared tile, zero-filling rows at or past `limit`.
template <int HEAD_DIM>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int rows,
                                          int limit) {
  constexpr int CPR = HEAD_DIM * 2 / 16;
  for (int c = threadIdx.x; c < rows * CPR; c += blockDim.x) {
    const int r = c / CPR;
    const int part = c % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < limit) val = *reinterpret_cast<const uint4*>(src + r * row_stride + part * 8);
    *reinterpret_cast<uint4*>(dst + r * HEAD_DIM + part * 8) = val;
  }
}

template <int HEAD_DIM>
__global__ void __launch_bounds__(kWarps * 32) prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seq_lens,
    __nv_bfloat16* __restrict__ out, int seq, int num_heads, int num_kv_heads,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale) {
  using Smem = PrefillSmem<HEAD_DIM>;
  constexpr int DPL = HEAD_DIM / 32;  // output columns per lane
  constexpr int SC = Smem::kScratchCols;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kQ);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kQ + Smem::kK);
  float* scratch = reinterpret_cast<float*>(smem + Smem::kQ + 2 * Smem::kK);
  __nv_bfloat16* p_hi =
      reinterpret_cast<__nv_bfloat16*>(smem + Smem::kQ + 2 * Smem::kK + Smem::kScratch);
  __nv_bfloat16* p_lo = p_hi + kWarps * kRowsPerWarp * kBlockK;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kh = h / (num_heads / num_kv_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sl = max(1, min(seq_lens[bi], seq));

  float* scr = scratch + warp * kRowsPerWarp * SC;
  __nv_bfloat16* ph = p_hi + warp * kRowsPerWarp * kBlockK;
  __nv_bfloat16* pl = p_lo + warp * kRowsPerWarp * kBlockK;
  const int row0 = q0 + warp * kRowsPerWarp;  // first query row of this warp

  load_rows<HEAD_DIM>(qs, q + bi * q_sb + (long long)q0 * q_ss + h * q_sh, q_ss,
                      kBlockQ, seq - q0);

  // Every lane keeps the running max and sum of all 16 rows of its warp,
  // and output columns [lane * DPL, lane * DPL + DPL) of each of them.
  float m[kRowsPerWarp], l[kRowsPerWarp], o[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[r][j] = 0.f;
  }

  // The last key any row of this tile can see: padded rows see keys
  // < seq_len, valid rows keys <= their own position.
  const int last_key = min(min(q0 + kBlockQ - 1, seq - 1), sl - 1);
  const int n_kt = last_key / kBlockK + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    load_rows<HEAD_DIM>(ks, k + bi * k_sb + (long long)k0 * k_ss + kh * k_sh, k_ss,
                        kBlockK, seq - k0);
    load_rows<HEAD_DIM>(vs, v + bi * v_sb + (long long)k0 * v_ss + kh * v_sh, v_ss,
                        kBlockK, seq - k0);
    __syncthreads();

    // S = Q_w K^T, [16, 64] fp32, into the warp's scratch (row stride 64).
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < HEAD_DIM / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, qs + (warp * kRowsPerWarp) * HEAD_DIM + kk * 16, HEAD_DIM);
        wmma::load_matrix_sync(bk, ks + (n * 16) * HEAD_DIM + kk * 16, HEAD_DIM);
        wmma::mma_sync(c, a, bk, c);
      }
      wmma::store_matrix_sync(scr + n * 16, c, kBlockK, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time; lane owns keys 2*lane, 2*lane+1.
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = row0 + r;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 2 * lane + e;
        const int kpos = k0 + kc;
        const bool ok = kpos <= qpos && kpos < sl;
        x[e] = ok ? scr[r * kBlockK + kc] * scale : kNegInf;
      }
      const float tmax = warp_max(fmaxf(x[0], x[1]));
      const float m_new = fmaxf(m[r], tmax);
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
    // stride SC); S has been consumed above.
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
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        o[r][j] = o[r][j] * alpha[r] + scr[r * SC + lane * DPL + j];
    }
    __syncwarp();  // the scratch is rewritten by the next tile's S
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = row0 + r;
    if (qpos < seq) {
      __nv_bfloat16* orow = out + bi * o_sb + (long long)qpos * o_ss + h * o_sh + lane * DPL;
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        orow[j] = __float2bfloat16(l[r] > 0.f ? o[r][j] / l[r] : 0.f);
    }
  }
}

template <int HEAD_DIM>
int launch(const void* q, const void* k, const void* v, const void* seq_lens,
           void* out, int batch, int seq, int num_heads, int num_kv_heads,
           const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = PrefillSmem<HEAD_DIM>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<HEAD_DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, num_heads, batch);
  prefill_kernel<HEAD_DIM><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seq_lens),
      static_cast<__nv_bfloat16*>(out), seq, num_heads, num_kv_heads, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, out in turn;
// the last dimension of each is contiguous. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int fma_causal_prefill_bf16(const void* q, const void* k,
                                       const void* v, const void* seq_lens,
                                       void* out, int batch, int seq,
                                       int num_heads, int num_kv_heads,
                                       int head_dim, const long long* strides,
                                       float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, seq_lens, out, batch, seq, num_heads,
                        num_kv_heads, strides, scale, s);
    case 128:
      return launch<128>(q, k, v, seq_lens, out, batch, seq, num_heads,
                         num_kv_heads, strides, scale, s);
    case 256:  // 176 KB of dynamic shared memory (PrefillSmem<256>)
      return launch<256>(q, k, v, seq_lens, out, batch, seq, num_heads,
                         num_kv_heads, strides, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Paged decode attention for Hopper (sm_90a), in two variants of one
// kernel template:
//
//   * INLINE = true replaces the TPU kernel
//       llm_d_fast_model_actuation_tpu/ops/pallas/decode.py:_decode_kernel_inline
//       (paged_decode_attention_inline_pallas): one GQA decode step per
//       sequence that attends over the cache entries at positions < pos,
//       read through the page table, with an fp32 online softmax, and
//       folds the new token's (k_new, v_new) in last as a virtual final
//       entry. The engine defers every layer's KV write to one scatter
//       after the layer loop.
//   * INLINE = false replaces the TPU kernel
//       llm_d_fast_model_actuation_tpu/ops/pallas/decode.py:_decode_kernel
//       (paged_decode_attention_pallas): the scatter-first step, whose new
//       token is already in the cache; it attends over positions
//       < seq_len, where seq_len counts the new token. A sequence with
//       seq_len 0 reads no page and writes zeros, as the Pallas kernel
//       does.
//
// Arithmetic follows the Pallas kernel, not the XLA "grouped" twin: q is
// scaled by head_dim**-0.5 in fp32 (decode.py:178) and stays fp32; K and V
// are widened to fp32; m, l and acc are fp32.
//
// What bounds it on an H100: bytes. Each step reads ceil(pos/16) pages of
// K and V per sequence and KV head and does ~2 flops per element read,
// far below the ~295 flops/byte at which the tensor cores would be the
// limit. So the design is about keeping many loads in flight:
//   * one block per (sequence, KV head), with `group` x `nsplit` warps:
//     warp (h, s) serves query head h of the group over every nsplit-th
//     32-token tile, so the tiles of one sequence are read by nsplit warps
//     at once, and the group's warps read the same K/V rows back to back
//     (the repeats hit L1);
//   * within a tile each lane reads its head_dim/32 slice of all 32 rows
//     (32 independent 8-byte loads for d = 128), then a transposing
//     butterfly (31 shuffles) leaves token t's dot product in lane t, so
//     the softmax of a tile costs one exp per lane;
//   * the splits' (m, l, acc) are merged through shared memory at the end,
//     then the inline token is folded in.
//
// Both variants share the page walk below; only the last step (fold the
// inline token, or divide by the sum) differs.
//
// Known limit: batch x kv_heads blocks (8 x 8 = 64 for Llama-3-8B at
// batch 8) leave half of the 132 SMs idle; splitting a sequence over
// several blocks (split-K / flash-decoding with a second pass) is the
// next step for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kTile = 32;          // tokens per tile: one per lane
constexpr int kMaxWarps = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One stage of the transposing reduction: each lane keeps half of its
// live partial sums (the half its partner lane does not keep) and adds the
// partner's partials for that half.
template <int OFF>
__device__ __forceinline__ void reduce_stage(float (&v)[kTile], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// v[t] holds this lane's partial dot product for token t; returns the full
// dot product of token `lane`.
__device__ __forceinline__ float transpose_reduce(float (&v)[kTile], int lane) {
  reduce_stage<16>(v, lane);
  reduce_stage<8>(v, lane);
  reduce_stage<4>(v, lane);
  reduce_stage<2>(v, lane);
  reduce_stage<1>(v, lane);
  return v[0];
}

template <int DPL>
struct Vec;
template <>
struct Vec<2> {
  using T = unsigned int;
};
template <>
struct Vec<4> {
  using T = uint2;
};
template <>
struct Vec<8> {
  using T = uint4;
};

// DPL consecutive bf16 at p (aligned to their size) as fp32.
template <int DPL>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float (&out)[DPL]) {
  using V = typename Vec<DPL>::T;
  const V raw = *reinterpret_cast<const V*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < DPL / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

template <int HEAD_DIM, bool INLINE>
__global__ void __launch_bounds__(kMaxWarps * 32) decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // [b, h, d]
    const __nv_bfloat16* __restrict__ k_pages,  // [P, ps, kvh, d]
    const __nv_bfloat16* __restrict__ v_pages,  // [P, ps, kvh, d]
    const __nv_bfloat16* __restrict__ k_new,    // [b, kvh, d]; unused unless INLINE
    const __nv_bfloat16* __restrict__ v_new,    // [b, kvh, d]; unused unless INLINE
    const int* __restrict__ page_table,         // [b, pps]
    const int* __restrict__ lens,               // [b]: cache entries to read
    //                                             (pos if INLINE, else seq_len)
    __nv_bfloat16* __restrict__ out,            // [b, h, d]
    int num_heads, int num_kv_heads, int page_size, int pages_per_seq,
    int nsplit, float scale) {
  constexpr int DPL = HEAD_DIM / 32;  // dims per lane
  constexpr int STATE = 2 + HEAD_DIM;  // m, l, acc of one warp
  extern __shared__ float merge[];     // [warps][STATE]

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = num_heads / num_kv_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hq = warp % group;     // query head within the group
  const int split = warp / group;  // which tiles this warp reads
  const int head = kvh * group + hq;
  const int pos = lens[b];
  const int* pt = page_table + (size_t)b * pages_per_seq;
  const long long row_stride = (long long)num_kv_heads * HEAD_DIM;

  float qv[DPL];
  load_bf16<DPL>(q + ((size_t)b * num_heads + head) * HEAD_DIM + lane * DPL, qv);
#pragma unroll
  for (int j = 0; j < DPL; ++j) qv[j] *= scale;

  float m = kNegInf;
  float l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  const int ntiles = (pos + kTile - 1) / kTile;
  for (int it = split; it < ntiles; it += nsplit) {
    const int t0 = it * kTile;
    const int nt = min(kTile, pos - t0);  // valid tokens in this tile
    // lane t resolves the row offset of token t0 + t (one table read);
    // lanes past the tile's valid tokens point at row 0 of page 0, which
    // is always in bounds, and their values are masked below. The loops
    // over the tile's rows have no branches, so all 32 loads are issued
    // before the first result is used.
    long long my_row = (long long)kvh * HEAD_DIM;
    if (lane < nt) {
      const int tok = t0 + lane;
      my_row += ((long long)pt[tok / page_size] * page_size + tok % page_size) * row_stride;
    }
    float part[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const long long row = __shfl_sync(0xffffffffu, my_row, t);
      float kv[DPL];
      load_bf16<DPL>(k_pages + row + lane * DPL, kv);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) dot += qv[j] * kv[j];
      part[t] = dot;
    }
    float s = transpose_reduce(part, lane);  // token `lane`'s logit
    s = lane < nt ? s : kNegInf;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = lane < nt ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= alpha;
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float pt_t = __shfl_sync(0xffffffffu, p, t);
      const long long row = __shfl_sync(0xffffffffu, my_row, t);
      float vv[DPL];
      load_bf16<DPL>(v_pages + row + lane * DPL, vv);
      // a select, not a product with p = 0: a masked row may hold inf/nan
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] += t < nt ? pt_t * vv[j] : 0.f;
    }
    m = m_new;
  }

  // Merge the splits of each head, then fold the inline token (or, in
  // the scatter-first variant, normalise).
  float* mine = merge + warp * STATE;
  if (lane == 0) {
    mine[0] = m;
    mine[1] = l;
  }
#pragma unroll
  for (int j = 0; j < DPL; ++j) mine[2 + lane * DPL + j] = acc[j];
  __syncthreads();
  if (split != 0) return;
  float M = kNegInf;
  for (int s2 = 0; s2 < nsplit; ++s2) M = fmaxf(M, merge[(s2 * group + hq) * STATE]);
  float L = 0.f;
  float A[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) A[j] = 0.f;
  for (int s2 = 0; s2 < nsplit; ++s2) {
    const float* o = merge + (s2 * group + hq) * STATE;
    const float w = expf(o[0] - M);
    L += o[1] * w;
#pragma unroll
    for (int j = 0; j < DPL; ++j) A[j] += o[2 + lane * DPL + j] * w;
  }

  __nv_bfloat16* orow = out + ((size_t)b * num_heads + head) * HEAD_DIM + lane * DPL;
  if constexpr (!INLINE) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) orow[j] = __float2bfloat16(L > 0.f ? A[j] / L : 0.f);
    return;
  }
  // the inline token: always valid, so L > 0 even at pos == 0
  const size_t nrow = ((size_t)b * num_kv_heads + kvh) * HEAD_DIM + lane * DPL;
  float kn[DPL], vn[DPL];
  load_bf16<DPL>(k_new + nrow, kn);
  load_bf16<DPL>(v_new + nrow, vn);
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < DPL; ++j) part += qv[j] * kn[j];
  const float logit = warp_sum(part);
  const float m_new = fmaxf(M, logit);
  const float alpha = expf(M - m_new);
  const float p_self = expf(logit - m_new);
  L = L * alpha + p_self;
#pragma unroll
  for (int j = 0; j < DPL; ++j) orow[j] = __float2bfloat16((A[j] * alpha + p_self * vn[j]) / L);
}

template <bool INLINE>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* k_new,
           const void* v_new, const void* page_table, const void* lens, void* out,
           int batch, int num_heads, int num_kv_heads, int head_dim, int page_size,
           int pages_per_seq, float scale, cudaStream_t s) {
  const int group = num_heads / num_kv_heads;
  if (group < 1 || group > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const int nsplit = kMaxWarps / group;
  const dim3 grid(batch, num_kv_heads);
  const dim3 block(32 * group * nsplit);
  const size_t smem = sizeof(float) * group * nsplit * (2 + head_dim);
#define FMA_DECODE_ARGS                                                      \
  static_cast<const __nv_bfloat16*>(q),                                      \
      static_cast<const __nv_bfloat16*>(k_pages),                            \
      static_cast<const __nv_bfloat16*>(v_pages),                            \
      static_cast<const __nv_bfloat16*>(k_new),                              \
      static_cast<const __nv_bfloat16*>(v_new),                              \
      static_cast<const int*>(page_table), static_cast<const int*>(lens),    \
      static_cast<__nv_bfloat16*>(out), num_heads, num_kv_heads, page_size,  \
      pages_per_seq, nsplit, scale
  switch (head_dim) {
    case 64:
      decode_kernel<64, INLINE><<<grid, block, smem, s>>>(FMA_DECODE_ARGS);
      break;
    case 128:
      decode_kernel<128, INLINE><<<grid, block, smem, s>>>(FMA_DECODE_ARGS);
      break;
    case 256:
      decode_kernel<256, INLINE><<<grid, block, smem, s>>>(FMA_DECODE_ARGS);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FMA_DECODE_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError()
// (0 = launched). They need num_heads / num_kv_heads <= 16 and head_dim in
// {64, 128, 256}.

// The inline variant: cache entries < positions[b], then (k_new, v_new).
extern "C" int fma_paged_decode_inline_bf16(
    const void* q, const void* k_pages, const void* v_pages, const void* k_new,
    const void* v_new, const void* page_table, const void* positions, void* out,
    int batch, int num_heads, int num_kv_heads, int head_dim, int page_size,
    int pages_per_seq, float scale, void* stream) {
  return launch<true>(q, k_pages, v_pages, k_new, v_new, page_table, positions, out,
                      batch, num_heads, num_kv_heads, head_dim, page_size,
                      pages_per_seq, scale, static_cast<cudaStream_t>(stream));
}

// The scatter-first variant: cache entries < seq_lens[b].
extern "C" int fma_paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages, const void* page_table,
    const void* seq_lens, void* out, int batch, int num_heads, int num_kv_heads,
    int head_dim, int page_size, int pages_per_seq, float scale, void* stream) {
  return launch<false>(q, k_pages, v_pages, nullptr, nullptr, page_table, seq_lens, out,
                       batch, num_heads, num_kv_heads, head_dim, page_size,
                       pages_per_seq, scale, static_cast<cudaStream_t>(stream));
}

// The W8A16 weight product for Hopper (sm_90a):
//   y[m, n] = bf16( bf16( sum_k x[m, k] * q[k, n] ) * bf16(s[n]) )
// x bf16 [M, K] (the activations' rows), q int8 [K, N] (the reference's
// [in, out] layout), s f32 [N] (one symmetric scale per output channel),
// y bf16 [M, N]. The sum is taken in f32.
//
// Replaces no TPU kernel: the JAX package's int8 product is XLA
// (llm_d_fast_model_actuation_tpu/models/quant.py:qmat, `(x @
// q.astype(x.dtype)) * s.astype(x.dtype)`), which fuses the int8 -> bf16
// conversion into the product's operand read, so the weight crosses HBM
// as int8 bytes once. In plain PyTorch the same expression writes the
// dequantized bf16 weight to memory and reads it back, about 2.5 times
// the bf16 product's traffic. This kernel keeps `qmat`'s meaning: every
// int8 weight byte is read from HBM once, converted in registers, and no
// dequantized weight exists anywhere.
//
// Bound: at decode's rows (M <= 16) bytes. A step of Llama-3-8B reads
// 7.5 GB of int8 weights, 2.24 ms at 3.35 TB/s; a step of Mixtral-8x7B,
// whose dense-compute FFN runs every expert on every token, 46.6 GB,
// 13.9 ms; 2 M flops per weight byte stay far below the card's ratio of
// operations to bytes. (The reference's MoE product is XLA too:
// llm_d_fast_model_actuation_tpu/models/moe.py:_qeinsum.)
//
// Design (simple, CUDA cores; tensor cores, TMA and wgmma are later work):
//   * a CTA owns kTileN = 256 output columns and one split of K (grid
//     [ceil(N / 256), splits]); 8 warps side by side over the columns;
//   * a warp is 4 column groups x 8 k-lanes: a thread loads 8 columns of
//     one q row as one 8-byte vector (a warp request covers 8 rows x 32
//     bytes, whole sectors), kUnroll rows ahead, converts each byte to
//     f32 in registers (byte permute into 2^23's mantissa, then one
//     subtraction) and multiplies it into MB rows of x, which the CTA
//     keeps in shared memory as f32;
//   * the 8 k-lanes of a column group are reduced by a butterfly of
//     shuffles that halves the values each round (a reduce-scatter:
//     every lane ends with MB of its group's MB x 8 sums); f32 addition
//     is commutative, so the order, and the bits, are fixed;
//   * with one split the CTA writes y itself (the bf16 rounding, the
//     scale rounded to bf16, the product rounded to bf16, the reference's
//     order); with several it writes f32 partials [splits, M, N] and a
//     second kernel sums them in split order and applies the same
//     epilogue. No atomics: the result does not depend on the schedule.
//   * rows beyond MB (8) loop inside the CTA: each block of rows reads
//     the CTA's slice of q again, from L2.
//   * the batched entry (fma_w8a16_bf16_experts) runs the same plan on
//     every expert of an MoE layer's stack, the expert in the grid's z
//     (grid [ceil(N / 256), splits, E]): expert e reads q[e] [K, N], s[e]
//     [N], and x at e times x's expert stride (0 when every expert reads
//     one x: the gate and up products), and writes y[e] [M, N]; the
//     partials are [splits, E, M, N] and one reduction pass covers all
//     E x M x N outputs. The 2-D entry is the batched one at E = 1, with
//     the same arithmetic, so its bits are those it always had.
// It allocates nothing and never synchronizes: the wrapper
// (ops/cuda/w8a16.py) allocates y and the partials with torch.empty, so
// a launch can be captured in a CUDA graph (the engine's decode chunks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                          // 8 warps
constexpr int kCols = 8;                               // columns a thread owns: one 8-byte load
constexpr int kGroups = 4;                             // column groups of a warp
constexpr int kLanesK = 8;                             // k-lanes of a warp
constexpr int kTileN = (kThreads / 32) * kGroups * kCols;  // 256 columns a CTA
constexpr int kUnroll = 4;                             // q rows a thread has in flight
constexpr int kKStep = kLanesK * kUnroll;              // a split's K is a multiple of it (32)

static_assert(kGroups * kLanesK == 32, "a warp is column groups x k-lanes");

// The four int8 bytes of w as f32: each byte (biased by 128) becomes the
// low mantissa byte of 2^23, and 2^23 + 128 is subtracted back. Exact.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// The reference's rounding: the product rounded to bf16, the scale rounded
// to bf16, their product (taken in f32, as torch multiplies bf16) rounded.
__device__ __forceinline__ __nv_bfloat16 epilogue(float acc, float scale) {
  const float a = __bfloat162float(__float2bfloat16_rn(acc));
  const float s = __bfloat162float(__float2bfloat16_rn(scale));
  return __float2bfloat16_rn(a * s);
}

// One reduce-scatter round over the lanes `offset` apart: of the `half`
// pairs (v[i], v[i + half]) a lane keeps the half its bit selects and
// adds its partner's copy of the same half.
template <int kHalf>
__device__ __forceinline__ void reduce_round(float* v, int offset, bool upper) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, offset);
  }
}

template <int MB>
__global__ void __launch_bounds__(kThreads) w8a16_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ part, __nv_bfloat16* __restrict__ y, int M, int K, int N, int k_split,
    long long x_estride) {
  extern __shared__ float xs[];  // [MB][k_split], this split's slice of MB rows of x
  constexpr int kVals = MB * kCols;
  // this CTA's expert: its x, q, s and y; its partials' slab of [splits, E, M, N]
  const size_t e = blockIdx.z, mn = static_cast<size_t>(M) * N;
  x += e * static_cast<size_t>(x_estride);
  q += e * K * static_cast<size_t>(N);
  s += e * N;
  y += e * mn;
  if (part != nullptr) part += (static_cast<size_t>(blockIdx.y) * gridDim.z + e) * mn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane & (kGroups - 1), kl = lane >> 2;
  const int n0 = blockIdx.x * kTileN + (warp * kGroups + group) * kCols;
  const bool cols_in = n0 < N;  // N % 8 == 0: a group's 8 columns are all in or all out
  const int k_begin = blockIdx.y * k_split;
  const int k_len = min(k_split, K - k_begin);  // a multiple of kKStep
  const int8_t* qp = q + static_cast<size_t>(k_begin) * N + n0;

  for (int m0 = 0; m0 < M; m0 += MB) {
    const int rows = min(MB, M - m0);
    __syncthreads();  // the previous block of rows is done with xs
    for (int i = threadIdx.x; i < MB * k_len; i += kThreads) {
      const int m = i / k_len, k = i - m * k_len;
      xs[m * k_split + k] =
          m < rows ? __bfloat162float(x[static_cast<size_t>(m0 + m) * K + k_begin + k]) : 0.f;
    }
    __syncthreads();

    float acc[kVals];
#pragma unroll
    for (int i = 0; i < kVals; ++i) acc[i] = 0.f;
    if (cols_in) {
      for (int k = kl; k < k_len; k += kKStep) {
        uint2 w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          w[u] = __ldg(reinterpret_cast<const uint2*>(qp + static_cast<size_t>(k + u * kLanesK) * N));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float wf[kCols];
          i8x4_to_f32(w[u].x, wf);
          i8x4_to_f32(w[u].y, wf + 4);
          const int kk = k + u * kLanesK;
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            const float xv = xs[m * k_split + kk];
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[m * kCols + c] = fmaf(xv, wf[c], acc[m * kCols + c]);
          }
        }
      }
    }
    // the 8 k-lanes of a column group: lane bits 4, 3, 2
    reduce_round<kVals / 2>(acc, 16, (lane & 16) != 0);
    reduce_round<kVals / 4>(acc, 8, (lane & 8) != 0);
    reduce_round<kVals / 8>(acc, 4, (lane & 4) != 0);
    // acc[i] is now the sum of value kl * MB + i of the group: row
    // (kl * MB + i) / 8, column (kl * MB + i) % 8
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      const int v = kl * MB + i, m = v / kCols, n = n0 + v % kCols;
      if (!cols_in || m >= rows) continue;
      const size_t at = static_cast<size_t>(m0 + m) * N + n;
      if (part != nullptr)
        part[at] = acc[i];
      else
        y[at] = epilogue(acc[i], s[n]);
    }
  }
}

// Sums the splits' partials in split order and applies the epilogue, over
// all E x M x N outputs (E experts; output i belongs to expert i / (M N)).
__global__ void w8a16_reduce(const float* __restrict__ part, const float* __restrict__ s,
                             __nv_bfloat16* __restrict__ y, int E, int M, int N, int splits) {
  const size_t mn = static_cast<size_t>(M) * N, total = mn * E;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) acc += part[sp * total + i];
    y[i] = epilogue(acc, s[(i / mn) * N + i % N]);
  }
}

template <int MB>
cudaError_t launch(const void* x, const void* q, const void* s, void* part, void* y, int E, long long x_estride,
                   int M, int K, int N, int k_split, int splits, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, splits, E);
  const size_t smem = static_cast<size_t>(MB) * k_split * sizeof(float);
  w8a16_kernel<MB><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
      splits > 1 ? static_cast<float*>(part) : nullptr, static_cast<__nv_bfloat16*>(y), M, K, N, k_split,
      x_estride);
  return cudaGetLastError();
}

}  // namespace

// y[e] = bf16(bf16(x[e] @ q[e]) * bf16(s[e])) for the E experts of q [E, K,
// N] and s [E, N], x[e] at e * x_estride elements of x (0: one shared x),
// y [E, M, N], on `stream`; the plan (rows a pass `mb`, K a split
// `k_split`, `splits`, the same for every expert) from
// ops/cuda/w8a16.py:launch_plan. `part` is [splits, E, M, N] f32 scratch
// when splits > 1 (else unused). Returns the first launch error (0 =
// launched).
extern "C" int fma_w8a16_bf16_experts(const void* x, const void* q, const void* s, void* part, void* y, int E,
                                      long long x_estride, int M, int K, int N, int mb, int k_split, int splits,
                                      void* stream) {
  if (E <= 0 || E > 65535 || x_estride < 0 || M <= 0 || K <= 0 || N <= 0 || N % kCols || k_split % kKStep ||
      splits < 1 || static_cast<long long>(k_split) * (splits - 1) >= K ||
      static_cast<long long>(k_split) * splits < K || K % kKStep ||
      static_cast<size_t>(mb) * k_split * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mb) {
    case 1: err = launch<1>(x, q, s, part, y, E, x_estride, M, K, N, k_split, splits, st); break;
    case 2: err = launch<2>(x, q, s, part, y, E, x_estride, M, K, N, k_split, splits, st); break;
    case 4: err = launch<4>(x, q, s, part, y, E, x_estride, M, K, N, k_split, splits, st); break;
    case 8: err = launch<8>(x, q, s, part, y, E, x_estride, M, K, N, k_split, splits, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N * E;
  const int blocks = static_cast<int>((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  w8a16_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(part), static_cast<const float*>(s),
                                        static_cast<__nv_bfloat16*>(y), E, M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

// y = bf16(bf16(x @ q) * bf16(s)): the batched entry at one expert.
// `part` is [splits, M, N] f32 scratch when splits > 1 (else unused).
extern "C" int fma_w8a16_bf16(const void* x, const void* q, const void* s, void* part, void* y, int M, int K,
                              int N, int mb, int k_split, int splits, void* stream) {
  return fma_w8a16_bf16_experts(x, q, s, part, y, 1, 0, M, K, N, mb, k_split, splits, stream);
}

// The W8A16 weight product for Hopper (sm_90a), on the tensor cores:
//   y[m, n] = bf16( bf16( sum_k x[m, k] * q[k, n] ) * bf16(s[n]) )
// x bf16 [M, K] (the activations' rows), q int8 [K, N] (the reference's
// [in, out] layout, not repacked), s f32 [N] (one symmetric scale per
// output channel), y bf16 [M, N]. The sum is taken in f32.
//
// Replaces no TPU kernel: the JAX package's int8 product is XLA
// (llm_d_fast_model_actuation_tpu/models/quant.py:qmat, `(x @
// q.astype(x.dtype)) * s.astype(x.dtype)`, and the expert product
// models/moe.py:_qeinsum), which fuses the int8 -> bf16 conversion into
// the product's operand read, so the weight crosses HBM as int8 bytes
// once. In plain PyTorch the same expression writes the dequantized bf16
// weight to memory and reads it back, about 2.5 times the bf16 product's
// traffic. This kernel keeps `qmat`'s meaning: every int8 weight byte is
// read from HBM once, converted in registers, and no dequantized weight
// exists anywhere.
//
// Bound: bytes, up to about 128 rows. A step of Llama-3-8B reads 7.5 GB
// of int8 weights, 2.24 ms at 3.35 TB/s; a step of Mixtral-8x7B, whose
// dense-compute FFN runs every expert on every token, 46.6 GB, 13.9 ms.
// At M rows a weight byte carries 2 M flops, under the tensor cores'
// ridge (989 T bf16 flop/s over 3.35 TB/s, about 295 flops a byte) up to
// about 147 rows. What is left per byte is its load and its conversion:
// the design keeps both cheap and keeps enough bytes in flight.
//
// Design:
//   * the weight is the A operand of mma.sync.m16n8k16 (bf16 in, f32
//     sums): 16 output channels x 16 k a tile; the x rows are B's 8
//     columns (n-tiles of 8 rows; `mb` = 8, 16 or 32 rows a pass).
//     int8 -> bf16 is exact (|q| <= 128) and a bf16 x bf16 product is
//     exact in f32, so the only rounding is the tensor core's f32 sum.
//   * no repacking: a lane loads 16 bytes (16 output channels) of each of
//     4 consecutive q rows (16-byte loads: a warp request is 4 rows x 128
//     contiguous bytes, whole sectors). The k order inside a tile is free
//     as long as A and B agree: lane t of a quad holds the tile's rows
//     4t .. 4t + 3 in its fragment slots k = 2t, 2t + 1, 2t + 8, 2t + 9,
//     so its B fragment is the 8 contiguous bytes x[m, 4t .. 4t + 3] (one
//     8-byte load, through the read-only L1 path; x is small and every
//     CTA of a column reads it), and its A fragments pair the same
//     channel of rows (4t, 4t + 1) and (4t + 2, 4t + 3) by byte permutes.
//     The 16 channels of a lane's load feed 8 mma tiles: tile j holds
//     channel 2j in its row g and 2j + 1 in its row g + 8 (g = lane / 4).
//   * conversion in registers: each byte (biased by 128) becomes the low
//     mantissa byte of 2^23, 2^23 + 128 is subtracted back (exact), and
//     the high halves of two such floats are one bf16x2 register: 11
//     ALU operations a 4-byte word, against 2 KB of weight a warp step.
//   * bytes in flight: every warp keeps kStages steps of q (64 bytes a
//     lane) and x loaded ahead of the one it converts, in registers; the
//     plan (launch_plan) gives the card at least two CTAs an SM. q is
//     read with L1::no_allocate, so it does not evict x from L1.
//   * a CTA is 4 warps over 128 output channels and one split of K; the
//     warps take its k16 steps in turn (warp w steps w, w + 4, ...), and
//     warps 1..3 hand their sums to warp 0 through shared memory, which
//     adds them in warp order. With one split warp 0 writes y itself (the
//     bf16 rounding, the scale rounded to bf16, the product rounded to
//     bf16, the reference's order); with several it writes f32 partials
//     [splits, E, M, N] and w8a16_reduce sums them in split order and
//     applies the same epilogue. No atomics: the bits do not depend on
//     the schedule.
//   * rows beyond `mb` loop inside the CTA: each block of rows reads the
//     CTA's slice of q again.
//   * the batched entry (fma_w8a16_bf16_experts) runs the same plan on
//     every expert of an MoE layer's stack, the expert in the grid's z
//     (grid [ceil(N / 128), splits, E]): expert e reads q[e] [K, N], s[e]
//     [N], and x at e times x's expert stride (0 when every expert reads
//     one x: the gate and up products), and writes y[e] [M, N]. The 2-D
//     entry is the batched one at E = 1.
// It allocates nothing and never synchronizes: the wrapper
// (ops/cuda/w8a16.py) allocates y and the partials with torch.empty, so
// a launch can be captured in a CUDA graph (the engine's decode chunks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                  // a CTA's warps, in turn along K
constexpr int kThreads = 32 * kWarps;
constexpr int kChans = 16;                 // output channels of a lane: one 16-byte load of a q row
constexpr int kTileN = 8 * kChans;         // output channels of a CTA: 8 lane groups (128)
constexpr int kStepK = 16;                 // k of one mma step
constexpr int kSplitK = kWarps * kStepK;   // a split's K is a multiple of it (64)
constexpr int kStages = 2;                 // steps a warp has loaded ahead of the one it converts

// The four int8 bytes of w as f32: each byte (biased by 128) becomes the
// low mantissa byte of 2^23, and 2^23 + 128 is subtracted back. Exact.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// bf16x2 of two floats whose bf16 rounding is exact (integers of at most
// 8 significant bits): their high halves, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 bytes of q, streamed: read once, kept out of L1.
__device__ __forceinline__ uint4 ld_q(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// One k16 step of a lane: its 4 q rows (16 channels each) converted into
// 8 A fragments, each multiplied into the NT n-tiles' B fragments.
// acc[(nt * 8 + j) * 4 + i] is mma tile j of n-tile nt: i = 0, 1 channel
// 2j at x rows 2t, 2t + 1; i = 2, 3 channel 2j + 1 at the same rows.
template <int NT>
__device__ __forceinline__ void step_mma(float* acc, const uint4 (&wq)[4], const uint2 (&wx)[NT]) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {  // channels 4w .. 4w + 3 of the lane's 16
    float f[4][4];               // [q row][channel]
#pragma unroll
    for (int r = 0; r < 4; ++r) i8x4_to_f32(word(wq[r], w), f[r]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // tile j = 2w + h: channel c in row g, c + 1 in row g + 8
      const int c = 2 * h;
      const uint32_t a[4] = {pack_hi(f[0][c], f[1][c]), pack_hi(f[0][c + 1], f[1][c + 1]),
                             pack_hi(f[2][c], f[3][c]), pack_hi(f[2][c + 1], f[3][c + 1])};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc + (nt * 8 + 2 * w + h) * 4, a, wx[nt]);
    }
  }
}

// The warp's i-th step of a lane: its 4 q rows (zero where its channels
// are out of range) and its x columns in each n-tile (zero past M).
template <int NT>
__device__ __forceinline__ void load_step(uint4 (&wq)[4], uint2 (&wx)[NT], const int8_t* qp, size_t q_step, int N,
                                          bool cols_in, const __nv_bfloat16* const (&xr)[NT],
                                          const bool (&row_in)[NT], int i) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    wq[r] = cols_in ? ld_q(qp + i * q_step + static_cast<size_t>(r) * N) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    wx[nt] = row_in[nt] ? __ldg(reinterpret_cast<const uint2*>(xr[nt] + static_cast<size_t>(i) * kSplitK))
                        : make_uint2(0u, 0u);
}

// The reference's rounding: the product rounded to bf16, the scale rounded
// to bf16, their product (taken in f32, as torch multiplies bf16) rounded.
__device__ __forceinline__ __nv_bfloat16 epilogue(float acc, float scale) {
  const float a = __bfloat162float(__float2bfloat16_rn(acc));
  const float s = __bfloat162float(__float2bfloat16_rn(scale));
  return __float2bfloat16_rn(a * s);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 4 : NT == 2 ? 3 : 2) w8a16_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ part, __nv_bfloat16* __restrict__ y, int M, int K, int N, int k_split,
    long long x_estride) {
  constexpr int kAcc = NT * 32;  // a lane's sums: NT n-tiles x 8 mma tiles x 4
  extern __shared__ float red[];  // [kWarps - 1][kAcc][32]: warps 1..3's sums for warp 0
  // this CTA's expert: its x, q, s and y; its partials' slab of [splits, E, M, N]
  const size_t e = blockIdx.z, mn = static_cast<size_t>(M) * N;
  x += e * static_cast<size_t>(x_estride);
  q += e * static_cast<size_t>(K) * N;
  s += e * N;
  y += e * mn;
  if (part != nullptr) part += (static_cast<size_t>(blockIdx.y) * gridDim.z + e) * mn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.x * kTileN + g * kChans;  // the lane's first output channel
  const bool cols_in = n < N;  // N % 16 == 0: a lane's 16 channels are all in or all out
  const int k_begin = blockIdx.y * k_split;
  const int steps = min(k_split, K - k_begin) / kStepK;
  const int mine = steps > warp ? (steps - warp + kWarps - 1) / kWarps : 0;  // steps warp, warp + 4, ...
  // the lane's q rows and x columns in its warp's first step: k_begin + 16 warp + 4t + 0..3
  const int k0 = k_begin + warp * kStepK + 4 * t;
  const int8_t* qp = q + static_cast<size_t>(k0) * N + n;
  const size_t q_step = static_cast<size_t>(kWarps) * kStepK * N;  // from one of the warp's steps to its next

  for (int m0 = 0; m0 < M; m0 += 8 * NT) {
    const __nv_bfloat16* xr[NT];  // the x row of the lane's B fragments in n-tile nt: m0 + 8 nt + g
    bool row_in[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int m = m0 + 8 * nt + g;
      row_in[nt] = m < M;
      xr[nt] = x + static_cast<size_t>(row_in[nt] ? m : 0) * K + k0;
    }
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    uint4 wq[kStages][4];
    uint2 wx[kStages][NT];
#pragma unroll
    for (int st = 0; st < kStages; ++st)
      if (st < mine) load_step<NT>(wq[st], wx[st], qp, q_step, N, cols_in, xr, row_in, st);
    for (int i0 = 0; i0 < mine; i0 += kStages) {
#pragma unroll
      for (int st = 0; st < kStages; ++st) {
        const int i = i0 + st;
        if (i < mine) {  // warp-uniform: every lane runs the mma
          uint4 cq[4];
          uint2 cx[NT];
#pragma unroll
          for (int r = 0; r < 4; ++r) cq[r] = wq[st][r];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) cx[nt] = wx[st][nt];
          if (i + kStages < mine) load_step<NT>(wq[st], wx[st], qp, q_step, N, cols_in, xr, row_in, i + kStages);
          step_mma<NT>(acc, cq, cx);
        }
      }
    }

    // warps 1..3 hand their sums to warp 0, which adds them in warp order
    if (warp > 0) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) red[((warp - 1) * kAcc + i) * 32 + lane] = acc[i];
    }
    __syncthreads();
    if (warp == 0) {
      for (int v = 0; v < kWarps - 1; ++v) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += red[(v * kAcc + i) * 32 + lane];
      }
      if (cols_in) {
        float sc[kChans];
        if (part == nullptr) {
#pragma unroll
          for (int i = 0; i < kChans / 4; ++i) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(s + n) + i);
            sc[4 * i] = v.x, sc[4 * i + 1] = v.y, sc[4 * i + 2] = v.z, sc[4 * i + 3] = v.w;
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {  // x rows 2t and 2t + 1 of the n-tile
            const int m = m0 + 8 * nt + 2 * t + rr;
            if (m >= M) continue;
            float v[kChans];  // the lane's 16 channels at row m
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              v[2 * j] = acc[(nt * 8 + j) * 4 + rr];
              v[2 * j + 1] = acc[(nt * 8 + j) * 4 + 2 + rr];
            }
            const size_t at = static_cast<size_t>(m) * N + n;
            if (part != nullptr) {
#pragma unroll
              for (int i = 0; i < kChans / 4; ++i)
                reinterpret_cast<float4*>(part + at)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
            } else {
              uint32_t o[kChans / 2];
#pragma unroll
              for (int i = 0; i < kChans / 2; ++i)
                o[i] = bf16x2_bits(epilogue(v[2 * i], sc[2 * i]), epilogue(v[2 * i + 1], sc[2 * i + 1]));
              reinterpret_cast<uint4*>(y + at)[0] = make_uint4(o[0], o[1], o[2], o[3]);
              reinterpret_cast<uint4*>(y + at)[1] = make_uint4(o[4], o[5], o[6], o[7]);
            }
          }
        }
      }
    }
    __syncthreads();  // warp 0 is done with red before the next block of rows
  }
}

// Sums the splits' partials in split order and applies the epilogue, over
// all E x M x N outputs (E experts; output i belongs to expert i / (M N)),
// four outputs of one row a thread.
__global__ void w8a16_reduce(const float* __restrict__ part, const float* __restrict__ s,
                             __nv_bfloat16* __restrict__ y, int E, int M, int N, int splits) {
  const size_t mn = static_cast<size_t>(M) * N, total = mn * E;
  for (size_t i = 4 * (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x); i < total;
       i += 4 * static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float4 p = *reinterpret_cast<const float4*>(part + sp * total + i);
      acc.x += p.x, acc.y += p.y, acc.z += p.z, acc.w += p.w;
    }
    const float4 sc = *reinterpret_cast<const float4*>(s + (i / mn) * N + i % N);
    *reinterpret_cast<uint2*>(y + i) = make_uint2(bf16x2_bits(epilogue(acc.x, sc.x), epilogue(acc.y, sc.y)),
                                                  bf16x2_bits(epilogue(acc.z, sc.z), epilogue(acc.w, sc.w)));
  }
}

template <int NT>
cudaError_t launch(const void* x, const void* q, const void* s, void* part, void* y, int E, long long x_estride,
                   int M, int K, int N, int k_split, int splits, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, splits, E);
  const size_t smem = static_cast<size_t>(kWarps - 1) * NT * 32 * 32 * sizeof(float);
  w8a16_kernel<NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
      splits > 1 ? static_cast<float*>(part) : nullptr, static_cast<__nv_bfloat16*>(y), M, K, N, k_split,
      x_estride);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// y[e] = bf16(bf16(x[e] @ q[e]) * bf16(s[e])) for the E experts of q [E, K,
// N] and s [E, N], x[e] at e * x_estride elements of x (0: one shared x),
// y [E, M, N], on `stream`; the plan (rows a pass `mb`: 8, 16 or 32, K a
// split `k_split`, `splits`, the same for every expert) from
// ops/cuda/w8a16.py:launch_plan. `part` is [splits, E, M, N] f32 scratch
// when splits > 1 (else unused). x is 8-byte aligned, q, s, y and part
// 16-byte aligned. Returns the first launch error (0 = launched).
extern "C" int fma_w8a16_bf16_experts(const void* x, const void* q, const void* s, void* part, void* y, int E,
                                      long long x_estride, int M, int K, int N, int mb, int k_split, int splits,
                                      void* stream) {
  if (E <= 0 || E > 65535 || x_estride < 0 || x_estride % 4 || M <= 0 || K <= 0 || N <= 0 || N % kChans ||
      K % kStepK || k_split <= 0 || k_split % kSplitK || splits < 1 || splits > 65535 ||
      static_cast<long long>(k_split) * (splits - 1) >= K || static_cast<long long>(k_split) * splits < K ||
      !aligned(x, 8) || !aligned(q, 16) || !aligned(s, 16) || !aligned(y, 16) || (splits > 1 && !aligned(part, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mb) {
    case 8: err = launch<1>(x, q, s, part, y, E, x_estride, M, K, N, k_split, splits, st); break;
    case 16: err = launch<2>(x, q, s, part, y, E, x_estride, M, K, N, k_split, splits, st); break;
    case 32: err = launch<4>(x, q, s, part, y, E, x_estride, M, K, N, k_split, splits, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(M) * N * E / 4;
  const int blocks = static_cast<int>((quads + 255) / 256 < 4096 ? (quads + 255) / 256 : 4096);
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

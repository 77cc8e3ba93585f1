// Causal (flash) prefill attention for Hopper (sm_90a): TMA, warp-specialised
// wgmma, softmax in registers.
//
// Replaces the TPU kernel
//   llm_d_fast_model_actuation_tpu/ops/pallas/prefill.py:_prefill_kernel
//   (causal_prefill_attention_pallas)
// and computes the same function over a right-padded [b, s, h, d] batch:
// query row i attends to keys j with j <= i and j < seq_len (padded rows
// past seq_len attend to the valid keys, as in the reference), GQA maps
// query head h to KV head h // group, and the softmax runs online in fp32.
// Key tiles above the diagonal, or wholly past seq_len, are never loaded.
//
// What bounds it on an H100: operations. A 128-row query tile against a
// key tile does 4 x 128 x d flops per 4 x d bytes of K and V, and the work
// grows with s^2 while the bytes grow with s, so above a few hundred tokens
// the tensor cores are the limit. Only wgmma reaches their full rate, and
// only if the tiles arrive while the previous ones are being multiplied
// and the softmax does not leave them idle. The design:
//
// - One CTA per (query tile of 128 rows, head, sequence), three
//   warpgroups. Warpgroup 0 is the producer: it gives up registers
//   (setmaxnreg) and one thread issues TMA loads. Warpgroups 1 and 2 are
//   consumers, each owning 64 query rows, and take the registers. While
//   one consumer runs its softmax the other's products keep the tensor
//   cores busy.
// - TMA with an mbarrier ring: the Q tile is loaded once; K and V tiles go
//   through a ring of stages with full barriers (one for K and one for V,
//   so S = Q K^T starts before V lands) and an empty barrier that each
//   consumer warp arrives on once its products have read the stage. Tiles
//   are stored with the 128-byte swizzle that the wgmma descriptors read; a
//   row of d values is loaded as d / 64 boxes of 64 columns (128 bytes,
//   the widest box that swizzle allows). Rows past s are zero-filled by
//   the TMA unit and never written back.
// - S = Q K^T by wgmma m64nBKk16, both operands K-major in shared memory,
//   fp32 in registers. The scale d**-0.5 is applied to S in fp32, folded
//   with log2(e) into one exp2.
// - Softmax in registers: in the accumulator layout a row is spread over
//   the four lanes of a quad, so its max takes two shuffles; the row sum l
//   stays per thread, in fp32, from the fp32 probabilities, and is summed
//   over the quad once, at the end. Only the diagonal tile and the tile
//   that holds seq_len are masked.
// - O += P V by wgmma with P from registers: the bf16 probabilities are
//   packed in place into the A fragment (for 16-bit types the accumulator
//   and A-fragment layouts line up) and V is read as an MN-major
//   (transposed) B operand. P is rounded to bf16 once, as SDPA's and every
//   flash kernel's P is.
// - The heaviest query tiles (the last ones, which see the most keys) are
//   issued first, so the launch does not end on a tail of long CTAs.
//
// Within a consumer the S product, the softmax and the P V product run in
// turn; the overlap between consumers is what hides the softmax. FA3's
// overlap inside a consumer (S of tile j + 1 issued before P V of tile j)
// and a third ring stage were measured against this loop and bought
// nothing on the card (PERF.md).
//
// Tile sizes per head_dim (Tiles below) are stated once more in Python,
// in ops/cuda/prefill.py:TILES, which also computes the grid and the
// tensor maps; the launch refuses a plan whose sizes differ from these.

#include <cuda.h>  // CUtensorMap and the encoder's types; nothing from libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 128;  // query rows per CTA: two consumers of 64
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kMaxDevices = 64;

// (key tile rows, ring stages) per head_dim. At 256 the O accumulator
// alone takes 128 registers a thread, so the key tile is 64 rows.
template <int HEAD_DIM> struct Tiles;
template <> struct Tiles<64> { static constexpr int kBlockK = 128, kStages = 4; };
template <> struct Tiles<128> { static constexpr int kBlockK = 128, kStages = 2; };
template <> struct Tiles<256> { static constexpr int kBlockK = 64, kStages = 2; };

// Dynamic shared memory, from a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): Q, then the K stages, then
// the V stages, each a run of d / 64 chunks of [rows][64] bf16; then the
// barriers. 1024 bytes are kept for the alignment.
template <int HEAD_DIM>
struct Smem {
  static constexpr int kBlockK = Tiles<HEAD_DIM>::kBlockK;
  static constexpr int kStages = Tiles<HEAD_DIM>::kStages;
  static constexpr int kChunks = HEAD_DIM / 64;
  static constexpr uint32_t kQ = kBlockQ * HEAD_DIM * 2;
  static constexpr uint32_t kKV = kBlockK * HEAD_DIM * 2;  // one K or V stage
  static constexpr uint32_t kBarriers = 8 * (1 + 3 * kStages);
  static constexpr size_t kBytes = 1024 + kQ + 2 * kStages * kKV + kBarriers;
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

// One key tile of the online softmax, in registers and in place: s
// becomes the fp32 probabilities, the rows' max and sum move on, and
// alpha0/alpha1 are the factors O must be rescaled by. Key 0 is visible
// to every row, so after the first tile the running max is finite.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int k0, int q0, int row_a,
                                             int col_l, int sl, float scale_log2, Rows& r,
                                             float& alpha0, float& alpha1) {
  // Mask only where a key may be invisible to some row of the tile: the
  // diagonal tile and the tile that holds seq_len.
  const bool full = k0 + BK - 1 <= q0 && k0 + BK <= sl;
  if (!full) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + col_l + (i % 2);
      const int row = row_a + 8 * ((i / 2) % 2);
      if (!(key <= row && key < sl)) s[i] = -INFINITY;
    }
  }
  // A row is spread over the four lanes of a quad: two shuffles.
  float x0 = r.m0, x1 = r.m1;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if ((i / 2) % 2 == 0) x0 = fmaxf(x0, s[i]);
    else x1 = fmaxf(x1, s[i]);
  }
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
  alpha0 = fast_exp2((r.m0 - x0) * scale_log2);
  alpha1 = fast_exp2((r.m1 - x1) * scale_log2);
  r.m0 = x0;
  r.m1 = x1;
  const float nb0 = -x0 * scale_log2, nb1 = -x1 * scale_log2;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const bool b = (i / 2) % 2;
    s[i] = fast_exp2(fmaf(s[i], scale_log2, b ? nb1 : nb0));
    if (b) sum1 += s[i];
    else sum0 += s[i];
  }
  r.l0 = r.l0 * alpha0 + sum0;
  r.l1 = r.l1 * alpha1 + sum1;
}

template <int HEAD_DIM>
__global__ void __launch_bounds__(kThreads, 1) prefill_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const int* __restrict__ seq_lens,
    __nv_bfloat16* __restrict__ out, int seq, int num_heads, int num_kv_heads, int batch,
    long long o_sb, long long o_ss, long long o_sh, float scale_log2) {
  using S = Smem<HEAD_DIM>;
  constexpr int BK = S::kBlockK;
  constexpr int ST = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base;                      // Q: kChunks x [kBlockQ][64]
  const uint32_t sk = base + S::kQ;              // K stage st at sk + st * kKV
  const uint32_t sv = sk + ST * S::kKV;          // V stage st at sv + st * kKV
  const uint32_t bars = sv + ST * S::kKV;        // q_full, k_full[ST], v_full[ST], empty[ST]
  const uint32_t q_full = bars;

  // Block -> (query tile, head, sequence), the last query tile first:
  // ops/cuda/prefill.py:block_coords states the same map.
  const int n_qt = (seq + kBlockQ - 1) / kBlockQ;
  const int per_tile = num_heads * batch;
  const int rank = blockIdx.x / per_tile;
  const int rest = blockIdx.x - rank * per_tile;
  const int h = rest % num_heads;
  const int bi = rest / num_heads;
  const int q0 = (n_qt - 1 - rank) * kBlockQ;
  const int kh = h / (num_heads / num_kv_heads);
  const int sl = max(1, min(seq_lens[bi], seq));
  // The last key any row of this tile sees: padded rows see keys < seq_len,
  // valid rows keys <= their own position. Tiles past it are not loaded.
  const int last_key = min(min(q0 + kBlockQ - 1, seq - 1), sl - 1);
  const int n_kt = last_key / BK + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      mbar_init(bars + 8 * (1 + st), 1);
      mbar_init(bars + 8 * (1 + ST + st), 1);
      mbar_init(bars + 8 * (1 + 2 * ST + st), kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, S::kQ);
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c)
        tma_load(sq + c * kBlockQ * 128, &tq, q_full, c * 64, q0, h, bi);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % ST;
        const uint32_t k_full = bars + 8 * (1 + st);
        const uint32_t v_full = bars + 8 * (1 + ST + st);
        mbar_wait(bars + 8 * (1 + 2 * ST + st), ((kt / ST) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(k_full, S::kKV);
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c)
          tma_load(sk + st * S::kKV + c * BK * 128, &tk, k_full, c * 64, kt * BK, kh, bi);
        mbar_expect_tx(v_full, S::kKV);
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c)
          tma_load(sv + st * S::kKV + c * BK * 128, &tv, v_full, c * 64, kt * BK, kh, bi);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    // This thread's two rows (accumulator layout): row_a and row_a + 8.
    const int row_a = q0 + wg * 64 + warp * 16 + lane / 4;
    const int col_l = 2 * (lane % 4);
    float o[HEAD_DIM / 2];
#pragma unroll
    for (int i = 0; i < HEAD_DIM / 2; ++i) o[i] = 0.f;
    const uint32_t sq_wg = sq + wg * 64 * 128;  // this warpgroup's rows of chunk 0

    const uint32_t k_full = bars + 8, v_full = bars + 8 * (1 + ST);
    const uint32_t empty = bars + 8 * (1 + 2 * ST);
    float s[BK / 2];
    uint32_t p[BK / 16][4];
    Rows r{-INFINITY, -INFINITY, 0.f, 0.f};
    float alpha0, alpha1;

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % ST;
      const uint32_t parity = (kt / ST) & 1;
      mbar_wait(k_full + 8 * st, parity);
      wgmma_fence();
      issue_qk<HEAD_DIM, BK, kBlockQ>(s, sq_wg, sk + st * S::kKV);
      wgmma_wait<0>();
      pin(s);
      softmax_tile<BK>(s, kt * BK, q0, row_a, col_l, sl, scale_log2, r, alpha0, alpha1);
      rescale(o, alpha0, alpha1);
      pack_p<BK>(p, s);
      pin(o);
      pin(p);
      mbar_wait(v_full + 8 * st, parity);
      wgmma_fence();
      issue_pv<HEAD_DIM, BK>(o, p, sv + st * S::kKV);
      wgmma_wait<0>();
      pin(o);
      pin(p);
      if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp has read the stage
    }

    // Epilogue: sum l over the quad, normalise, store rows < seq.
    float l0 = r.l0, l1 = r.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    __nv_bfloat16* oa = out + bi * o_sb + (long long)row_a * o_ss + h * o_sh + col_l;
    __nv_bfloat16* ob = oa + 8 * o_ss;
#pragma unroll
    for (int j = 0; j < HEAD_DIM / 8; ++j) {
      if (row_a < seq)
        *reinterpret_cast<uint32_t*>(oa + 8 * j) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row_a + 8 < seq)
        *reinterpret_cast<uint32_t*>(ob + 8 * j) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled g_encode = nullptr;

// The plan (ops/cuda/prefill.py:launch_plan), 41 integers:
//   [0..4]   block_q, block_k, stages, shared-memory bytes, grid size;
//   [5..37]  q, k, v tensor maps, 11 each: dims (d, s, heads, batch),
//            byte strides of s, heads, batch, box (64, rows, 1, 1);
//   [38..40] out's element strides of batch, s, head.
constexpr int kEncodeFailed = 1000;  // + the encoder's CUresult

template <int HEAD_DIM>
int launch(const void* q, const void* k, const void* v, const void* seq_lens, void* out,
           int batch, int seq, int num_heads, int num_kv_heads, const long long* plan,
           float scale_log2, cudaStream_t stream) {
  using S = Smem<HEAD_DIM>;
  if (plan[0] != kBlockQ || plan[1] != S::kBlockK || plan[2] != S::kStages ||
      plan[3] != static_cast<long long>(S::kBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  // Raise the kernel's shared-memory limit once per device.
  static int limit_set[kMaxDevices];  // 0: not yet, 1: done
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!limit_set[dev]) {
    err = cudaFuncSetAttribute(prefill_kernel<HEAD_DIM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set[dev] = 1;
  }
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int t = 0; t < 3; ++t) {
    const long long* p = plan + 5 + 11 * t;
    const cuuint64_t dims[4] = {(cuuint64_t)p[0], (cuuint64_t)p[1], (cuuint64_t)p[2],
                                (cuuint64_t)p[3]};
    const cuuint64_t strides[3] = {(cuuint64_t)p[4], (cuuint64_t)p[5], (cuuint64_t)p[6]};
    const cuuint32_t box[4] = {(cuuint32_t)p[7], (cuuint32_t)p[8], (cuuint32_t)p[9],
                               (cuuint32_t)p[10]};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = g_encode(&maps[t], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                const_cast<void*>(ptrs[t]), dims, strides, box, elem,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds reads 0
    if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  }
  prefill_kernel<HEAD_DIM><<<(unsigned)plan[4], kThreads, S::kBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const int*>(seq_lens),
      static_cast<__nv_bfloat16*>(out), seq, num_heads, num_kv_heads, batch, plan[38], plan[39],
      plan[40], scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Hand the library cuTensorMapEncodeTiled, looked up in the libcuda that
// PyTorch has loaded (ops/cuda/prefill.py), so nothing links it.
extern "C" void fma_prefill_set_encoder(void* fn) { g_encode = reinterpret_cast<EncodeTiled>(fn); }

// Launches on `stream` and returns cudaGetLastError() (0 = launched),
// cudaErrorInvalidValue for a plan this build does not match, or
// 1000 + the CUresult of a tensor map the encoder refused.
extern "C" int fma_causal_prefill_bf16(const void* q, const void* k, const void* v,
                                       const void* seq_lens, void* out, int batch, int seq,
                                       int num_heads, int num_kv_heads, int head_dim,
                                       const long long* plan, float scale_log2, void* stream) {
  if (g_encode == nullptr) return static_cast<int>(cudaErrorInitializationError);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, seq_lens, out, batch, seq, num_heads, num_kv_heads, plan,
                        scale_log2, s);
    case 128:
      return launch<128>(q, k, v, seq_lens, out, batch, seq, num_heads, num_kv_heads, plan,
                         scale_log2, s);
    case 256:
      return launch<256>(q, k, v, seq_lens, out, batch, seq, num_heads, num_kv_heads, plan,
                         scale_log2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

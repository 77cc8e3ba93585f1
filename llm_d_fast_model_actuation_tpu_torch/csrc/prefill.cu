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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map (d, s, head, batch) into shared memory,
// completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Pin registers at this point of the program: the compiler may not move
// their reads or writes across it (accumulators are written by wgmma
// asynchronously, between the issue and the wait).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[0..32) = (accumulate ? S : 0) + A B^T over one k16 step, m64n64k16:
// A and B both K-major in shared memory (128-byte swizzle descriptors).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}
// S[0..64) = (accumulate ? S : 0) + A B^T over one k16 step, m64n128k16:
// A and B both K-major in shared memory (128-byte swizzle descriptors).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}
// O[0..32) += P V over one k16 step, m64n64k16: P from registers (the
// A fragment), V in shared memory as an MN-major (transposed) B operand.
// P is an in-out operand: its registers must hold their values until the
// product completes, so they stay live (and pinned) up to the wait.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(b), "r"(1));
}
// O[0..64) += P V over one k16 step, m64n128k16: P from registers (the
// A fragment), V in shared memory as an MN-major (transposed) B operand.
// P is an in-out operand: its registers must hold their values until the
// product completes, so they stay live (and pinned) up to the wait.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]),
        "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(b), "r"(1));
}
// O[0..128) += P V over one k16 step, m64n256k16: P from registers (the
// A fragment), V in shared memory as an MN-major (transposed) B operand.
// P is an in-out operand: its registers must hold their values until the
// product completes, so they stay live (and pinned) up to the wait.
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]),
        "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// S = Q K^T for one key tile, issued and committed, not waited: d / 16
// k16 steps, both operands K-major; a step moves 32 bytes along the
// 128-byte row, and the next 64 columns are the next chunk.
template <int HEAD_DIM, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t sq_wg, uint32_t sk_st) {
#pragma unroll
  for (int kk = 0; kk < HEAD_DIM / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    wgmma_ss(s, sw128_desc(sq_wg + (kk / 4) * kBlockQ * 128 + step, 16, 1024),
             sw128_desc(sk_st + (kk / 4) * BK * 128 + step, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V for one key tile, issued and committed: V is [keys][d] with d
// contiguous, the MN-major B operand; a k-step is 16 key rows (2048
// bytes), the next 64 columns of d are the next chunk (BK * 128 bytes on).
template <int HEAD_DIM, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[HEAD_DIM / 2], uint32_t (&p)[BK / 16][4],
                                         uint32_t sv_st) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, p[kk], sw128_desc(sv_st + kk * 2048, BK * 128, 1024));
  wgmma_commit();
}

// The online-softmax state of this thread's two rows.
struct Rows {
  float m0, m1;  // running max of the raw scores
  float l0, l1;  // this thread's share of the running sum
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

// The accumulator of keys [16kk, 16kk + 16) is the A fragment of k-step
// kk, two bf16 values to a register.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float alpha0, float alpha1) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= ((i / 2) % 2) ? alpha1 : alpha0;
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
      issue_qk<HEAD_DIM, BK>(s, sq_wg, sk + st * S::kKV);
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

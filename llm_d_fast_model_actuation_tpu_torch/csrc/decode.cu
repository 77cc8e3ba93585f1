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
// limit. So the design is about spreading the reads over the SMs and
// keeping many of them in flight.
//
// The work is cut as in the kernel's first version, whose output bits it
// keeps: the (m, l, acc) of one query head is built in nsplit = 16 / group
// "splits", split s taking every nsplit-th 32-token tile from tile s; one
// warp builds one split of one head (a per-lane dot product over the
// lane's head_dim/32 slice, a transposing butterfly that leaves token t's
// logit in lane t, expf, acc * alpha, then p.V with a select); the splits
// are merged in the order s = 0 .. nsplit-1, then the inline token is
// folded in (or the sum divided out). What changed is where each split
// runs and how its rows arrive:
//
//   * one CTA per (sequence, KV head, split) -- two splits at group 1 --
//     holding one warp per query head of the group, so the group's heads
//     share every K/V row the CTA reads; the nsplit / splits-per-CTA CTAs
//     of one (sequence, KV head) form a thread-block cluster (at most 8,
//     the portable size, hence two splits a CTA at group 1's 16). At
//     batch 8 and 8 KV heads that is 256 CTAs where there were 64;
//   * two producer warps copy each token's K row and V row of this KV
//     head (128, 256 or 512 bytes) into a ring of shared-memory stages,
//     one stage per step of the CTA's tiles, several steps ahead of the
//     consumer warps, with 16-byte cp.async (no tensor map, so any page
//     size and any per-layer view of the pool) whose landing each
//     producer lane signals on the stage's mbarrier
//     (cp.async.mbarrier.arrive); each reads the page table into shared
//     memory in chunks, so a step does not wait on a table read. (One
//     1-D cp.async.bulk per row was slower: on the card each such copy
//     cost the SM's copy engine about 40 ns, 2.6 us a 32-token tile.
//     What bounds the kernel now is how many bytes one SM keeps in
//     flight: the longest sequence's rows stream through nsplit CTAs per
//     KV head, which the kept arithmetic fixes; PERF.md has the numbers);
//   * the splits' (m, l, acc) stay in each CTA's shared memory; after a
//     cluster barrier, split 0's warps read them in order through
//     distributed shared memory (mapa + ld.shared::cluster), and a second
//     cluster barrier keeps every CTA alive until they are read. No
//     workspace, no second launch, no atomics: one launch, which a CUDA
//     graph can capture.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // smem_addr, mbarrier helpers

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kTile = 32;          // tokens per tile: one per lane
constexpr int kMaxWarps = 16;      // group x nsplit: warps over one (sequence, KV head)
constexpr int kMaxCluster = 8;     // CTAs of one (sequence, KV head): the portable cluster size
constexpr int kTableChunk = 1024;  // page-table entries a producer warp holds at once
constexpr int kProducers = 2;      // producer warps of a CTA
constexpr int kMaxDevices = 64;

// Tiles the K/V ring holds, by head_dim (a stage is one tile per split of
// the CTA): 96 KB of rows at head_dim 64 and 128, 128 KB at 256.
template <int HEAD_DIM>
struct Ring;
template <>
struct Ring<64> { static constexpr int kTiles = 12; };
template <>
struct Ring<128> { static constexpr int kTiles = 6; };
template <>
struct Ring<256> { static constexpr int kTiles = 4; };

// How one launch is cut (ops/cuda/decode.py mirrors it).
struct Plan {
  int nsplit;   // splits of one (sequence, KV head)
  int cluster;  // CTAs of one (sequence, KV head)
  int spc;      // splits per CTA
  int stages;   // ring stages
  int warps;    // consumer warps per CTA: group x spc
  int smem;     // dynamic shared memory bytes
};

template <int HEAD_DIM>
Plan make_plan(int group) {
  Plan p;
  p.nsplit = kMaxWarps / group;
  p.cluster = p.nsplit < kMaxCluster ? p.nsplit : kMaxCluster;
  p.spc = p.nsplit / p.cluster;
  p.stages = Ring<HEAD_DIM>::kTiles / p.spc;
  p.warps = group * p.spc;
  p.smem = p.stages * 2 * p.spc * kTile * HEAD_DIM * 2  // K and V rows, bf16
           + p.warps * (2 + HEAD_DIM) * 4                // each warp's (m, l, acc)
           + kProducers * kTableChunk * 4                // page-table chunks
           + 2 * p.stages * 8;                           // full and empty mbarriers
  return p;
}

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

// 16 bytes from global `src` to shared `dst`, both 16-byte aligned,
// asynchronously (through L2, not L1).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// One arrival on the mbarrier at `bar` once every cp.async this thread
// has issued so far has landed (the barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster: shared-memory writes before it
// are visible to reads after it, from any CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// The float at shared address `addr` of this CTA's layout, in CTA `rank`
// of the cluster.
__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Split 0's warp of query head `head`: merge the nsplit splits' (m, l,
// acc) in order, then fold the inline token (or, in the scatter-first
// variant, normalise) and write the head's output row.
template <int HEAD_DIM, bool INLINE>
__device__ __forceinline__ void finish(const float* merge, const float (&qv)[HEAD_DIM / 32],
                                       const __nv_bfloat16* __restrict__ k_new,
                                       const __nv_bfloat16* __restrict__ v_new,
                                       __nv_bfloat16* __restrict__ out, int b, int kvh, int hq,
                                       int group, int head, int num_heads, int num_kv_heads,
                                       int nsplit, int spc, int lane) {
  constexpr int DPL = HEAD_DIM / 32;
  constexpr int STATE = 2 + HEAD_DIM;
  // split s2's state: CTA s2 / spc of the cluster, slot (s2 % spc, hq)
  const uint32_t base = smem_addr(merge);
  float M = kNegInf;
  for (int s2 = 0; s2 < nsplit; ++s2) {
    const uint32_t o = base + 4u * (uint32_t)(((s2 % spc) * group + hq) * STATE);
    M = fmaxf(M, ld_cluster(o, (uint32_t)(s2 / spc)));
  }
  float L = 0.f;
  float A[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) A[j] = 0.f;
  for (int s2 = 0; s2 < nsplit; ++s2) {
    const uint32_t o = base + 4u * (uint32_t)(((s2 % spc) * group + hq) * STATE);
    const uint32_t r = (uint32_t)(s2 / spc);
    const float w = expf(ld_cluster(o, r) - M);
    L += ld_cluster(o + 4u, r) * w;
#pragma unroll
    for (int j = 0; j < DPL; ++j) A[j] += ld_cluster(o + 4u * (2 + lane * DPL + j), r) * w;
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

// Grid (cluster, kv_heads, batch), clusters of (cluster, 1, 1); block
// 32 x (warps + kProducers): the consumer warps, then the producer warps.
template <int HEAD_DIM, bool INLINE>
__global__ void __launch_bounds__((kMaxWarps + kProducers) * 32) decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // [b, h, d]
    const __nv_bfloat16* __restrict__ k_pages,  // [P, ps, kvh, d]
    const __nv_bfloat16* __restrict__ v_pages,  // [P, ps, kvh, d]
    const __nv_bfloat16* __restrict__ k_new,    // [b, kvh, d]; unused unless INLINE
    const __nv_bfloat16* __restrict__ v_new,    // [b, kvh, d]; unused unless INLINE
    const int* __restrict__ page_table,         // [b, pps]
    const int* __restrict__ lens,               // [b]: cache entries to read
    //                                             (pos if INLINE, else seq_len)
    __nv_bfloat16* __restrict__ out,            // [b, h, d]
    int num_heads, int num_kv_heads, int page_size, int pages_per_seq, int nsplit, int spc,
    int stages, float scale) {
  constexpr int DPL = HEAD_DIM / 32;   // dims per lane
  constexpr int STATE = 2 + HEAD_DIM;  // m, l, acc of one warp
  extern __shared__ __align__(128) unsigned char smem[];

  const int group = num_heads / num_kv_heads;
  const int warps = group * spc;  // consumer warps
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rank = (int)cluster_rank();
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int pos = lens[b];
  const int ntiles = (pos + kTile - 1) / kTile;
  const int first = rank * spc;  // this CTA's first split
  // steps of this CTA: step k holds tile first + ls + k * nsplit of each
  // local split ls, spc tiles of consecutive tokens
  const int steps = ntiles > first ? (ntiles - first + nsplit - 1) / nsplit : 0;

  // shared memory: the ring [stages][K, V][spc * kTile][d] bf16, then each
  // consumer warp's (m, l, acc), each producer warp's page-table chunk,
  // the mbarriers
  const int stage_elems = 2 * spc * kTile * HEAD_DIM;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* merge = reinterpret_cast<float*>(ring + (size_t)stages * stage_elems);
  int* tables = reinterpret_cast<int*>(merge + warps * STATE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(tables + kProducers * kTableChunk);
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = smem_addr(bars + stages);

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full0 + 8 * st, 32 * kProducers);  // one per producer lane, when its copies land
      mbar_init(empty0 + 8 * st, warps);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float qv[DPL];
  const int hq = warp % group;  // query head within the group (consumers)
  const int head = kvh * group + hq;
  if (warp >= warps) {
    // -- producers: page-table chunks, then each step's rows into its stage;
    // producer warp pw copies passes pw, pw + kProducers, ...
    const int pw = warp - warps;
    int* table = tables + pw * kTableChunk;
    constexpr int kChunks = HEAD_DIM * 2 / 16;  // 16-byte pieces of a row
    constexpr int kRowsPerPass = 32 / kChunks;  // rows one warp instruction copies
    constexpr int kPasses = kTile / kRowsPerPass;  // warp instructions a tile's K rows take
    const int* pt = page_table + (size_t)b * pages_per_seq;
    const long long row_stride = (long long)num_kv_heads * HEAD_DIM;
    const int npages = (pos + page_size - 1) / page_size;
    int base = -1;  // first page of the chunk in `table`; -1: none yet
    for (int k = 0; k < steps; ++k) {
      const int st = k % stages;
      const int t_first = (first + k * nsplit) * kTile;
      const int t_end = min(pos, t_first + spc * kTile);
      const int n = t_end - t_first;  // rows of this step
      if (base < 0 || (t_end - 1) / page_size >= base + kTableChunk) {
        __syncwarp();  // every lane is done with the old chunk
        base = t_first / page_size;
        for (int i = lane; i < kTableChunk && base + i < npages; i += 32) table[i] = pt[base + i];
        __syncwarp();
      }
      // lane t: the pool rows (page * page_size + slot) of the step's rows
      // t and 32 + t
      int pool_row[2] = {0, 0};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int t = t_first + c * kTile + lane;
        if (c < spc && t < t_end) pool_row[c] = table[t / page_size - base] * page_size + t % page_size;
      }
      mbar_wait(empty0 + 8 * st, ((k / stages) & 1) ^ 1);
      const uint32_t kdst = smem_addr(ring + (size_t)st * stage_elems);
      const uint32_t vdst = kdst + 2u * spc * kTile * HEAD_DIM;
      const int piece = lane % kChunks;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (c < spc) {
#pragma unroll
          for (int pass = 0; pass < kPasses; ++pass) {
            if (pass % kProducers != pw) continue;  // another producer warp's rows
            const int rr = pass * kRowsPerPass + lane / kChunks;  // row within tile c
            const int id = __shfl_sync(0xffffffffu, pool_row[c], rr);
            const int r = c * kTile + rr;  // row within the step
            if (r < n) {
              const long long src = (long long)id * row_stride + (long long)kvh * HEAD_DIM + piece * 8;
              const uint32_t dst = 2u * (r * HEAD_DIM + piece * 8);
              cp_async16(kdst + dst, k_pages + src);
              cp_async16(vdst + dst, v_pages + src);
            }
          }
        }
      }
      cp_async_arrive(full0 + 8 * st);
    }
  } else {
    // -- consumers: warp (ls, hq) builds split first + ls of head hq
    const int ls = warp / group;
    const int split = first + ls;
    load_bf16<DPL>(q + ((size_t)b * num_heads + head) * HEAD_DIM + lane * DPL, qv);
#pragma unroll
    for (int j = 0; j < DPL; ++j) qv[j] *= scale;

    float m = kNegInf;
    float l = 0.f;
    float acc[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

    for (int k = 0; k < steps; ++k) {
      const int st = k % stages;
      mbar_wait(full0 + 8 * st, (k / stages) & 1);
      const int it = split + k * nsplit;
      if (it < ntiles) {
        const int t0 = it * kTile;
        const int nt = min(kTile, pos - t0);  // valid tokens in this tile
        // rows past nt hold an older tile's data (or nothing yet); the
        // selects below keep them out of every sum, as before
        const __nv_bfloat16* krows =
            ring + (size_t)st * stage_elems + ls * kTile * HEAD_DIM + lane * DPL;
        const __nv_bfloat16* vrows = krows + spc * kTile * HEAD_DIM;
        float part[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          float kv[DPL];
          load_bf16<DPL>(krows + t * HEAD_DIM, kv);
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
          float vv[DPL];
          load_bf16<DPL>(vrows + t * HEAD_DIM, vv);
          // a select, not a product with p = 0: a masked row may hold inf/nan
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[j] += t < nt ? pt_t * vv[j] : 0.f;
        }
        m = m_new;
      }
      __syncwarp();  // every lane has read the stage
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
    float* mine = merge + warp * STATE;
    if (lane == 0) {
      mine[0] = m;
      mine[1] = l;
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) mine[2 + lane * DPL + j] = acc[j];
  }

  cluster_sync();  // every split's state is written
  if (rank == 0 && warp < group)
    finish<HEAD_DIM, INLINE>(merge, qv, k_new, v_new, out, b, kvh, hq, group, head, num_heads,
                             num_kv_heads, nsplit, spc, lane);
  cluster_sync();  // ... and read: no CTA leaves before split 0 has merged
}

template <int HEAD_DIM, bool INLINE>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* k_new,
           const void* v_new, const void* page_table, const void* lens, void* out, int batch,
           int num_heads, int num_kv_heads, int page_size, int pages_per_seq, float scale,
           cudaStream_t s) {
  const int group = num_heads / num_kv_heads;
  const Plan p = make_plan<HEAD_DIM>(group);
  // Raise the kernel's shared-memory limit once per device, to the most
  // any group needs.
  static int limit_set[kMaxDevices];  // 0: not yet, 1: done
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!limit_set[dev]) {
    int most = 0;
    for (int g = 1; g <= kMaxWarps; ++g) {
      const int need = make_plan<HEAD_DIM>(g).smem;
      most = need > most ? need : most;
    }
    err = cudaFuncSetAttribute(decode_kernel<HEAD_DIM, INLINE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set[dev] = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, num_kv_heads, batch);
  cfg.blockDim = dim3(32 * (p.warps + kProducers));
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, decode_kernel<HEAD_DIM, INLINE>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages), static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
      static_cast<const int*>(page_table), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), num_heads, num_kv_heads, page_size, pages_per_seq,
      p.nsplit, p.spc, p.stages, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool INLINE>
int dispatch(const void* q, const void* k_pages, const void* v_pages, const void* k_new,
             const void* v_new, const void* page_table, const void* lens, void* out, int batch,
             int num_heads, int num_kv_heads, int head_dim, int page_size, int pages_per_seq,
             float scale, void* stream) {
  const int group = num_kv_heads > 0 ? num_heads / num_kv_heads : 0;
  if (group < 1 || group * num_kv_heads != num_heads || group > kMaxWarps || page_size < 1 ||
      batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FMA_DECODE_ARGS                                                                      \
  q, k_pages, v_pages, k_new, v_new, page_table, lens, out, batch, num_heads, num_kv_heads, \
      page_size, pages_per_seq, scale, s
  switch (head_dim) {
    case 64:
      return launch<64, INLINE>(FMA_DECODE_ARGS);
    case 128:
      return launch<128, INLINE>(FMA_DECODE_ARGS);
    case 256:
      return launch<256, INLINE>(FMA_DECODE_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FMA_DECODE_ARGS
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for arguments this build does
// not take. They need num_heads a multiple of num_kv_heads with
// num_heads / num_kv_heads <= 16, head_dim in {64, 128, 256}, and every
// pointer 16-byte aligned; any page size.

// The inline variant: cache entries < positions[b], then (k_new, v_new).
extern "C" int fma_paged_decode_inline_bf16(
    const void* q, const void* k_pages, const void* v_pages, const void* k_new,
    const void* v_new, const void* page_table, const void* positions, void* out,
    int batch, int num_heads, int num_kv_heads, int head_dim, int page_size,
    int pages_per_seq, float scale, void* stream) {
  return dispatch<true>(q, k_pages, v_pages, k_new, v_new, page_table, positions, out, batch,
                        num_heads, num_kv_heads, head_dim, page_size, pages_per_seq, scale,
                        stream);
}

// The scatter-first variant: cache entries < seq_lens[b].
extern "C" int fma_paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages, const void* page_table,
    const void* seq_lens, void* out, int batch, int num_heads, int num_kv_heads,
    int head_dim, int page_size, int pages_per_seq, float scale, void* stream) {
  return dispatch<false>(q, k_pages, v_pages, nullptr, nullptr, page_table, seq_lens, out,
                         batch, num_heads, num_kv_heads, head_dim, page_size, pages_per_seq,
                         scale, stream);
}

// A copy kernel that probes the kernel toolchain, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   llm_d_fast_model_actuation_tpu/utils/compat.py:pallas_interpret_supported
//   (its `_copy` body, an [8, 128] float32 copy)
// which asks whether the installed Pallas can run a kernel at all. Here
// the question is whether this checkout's kernels were built by nvcc for
// this card, load, and launch: the engine launches this copy once when it
// starts on the card and raises if the copy does not come back equal. It
// routes nothing. Bound: bytes (4 KiB each way); launch latency dominates.

#include <cuda_runtime.h>

namespace {

__global__ void copy_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i];
}

}  // namespace

// Copies n floats from x to y on `stream`; returns cudaGetLastError()
// (0 = launched).
extern "C" int fma_copy_probe_f32(const void* x, void* y, int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  copy_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

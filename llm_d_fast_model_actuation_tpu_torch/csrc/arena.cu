// Device memory at stable addresses, through the CUDA driver's virtual
// memory management. Host code only: this library holds no kernel.
//
// The engine keeps its weights, KV pool and static buffers in one virtual
// address range per device (engine/arena.py). The range is reserved once
// (cuMemAddressReserve); each allocation is physical memory created and
// mapped into it (cuMemCreate, cuMemMap, cuMemSetAccess). A sleep unmaps
// and releases the physical memory (cuMemUnmap, cuMemRelease) and keeps the
// range; a wake creates new physical memory and maps it at the same
// addresses. So a tensor view of the range keeps its data_ptr() across a
// sleep, and a CUDA graph captured before it replays unchanged after it.
// This is the role vLLM's CuMemAllocator plays for its GPU engine.
//
// The CUDA driver's functions are handed in by the caller (ctypes looks
// them up in the libcuda.so.1 that PyTorch has loaded), as the prefill and
// ragged libraries are handed cuTensorMapEncodeTiled, so nothing links
// -lcuda.
// Every call runs with the device's primary context current (pushed and
// popped around the call), so it works on any host thread.
//
// Every function returns 0 or the CUresult of the CUDA call that failed.

#include <cuda.h>

#include <cstddef>

namespace {

typedef CUresult (*DeviceGetFn)(CUdevice*, int);
typedef CUresult (*PrimaryCtxRetainFn)(CUcontext*, CUdevice);
typedef CUresult (*PrimaryCtxReleaseFn)(CUdevice);
typedef CUresult (*CtxPushFn)(CUcontext);
typedef CUresult (*CtxPopFn)(CUcontext*);
typedef CUresult (*GranularityFn)(size_t*, const CUmemAllocationProp*,
                                  CUmemAllocationGranularity_flags);
typedef CUresult (*AddressReserveFn)(CUdeviceptr*, size_t, size_t, CUdeviceptr, unsigned long long);
typedef CUresult (*AddressFreeFn)(CUdeviceptr, size_t);
typedef CUresult (*CreateFn)(CUmemGenericAllocationHandle*, size_t, const CUmemAllocationProp*,
                             unsigned long long);
typedef CUresult (*MapFn)(CUdeviceptr, size_t, size_t, CUmemGenericAllocationHandle,
                          unsigned long long);
typedef CUresult (*SetAccessFn)(CUdeviceptr, size_t, const CUmemAccessDesc*, size_t);
typedef CUresult (*UnmapFn)(CUdeviceptr, size_t);
typedef CUresult (*ReleaseFn)(CUmemGenericAllocationHandle);

// In the order of engine/arena.py:CU_SYMBOLS.
struct CuFunctions {
  DeviceGetFn device_get;
  PrimaryCtxRetainFn ctx_retain;
  PrimaryCtxReleaseFn ctx_release;
  CtxPushFn ctx_push;
  CtxPopFn ctx_pop;
  GranularityFn granularity;
  AddressReserveFn reserve;
  AddressFreeFn address_free;
  CreateFn create;
  MapFn map;
  SetAccessFn set_access;
  UnmapFn unmap;
  ReleaseFn release;
};
constexpr int kSymbols = 13;

CuFunctions g_cu = {};
bool g_ready = false;

// The device's primary context, current for the scope's lifetime.
class Scope {
 public:
  explicit Scope(int ordinal) {
    err_ = g_cu.device_get(&dev_, ordinal);
    if (err_ != CUDA_SUCCESS) return;
    CUcontext ctx = nullptr;
    err_ = g_cu.ctx_retain(&ctx, dev_);
    if (err_ != CUDA_SUCCESS) return;
    err_ = g_cu.ctx_push(ctx);
    if (err_ != CUDA_SUCCESS) {
      g_cu.ctx_release(dev_);
      return;
    }
    pushed_ = true;
  }
  ~Scope() {
    if (!pushed_) return;
    CUcontext popped = nullptr;
    g_cu.ctx_pop(&popped);
    g_cu.ctx_release(dev_);
  }
  CUresult error() const { return err_; }
  CUdevice device() const { return dev_; }

 private:
  CUdevice dev_ = 0;
  CUresult err_ = CUDA_SUCCESS;
  bool pushed_ = false;
};

CUmemAllocationProp device_prop(CUdevice dev) {
  CUmemAllocationProp prop = {};
  prop.type = CU_MEM_ALLOCATION_TYPE_PINNED;
  prop.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  prop.location.id = static_cast<int>(dev);
  prop.requestedHandleTypes = CU_MEM_HANDLE_TYPE_NONE;
  return prop;
}

constexpr int kNotReady = static_cast<int>(CUDA_ERROR_NOT_INITIALIZED);

}  // namespace

// Hand the library the CUDA driver's functions: `n` pointers in the order of
// engine/arena.py:CU_SYMBOLS. Returns CUDA_ERROR_INVALID_VALUE when
// `n` or a pointer is wrong.
extern "C" int fma_arena_set_functions(void* const* fns, int n) {
  if (n != kSymbols) return static_cast<int>(CUDA_ERROR_INVALID_VALUE);
  for (int i = 0; i < n; ++i) {
    if (fns[i] == nullptr) return static_cast<int>(CUDA_ERROR_INVALID_VALUE);
  }
  g_cu.device_get = reinterpret_cast<DeviceGetFn>(fns[0]);
  g_cu.ctx_retain = reinterpret_cast<PrimaryCtxRetainFn>(fns[1]);
  g_cu.ctx_release = reinterpret_cast<PrimaryCtxReleaseFn>(fns[2]);
  g_cu.ctx_push = reinterpret_cast<CtxPushFn>(fns[3]);
  g_cu.ctx_pop = reinterpret_cast<CtxPopFn>(fns[4]);
  g_cu.granularity = reinterpret_cast<GranularityFn>(fns[5]);
  g_cu.reserve = reinterpret_cast<AddressReserveFn>(fns[6]);
  g_cu.address_free = reinterpret_cast<AddressFreeFn>(fns[7]);
  g_cu.create = reinterpret_cast<CreateFn>(fns[8]);
  g_cu.map = reinterpret_cast<MapFn>(fns[9]);
  g_cu.set_access = reinterpret_cast<SetAccessFn>(fns[10]);
  g_cu.unmap = reinterpret_cast<UnmapFn>(fns[11]);
  g_cu.release = reinterpret_cast<ReleaseFn>(fns[12]);
  g_ready = true;
  return 0;
}

// The minimum granularity of a device allocation on `device`: every size
// and offset in the arena is a multiple of it.
extern "C" int fma_arena_granularity(int device, unsigned long long* out) {
  if (!g_ready) return kNotReady;
  Scope scope(device);
  if (scope.error() != CUDA_SUCCESS) return static_cast<int>(scope.error());
  const CUmemAllocationProp prop = device_prop(scope.device());
  size_t g = 0;
  const CUresult r = g_cu.granularity(&g, &prop, CU_MEM_ALLOC_GRANULARITY_MINIMUM);
  *out = g;
  return static_cast<int>(r);
}

// Reserve `size` bytes of virtual addresses (a multiple of the granularity)
// aligned to `align`; the base goes to *va.
extern "C" int fma_arena_reserve(int device, unsigned long long size, unsigned long long align,
                                 unsigned long long* va) {
  if (!g_ready) return kNotReady;
  Scope scope(device);
  if (scope.error() != CUDA_SUCCESS) return static_cast<int>(scope.error());
  CUdeviceptr base = 0;
  const CUresult r = g_cu.reserve(&base, size, align, 0, 0);
  *va = static_cast<unsigned long long>(base);
  return static_cast<int>(r);
}

// Give a reservation back; nothing may be mapped in it.
extern "C" int fma_arena_free(int device, unsigned long long va, unsigned long long size) {
  if (!g_ready) return kNotReady;
  Scope scope(device);
  if (scope.error() != CUDA_SUCCESS) return static_cast<int>(scope.error());
  return static_cast<int>(g_cu.address_free(static_cast<CUdeviceptr>(va), size));
}

// Create `size` bytes of physical memory on `device` and map them, readable
// and writable by the device, at `va`; the allocation's handle goes to
// *handle. On failure nothing stays created or mapped.
extern "C" int fma_arena_map(int device, unsigned long long va, unsigned long long size,
                             unsigned long long* handle) {
  if (!g_ready) return kNotReady;
  Scope scope(device);
  if (scope.error() != CUDA_SUCCESS) return static_cast<int>(scope.error());
  const CUmemAllocationProp prop = device_prop(scope.device());
  CUmemGenericAllocationHandle h = 0;
  CUresult r = g_cu.create(&h, size, &prop, 0);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  const CUdeviceptr ptr = static_cast<CUdeviceptr>(va);
  r = g_cu.map(ptr, size, 0, h, 0);
  if (r != CUDA_SUCCESS) {
    g_cu.release(h);
    return static_cast<int>(r);
  }
  CUmemAccessDesc access = {};
  access.location = prop.location;
  access.flags = CU_MEM_ACCESS_FLAGS_PROT_READWRITE;
  r = g_cu.set_access(ptr, size, &access, 1);
  if (r != CUDA_SUCCESS) {
    g_cu.unmap(ptr, size);
    g_cu.release(h);
    return static_cast<int>(r);
  }
  *handle = static_cast<unsigned long long>(h);
  return 0;
}

// Unmap `size` bytes at `va` and release their physical memory (`handle`,
// from fma_arena_map). The addresses stay reserved.
extern "C" int fma_arena_unmap(int device, unsigned long long va, unsigned long long size,
                               unsigned long long handle) {
  if (!g_ready) return kNotReady;
  Scope scope(device);
  if (scope.error() != CUDA_SUCCESS) return static_cast<int>(scope.error());
  const CUresult r = g_cu.unmap(static_cast<CUdeviceptr>(va), size);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  return static_cast<int>(g_cu.release(static_cast<CUmemGenericAllocationHandle>(handle)));
}

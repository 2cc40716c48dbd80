// Hopper (sm_90a) building blocks shared by the tensor-core kernels of the
// port: B1's and B4's attention body (attention_sm90.cuh) and the half-block
// GEMM of B4 and B5 (halfblock_gemm.cu). mbarriers, TMA tile loads, the
// wgmma shared-memory descriptor of a 128-byte swizzled tile and wgmma's
// fence / commit / wait, warpgroup register hand-over, and on the host the
// tensor-map encoder and a once-per-device shared-memory opt-in.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>
#include <mutex>

namespace sm90 {

constexpr int kTensorMapError = -1;  // returned when a tensor map cannot be made

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialized barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of parity `parity` to complete; traps (a launch error
// the wrapper reports) if it never does, rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (spins == (1u << 26)) __trap();
  }
}

// --- TMA ------------------------------------------------------------------------

// one box of a 2-D tensor map at (inner x, outer y) into shared memory at
// `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
                  "r"(y)
               : "memory");
}

// the same for a 3-D tensor map at (x, y, z)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y, int z) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4, %5}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
                  "r"(y), "r"(z)
               : "memory");
}

// orders this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (a wgmma's operand reads, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma ----------------------------------------------------------------------

// wgmma matrix descriptor of a 128-byte swizzled tile at shared address
// `addr`: 8-row groups `sbo` bytes apart, `lbo` the leading byte offset
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are in flight
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait_all() { wg_wait<0>(); }
// keeps a register in place across asynchronous wgmma reads and writes
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

// --- warpgroups -----------------------------------------------------------------

// hands registers back (a producer) or takes them (consumers): every warp
// of the warpgroup executes it, on a path that never rejoins the others
template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// named barrier `id` (1..15) over `threads` threads: wait, or arrive and go on
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// --- the host -------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A row-major bf16 matrix (rows, cols) as a 2-D tensor map whose box is
// 64 columns (128 bytes, swizzled in 128-byte rows) by `box_rows` rows;
// rows past the end read as zeros. TMA needs a 16-byte aligned base and
// row stride (cols a multiple of 8), which the callers check.
inline int make_rows_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError;
}

// The current device and its SM count; raises `kernel`'s dynamic shared-
// memory cap to `bytes` there unless an earlier call already raised it as
// far (one cudaFuncSetAttribute per kernel, device and size, made at the
// first launch, and so before any capture into a CUDA graph).
inline cudaError_t prepare_launch(const void* kernel, int bytes, int* sms) {
  constexpr int kMaxDevices = 64, kMaxKernels = 64;
  struct Raised { const void* kernel; int device; int bytes; };
  static std::mutex lock;
  static Raised raised[kMaxKernels];
  static int n_raised = 0;
  static std::atomic<int> sm_count[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if ((*sms = sm_count[dev].load(std::memory_order_acquire)) == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev].store(*sms, std::memory_order_release);
  }
  std::lock_guard<std::mutex> guard(lock);
  Raised* entry = nullptr;
  for (int i = 0; i < n_raised; ++i)
    if (raised[i].kernel == kernel && raised[i].device == dev) entry = &raised[i];
  if (entry != nullptr && entry->bytes >= bytes) return cudaSuccess;
  if (entry == nullptr) {
    if (n_raised == kMaxKernels) return cudaErrorInvalidValue;
    entry = &raised[n_raised++];
    *entry = {kernel, dev, 0};
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) entry->bytes = bytes;
  return err;
}

}  // namespace sm90

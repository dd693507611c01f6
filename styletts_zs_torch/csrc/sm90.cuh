// Hopper (sm_90a) building blocks shared by the kernels that feed wgmma from
// shared memory filled by TMA: csrc/attention_fwd_sm90.cuh (rows 1-3) and
// csrc/conv_transpose.cu (row 10).  PTX wrappers for shared-memory
// addresses, mbarriers, TMA tile loads and wgmma's fences and groups, the
// wgmma shared-memory descriptor, and the driver's tensor-map encoder found
// through the runtime (so the library links without -lcuda).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) among `count` threads, whole
// warps.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrive at barrier `id` without waiting (the waiters bar.sync it).
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first,
// into shared memory at dst, completing on bar.  Coordinates outside the
// tensor (negative ones included) arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// The same for a 4-D tensor map.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy reads (wgmma) and writes (TMA) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor: start address, leading offset 0 (unused
// by the layouts here: one swizzle atom wide along the contiguous
// dimension), stride `sbo` bytes between groups of 8 rows (K-major) or of 8
// k (MN-major), and the swizzle: 1 = 128-byte, 2 = 64-byte.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that reads or writes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                         12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first, contiguous),
// byte strides of the outer ones, read in boxes of `box` elements with the
// given swizzle; zero fill outside the tensor.
inline bool encode_bf16(CUtensorMap* map, const void* ptr, int rank,
                 const cuuint64_t* dims, const cuuint64_t* byte_strides,
                 const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), dims, byte_strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90

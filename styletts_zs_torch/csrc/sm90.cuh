// Hopper (sm_90a) building blocks shared by the kernels that feed wgmma from
// shared memory filled by TMA: csrc/attention_fwd_sm90.cuh (rows 1-3),
// csrc/local_attention_bwd.cu (rows 4-5), csrc/full_attention.cu (row 2's
// fp32 variant), csrc/adain_conv.cu (row 6), csrc/adain_conv_bwd.cu (row 7),
// csrc/conv_transpose.cu (row 10), csrc/istft.cu (row 11) and
// csrc/synthesis_head.cu (row 12).  PTX
// wrappers for shared-memory addresses, mbarriers, TMA tile and bulk loads
// and wgmma's fences and groups, the wgmma shared-memory descriptor, the
// driver's tensor-map encoder found through the runtime (so the library
// links without -lcuda), the products (m64n64k16 for the attention kernels,
// m64n64k8 in TF32 for row 2's fp32 variant and m64n{16,32,48,64}k8 for row
// 11, m64n256k16 for rows 6 and 7, m64n128k16 for row 6 on 128 channels,
// m64n80k16 for row 12), the TF32 split, and the attention kernels'
// (B, T, H, 64) tile maps (bf16 and fp32) and exp2.

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

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global memory into shared memory at dst, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// The same with a leading offset of `lbo` bytes: for a K-major operand
// without swizzle (0), the stride between its two 8-element halves of a
// k-step, each a column of 16-byte rows (`sbo` = 128: rows 16 bytes apart,
// so the start may move by whole rows); for an MN-major operand with
// 128-byte swizzle wider than 64 elements, the stride between its 64-wide
// blocks.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return smem_desc(addr, sbo, swizzle) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16);
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
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// ---------------------------------------------------------------------------
// The attention kernels' pieces: 64 x 64 bf16 tiles of (B, T, H, 64) views,
// 128-byte swizzle (a 64-wide bf16 row is one swizzle row)
// ---------------------------------------------------------------------------

// A 64 x 64 box at (d 0, t, h, b) of a (D, T, H, B) tensor map into shared
// memory at dst, completing on bar.  Rows past T arrive as zeros.
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int t, int h,
                                              int b) {
  tma_load_4d(dst, map, bar, 0, t, h, b);
}

// wgmma descriptor of a 128-byte-swizzled tile of 64-element rows.
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return smem_desc(addr, 1024, 1);
}

#define SM90_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define SM90_D32_OPS(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (+)= A B, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D32_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A from registers (four bf16x2 a thread), B MN-major
// in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D32_OPS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (+)= A B, m64n64k8 in TF32 with fp32 accumulation: A from registers
// (four tf32 values a thread: a0 row r, column c; a1 row r + 8, column c;
// a2 row r, column c + 4; a3 row r + 8, column c + 4; r = 16 warp + lane/4,
// c = lane % 4), B K-major in shared memory (TF32 has no transpose bit).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : SM90_D32_OPS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

#undef SM90_D32
#undef SM90_D32_OPS

#define SM90_ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// The same product at N = 16, 32, 48 or 64 (N / 2 accumulators a thread,
// laid out as m64n64k8's first N / 2): row 11's inverse DFT, whose B is the
// n_fft-wide basis.
template <int N>
__device__ __forceinline__ void wgmma_tf32_n(float (&d)[N / 2], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db,
                                             int accumulate) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64, "N");
  if constexpr (N == 64) {
    wgmma_tf32(d, a0, a1, a2, a3, db, accumulate);
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n"
        "}\n"
        : SM90_ACC4(d, 0), SM90_ACC4(d, 4), SM90_ACC4(d, 8), SM90_ACC4(d, 12),
          SM90_ACC4(d, 16), SM90_ACC4(d, 20)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : SM90_ACC4(d, 0), SM90_ACC4(d, 4), SM90_ACC4(d, 8), SM90_ACC4(d, 12)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
        "}\n"
        : SM90_ACC4(d, 0), SM90_ACC4(d, 4)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
  }
}

#undef SM90_ACC4

// x rounded to the nearest TF32 value (ties away from zero): its bits, the
// low 13 of them 0.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split: x = hi + lo + e, hi and lo TF32 values, |lo| <= 2^-11
// |x| and |e| <= 2^-22 |x|; a product x y is then hi_x hi_y + hi_x lo_y +
// lo_x hi_y to about fp32's precision (the dropped lo_x lo_y is below
// 2^-22 |x y|).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d (+)= A B, m64n256k16: A K-major, B MN-major (kTransB 1, the transpose
// bit) or K-major (0), both in shared memory; 128 fp32 accumulators a
// thread.  With accumulate 0 the product defines d, so no other instruction
// need write it first (ptxas serialises wgmma whose accumulators other
// instructions define).
template <int kTransB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}

// Row 6: B (the weight, output channels contiguous) MN-major.
__device__ __forceinline__ void wgmma_n256_kmn(float (&d)[128], uint64_t da,
                                              uint64_t db, int accumulate) {
  wgmma_n256<1>(d, da, db, accumulate);
}

// Row 7: B (the weight read as (c, o) rows, o contiguous) K-major.
__device__ __forceinline__ void wgmma_n256_kk(float (&d)[128], uint64_t da,
                                             uint64_t db, int accumulate) {
  wgmma_n256<0>(d, da, db, accumulate);
}

// d (+)= A B, m64n128k16: A K-major, B MN-major (the transpose bit), both
// in shared memory; 64 fp32 accumulators a thread.  Row 6 on a block of
// 128 output channels (a tensor-parallel chunk of the decoder's 512).  With
// accumulate 0 the product defines d, as for wgmma_n256.
__device__ __forceinline__ void wgmma_n128_kmn(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n80k16: A and B K-major in shared memory; 40 fp32
// accumulators a thread.
__device__ __forceinline__ void wgmma_n80_kk(float (&d)[40], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// A tensor map of `rank` dimensions (innermost first, contiguous) of
// `type`, byte strides of the outer ones, read in boxes of `box` elements
// with the given swizzle; zero fill outside the tensor.
inline bool encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                         const void* ptr, int rank, const cuuint64_t* dims,
                         const cuuint64_t* byte_strides, const cuuint32_t* box,
                         CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, byte_strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool encode_bf16(CUtensorMap* map, const void* ptr, int rank,
                 const cuuint64_t* dims, const cuuint64_t* byte_strides,
                 const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims,
                      byte_strides, box, swizzle);
}

// A (D, T, H, B) tensor map of a (B, T, H, 64) view with element strides
// st[0..2] = (b, t, h), read in boxes of 64 rows with 128-byte swizzle: bf16
// 64 wide (one 128-byte swizzle row), fp32 32 wide (a row is two boxes, at
// d 0 and 32).  A dimension of extent 1 gets its contiguous stride (its own
// is never used).
inline bool encode_view(CUtensorMap* map, const void* ptr, int B, int T,
                        int H, const long long* st, bool fp32 = false) {
  constexpr int kD = 64, kRows = 64;
  const long long sb = B > 1 ? st[0] : static_cast<long long>(T) * H * kD;
  const long long stt = T > 1 ? st[1] : static_cast<long long>(H) * kD;
  const long long sh = H > 1 ? st[2] : kD;
  const int size = fp32 ? 4 : 2;
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stt) * size,
                                 static_cast<cuuint64_t>(sh) * size,
                                 static_cast<cuuint64_t>(sb) * size};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / size), kRows, 1,
                             1};
  return encode_tiled(map,
                      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      ptr, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace sm90

// AdaIN conv pass, backward data: written by hand for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/decoder_kernels.py::_bwd_data_kernel (the
// pallas_call in _bwd_data_mod_pass, used by adain_conv_block_bwd_pallas).
//
// What it computes, for the cotangent dc (B, T, C_out) of one pass's conv
// output, the pass's input x (B, T, C) with its per-frame or global
// scale/shift (B, T, C) / (B, C) and instance statistics mean/rstd (B, C)
// fp32, and the pass's weight w (K, C, C_out) (the JAX layout) with
// dilation d:
//   da[t, c] = sum_k sum_o dc[t + k d - halo, o] w[K-1-k, c, o],
//              halo = (K-1)d/2, dc = 0 outside [0, T)
//              (conv backward-data: the forward's tap products over the
//              flipped, transposed weight);
//   dh[t, c] = da[t, c] * silu'(u),  u = (x - mean) * rstd * (1 + scale)
//              + shift, silu'(u) = sig(u) (1 + u (1 - sig(u))),
// sums in fp32, dh in dc's dtype: the Pallas kernel's rounding points.
// The weight is read flipped where it lies: tap k's product takes
// w[K-1-k] as (c, o) rows, o contiguous, so no flipped weight is built per
// call.
//
// What bounds it on this card: at the train step's shapes (B 16, T 1024,
// C = C_out = 512, K 5) one pass does 43 GFLOP of products and moves
// ~84 MB (dc, x, scale, shift read once, dh written once), so it is bound
// by operations: ~43 us at the bf16 tensor-core peak.
//
// Two variants, chosen by dtype:
//  - bf16 (the train step): adain_bwd_data_sm90_kernel, row 6's core
//    (csrc/adain_conv.cu adain_conv_sm90_kernel) turned around.  One block
//    (two warpgroups, 256 threads, one block an SM) owns 128 frames x 256
//    input channels c of one batch row; each warpgroup owns 64 frames:
//    wgmma.m64n256k16 with 128 fp32 accumulators a thread.  The reduction
//    over o (C_out) is walked in stages of 16 channels (one k-step) in a
//    ring of five stages on mbarriers (46 KB each: as many as the 227 KB a
//    block may use holds), requested by TMA three stages ahead: the stage's
//    window of 128 + 2 halo frames of dc (rows outside [0, T) arrive as
//    zeros) and the weight slab w[0..K-1, n0 .. n0 + 255, o0 .. o0 + 15]
//    (40 KB).  wgmma's A is the window as it lies, K-major without swizzle
//    in 16-byte rows of 8 channels, tap k's shift of k d frames a
//    descriptor start k d rows further (row 6's reading of its x window);
//    B is tap K-1-k's (c, o) rows of the slab, K-major, each row's 16
//    channels (32 bytes) under TMA's 32-byte swizzle.  B is four times A's
//    bytes a product: read unswizzled, as 16-byte columns 20 KB apart, it
//    held the kernel at 0.165 ms at the train step's shape against 0.106
//    swizzled (timed on an H100 SXM while building it).  Nothing runs
//    before the products, so the threads only wait for a stage, issue its
//    five products, and retire the stage before; a block barrier per stage
//    tells the loading thread that both warpgroups retired the stage it
//    refills.  Under the last stages' products every thread asks L2 for the
//    epilogue's x / scale / shift rows (prefetch.global.L2); after the
//    products the accumulators go through shared memory (fp32, the ring's
//    room) so that the epilogue reads x, scale, shift and the statistics
//    as coalesced 16-byte rows, recomputes silu'(u) branch-free
//    (__fdividef, as row 6's modulation found it needed), multiplies it in
//    fp32 and rounds once to bf16.  K 5, a halo of at most 18, C_out % 16,
//    C % 256 (kernels/adain_conv.py::_check_sm90_bwd).
//  - fp32: exact FMAs on the CUDA cores, 64 x 64 per block, each of 256
//    threads owning a 4 x 4 tile (the fp32 card path is held to the CPU's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

// the pass's modulation recomputed, then silu'
__device__ __forceinline__ float dsilu_mod(float x, float mean, float rstd,
                                           float sc, float sh) {
  const float u = (x - mean) * rstd * (1.f + sc) + sh;
  const float sig = 1.f / (1.f + expf(-u));
  return sig * (1.f + u * (1.f - sig));
}

// The same for the bf16 variant, whose result is rounded to bf16 next: the
// sigmoid's quotient by __fdividef (within 2 ulp, no slow-path branch); for
// 1 + e^-u past 2^126 it gives 0 where the sigmoid is below 1e-38.
__device__ __forceinline__ float dsilu_mod_bf16(float x, float mean,
                                                float rstd, float sc,
                                                float sh) {
  const float u = (x - mean) * rstd * (1.f + sc) + sh;
  const float sig = __fdividef(1.f, 1.f + expf(-u));
  return sig * (1.f + u * (1.f - sig));
}

// ---------------------------------------------------------------------------
// bf16 variant: wgmma on TMA-fed shared memory
// ---------------------------------------------------------------------------

using namespace sm90;

union Vec8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

constexpr int kBM = 128;                  // frames a block: 64 a warpgroup (M)
constexpr int kBN = 256;                  // input channels c a block (N)
constexpr int kCK = 16;                   // channels o a stage: a k-step
constexpr int kK = 5;                     // taps (the decoder's K)
constexpr int kMaxHalo = 18;              // K 5 at dilation 9
constexpr int kRows = 168;                // >= kBM + 2 kMaxHalo, 8 | kRows
constexpr int kStages = 5;
constexpr int kLookahead = 3;             // stages requested ahead of use
constexpr int kThreads = 256;             // two warpgroups
constexpr int kWRowBytes = kCK * 2;       // 16 o of a (tap, c) row
constexpr int kWTapBytes = kBN * kWRowBytes;
constexpr int kWBytes = kK * kWTapBytes;  // the stage's weight slab
constexpr int kColBytes = kRows * 16;     // 8 o of every window row
constexpr int kStageBytes = kWBytes + 2 * kColBytes;
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kSmem = 256 + kBarOffset + 8 * kStages;   // + 256 to align
constexpr int kLdC = kBN + 8;             // fp32 epilogue rows: 8-byte
                                          // stores of a warp on 2 wavefronts
constexpr int kPrefetchAhead = 4;         // stages before the last at which
                                          // the epilogue's rows go to L2
static_assert(kRows >= kBM + 2 * kMaxHalo && kRows % 8 == 0, "window rows");
static_assert(kStageBytes % 256 == 0, "stages on the 32-byte swizzle's "
              "256-byte atom");
static_assert(kSmem <= 232448, "fits the 227 KB a block may use");
static_assert(kBM * kLdC * 4 <= kBarOffset, "the epilogue fits the ring");
static_assert(kStages >= kLookahead + 2, "a stage is reloaded two stages "
              "after its products were issued");

// Stage s of the ring (256-byte aligned):
//   [0, kWBytes)  w[k, n0 .. n0 + 255, o0 .. o0 + 15]: K taps x 256 (c) rows
//                 of 32 bytes (16 o) with 32-byte swizzle, tap k at
//                 k kWTapBytes;
//   then dc's window, two columns of kRows 16-byte rows without swizzle:
//   o0 .. o0 + 7 of window rows 0 .. rows - 1 (frame t0 - halo + row),
//   then o0 + 8 .. o0 + 15.
__global__ void __launch_bounds__(kThreads, 1)
adain_bwd_data_sm90_kernel(const __grid_constant__ CUtensorMap tm_dc,
                           const __grid_constant__ CUtensorMap tm_w,
                           const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ sc,
                           const __nv_bfloat16* __restrict__ sh,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           __nv_bfloat16* __restrict__ out, int T, int C,
                           int C_out, int dil, long long x_sb, long long x_st,
                           long long s_sb, long long s_st, long long h_sb,
                           long long h_st) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 255u) & ~255u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + kBarOffset;

  const int halo = (kK - 1) * dil / 2;
  const int rows = kBM + 2 * halo;
  const int t0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int n_chunks = C_out / kCK;
  const uint32_t tx_bytes = kWBytes + 2 * rows * 16;

  auto stage = [&](int s) { return base + s * kStageBytes; };
  auto window = [&](int s) { return stage(s) + kWBytes; };
  // reduction channels i kCK .. i kCK + 15 into stage s (one thread)
  auto load = [&](int s, int i) {
    const uint32_t bar = full0 + 8 * s;
    const int o0 = i * kCK;
    mbar_expect_tx(bar, tx_bytes);
    tma_load_3d(stage(s), &tm_w, bar, o0, n0, 0);
    for (int col = 0; col < 2; ++col)
      tma_load_3d(window(s) + col * kColBytes, &tm_dc, bar, o0 + 8 * col,
                  t0 - halo, b);
  };

  const __nv_bfloat16* xb = x + b * x_sb;
  const __nv_bfloat16* scb = sc + b * s_sb;
  const __nv_bfloat16* shb = sh + b * h_sb;
  // the epilogue's rows of x, scale and shift into L2: 128-byte lines
  auto prefetch_epilogue = [&]() {
    for (int v = tid; v < kBM * (kBN / 64); v += kThreads) {
      const int t = t0 + v / (kBN / 64);
      if (t >= T) continue;
      const int c = n0 + 64 * (v % (kBN / 64));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(xb + t * x_st + c));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(scb + t * s_st + c));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(shb + t * h_st + c));
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init_fence();
    for (int i = 0; i < kLookahead && i < n_chunks; ++i) load(i, i);
  }
  __syncthreads();

  // acc[4j + 2r + e]: frame t0 + 64 wg + 16 warp + lane/4 + 8r, input
  // channel n0 + 8j + 2(lane%4) + e; defined by the first product
  float acc[128];

  // Stage i: the barrier tells the loading thread (in the second
  // warpgroup, so the first issues its products undelayed) that both
  // warpgroups retired stage i - 2, whose room then takes stage i + 3; then
  // stage i's kK tap products, one m64n256k16 each, and stage i - 1's
  // retired.  Nothing but wgmma touches the accumulators in the loop.
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kStages;
    named_barrier_sync(1, kThreads);
    if (tid == kThreads - 128 && i + kLookahead < n_chunks)
      load((i + kLookahead) % kStages, i + kLookahead);
    if (i == n_chunks - kPrefetchAhead) prefetch_epilogue();
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kK; ++k)
      wgmma_n256_kk(acc,
                    smem_desc(window(s) + (64 * wg + k * dil) * 16,
                              kColBytes, 128, 0),
                    smem_desc(stage(s) + (kK - 1 - k) * kWTapBytes, 256, 3),
                    i > 0 || k > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the accumulators into shared memory (the ring is free once both
  // warpgroups' products are done), fp32 rows of kLdC
  __syncthreads();
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 64 * wg + 16 * warp + lane / 4 + 8 * r;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<float2*>(cs + row * kLdC + 8 * j + 2 * (lane % 4)) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
  __syncthreads();

  // dh = da * silu'(u): each thread takes 8 channels of a frame at a time
  const float* mb = mean + static_cast<long long>(b) * C;
  const float* rb = rstd + static_cast<long long>(b) * C;
  __nv_bfloat16* ob = out + static_cast<long long>(b) * T * C;
  constexpr int kVB = kBN / 8;
#pragma unroll 2
  for (int v = tid; v < kBM * kVB; v += kThreads) {
    const int r = v / kVB;
    const int j = (v % kVB) * 8;
    const int t = t0 + r, c = n0 + j;
    if (t >= T) continue;
    Vec8 xv, sv, bv, yv;
    xv.u = *reinterpret_cast<const uint4*>(xb + t * x_st + c);
    sv.u = *reinterpret_cast<const uint4*>(scb + t * s_st + c);
    bv.u = *reinterpret_cast<const uint4*>(shb + t * h_st + c);
    const float4 m0 = *reinterpret_cast<const float4*>(mb + c);
    const float4 m1 = *reinterpret_cast<const float4*>(mb + c + 4);
    const float4 r0 = *reinterpret_cast<const float4*>(rb + c);
    const float4 r1 = *reinterpret_cast<const float4*>(rb + c + 4);
    const float4 a0 = *reinterpret_cast<const float4*>(cs + r * kLdC + j);
    const float4 a1 = *reinterpret_cast<const float4*>(cs + r * kLdC + j + 4);
    const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
    const float rv[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      yv.h[e] = __float2bfloat16(
          av[e] * dsilu_mod_bf16(__bfloat162float(xv.h[e]), mv[e], rv[e],
                                 __bfloat162float(sv.h[e]),
                                 __bfloat162float(bv.h[e])));
    *reinterpret_cast<uint4*>(ob + static_cast<long long>(t) * C + c) = yv.u;
  }
}

// The tensor maps: dc (B, T, C_out) contiguous in unswizzled 8-channel x
// rows boxes; w (K, C, C_out) contiguous in 16-channel x 256 x K boxes with
// 32-byte swizzle.  Returns a cudaError_t.
int launch_bf16(const void* dc, const void* x, const void* scale,
                const void* shift, const float* mean, const float* rstd,
                const void* w, void* out, int B, int T, int C, int C_out,
                int K, int dil, long long x_sb, long long x_st, long long s_sb,
                long long s_st, long long h_sb, long long h_st,
                cudaStream_t stream) {
  const int halo = (K - 1) * dil / 2;
  const int rows = kBM + 2 * halo;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (K != kK || halo > kMaxHalo || C_out % kCK != 0 || C % kBN != 0 ||
      !aligned(dc) || !aligned(x) || !aligned(scale) || !aligned(shift) ||
      !aligned(w) || !aligned(mean) || !aligned(rstd) || !aligned(out) ||
      (s_st != 0) != (h_st != 0))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_dc, tm_w;
  const cuuint64_t dc_dims[3] = {static_cast<cuuint64_t>(C_out),
                                 static_cast<cuuint64_t>(T),
                                 static_cast<cuuint64_t>(B)};
  const cuuint64_t dc_strides[2] = {
      static_cast<cuuint64_t>(C_out) * 2,
      static_cast<cuuint64_t>(T) * C_out * 2};
  const cuuint32_t dc_box[3] = {8, static_cast<cuuint32_t>(rows), 1};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(C_out),
                                static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(K)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(C_out) * 2,
                                   static_cast<cuuint64_t>(C) * C_out * 2};
  const cuuint32_t w_box[3] = {kCK, kBN, static_cast<cuuint32_t>(K)};
  if (!encode_bf16(&tm_dc, dc, 3, dc_dims, dc_strides, dc_box,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_bf16(&tm_w, w, 3, w_dims, w_strides, w_box,
                   CU_TENSOR_MAP_SWIZZLE_32B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      adain_bwd_data_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kBM - 1) / kBM, C / kBN, B);
  adain_bwd_data_sm90_kernel<<<grid, kThreads, kSmem, stream>>>(
      tm_dc, tm_w, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(shift), mean, rstd,
      static_cast<__nv_bfloat16*>(out), T, C, C_out, dil, x_sb, x_st, s_sb,
      s_st, h_sb, h_st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core variant
// ---------------------------------------------------------------------------

constexpr int kFM = 64;             // frames per block
constexpr int kFN = 64;             // output channels per block
constexpr int kFK = 16;             // reduction channels per chunk
constexpr int kFThreads = 256;      // 16 x 16, each 4 frames x 4 channels
constexpr int kFLdA = kFK + 1;

__global__ void __launch_bounds__(kFThreads)
adain_bwd_data_f32_kernel(const float* __restrict__ dc,
                          const float* __restrict__ x,
                          const float* __restrict__ sc,
                          const float* __restrict__ sh,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const float* __restrict__ w, float* __restrict__ out,
                          int T, int C, int C_out, int K, int dil,
                          long long x_sb, long long x_st, long long s_sb,
                          long long s_st, long long h_sb, long long h_st) {
  extern __shared__ float fsmem[];
  const int halo = (K - 1) * dil / 2;
  const int rows = kFM + 2 * halo;
  float* As = fsmem;                   // [rows][kFLdA]
  float* Bs = As + rows * kFLdA;       // [K][kFK][kFN]

  const int t0 = blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* dcb = dc + (long long)b * T * C_out;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;

  for (int o0 = 0; o0 < C_out; o0 += kFK) {
    __syncthreads();
    for (int e = tid; e < rows * kFK; e += kFThreads) {
      const int r = e / kFK, i = e % kFK;
      const int t = t0 - halo + r, o = o0 + i;
      As[r * kFLdA + i] =
          (t >= 0 && t < T && o < C_out) ? dcb[(long long)t * C_out + o] : 0.f;
    }
    for (int e = tid; e < K * kFK * kFN; e += kFThreads) {
      const int k = e / (kFK * kFN);
      const int i = (e / kFN) % kFK;
      const int j = e % kFN;
      const int o = o0 + i, c = n0 + j;
      Bs[e] = (o < C_out && c < C)
                  ? w[((long long)(K - 1 - k) * C + c) * C_out + o]
                  : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      const float* Ak = As + (ty + k * dil) * kFLdA;
      const float* Bk = Bs + k * kFK * kFN + tx;
#pragma unroll 4
      for (int i = 0; i < kFK; ++i) {
        float av[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = Ak[16 * a * kFLdA + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bk[i * kFN + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(av[a], bv[j], acc[a][j]);
      }
    }
  }

  const float* xb = x + b * x_sb;
  const float* scb = sc + b * s_sb;
  const float* shb = sh + b * h_sb;
  const float* mb = mean + (long long)b * C;
  const float* rb = rstd + (long long)b * C;
  float* ob = out + (long long)b * T * C;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0 + ty + 16 * a;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < C)
        ob[(long long)t * C + c] =
            acc[a][j] * dsilu_mod(xb[t * x_st + c], mb[c], rb[c],
                                  scb[t * s_st + c], shb[t * h_st + c]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  dc is contiguous (B, T, C_out); x,
// scale and shift have a contiguous channel dimension and (b, t) strides in
// elements (a global scale or shift has a t stride of 0); mean and rstd are
// contiguous (B, C) fp32; w is contiguous (K, C, C_out) in dc's dtype; out
// contiguous (B, T, C).  K odd and (K-1)*dilation even.  bf16 needs K 5, a
// halo of at most 18 frames, C_out % 16 == 0, C % 256 == 0, 16-byte aligned
// pointers and strides in multiples of 8, and scale and shift both
// time-varying or both global (the wrapper checks).  Returns a cudaError_t
// (0 on success).
extern "C" int adain_conv_bwd_data(int dtype, const void* dc, const void* x,
                                   const void* scale, const void* shift,
                                   const float* mean, const float* rstd,
                                   const void* w, void* out, int B, int T,
                                   int C, int C_out, int K, int dilation,
                                   long long x_sb, long long x_st,
                                   long long s_sb, long long s_st,
                                   long long h_sb, long long h_st,
                                   void* stream) {
  if (K % 2 != 1 || ((K - 1) * dilation) % 2 != 0 || T < 1 || C < 1 ||
      C_out < 1)
    return (int)cudaErrorInvalidValue;
  const int halo = (K - 1) * dilation / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(dc, x, scale, shift, mean, rstd, w, out, B, T, C,
                       C_out, K, dilation, x_sb, x_st, s_sb, s_st, h_sb, h_st,
                       st);
  if (dtype == 0) {
    const size_t smem = sizeof(float) * ((size_t)(kFM + 2 * halo) * kFLdA +
                                         (size_t)K * kFK * kFN);
    cudaError_t err = cudaFuncSetAttribute(
        adain_bwd_data_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + kFM - 1) / kFM, (C + kFN - 1) / kFN, B);
    adain_bwd_data_f32_kernel<<<grid, kFThreads, smem, st>>>(
        static_cast<const float*>(dc), static_cast<const float*>(x),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        mean, rstd, static_cast<const float*>(w), static_cast<float*>(out), T,
        C, C_out, K, dilation, x_sb, x_st, s_sb, s_st, h_sb, h_st);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks per SM and dynamic shared memory per block of the bf16 kernel.
// Returns a cudaError_t.
extern "C" int adain_conv_bwd_data_occupancy(int* blocks_per_sm,
                                             int* smem_bytes) {
  *smem_bytes = kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      adain_bwd_data_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, adain_bwd_data_sm90_kernel, kThreads, kSmem);
}

// Fused AdaIN -> SiLU -> dilated conv pass, written by hand for Hopper
// (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/decoder_kernels.py::_mod_conv_kernel
// (the pallas_call in _mod_conv_pass, wrapper adain_conv_block_pallas).
//
// What it computes, for x (B, T, C), per-frame or global scale/shift
// (B, T, C) / (B, C), instance statistics mean/rstd (B, C) fp32 and a
// K-tap weight w (K, C, C_out) (the JAX layout) with dilation d:
//   h[t, c] = silu((x - mean) * rstd * (1 + scale) + shift)   in fp32,
//             0 for t outside [0, T), rounded once to x's dtype;
//   y[t, o] = sum_k sum_c h[t + k d - halo, c] w[k, c, o],  halo = (K-1)d/2,
// accumulated in fp32 and stored in x's dtype: the Pallas kernel's
// rounding points (not the XLA twin's, which rounds the AdaIN output to the
// compute dtype before the SiLU).
//
// What bounds it on this card: at the 1-step batch-32 shape (B 32, T 1024,
// C 512, C_out 512, K 5) one pass does 86 GFLOP of products and moves
// ~134 MB (x, a time-varying scale and shift read once, y written once;
// 40 us at 3.35 TB/s), so it is bound by operations: ~87 us at the bf16
// tensor-core peak (~52 us at the long-form B 4, T 4864), ~1.3 ms at the
// fp32 CUDA-core peak.
//
// Two variants, chosen by dtype:
//  - bf16 (every model path): adain_conv_sm90_kernel.  One block (two
//    warpgroups, 256 threads, one block an SM) owns 128 frames x 256 output
//    channels of one batch row, so each frame's modulation is computed by
//    two blocks (C_out 512), not by each of four.  Each warpgroup owns 64
//    frames: wgmma.m64n256k16 with 128 fp32 accumulators a thread.  The
//    A tensor-parallel chunk of 128 output channels (C_out % 256 != 0)
//    takes the same kernel with a block of 128 channels on
//    wgmma.m64n128k16 (64 accumulators a thread).  The
//    input channels are walked in stages of 16 (one k-step), in a ring of
//    four stages on mbarriers, requested by TMA two stages ahead: the
//    weight's K taps (128-byte swizzle, MN-major: o is contiguous in the
//    JAX layout) and the window of 128 + 2 halo frames of x, and of a
//    time-varying scale and shift (their strided views read in place),
//    with the 16 channels' statistics by bulk copies (global style, a t
//    stride of 0, which a tensor map cannot express, comes the same way
//    from its (C) row).  The threads then modulate the window in place
//    into h (each element once, rows outside [0, T) set to 0) and every
//    tap's product reads it as it lies: wgmma's A operand is K-major
//    without swizzle, rows 16 bytes apart, so tap k's shift of k d frames
//    is a descriptor start k d rows further (the window is read once, not
//    copied per tap).  The products are asynchronous: the threads modulate
//    stage i while stage i - 1's products run, then issue stage i's and
//    retire stage i - 1's.  The epilogue writes bf16 pairs from the
//    accumulators.
//    What the overlap needed (timed on an H100 SXM while building it): the
//    SiLU's quotient without IEEE division's slow-path branch
//    (mod_silu_bf16), which had kept each thread's elements one after the
//    other; the statistics in the stage, not read from global memory per
//    chunk; and accumulators defined by the first product (scale-d 0),
//    not zeroed by the threads, without which the modulation did not
//    overlap the products at all.  What is left: the products alone run
//    well below the tensor cores' peak at this tile size and ring depth,
//    and the modulation's arithmetic is not wholly hidden behind them.
//  - fp32: exact FMAs on the CUDA cores (the fp32 card path is held to the
//    CPU's), 64 x 64 per block, each of 256 threads owning a 4 x 4 tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

// the pass's prologue: AdaIN modulation then SiLU, in fp32
__device__ __forceinline__ float mod_silu(float x, float mean, float rstd,
                                          float sc, float sh) {
  const float v = (x - mean) * rstd * (1.f + sc) + sh;
  return v / (1.f + expf(-v));
}

// The same for the bf16 variant, whose result is rounded to bf16 next: the
// quotient by __fdividef (within 2 ulp of fp32 division), whose code has no
// branch, so a thread's eight elements interleave; IEEE division's slow-path
// branch kept them one after the other and made the modulation, not the
// products, the kernel's critical path.  For 1 + e^-v past 2^126 it gives
// 0 where silu is below 1e-36 in magnitude.
__device__ __forceinline__ float mod_silu_bf16(float x, float mean,
                                               float rstd, float sc,
                                               float sh) {
  const float v = (x - mean) * rstd * (1.f + sc) + sh;
  return __fdividef(v, 1.f + expf(-v));
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
constexpr int kCK = 16;                   // input channels a stage: a k-step
constexpr int kK = 5;                     // taps (the decoder's K)
constexpr int kMaxHalo = 18;              // K 5 at dilation 9
constexpr int kRows = 168;                // >= kBM + 2 kMaxHalo, 8 | kRows
constexpr int kStages = 4;
constexpr int kLookahead = 2;             // chunks requested ahead of use
constexpr int kThreads = 256;             // two warpgroups
constexpr int kWTapBytes = kCK * 128;     // one tap of one 64-channel box
constexpr int kColBytes = kRows * 16;     // 8 channels of every window row
constexpr int kTileBytes = 2 * kColBytes; // x, scale or shift of a stage
constexpr int kStatsBytes = 2 * kCK * 4 + 2 * kCK * 2;   // mean, rstd (fp32)
                                                          // and global style
static_assert(kRows >= kBM + 2 * kMaxHalo && kRows % 8 == 0, "window rows");
static_assert(kStages >= kLookahead + 2, "a stage is reloaded two chunks "
              "after its products were issued");

// The layout for kBN output channels a block (N): 256 (wgmma.m64n256k16)
// wherever C_out % 256 == 0, else 128 (m64n128k16: a tensor-parallel chunk
// of 128 channels), with the same stages, ring and window.
template <int kBN>
struct Tile {
  static constexpr int kNB = kBN / 64;    // the weight's 64-channel boxes
  static constexpr int kWBytes = kNB * kK * kWTapBytes;
  static constexpr int kStatsOffset = kWBytes + 3 * kTileBytes;  // the tail
  static constexpr int kStageBytes =
      (kStatsOffset + kStatsBytes + 1023) / 1024 * 1024;
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * kStages;
  static_assert(kBN == 128 || kBN == 256, "a wgmma N of 128 or 256");
  static_assert(kSmem <= 232448, "fits the 227 KB a block may use");
};

// Stage s of the ring (1024-byte aligned, the weight's swizzle atom):
//   [0, kWBytes)   w[k, c0 .. c0 + 15, n0 .. n0 + kBN - 1]: kNB boxes of K
//                  taps x 16 rows x 64 channels (128 bytes, 128-byte
//                  swizzle), box
//                  nb at nb K kWTapBytes, tap k at k kWTapBytes within it;
//   then x, scale and shift (the last two with time-varying style only),
//   each two columns of kRows 16-byte rows: channels c0 .. c0 + 7 of window
//   rows 0 .. rows - 1 (frame t0 - halo + row), then c0 + 8 .. c0 + 15;
//   then the 16 channels' mean and rstd (fp32) and, with global style,
//   their scale and shift (bf16), by bulk copies.
// x's tile is modulated in place into h, wgmma's A: K-major, no swizzle,
// rows 16 bytes apart, so a tap's shift k d is a start k d rows further.
template <int kBN, bool kTimeVarying>
__global__ void __launch_bounds__(kThreads, 1)
adain_conv_sm90_kernel(const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_sc,
                       const __grid_constant__ CUtensorMap tm_sh,
                       const __nv_bfloat16* __restrict__ sc,
                       const __nv_bfloat16* __restrict__ sh,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       __nv_bfloat16* __restrict__ out, int T, int C,
                       int C_out, int dil, long long s_sb, long long h_sb) {
  using L = Tile<kBN>;
  constexpr int kNB = L::kNB, kWBytes = L::kWBytes;
  constexpr int kStatsOffset = L::kStatsOffset;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + L::kBarOffset;

  const int halo = (kK - 1) * dil / 2;
  const int rows = kBM + 2 * halo;
  const int t0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int n_chunks = C / kCK;
  const uint32_t tx_bytes = kWBytes +
                            (kTimeVarying ? 3 : 1) * 2 * rows * 16 +
                            (kTimeVarying ? 2 * kCK * 4 : kStatsBytes);

  auto stage = [&](int s) { return base + s * L::kStageBytes; };
  // which: 0 x (then h), 1 scale, 2 shift
  auto tile = [&](int s, int which) {
    return stage(s) + kWBytes + which * kTileBytes;
  };
  // input channels i kCK .. i kCK + 15 into stage s (one thread)
  auto load = [&](int s, int i) {
    const uint32_t bar = full0 + 8 * s;
    const int c0 = i * kCK;
    mbar_expect_tx(bar, tx_bytes);
    for (int nb = 0; nb < kNB; ++nb)
      tma_load_3d(stage(s) + nb * kK * kWTapBytes, &tm_w, bar, n0 + 64 * nb,
                  c0, 0);
    for (int col = 0; col < 2; ++col) {
      // window rows past [0, T) arrive as zeros (and become h = 0 below)
      tma_load_3d(tile(s, 0) + col * kColBytes, &tm_x, bar, c0 + 8 * col,
                  t0 - halo, b);
      if constexpr (kTimeVarying) {
        tma_load_3d(tile(s, 1) + col * kColBytes, &tm_sc, bar, c0 + 8 * col,
                    t0 - halo, b);
        tma_load_3d(tile(s, 2) + col * kColBytes, &tm_sh, bar, c0 + 8 * col,
                    t0 - halo, b);
      }
    }
    const uint32_t stats = stage(s) + kStatsOffset;
    const long long bc = static_cast<long long>(b) * C + c0;
    bulk_load(stats, mean + bc, kCK * 4, bar);
    bulk_load(stats + kCK * 4, rstd + bc, kCK * 4, bar);
    if constexpr (!kTimeVarying) {   // a t stride of 0: one (C) row
      bulk_load(stats + 2 * kCK * 4, sc + b * s_sb + c0, kCK * 2, bar);
      bulk_load(stats + 2 * kCK * 4 + kCK * 2, sh + b * h_sb + c0, kCK * 2,
                bar);
    }
  };

  // h = silu((x - mean) rstd (1 + scale) + shift) in fp32, rounded once to
  // bf16, 0 outside [0, T): each thread takes 16-byte rows of the stage's
  // window (the whole block shares the window, each element done once)
  auto modulate = [&](int s) {
    unsigned char* xs = smem + (tile(s, 0) - base);
    const float* stats =
        reinterpret_cast<const float*>(smem + (stage(s) - base) + kStatsOffset);
#pragma unroll 2
    for (int v = tid; v < 2 * rows; v += kThreads) {
      const int col = v >= rows;
      const int r = v - col * rows;
      const int t = t0 - halo + r;
      unsigned char* px = xs + col * kColBytes + r * 16;
      Vec8 hv;
      hv.u = make_uint4(0u, 0u, 0u, 0u);
      if (t >= 0 && t < T) {
        Vec8 xv, sv, bv;
        xv.u = *reinterpret_cast<const uint4*>(px);
        if constexpr (kTimeVarying) {
          sv.u = *reinterpret_cast<const uint4*>(px + kTileBytes);
          bv.u = *reinterpret_cast<const uint4*>(px + 2 * kTileBytes);
        } else {
          const uint4* g = reinterpret_cast<const uint4*>(stats + 2 * kCK);
          sv.u = g[col];
          bv.u = g[2 + col];
        }
        const float4* ms = reinterpret_cast<const float4*>(stats + 8 * col);
        const float4 m0 = ms[0], m1 = ms[1];
        const float4 r0 = ms[kCK / 4], r1 = ms[kCK / 4 + 1];
        const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
        const float rv[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          hv.h[e] = __float2bfloat16(mod_silu_bf16(
              __bfloat162float(xv.h[e]), mv[e], rv[e],
              __bfloat162float(sv.h[e]), __bfloat162float(bv.h[e])));
      }
      *reinterpret_cast<uint4*>(px) = hv.u;
    }
    fence_proxy_async();   // h is read by wgmma (the async proxy)
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init_fence();
    for (int i = 0; i < kLookahead && i < n_chunks; ++i) load(i, i);
  }
  __syncthreads();

  // acc[4j + 2r + e]: frame t0 + 64 wg + 16 warp + lane/4 + 8r, output
  // channel n0 + 8j + 2(lane%4) + e; defined by the first product
  float acc[kBN / 2];

  // Chunk i: modulate its window (while chunk i - 1's products run), then
  // issue its kK tap products, one m64n256k16 (m64n128k16) each, and
  // retire chunk i - 1's.  The block barrier after the modulation also
  // tells the loading thread (in the second warpgroup, so the first issues
  // its products undelayed) that both warpgroups retired chunk i - 2, whose
  // stage then takes chunk i + 2.  Nothing but wgmma touches the accumulators in the
  // loop (ptxas would serialise the products otherwise).
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kStages;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);
    modulate(s);
    named_barrier_sync(1, kThreads);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const uint64_t da = smem_desc(tile(s, 0) + (64 * wg + k * dil) * 16,
                                    kColBytes, 128, 0);
      const uint64_t db = smem_desc(stage(s) + k * kWTapBytes,
                                    kWBytes / kNB, 1024, 1);
      if constexpr (kBN == 256)
        wgmma_n256_kmn(acc, da, db, i > 0 || k > 0);
      else
        wgmma_n128_kmn(acc, da, db, i > 0 || k > 0);
    }
    wgmma_commit();
    if (tid == kThreads - 128 && i + kLookahead < n_chunks)
      load((i + kLookahead) % kStages, i + kLookahead);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // bf16 pairs straight from the fragment: each store instruction of a warp
  // writes 16 contiguous bytes of 8 frames
  __nv_bfloat16* ob = out + static_cast<long long>(b) * T * C_out + n0 +
                      2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + 64 * wg + 16 * warp + lane / 4 + 8 * r;
    if (t >= T) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(
        ob + static_cast<long long>(t) * C_out);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      row[4 * j] = pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// The tensor maps: w (K, C, C_out) contiguous in 64 x 16 x K boxes with
// 128-byte swizzle; x and a time-varying scale/shift (B, T, C) with element
// strides (b, t) and contiguous channels in unswizzled 8-channel x rows
// boxes.  A dimension of extent 1 gets a dense stride.  A block owns 256
// output channels where C_out % 256 == 0, else 128.  Returns a cudaError_t.
template <int kBN>
int launch_bf16_tile(const void* x, const void* scale, const void* shift,
                const float* mean, const float* rstd, const void* w,
                void* out, int B, int T, int C, int C_out, int K, int dil,
                long long x_sb, long long x_st, long long s_sb,
                long long s_st, long long h_sb, long long h_st,
                cudaStream_t stream) {
  const int halo = (K - 1) * dil / 2;
  const int rows = kBM + 2 * halo;
  const bool time_varying = s_st != 0;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (K != kK || halo > kMaxHalo || C % kCK != 0 || C_out % kBN != 0 ||
      !aligned(x) || !aligned(scale) || !aligned(shift) || !aligned(w) ||
      !aligned(mean) || !aligned(rstd) || time_varying != (h_st != 0))
    return (int)cudaErrorInvalidValue;
  auto bt_map = [&](CUtensorMap* map, const void* p, long long sb,
                    long long st) {
    if (T == 1) st = C;
    if (B == 1) sb = static_cast<long long>(T) * st;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(st) * 2,
                                   static_cast<cuuint64_t>(sb) * 2};
    const cuuint32_t box[3] = {8, static_cast<cuuint32_t>(rows), 1};
    return encode_bf16(map, p, 3, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  CUtensorMap tm_w, tm_x, tm_sc, tm_sh;
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(C_out),
                                static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(K)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(C_out) * 2,
                                   static_cast<cuuint64_t>(C) * C_out * 2};
  const cuuint32_t w_box[3] = {64, kCK, static_cast<cuuint32_t>(K)};
  bool ok = encode_bf16(&tm_w, w, 3, w_dims, w_strides, w_box,
                        CU_TENSOR_MAP_SWIZZLE_128B) &&
            bt_map(&tm_x, x, x_sb, x_st);
  if (time_varying)
    ok = ok && bt_map(&tm_sc, scale, s_sb, s_st) &&
         bt_map(&tm_sh, shift, h_sb, h_st);
  else
    tm_sc = tm_sh = tm_x;   // unused: global style is read by the threads
  if (!ok) return (int)cudaErrorInvalidValue;
  auto* kernel = time_varying ? adain_conv_sm90_kernel<kBN, true>
                              : adain_conv_sm90_kernel<kBN, false>;
  constexpr int kSmem = Tile<kBN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kBM - 1) / kBM, C_out / kBN, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      tm_w, tm_x, tm_sc, tm_sh, static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(shift), mean, rstd,
      static_cast<__nv_bfloat16*>(out), T, C, C_out, dil, s_sb, h_sb);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* scale, const void* shift,
                const float* mean, const float* rstd, const void* w,
                void* out, int B, int T, int C, int C_out, int K, int dil,
                long long x_sb, long long x_st, long long s_sb,
                long long s_st, long long h_sb, long long h_st,
                cudaStream_t stream) {
  auto* launch = C_out % 256 == 0 ? launch_bf16_tile<256>
                                  : launch_bf16_tile<128>;
  return launch(x, scale, shift, mean, rstd, w, out, B, T, C, C_out, K, dil,
                x_sb, x_st, s_sb, s_st, h_sb, h_st, stream);
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core variant
// ---------------------------------------------------------------------------

constexpr int kFM = 64;             // frames per block
constexpr int kFN = 64;             // output channels per block
constexpr int kFK = 16;             // input channels per chunk
constexpr int kFThreads = 256;      // 16 x 16, each 4 frames x 4 channels
constexpr int kFLdA = kFK + 1;

__global__ void __launch_bounds__(kFThreads)
adain_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ sc,
                      const float* __restrict__ sh,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      const float* __restrict__ w, float* __restrict__ out,
                      int T, int C, int C_out, int K, int dil, long long x_sb,
                      long long x_st, long long s_sb, long long s_st,
                      long long h_sb, long long h_st) {
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

  const float* xb = x + b * x_sb;
  const float* scb = sc + b * s_sb;
  const float* shb = sh + b * h_sb;
  const float* mb = mean + (long long)b * C;
  const float* rb = rstd + (long long)b * C;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kFK) {
    __syncthreads();
    for (int e = tid; e < rows * kFK; e += kFThreads) {
      const int r = e / kFK, i = e % kFK;
      const int t = t0 - halo + r, c = c0 + i;
      float h = 0.f;
      if (t >= 0 && t < T && c < C)
        h = mod_silu(xb[t * x_st + c], mb[c], rb[c], scb[t * s_st + c],
                     shb[t * h_st + c]);
      As[r * kFLdA + i] = h;
    }
    for (int e = tid; e < K * kFK * kFN; e += kFThreads) {
      const int k = e / (kFK * kFN);
      const int i = (e / kFN) % kFK;
      const int j = e % kFN;
      const int c = c0 + i, o = n0 + j;
      Bs[e] = (c < C && o < C_out) ? w[((long long)k * C + c) * C_out + o] : 0.f;
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

  float* ob = out + (long long)b * T * C_out;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0 + ty + 16 * a;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tx + 16 * j;
      if (o < C_out) ob[(long long)t * C_out + o] = acc[a][j];
    }
  }
}


}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, scale and shift have a contiguous
// channel dimension and (b, t) strides in elements; a global scale or shift
// has a t stride of 0.  mean and rstd are contiguous (B, C) fp32, w is
// contiguous (K, C, C_out) in x's dtype, out contiguous (B, T, C_out).
// K is odd and (K-1)*dilation even (a symmetric halo).  bf16 needs K 5,
// a halo of at most 18 frames, C % 16 == 0, C_out % 128 == 0, 16-byte
// aligned pointers and strides in multiples of 8, and scale and shift both
// time-varying or both global (the wrapper checks).  Returns a cudaError_t
// (0 on success).
extern "C" int adain_conv_fwd(int dtype, const void* x, const void* scale,
                              const void* shift, const float* mean,
                              const float* rstd, const void* w, void* out,
                              int B, int T, int C, int C_out, int K,
                              int dilation, long long x_sb, long long x_st,
                              long long s_sb, long long s_st, long long h_sb,
                              long long h_st, void* stream) {
  if (K % 2 != 1 || ((K - 1) * dilation) % 2 != 0 || T < 1 || C < 1 ||
      C_out < 1)
    return (int)cudaErrorInvalidValue;
  const int halo = (K - 1) * dilation / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(x, scale, shift, mean, rstd, w, out, B, T, C, C_out,
                       K, dilation, x_sb, x_st, s_sb, s_st, h_sb, h_st, st);
  if (dtype == 0) {
    const size_t smem = sizeof(float) * ((size_t)(kFM + 2 * halo) * kFLdA +
                                         (size_t)K * kFK * kFN);
    cudaError_t err = cudaFuncSetAttribute(
        adain_conv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + kFM - 1) / kFM, (C_out + kFN - 1) / kFN, B);
    adain_conv_f32_kernel<<<grid, kFThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(shift), mean, rstd,
        static_cast<const float*>(w), static_cast<float*>(out), T, C, C_out, K,
        dilation, x_sb, x_st, s_sb, s_st, h_sb, h_st);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks per SM and dynamic shared memory per block of the bf16 kernel.
// Returns a cudaError_t.
extern "C" int adain_conv_fwd_occupancy(int* blocks_per_sm,
                                        int* smem_bytes) {
  constexpr int kSmem = Tile<256>::kSmem;
  *smem_bytes = kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      adain_conv_sm90_kernel<256, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, adain_conv_sm90_kernel<256, true>, kThreads, kSmem);
}

// Stride-r transposed 1-D conv (the vocoder's upsampling), written by hand
// for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/vocoder_kernels.py::_shift_matmul_kernel
// (the pallas_call in _shift_matmul, wrapper conv_transpose1d_pallas).
//
// What it computes, for x (B, T, Cin) and a kernel w (K, Cin, Cout) in the
// JAX layout, stride r and the HiFi-GAN trim p = (K - r) / 2:
//   out[q r + phi, o] = sum_m sum_c a[q - m, c] Kf[phi + p + m r, c, o],
// Kf = w flipped on its taps (Kf[j] = w[K-1-j]), over the m with
// 0 <= phi + p + m r < K, a = x or leaky_relu(x, slope) (rounded to x's
// dtype, as a separate leaky_relu would round it), a = 0 outside [0, T);
// summed in fp32 and stored in x's dtype, in (B, Cout, T r) memory: the
// layout the vocoder's resblock convs (cuDNN, channels first) read without
// a copy, and in which their residual adds stay vectorised.
//
// What bounds it on this card: each output phase uses only its own taps,
// K/r = 2 of the K = 10 at the vocoder's r = 5, so the useful work is
// 2 B T K Cin Cout FLOP: 86 GFLOP at the 1-step batch-32 stage 1 (32 x 1024
// frames, 512 -> 256 channels; 87 us at the bf16 tensor-core peak) against
// 32 + 84 MB moved (35 us at 3.35 TB/s), 107 GFLOP at stage 2 (32 x 5120,
// 256 -> 128; 109 us) against 84 + 210 MB (88 us): bound by the tensor
// cores, with the bytes close behind at stage 2.  The kernel takes 2.4-2.9x
// that bound on an H100 SXM (chip_smoke.py); what holds it there is not L2
// traffic but the frames-major window copy and the epilogue, which nothing
// overlaps at one block an SM.
//
// Two variants, chosen by dtype:
//  - bf16 (every model path): conv_transpose_sm90_kernel, for K 10 and r 5.
//    One block (two warpgroups, 256 threads, one block an SM) owns 64
//    output channels x 128 frames of one batch row and all r = 5 phases of
//    them, so it writes contiguous runs of 640 output samples a channel.
//    Each phase is a GEMM of depth 2 Cin: M = the 64 output channels, N =
//    the frames (64 a warpgroup), its two taps the two shifted copies of
//    the input window.  Per stage of 32 input channels, TMA brings the ten
//    tap tiles (64 x 32, straight from the (K, Cin, Cout) weight, MN-major:
//    wgmma's A with the transpose bit, 128-byte swizzle) and the window,
//    into a ring of three stages on mbarriers.  wgmma reads the window as
//    three K-major copies (rows = frames, 32 channels of 64 bytes, 64-byte
//    swizzle), one per tap shift m in {-1, 0, 1}.
//    The one-frame shift: along frames a shift is a whole row of a K-major
//    copy, but a 2-byte offset along the frames-contiguous layout the
//    vocoder hands over, which neither a wgmma descriptor nor a swizzle can
//    express, and a TMA box starts on 16 bytes along the contiguous
//    dimension (an odd frame coordinate is an illegal instruction).  So:
//    channels-last x: one TMA box per copy at frame q0 - m (rows, so any
//    frame); TMA's zero fill past [0, T) is the function's zero padding.
//    (B, C, T)-major x: one unswizzled TMA box of frames q0 - 8 .. q0 + 136
//    (16-byte aligned; the halo holds the shifts; zero fill past [0, T)),
//    which each warpgroup transposes into its own part of the three copies,
//    a thread reading two frames x 8 channels once and storing them as
//    16-byte rows of every copy that holds them.
//    The leaky ReLU runs once per staged element: in that transposing pass,
//    or in place on the channels-last copies (elementwise, so the swizzle
//    does not matter; leaky(0) = 0 keeps the zero fill), rounded to bf16 as
//    the plain version rounds it, before fence.proxy.async and the first
//    wgmma that reads it.  Each warpgroup issues 20 wgmma.m64n64k16 a stage
//    (5 phases x 2 taps x 2 k-steps) into five fp32 accumulators of 32
//    registers (160 a thread; 209 registers in all).  The warpgroups
//    synchronise with named barriers of their own and issue their products
//    in turns, so one prepares its copies while the other's products run;
//    the one that releases a stage last issues its reload.
//    The phase interleave is done in registers: a thread holds frames f,
//    f+1 of a channel for every phase, i.e. 10 consecutive output samples,
//    which it writes as five bf16 pairs into a shared-memory tile; the
//    block then stores each channel's 1280 contiguous bytes with 16-byte
//    writes (no stride-r stores for the L2 to merge).
//    Tried and not kept (slower at all four vocoder shapes on an H100
//    SXM): the window copies made by the whole block between the two
//    warpgroups' products; a producer warp beside the two warpgroups
//    (wgmma allocates registers by warpgroup, so 288 threads cap a thread
//    at 168 and the accumulators spill); two stages.  Halving the weight
//    tiles' bytes changed nothing.
//  - fp32: exact FMAs on the CUDA cores, 64 x 64 per block, each of 256
//    threads owning a 4 x 4 tile, one block per (frame tile, phase,
//    channel tile), any K >= r and any strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

// The taps of phase phi: m in [m_lo, m_hi], i.e. 0 <= phi + p + m r < K.
struct Phase {
  int m_lo, m_hi;
};
__device__ __forceinline__ Phase phase_taps(int phi, int p, int r, int K) {
  return {-((phi + p) / r), (K - 1 - phi - p) / r};
}

// ---------------------------------------------------------------------------
// bf16 variant: wgmma on TMA-fed shared memory
// ---------------------------------------------------------------------------

using namespace sm90;

constexpr int kR = 5;                       // stride
constexpr int kK = 10;                      // taps
constexpr int kP = (kK - kR) / 2;           // trim
constexpr int kMinM = -((kR - 1 + kP) / kR);  // tap shifts m in [kMinM, kMaxM]
constexpr int kMaxM = (kK - 1 - kP) / kR;
constexpr int kShifts = kMaxM - kMinM + 1;  // window copies a stage: 3
constexpr int kBM = 64;                     // output channels a block (M)
constexpr int kWN = 64;                     // frames a warpgroup (N)
constexpr int kWGs = 2;
constexpr int kBN = kWGs * kWN;             // frames a block
constexpr int kCK = 32;                     // input channels a stage
constexpr int kStages = 3;
constexpr int kThreads = 128 * kWGs;
constexpr int kTapBytes = kCK * kBM * 2;    // one tap's 32 x 64 tile
constexpr int kWBytes = kK * kTapBytes;
constexpr int kXTileBytes = kWN * kCK * 2;  // one copy, one warpgroup: 64 rows
constexpr int kXBytes = kShifts * kWGs * kXTileBytes;
// The (B, C, T)-major window as TMA can cut it: box starts on 16 bytes, so
// frames q0 - 8 .. q0 + kBN + 8 (the halo the shifts need, rounded), one
// row of kHaloW frames a channel, unswizzled.
constexpr int kHalo = 8;
constexpr int kHaloW = kBN + 2 * kHalo;
constexpr int kRawBytes = kCK * kHaloW * 2;
constexpr int kStageBytes = kWBytes + kXBytes + kRawBytes;
constexpr int kBarOffset = kStages * kStageBytes;
// + 1024 to align the ring; a full barrier and a release counter a stage
constexpr int kSmem = 1024 + kBarOffset + 16 * kStages;
constexpr int kOutRow = kR * kBN;           // output samples a channel row
constexpr int kStgStride = 2 * kOutRow + 16;  // bytes: rows 4 banks apart
static_assert(kBM * kStgStride <= kBarOffset, "staging fits in the ring");
static_assert(kStageBytes % 1024 == 0 && kTapBytes % 1024 == 0 &&
                  kXTileBytes % 1024 == 0,
              "swizzle atoms stay aligned");
static_assert(kHalo >= 2 && kMinM == -1 && kMaxM == 1,
              "the frames-major copy takes shifts -1, 0, 1 and a halo of 2");

// Weight tap j (w[j] = Kf[K-1-j]) serves phase tap_phase(j) at shift
// tap_m(j): K - 1 - j = phi + p + m r.
__host__ __device__ constexpr int tap_phase(int j) {
  return ((kK - 1 - j - kP) % kR + kR) % kR;
}
__host__ __device__ constexpr int tap_m(int j) {
  return (kK - 1 - j - kP - tap_phase(j)) / kR;
}

#define CT_D32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define CT_D32_OPS(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d += A B, m64n64k16: A MN-major (the transpose bit) and B K-major, both
// in shared memory.
__device__ __forceinline__ void wgmma_acc(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CT_D32
      ", %32, %33, p, 1, 1, 1, 0;\n"
      "}\n"
      : CT_D32_OPS(d)
      : "l"(da), "l"(db), "r"(1));
}

#undef CT_D32
#undef CT_D32_OPS

// leaky_relu of two bf16, in fp32, rounded back as the plain version rounds
__device__ __forceinline__ uint32_t leaky2(uint32_t v, float slope) {
  float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  if (!(f.x > 0.f)) f.x *= slope;
  if (!(f.y > 0.f)) f.y *= slope;
  return pack_bf16(f.x, f.y);
}

// kFramesMajor: x is the vocoder's (B, C, T)-major view; else channels
// last.  Either way wgmma reads three K-major copies of the window, one per
// tap shift, rows = frames, 32 channels (64 bytes) a row, 64-byte swizzle.
// Warpgroup g owns the frames q0 + 64 g .. q0 + 64 g + 63: it prepares its
// own copies of a stage and then runs its products, synchronised with its
// own warps alone (a named barrier), so while one warpgroup prepares, the
// other's products have the tensor cores.  The warpgroup that releases a
// stage last issues its reload.
template <bool kFramesMajor>
__global__ void __launch_bounds__(kThreads, 1)
conv_transpose_sm90_kernel(const __grid_constant__ CUtensorMap tm_w,
                           const __grid_constant__ CUtensorMap tm_x,
                           __nv_bfloat16* __restrict__ out, int T, int C_in,
                           int C_out, int leaky, float slope) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle: 1024
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + kBarOffset;        // TMA landed
  int* released = reinterpret_cast<int*>(smem + kBarOffset + 8 * kStages);

  const int n0 = blockIdx.x * kBM;
  const int q0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int wtid = tid % 128;   // thread within the warpgroup
  const int n_chunks = (C_in + kCK - 1) / kCK;

  auto stage = [&](int s) { return base + s * kStageBytes; };
  // the window copy of shift m = kMinM + sh for warpgroup g's frames
  auto x_tile = [&](int s, int sh, int g) {
    return stage(s) + kWBytes + (sh * kWGs + g) * kXTileBytes;
  };
  // chunk i of the input channels into stage s
  auto load = [&](int s, int i) {
    const uint32_t bar = full0 + 8 * s;
    const int c0 = i * kCK;
    if constexpr (kFramesMajor) {
      // TMA starts a box on 16 bytes along the contiguous dimension, and a
      // shift is 2: one raw window with the halo, which the warpgroups copy
      mbar_expect_tx(bar, kWBytes + kRawBytes);
      tma_load_3d(stage(s), &tm_w, bar, n0, c0, 0);   // all K taps
      tma_load_3d(stage(s) + kWBytes + kXBytes, &tm_x, bar, q0 - kHalo, c0,
                  b);
    } else {   // rows are frames: each shift is its own box
      mbar_expect_tx(bar, kWBytes + kXBytes);
      tma_load_3d(stage(s), &tm_w, bar, n0, c0, 0);
#pragma unroll
      for (int sh = 0; sh < kShifts; ++sh)
#pragma unroll
        for (int g = 0; g < kWGs; ++g)
          tma_load_3d(x_tile(s, sh, g), &tm_x, bar, c0,
                      q0 + kWN * g - (kMinM + sh), b);  // m reads a[q - m]
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      released[s] = 0;
    }
    mbar_init_fence();
    for (int s = 0; s < kStages && s < n_chunks; ++s) load(s, s);
  }
  __syncthreads();

  // acc[phi][4j + 2r + e]: output channel n0 + 16 warp + lane/4 + 8r,
  // frame q0 + 64 wg + 8j + 2(lane%4) + e, sample (frame) r + phi
  float acc[kR][32];
#pragma unroll
  for (int phi = 0; phi < kR; ++phi)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[phi][i] = 0.f;

  {

    // Warpgroup wg's window copies of stage s, ready for wgmma: the leaky
    // ReLU applied once per staged element (in place for channels-last;
    // for the frames-major view, while transposing the raw window into the
    // K-major copies), then the writes made visible to the async proxy.
    auto prepare = [&](int s) {
      unsigned char* xs = smem + (stage(s) - base) + kWBytes;
      if constexpr (kFramesMajor) {
        const unsigned char* rawx = xs + kXBytes;
        // thread: frames f, f+1 of its warpgroup (f even; the lanes of a
        // warp take neighbouring pairs, so each 32-bit load is
        // conflict-free) and 8 channels cg (one a warp), read once,
        // activated once, and stored as 16-byte rows into each copy that
        // holds them (copy m puts frame f at row f + m); lanes 0 and 31
        // also take the halo frame that copy m = +1 (-1) needs at row 0
        // (63)
        const int k = wtid % 32, cg = wtid / 32;
        const int f = kWN * wg + 2 * k;             // frame relative to q0
        const unsigned char* src = rawx + (8 * cg * kHaloW + f + kHalo) * 2;
        uint32_t lo[4], hi[4];                       // frame f, frame f + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t c0 = *reinterpret_cast<const uint32_t*>(
              src + 2 * e * kHaloW * 2);
          const uint32_t c1 = *reinterpret_cast<const uint32_t*>(
              src + (2 * e + 1) * kHaloW * 2);
          const uint32_t a0 = leaky ? leaky2(c0, slope) : c0;
          const uint32_t a1 = leaky ? leaky2(c1, slope) : c1;
          lo[e] = __byte_perm(a0, a1, 0x5410);       // channels 2e, 2e+1
          hi[e] = __byte_perm(a0, a1, 0x7632);
        }
        auto put = [&](int sh, int r, const uint32_t* v) {
          *reinterpret_cast<uint4*>(
              xs + (sh * kWGs + wg) * kXTileBytes + r * 2 * kCK +
              ((cg ^ ((r >> 1) & 3)) << 4)) = make_uint4(v[0], v[1], v[2], v[3]);
        };
#pragma unroll
        for (int sh = 0; sh < kShifts; ++sh)
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const int r = 2 * k + d + kMinM + sh;    // row of copy m
            if (r >= 0 && r < kWN) put(sh, r, d ? hi : lo);
          }
        if (k == 0 || k == 31) {
          const int e0 = k == 0 ? -1 : 2;            // frame f - 1 or f + 2
          const unsigned short* h =
              reinterpret_cast<const unsigned short*>(src) + e0;
          uint32_t v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t c = h[2 * e * kHaloW] | (uint32_t(h[(2 * e + 1) * kHaloW]) << 16);
            v[e] = leaky ? leaky2(c, slope) : c;
          }
          put(k == 0 ? kShifts - 1 : 0, k == 0 ? 0 : kWN - 1, v);
        }
      } else {
        if (!leaky) return;
#pragma unroll
        for (int sh = 0; sh < kShifts; ++sh) {
          unsigned char* tile = xs + (sh * kWGs + wg) * kXTileBytes;
          for (int v = wtid; v < kXTileBytes / 16; v += 128) {
            uint4 u = *reinterpret_cast<uint4*>(tile + 16 * v);
            u.x = leaky2(u.x, slope);
            u.y = leaky2(u.y, slope);
            u.z = leaky2(u.z, slope);
            u.w = leaky2(u.w, slope);
            *reinterpret_cast<uint4*>(tile + 16 * v) = u;
          }
        }
      }
      fence_proxy_async();
    };

    // The warpgroups issue their products in turns (named barriers 3 and
    // 4: "warpgroup 0 / 1 may issue"), so one prepares while the other's
    // products run; warpgroup 1 lets warpgroup 0 go first.
    if (wg == 1) named_barrier_arrive(3, 256);
    for (int i = 0; i < n_chunks; ++i) {
      const int st = i % kStages;
      mbar_wait(full0 + 8 * st, (i / kStages) & 1);
      prepare(st);
      named_barrier_sync(1 + wg, 128);   // this warpgroup's copies are in
      named_barrier_sync(3 + wg, 256);   // its turn
#pragma unroll
      for (int phi = 0; phi < kR; ++phi) fence_regs(acc[phi]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          // A: tap j, rows of 16 input channels (2048 bytes), MN-major;
          // B: the copy of the tap's shift, 16 channels (32 bytes) a k-step
          const uint64_t da =
              smem_desc(stage(st) + j * kTapBytes + kk * 2048, 1024, 1);
          const uint64_t db = smem_desc(
              x_tile(st, tap_m(j) - kMinM, wg) + kk * 32, 512, 2);
          wgmma_acc(acc[tap_phase(j)], da, db);
        }
      wgmma_commit();
      if (wg == 0 || i + 1 < n_chunks) named_barrier_arrive(4 - wg, 256);
      wgmma_wait_all();
#pragma unroll
      for (int phi = 0; phi < kR; ++phi) fence_regs(acc[phi]);
      named_barrier_sync(1 + wg, 128);   // the warpgroup is done with st
      if (wtid == 0 && i + kStages < n_chunks &&
          atomicAdd(&released[st], 1) == kWGs - 1) {   // the last one
        released[st] = 0;
        load(st, i + kStages);
      }
    }
  }
  __syncthreads();   // every warpgroup is done with the ring

  // The phase interleave: a thread's frames f, f+1 of a channel are the
  // output samples r f .. r f + 2r - 1, written as r bf16 pairs into a
  // (64 channels x 640 samples) tile over the consumed ring.
  unsigned char* stg = smem;
  {
    const int quad = lane % 4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + lane / 4 + 8 * r;
        const int f = kWN * wg + 8 * j + 2 * quad;
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(stg + row * kStgStride + 2 * kR * f);
#pragma unroll
        for (int u = 0; u < kR; ++u)
          dst[u] = pack_bf16(acc[(2 * u) % kR][4 * j + 2 * r + (2 * u) / kR],
                             acc[(2 * u + 1) % kR][4 * j + 2 * r + (2 * u + 1) / kR]);
      }
  }
  __syncthreads();
  // each channel's samples r q0 .. r (q0 + 128) - 1 are contiguous in out:
  // 16-byte stores, the ragged last frame tile cut at T (T % 8 == 0, so a
  // 16-byte vector lies wholly inside or outside)
  const long long T_out = static_cast<long long>(T) * kR;
  const int valid = min(kBN, T - q0) * kR;
  constexpr int kVecs = kOutRow / 8;
  for (int v = tid; v < kBM * kVecs; v += kThreads) {
    const int row = v / kVecs, c = v % kVecs;
    if (8 * c < valid)
      *reinterpret_cast<uint4*>(
          out + (static_cast<long long>(b) * C_out + n0 + row) * T_out +
          static_cast<long long>(q0) * kR + 8 * c) =
          *reinterpret_cast<const uint4*>(stg + row * kStgStride + 16 * c);
  }
}

// The tensor maps: w (K, Cin, Cout) contiguous in 64 x 32 x K boxes; x
// (B, T, Cin) with element strides (sb, st, sc): frames contiguous (st ==
// 1, the vocoder's view) in unswizzled boxes of kHaloW frames x 32
// channels, or channels contiguous (sc == 1) in 32-channel x 64-frame
// boxes with 64-byte swizzle.  A dimension of extent 1 gets a dense
// stride.  Returns a cudaError_t.
int launch_bf16(const void* x, const void* w, void* out, int B, int T,
                int C_in, int C_out, long long sb, long long st,
                long long sc, int leaky, float slope, cudaStream_t stream) {
  const bool frames_major = st == 1 && (sc % 8 == 0 || C_in == 1);
  const bool channels_last = !frames_major && sc == 1 && st % 8 == 0;
  if (C_out % kBM != 0 || T % 8 != 0 || (B > 1 && sb % 8 != 0) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      !(frames_major || channels_last))
    return (int)cudaErrorInvalidValue;
  if (B == 1) sb = static_cast<long long>(T) * C_in;
  CUtensorMap tm_w, tm_x;
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(C_out),
                                static_cast<cuuint64_t>(C_in), kK};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(C_out) * 2,
                                   static_cast<cuuint64_t>(C_in) * C_out * 2};
  const cuuint32_t w_box[3] = {kBM, kCK, kK};
  if (!encode_bf16(&tm_w, w, 3, w_dims, w_strides, w_box,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const cuuint64_t x_strides[2] = {
      static_cast<cuuint64_t>(frames_major ? (C_in > 1 ? sc : T) : st) * 2,
      static_cast<cuuint64_t>(sb) * 2};
  bool ok;
  if (frames_major) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(C_in),
                                static_cast<cuuint64_t>(B)};
    const cuuint32_t box[3] = {kHaloW, kCK, 1};
    ok = encode_bf16(&tm_x, x, 3, dims, x_strides, box,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C_in),
                                static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B)};
    const cuuint32_t box[3] = {kCK, kWN, 1};
    ok = encode_bf16(&tm_x, x, 3, dims, x_strides, box,
                     CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  dim3 grid(C_out / kBM, (T + kBN - 1) / kBN, B);
  auto* kernel = frames_major ? conv_transpose_sm90_kernel<true>
                              : conv_transpose_sm90_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, kSmem, stream>>>(
      tm_w, tm_x, static_cast<__nv_bfloat16*>(out), T, C_in, C_out, leaky,
      slope);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core variant
// ---------------------------------------------------------------------------

constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;
constexpr int kFThreads = 256;      // 16 x 16, each 4 frames x 4 channels
constexpr int kFLdA = kFK + 1;

__global__ void __launch_bounds__(kFThreads)
conv_transpose_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w, float* __restrict__ out,
                          int T, int C_in, int C_out, int K, int r, int p,
                          int span, long long x_sb, long long x_st,
                          long long x_sc, int leaky, float slope) {
  extern __shared__ float fsmem[];
  float* As = fsmem;                          // [kFM + span][kFLdA]
  float* Bs = As + (kFM + span) * kFLdA;      // [taps][kFK][kFN]

  const int q0 = (blockIdx.x / r) * kFM;
  const int phi = blockIdx.x % r;
  const int n0 = blockIdx.y * kFN;
  const int b = blockIdx.z;
  const Phase ph = phase_taps(phi, p, r, K);
  const int n_taps = ph.m_hi - ph.m_lo + 1;
  const int rows = kFM + ph.m_hi - ph.m_lo;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* xb = x + b * x_sb;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;

  for (int c0 = 0; c0 < C_in; c0 += kFK) {
    __syncthreads();
    // the window a[q0 - m_hi + rho, c0 + i], the threads along time
    for (int e = tid; e < rows * kFK; e += kFThreads) {
      const int rho = e % rows, i = e / rows;
      const int q = q0 - ph.m_hi + rho, c = c0 + i;
      float a = 0.f;
      if (q >= 0 && q < T && c < C_in) {
        a = xb[q * x_st + c * x_sc];
        if (leaky && !(a > 0.f)) a *= slope;
      }
      As[rho * kFLdA + i] = a;
    }
    for (int e = tid; e < n_taps * kFK * kFN; e += kFThreads) {
      const int j = e / (kFK * kFN);
      const int i = (e / kFN) % kFK;
      const int o = n0 + e % kFN;
      const int c = c0 + i;
      const int tap = K - 1 - (phi + p + (ph.m_lo + j) * r);
      Bs[e] = (c < C_in && o < C_out) ? w[((long long)tap * C_in + c) * C_out + o] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < n_taps; ++j) {
      const float* Aj = As + (ty + ph.m_hi - (ph.m_lo + j)) * kFLdA;
      const float* Bj = Bs + j * kFK * kFN + tx;
#pragma unroll 4
      for (int i = 0; i < kFK; ++i) {
        float av[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = Aj[16 * a * kFLdA + i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bv[jj] = Bj[i * kFN + 16 * jj];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[a][jj] = fmaf(av[a], bv[jj], acc[a][jj]);
      }
    }
  }

  const long long T_out = (long long)T * r;
  float* ob = out + (long long)b * C_out * T_out;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = q0 + ty + 16 * a;
    if (q >= T) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int o = n0 + tx + 16 * jj;
      if (o < C_out) ob[o * T_out + (long long)q * r + phi] = acc[a][jj];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, T, C_in) with strides (in
// elements) x_sb, x_st, x_sc; w contiguous (K, C_in, C_out) in x's dtype;
// out contiguous (B, C_out, T*r).  leaky != 0 applies leaky_relu(x, slope)
// on the load.  fp32: any K >= r and any strides.  bf16: K 10, r 5,
// C_out % 64 == 0, T % 8 == 0, x and w 16-byte aligned, x with frames
// (x_st == 1) or channels (x_sc == 1) contiguous and its other strides in
// multiples of 8 (the wrapper checks).  Returns a cudaError_t (0 on
// success).
extern "C" int conv_transpose_fwd(int dtype, const void* x, const void* w,
                                  void* out, int B, int T, int C_in, int C_out,
                                  int K, int r, long long x_sb, long long x_st,
                                  long long x_sc, int leaky, float slope,
                                  void* stream) {
  if (T < 1 || C_in < 1 || C_out < 1 || r < 1 || K < r)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (K != kK || r != kR) return (int)cudaErrorInvalidValue;
    return launch_bf16(x, w, out, B, T, C_in, C_out, x_sb, x_st, x_sc, leaky,
                       slope, st);
  }
  if (dtype == 0) {
    const int p = (K - r) / 2;
    int span = 0;   // the most taps of any phase, less one
    for (int phi = 0; phi < r; ++phi) {
      const int s = (K - 1 - phi - p) / r + (phi + p) / r;
      span = s > span ? s : span;
    }
    const size_t smem = sizeof(float) * ((size_t)(kFM + span) * kFLdA +
                                         (size_t)(span + 1) * kFK * kFN);
    cudaError_t err = cudaFuncSetAttribute(
        conv_transpose_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + kFM - 1) / kFM * r, (C_out + kFN - 1) / kFN, B);
    conv_transpose_f32_kernel<<<grid, kFThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), T, C_in, C_out, K, r, p, span, x_sb, x_st,
        x_sc, leaky, slope);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks per SM and dynamic shared memory per block of the bf16 kernel.
// Returns a cudaError_t.
extern "C" int conv_transpose_fwd_occupancy(int* blocks_per_sm,
                                            int* smem_bytes) {
  *smem_bytes = kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      conv_transpose_sm90_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, conv_transpose_sm90_kernel<true>, kThreads, kSmem);
}

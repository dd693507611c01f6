// Fused vocoder synthesis head, written by hand for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/vocoder_kernels.py::_synth_head_kernel
// (the pallas_call in synthesis_head_pallas).
//
// What it computes, for x (B, T, C) and a K-tap head conv w (K, C, 3F) + b,
// F = n_fft/2 + 1:
//   h        = leaky_relu(x, 0.1)                       (in x's dtype)
//   y        = round_to_x_dtype(round_to_x_dtype(conv_SAME(h, w)) + b)
//   mag      = exp(clip(y[:F], -12, 6)),  n = rsqrt(pc^2 + ps^2 + 1e-7)
//   real     = mag * pc * n,  imag = mag * ps * n       (fp32; frames < T)
//   wav      = overlap_add([real | imag] @ syn, hop) * inv_env,
// trimmed by n_fft/2 on the left to (T-1)*hop samples, fp32.  syn is the
// (2F, n_fft) windowed irfft basis and inv_env = 1/max(envelope, 1e-8); the
// wrapper builds both in numpy once and copies them to the card.
//
// What bounds it on this card: at the main path's shapes (B 32, T 25600,
// C 128, K 7, n_fft 48, hop 12) it reads 210 MB of bf16 x and writes 39 MB
// of fp32 audio (~75 us at 3.35 TB/s), but the conv does 7*128*75 MACs per
// frame, ~110 GFLOP in all: bound by operations (~0.11 ms at the bf16
// tensor-core peak).
//
// Two kernels, output-stationary (a block writes whole samples, so the
// overlap-add needs no atomics; nothing between x and the waveform goes to
// device memory):
//  - bf16 at the vocoder's geometry (C 128, K 7, n_fft 48, hop 12) with
//    frames contiguous, the (B, C, T)-major view the vocoder's convs hand
//    over (every model path): synth_head_sm90_kernel.  One block an SM
//    (two warpgroups) keeps the 143 KB weight in shared memory, loaded
//    once, and walks tiles of 120 output frames.  A tile needs the spectra
//    of 123 frames (3 before its first) and the conv's 3-frame halo: TMA
//    brings one unswizzled window of 136 frames x 128 channels starting on
//    a 16-byte boundary (zeros past [0, T)), the next tile's while this
//    one is computed; the threads transpose it into K-major rows with the
//    leaky ReLU (a one-frame shift is 2 bytes along the view's contiguous
//    dimension, which neither TMA nor a wgmma descriptor can start on).
//    The conv is 56 wgmma.m64n80k16 a warpgroup: A the K-major rows
//    without swizzle, 16 bytes apart, so tap k is a start k rows further;
//    B the weight, K-major with 128-byte swizzle, its 75 columns permuted
//    (head_column) so that a thread's accumulators hold the
//    log-magnitude, cos and sin of its bins and the epilogue runs from
//    registers (one shuffle for bin 24).  The spectra overwrite the
//    consumed rows; the overlap-add runs on the CUDA cores in fp32,
//    register-tiled (two frames x three phases a thread, so a float4 of a
//    spectrum row serves three phases and one of the basis two frames).
//    The tile's steps run one after the other (the resident weight leaves
//    no room for a second set of rows or spectra); only the next window's
//    TMA overlaps them.  Tried and not kept: each frame's inverse DFT
//    first, written in place, then the four-frame sums (slower).
//  - any other shape, and fp32: synth_head_kernel<T, RO>, a register-tiled
//    FMA loop on the CUDA cores, 64 frames per block, each of the 256
//    threads owning 8 frames x RO output channels (columns tx + 32j),
//    weights in chunks of 32 input channels; exact fp32 sums, so the fp32
//    check is tight; x (B, T, C) contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 32;   // threads along output channels
constexpr int kTY = 8;    // threads along frames
constexpr int kRF = 8;    // frames per thread: NFc = FT + M - 1 <= 64
constexpr int kCC = 32;   // input channels per weight chunk
constexpr int kMaxFrames = kTY * kRF;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// leaky_relu(x, 0.1) rounded as the JAX twin rounds it: the negative branch
// is a product in x's dtype (0.1 itself rounded to bf16 for bf16 input)
__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : x * 0.1f; }
__device__ __forceinline__ float leaky(__nv_bfloat16 x) {
  const float xf = __bfloat162float(x);
  if (xf >= 0.f) return xf;
  const float slope = __bfloat162float(__float2bfloat16(0.1f));
  return __bfloat162float(__float2bfloat16(xf * slope));
}

// conv + bias, each rounded to the compute dtype before the fp32 epilogue
__device__ __forceinline__ float add_bias(float acc, float bias) { return acc + bias; }
__device__ __forceinline__ float add_bias(float acc, __nv_bfloat16 bias) {
  const float a = __bfloat162float(__float2bfloat16(acc));
  return __bfloat162float(__float2bfloat16(a + __bfloat162float(bias)));
}

struct HeadShape {
  int T, C, K, n_freq, n_fft, hop, M, FT, out_len;
};

__host__ __device__ inline int rows_of(const HeadShape& s) {
  return s.FT + s.M - 1 + s.K - 1;
}

template <int RO>
__host__ __device__ inline size_t smem_floats(const HeadShape& s) {
  const int nfc = s.FT + s.M - 1;
  const int nop = kTX * RO;
  const int xs = rows_of(s) * s.C;
  const int yb = nfc * nop;
  return (size_t)(xs > yb ? xs : yb) + kCC * nop + nfc * 2 * s.n_freq +
         2 * s.n_freq * s.n_fft;
}

template <typename T, int RO>
__global__ void __launch_bounds__(kThreads)
synth_head_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, const float* __restrict__ syn,
                  const float* __restrict__ inv_env, float* __restrict__ out,
                  HeadShape s) {
  extern __shared__ float smem[];
  constexpr int NOP = kTX * RO;
  const int NO = 3 * s.n_freq;
  const int F2 = 2 * s.n_freq;
  const int NFc = s.FT + s.M - 1;       // frames whose spectra this block needs
  const int NR = rows_of(s);            // input rows those frames need
  const int xs_size = NR * s.C > NFc * NOP ? NR * s.C : NFc * NOP;
  float* xs = smem;                     // [NR][C]; later yb [NFc][NOP]
  float* ws = xs + xs_size;             // [kCC][NOP]
  float* spec = ws + kCC * NOP;         // [NFc][2F]
  float* syn_s = spec + NFc * F2;       // [2F][n_fft]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * s.FT;     // first frame whose samples we own
  const int g0 = f0 - (s.M - 1);        // first spectrum frame
  const int r0 = g0 - (s.K - 1) / 2;    // first input row
  const T* xb = x + (long long)b * s.T * s.C;

  for (int idx = tid; idx < NR * s.C; idx += kThreads) {
    const int row = r0 + idx / s.C;
    xs[idx] = (row >= 0 && row < s.T) ? leaky(xb[(long long)row * s.C + idx % s.C]) : 0.f;
  }
  for (int idx = tid; idx < F2 * s.n_fft; idx += kThreads) syn_s[idx] = syn[idx];

  float acc[kRF][RO];
#pragma unroll
  for (int r = 0; r < kRF; ++r)
#pragma unroll
    for (int j = 0; j < RO; ++j) acc[r][j] = 0.f;

  for (int tap = 0; tap < s.K; ++tap) {
    for (int c0 = 0; c0 < s.C; c0 += kCC) {
      __syncthreads();
      for (int idx = tid; idx < kCC * NOP; idx += kThreads) {
        const int cc = idx / NOP, o = idx % NOP;
        ws[idx] = (o < NO && c0 + cc < s.C)
                      ? to_f(w[((long long)tap * s.C + c0 + cc) * NO + o])
                      : 0.f;
      }
      __syncthreads();
      const int cn = min(kCC, s.C - c0);
      for (int cc = 0; cc < cn; ++cc) {
        float av[kRF], wv[RO];
#pragma unroll
        for (int r = 0; r < kRF; ++r) {
          const int i = ty + kTY * r;
          av[r] = i < NFc ? xs[(i + tap) * s.C + c0 + cc] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < RO; ++j) wv[j] = ws[cc * NOP + tx + kTX * j];
#pragma unroll
        for (int r = 0; r < kRF; ++r)
#pragma unroll
          for (int j = 0; j < RO; ++j) acc[r][j] = fmaf(av[r], wv[j], acc[r][j]);
      }
    }
  }
  __syncthreads();  // xs is dead: reuse it for the conv output

  float* yb = xs;
#pragma unroll
  for (int r = 0; r < kRF; ++r) {
    const int i = ty + kTY * r;
#pragma unroll
    for (int j = 0; j < RO; ++j) {
      const int o = tx + kTX * j;
      if (i < NFc && o < NO) yb[i * NOP + o] = add_bias(acc[r][j], bias[o]);
    }
  }
  __syncthreads();

  for (int idx = tid; idx < NFc * s.n_freq; idx += kThreads) {
    const int i = idx / s.n_freq, kf = idx % s.n_freq;
    const int g = g0 + i;
    float re = 0.f, im = 0.f;
    if (g >= 0 && g < s.T) {
      const float lm = yb[i * NOP + kf];
      const float pc = yb[i * NOP + s.n_freq + kf];
      const float ps = yb[i * NOP + 2 * s.n_freq + kf];
      const float mag = expf(fminf(fmaxf(lm, -12.f), 6.f));
      const float nrm = rsqrtf(pc * pc + ps * ps + 1e-7f);
      re = mag * pc * nrm;
      im = mag * ps * nrm;
    }
    spec[i * F2 + kf] = re;
    spec[i * F2 + s.n_freq + kf] = im;
  }
  __syncthreads();

  const int start = s.n_fft / 2;
  float* ob = out + (long long)b * s.out_len;
  for (int idx = tid; idx < s.FT * s.hop; idx += kThreads) {
    const int jf = idx / s.hop, phi = idx % s.hop;
    const long long s_full = (long long)(f0 + jf) * s.hop + phi;
    const long long s_out = s_full - start;
    if (s_out < 0 || s_out >= s.out_len) continue;
    float a = 0.f;
    for (int m = 0; m < s.M; ++m) {
      const int n = phi + s.hop * m;
      if (n >= s.n_fft) break;
      const float* sp = spec + (jf + s.M - 1 - m) * F2;
      for (int kk = 0; kk < F2; ++kk) a = fmaf(sp[kk], syn_s[kk * s.n_fft + n], a);
    }
    ob[s_out] = a * inv_env[s_full];
  }
}

// ---------------------------------------------------------------------------
// bf16 variant at the vocoder's geometry: wgmma, the weight resident, TMA
// ---------------------------------------------------------------------------

using namespace sm90;

constexpr int kHC = 128;                   // input channels
constexpr int kHK = 7;                     // taps
constexpr int kHNfft = 48;
constexpr int kHHop = 12;
constexpr int kHFreq = kHNfft / 2 + 1;     // 25 bins
constexpr int kHN = 80;                    // 3 x 25 head outputs, padded: N
constexpr int kHM = (kHNfft - 1) / kHHop + 1;   // frames a sample sums: 4
constexpr int kHFT = 120;                  // output frames a tile (8 | kHFT)
constexpr int kHConv = 128;                // spectrum frames a tile, from
                                           // f0 - 3: 64 a warpgroup (M)
constexpr int kHRawW = 136;                // raw window: frames f0 - 8 ..
constexpr int kHOff = 2;                   // raw frame of K-major row 0,
                                           // frame f0 - 6 = f0 - 3 - halo
constexpr int kHRows = kHConv + kHK - 1;   // K-major rows the taps read: 134
constexpr int kHColBytes = 136 * 16;       // one 8-channel column of rows
constexpr int kHSpecLd = 52;               // a spectrum row: 25 re, 25 im,
                                           // 2 zeros (float4 reads)
constexpr int kHThreads = 256;
constexpr int kHTapBytes = 2 * kHN * 128;  // one tap: two 64-channel halves
constexpr int kHWBytes = kHK * kHTapBytes;
constexpr int kHRawOff = kHWBytes;
constexpr int kHRawBytes = kHC * kHRawW * 2;
constexpr int kHAOff = kHRawOff + kHRawBytes;
constexpr int kHABytes = (kHC / 8) * kHColBytes;
constexpr int kHSynOff = kHAOff + kHABytes;
constexpr int kHSynBytes = kHNfft * kHSpecLd * 4;
constexpr int kHBarOff = kHSynOff + kHSynBytes;
constexpr int kHSmem = 1024 + kHBarOff + 8;
static_assert(kHConv >= kHFT + kHM - 1 && kHFT % 8 == 0, "a tile's spectra");
static_assert(kHOff + kHRows <= kHRawW && 136 >= kHRows && kHOff % 2 == 0,
              "the raw window holds the rows, read as frame pairs");
static_assert(kHConv * kHSpecLd * 4 <= kHABytes,
              "the spectra fit over the K-major rows");
static_assert(kHSmem <= 232448, "fits the 227 KB a block may use");

// Column p = 8j + 2q + e of the product (lane quad q of a warp holds
// j = 0..9, e = 0..1 for two frames: slot s = 2j + e) holds head output
// head_column(p), so that a thread holds the log-magnitude, cos and sin of
// its bins together: lane q has bins 6q .. 6q + 5 in slots 0..17 (bin k's
// three outputs in three consecutive slots), lane 0 the log-magnitude and
// cos of bin 24 in slots 18-19 and lane 1 its sin in slot 18; -1 is a
// zero column.
__host__ __device__ constexpr int head_column(int p) {
  const int q = (p % 8) / 2, s = 2 * (p / 8) + p % 2;
  if (s < 18) return (s % 3) * kHFreq + 6 * q + s / 3;
  if (q == 0) return s == 18 ? kHFreq - 1 : 2 * kHFreq - 1;
  if (q == 1 && s == 18) return 3 * kHFreq - 1;
  return -1;
}

// leaky_relu(x, 0.1) of two bf16, rounded as `leaky` rounds
__device__ __forceinline__ uint32_t leaky2(uint32_t v) {
  const float slope = __bfloat162float(__float2bfloat16(0.1f));
  float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  if (!(f.x >= 0.f)) f.x *= slope;
  if (!(f.y >= 0.f)) f.y *= slope;
  return pack_bf16(f.x, f.y);
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// One block an SM walks the tiles tile = blockIdx.x, + gridDim.x, ... of
// kHFT output frames (tile % tiles_per_row of batch row tile /
// tiles_per_row) with the weight resident in shared memory.  Per tile:
// TMA brings the raw (B, C, T)-major window (prefetched during the previous
// tile); the threads transpose it into K-major rows with the leaky ReLU;
// each warpgroup runs its 64 spectrum frames' conv (7 taps x 8 k-steps of
// m64n80k16; tap k reads the rows from k on); the epilogue rounds conv and
// bias as the twin does and writes the spectra over the K-major rows; then
// the overlap-add.
__global__ void __launch_bounds__(kHThreads, 1)
synth_head_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ bias,
                       const float* __restrict__ syn,
                       const float* __restrict__ inv_env,
                       float* __restrict__ out, int T, int tiles_per_row,
                       int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle: 1024
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar = base + kHBarOff;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int q = lane % 4;
  const long long out_len = static_cast<long long>(T - 1) * kHHop;

  auto load = [&](int tile) {   // one thread; zeros past [0, T)
    const int b = tile / tiles_per_row, f0 = (tile % tiles_per_row) * kHFT;
    mbar_expect_tx(bar, kHRawBytes);
    tma_load_3d(base + kHRawOff, &tm_x, bar, f0 - 8, 0, b);
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    if (static_cast<int>(blockIdx.x) < n_tiles) load(blockIdx.x);
  }

  // The weight, once a block: w[k, c, head_column(p)] as row p of tap k's
  // K-major B (two halves of 64 channels, 128-byte rows, 128-byte swizzle);
  // a thread writes 8 channels of a row.
  for (int it = tid; it < kHK * (kHC / 8) * kHN; it += kHThreads) {
    const int p = it % kHN, cg = (it / kHN) % (kHC / 8);
    const int k = it / (kHN * (kHC / 8));
    const int o = head_column(p);
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (o >= 0) {
      const __nv_bfloat16* src =
          w + (static_cast<long long>(k) * kHC + 8 * cg) * (3 * kHFreq) + o;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = bits2(src[2 * e * 3 * kHFreq], src[(2 * e + 1) * 3 * kHFreq]);
    }
    *reinterpret_cast<uint4*>(smem + (2 * k + cg / 8) * kHN * 128 + p * 128 +
                              (((cg % 8) ^ (p % 8)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  // the synthesis basis transposed: synT[n][kk] = syn[kk][n], zero-padded
  float* synT = reinterpret_cast<float*>(smem + kHSynOff);
  for (int it = tid; it < kHNfft * kHSpecLd; it += kHThreads) {
    const int n = it / kHSpecLd, kk = it % kHSpecLd;
    synT[it] = kk < 2 * kHFreq ? syn[kk * kHNfft + n] : 0.f;
  }
  // this thread's columns' biases
  float bcol[20];
#pragma unroll
  for (int s = 0; s < 20; ++s) {
    const int o = head_column(8 * (s / 2) + 2 * q + s % 2);
    bcol[s] = o >= 0 ? __bfloat162float(bias[o]) : 0.f;
  }
  fence_proxy_async();   // the weight is read by wgmma
  __syncthreads();

  unsigned char* a_rows = smem + kHAOff;
  float* spec = reinterpret_cast<float*>(smem + kHAOff);
  int parity = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row, f0 = (tile % tiles_per_row) * kHFT;
    mbar_wait(bar, parity);
    parity ^= 1;
    // K-major row r (frame f0 - 6 + r) from the raw window: a thread reads
    // frames r, r + 1 of 8 channels (lanes on neighbouring pairs, so each
    // 32-bit read is conflict-free), applies the leaky ReLU once per
    // element and stores two 16-byte rows
    for (int it = tid; it < (kHRows / 2) * (kHC / 8); it += kHThreads) {
      const int rp = it % (kHRows / 2), cg = it / (kHRows / 2);
      const unsigned char* src =
          smem + kHRawOff + (8 * cg * kHRawW + 2 * rp + kHOff) * 2;
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t a0 = leaky2(
            *reinterpret_cast<const uint32_t*>(src + 2 * e * kHRawW * 2));
        const uint32_t a1 = leaky2(
            *reinterpret_cast<const uint32_t*>(src + (2 * e + 1) * kHRawW * 2));
        lo[e] = __byte_perm(a0, a1, 0x5410);   // channels 2e, 2e + 1
        hi[e] = __byte_perm(a0, a1, 0x7632);
      }
      unsigned char* dst = a_rows + cg * kHColBytes + 2 * rp * 16;
      *reinterpret_cast<uint4*>(dst) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(dst + 16) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
    fence_proxy_async();
    __syncthreads();   // the raw window is consumed: prefetch the next tile
    if (tid == 0 && tile + static_cast<int>(gridDim.x) < n_tiles)
      load(tile + gridDim.x);

    // acc[4j + 2r + e]: spectrum frame f0 - 3 + 64 wg + 16 warp + lane/4 +
    // 8r, column 8j + 2q + e
    float acc[40];
#pragma unroll
    for (int i = 0; i < 40; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kHK; ++k)
#pragma unroll
      for (int kk = 0; kk < kHC / 16; ++kk)
        wgmma_n80_kk(acc,
                     smem_desc(base + kHAOff + 2 * kk * kHColBytes +
                                   (64 * wg + k) * 16,
                               kHColBytes, 128, 0),
                     smem_desc(base + (2 * k + kk / 4) * kHN * 128 +
                                   (kk % 4) * 32,
                               1024, 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();   // both warpgroups are done with the K-major rows

    // conv and bias rounded to bf16 as the twin rounds them, then the fp32
    // magnitude and unit phase; frames outside [0, T) give zero spectra
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * wg + 16 * warp + lane / 4 + 8 * r;
      const int g = f0 - 3 + row;
      const bool live = g >= 0 && g < T;
      float y[20];
#pragma unroll
      for (int s = 0; s < 20; ++s)
        y[s] = add_bias(acc[4 * (s / 2) + 2 * r + s % 2],
                        __float2bfloat16(bcol[s]));
      const float sin24 = __shfl_down_sync(0xffffffffu, y[18], 1);
      float* sp = spec + row * kHSpecLd;
      auto put = [&](int kf, float lm, float pc, float ps) {
        float re = 0.f, im = 0.f;
        if (live) {
          const float mag = expf(fminf(fmaxf(lm, -12.f), 6.f));
          const float nrm = rsqrtf(pc * pc + ps * ps + 1e-7f);
          re = mag * pc * nrm;
          im = mag * ps * nrm;
        }
        sp[kf] = re;
        sp[kHFreq + kf] = im;
      };
#pragma unroll
      for (int tau = 0; tau < 6; ++tau)
        put(6 * q + tau, y[3 * tau], y[3 * tau + 1], y[3 * tau + 2]);
      if (q == 0) put(kHFreq - 1, y[18], y[19], sin24);
      if (q == 3) sp[50] = sp[51] = 0.f;
    }
    __syncthreads();

    // The overlap-add in fp32 on the CUDA cores, register-tiled: thread
    // (pair, pg) sums output frames f0 + 2 pair, + 1 at phases 3 pg .. 3 pg
    // + 2, so each float4 of a spectrum row serves three phases and each of
    // the basis serves two frames (the lanes of one pg read the same basis
    // address: a broadcast).
    if (tid < (kHFT / 2) * 4) {
      const int jf = 2 * (tid / 4), pg = tid % 4;
      float sum[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
      for (int k4 = 0; k4 < kHSpecLd; k4 += 4) {
        float4 sv[kHM + 1];   // spectrum rows jf .. jf + 4 (frames f0 + jf - 3 ..)
#pragma unroll
        for (int u = 0; u < kHM + 1; ++u)
          sv[u] = *reinterpret_cast<const float4*>(spec + (jf + u) * kHSpecLd +
                                                   k4);
#pragma unroll
        for (int m = 0; m < kHM; ++m)
#pragma unroll
          for (int ph = 0; ph < 3; ++ph) {
            const float4 sy = *reinterpret_cast<const float4*>(
                synT + (3 * pg + ph + kHHop * m) * kHSpecLd + k4);
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              const float4 v = sv[f + kHM - 1 - m];
              float a = sum[f][ph];
              a = fmaf(v.x, sy.x, a);
              a = fmaf(v.y, sy.y, a);
              a = fmaf(v.z, sy.z, a);
              sum[f][ph] = fmaf(v.w, sy.w, a);
            }
          }
      }
      float* ob = out + static_cast<long long>(b) * out_len;
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int ph = 0; ph < 3; ++ph) {
          const long long s_full =
              static_cast<long long>(f0 + jf + f) * kHHop + 3 * pg + ph;
          const long long s_out = s_full - kHNfft / 2;
          if (s_out >= 0 && s_out < out_len)
            ob[s_out] = sum[f][ph] * inv_env[s_full];
        }
    }
    __syncthreads();   // the spectra are read before the next rows land
  }
}

// x (B, T, 128) with frames contiguous (x_st == 1: the vocoder's (B, C,
// T)-major view), channel stride x_sc and batch stride x_sb, both in
// multiples of 8 elements; the tile walk (tiles_per_row tiles of kHFT
// frames a batch row, covering frames 0 .. T, in n_tiles = B tiles_per_row
// tiles over `grid` blocks) comes from the wrapper.  Returns a cudaError_t.
int launch_sm90(const void* x, const void* w, const void* bias,
                const float* syn, const float* inv_env, float* out, int B,
                int T, long long x_sb, long long x_sc, int tiles_per_row,
                int n_tiles, int grid, cudaStream_t stream) {
  if (static_cast<long long>(tiles_per_row) * kHFT <= T ||
      n_tiles != B * tiles_per_row || grid < 1 || grid > n_tiles ||
      x_sc % 8 != 0 || (B > 1 && x_sb % 8 != 0) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 1) x_sb = x_sc * kHC;
  CUtensorMap tm_x;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(T), kHC,
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(x_sc) * 2,
                                 static_cast<cuuint64_t>(x_sb) * 2};
  const cuuint32_t box[3] = {kHRawW, kHC, 1};
  if (!encode_bf16(&tm_x, x, 3, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      synth_head_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kHSmem);
  if (err != cudaSuccess) return (int)err;
  synth_head_sm90_kernel<<<grid, kHThreads, kHSmem, stream>>>(
      tm_x, static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), syn, inv_env, out, T,
      tiles_per_row, n_tiles);
  return (int)cudaGetLastError();
}


template <typename T, int RO>
int launch(const void* x, const void* w, const void* bias, const float* syn,
           const float* inv_env, float* out, int B, const HeadShape& s,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<RO>(s);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      synth_head_kernel<T, RO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // frames whose samples land in the trimmed output: [0, last_frame]
  const int last_frame = (s.n_fft / 2 + s.out_len - 1) / s.hop;
  dim3 grid(last_frame / s.FT + 1, B);
  synth_head_kernel<T, RO><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), syn, inv_env, out, s);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_ro(const void* x, const void* w, const void* bias,
                const float* syn, const float* inv_env, float* out, int B,
                const HeadShape& s, cudaStream_t stream) {
  const int NO = 3 * s.n_freq;
  if (NO <= kTX * 3) return launch<T, 3>(x, w, bias, syn, inv_env, out, B, s, stream);
  if (NO <= kTX * 6) return launch<T, 6>(x, w, bias, syn, inv_env, out, B, s, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and bias share it).  x (B, T, C)
// with element strides x_sb, x_st, x_sc; w (K, C, 3*n_freq), bias
// (3*n_freq,), syn (2*n_freq, n_fft) fp32, inv_env ((T-1)*hop + n_fft,)
// fp32 and out (B, (T-1)*hop) fp32 contiguous.  bf16 at C 128, K 7, n_fft
// 48, hop 12 with frames contiguous (x_st == 1) takes the sm90 kernel and
// its tile walk (tiles_per_row, n_tiles, grid: head_kernel.sm90_walk);
// anything else needs x contiguous (B, T, C) and ignores the walk.
// Returns a cudaError_t (0 on success).
extern "C" int synthesis_head_fwd(int dtype, const void* x, const void* w,
                                  const void* bias, const float* syn,
                                  const float* inv_env, float* out, int B,
                                  int T, int C, int K, int n_fft, int hop,
                                  long long x_sb, long long x_st,
                                  long long x_sc, int tiles_per_row,
                                  int n_tiles, int grid, void* stream) {
  HeadShape s;
  s.T = T;
  s.C = C;
  s.K = K;
  s.n_freq = n_fft / 2 + 1;
  s.n_fft = n_fft;
  s.hop = hop;
  s.M = (n_fft - 1) / hop + 1;
  s.FT = kMaxFrames - (s.M - 1);
  s.out_len = (T - 1) * hop;
  if (K % 2 == 0 || s.FT < 1 || T < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && C == kHC && K == kHK && n_fft == kHNfft && hop == kHHop &&
      x_st == 1)
    return launch_sm90(x, w, bias, syn, inv_env, out, B, T, x_sb, x_sc,
                       tiles_per_row, n_tiles, grid, st);
  if (x_sc != 1 || x_st != C || (B > 1 && x_sb != static_cast<long long>(T) * C))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_ro<float>(x, w, bias, syn, inv_env, out, B, s, st);
  if (dtype == 1)
    return dispatch_ro<__nv_bfloat16>(x, w, bias, syn, inv_env, out, B, s, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks per SM and dynamic shared memory per block of the bf16 sm90
// kernel.  Returns a cudaError_t.
extern "C" int synthesis_head_fwd_occupancy(int* blocks_per_sm,
                                            int* smem_bytes) {
  *smem_bytes = kHSmem;
  cudaError_t err = cudaFuncSetAttribute(
      synth_head_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kHSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, synth_head_sm90_kernel, kHThreads, kHSmem);
}

// Standalone centred iSTFT overlap-add, written by hand for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/vocoder_kernels.py::_istft_sf_kernel
// (the pallas_call of istft_pallas).
//
// What it computes, for real and imag (B, F, n_freq) fp32, n_freq =
// n_fft/2 + 1, window length n_fft:
//   frame_t = [real_t | imag_t] @ syn          syn: the (2 n_freq, n_fft)
//                                              irfft basis times the Hann
//                                              window, over n_fft
//   wav     = overlap_add(frames, hop) * inv_env,  inv_env = 1/max(sum of
//                                              the squared windows, 1e-8)
// trimmed by n_fft/2 on the left to (F-1)*hop samples, fp32.  The wrapper
// builds syn and inv_env in numpy once and copies them to the card.
//
// What bounds it on this card: per frame it reads 2 n_freq fp32 values and
// writes hop samples, against 2 * 2 n_freq * n_fft FLOPs; at the vocoder
// head's geometry (n_fft 48, hop 12) 200 bytes in and 48 out a frame: 203 MB
// at 32 x 25 600 frames, 0.061 ms at 3.35 TB/s.  The products are 3.9 GFLOP,
// 0.059 ms at the fp32 peak (67 TFLOP/s) and ~0.027 ms as 3xTF32 on the
// tensor cores (13 GFLOP with K padded to 56, at 495 TFLOP/s): on the tensor
// cores the kernel is bytes-bound.
//
// Two kernels:
//
// istft_sm90_kernel (n_fft 16, 32, 48 or 64, M = ceil(n_fft / hop) <= 33:
// kernels/istft.py takes_sm90): the inverse DFT of 64 frames at a time is
// one product, (64 x K) @ (K x n_fft), K = 2 n_freq padded with zeros to a
// multiple of 8, on wgmma.m64n{n_fft}k8 in 3xTF32 (sm90.cuh split_tf32: x =
// hi + lo, and x y = hi hi + hi lo + lo hi to about fp32's precision, as
// row 2's fp32 kernel): the spectra are wgmma's A, read from shared memory
// into registers and split there; the basis is its B, K-major (TF32 has no
// transpose bit) with 128-byte swizzle, split once a block and resident (an
// n48 product, not the basis padded to m64n64k8's 64 columns: a third fewer
// products and 8 fewer accumulators a thread).  One warpgroup a block and a
// persistent grid, three blocks an SM: the B * S output slots (slot f: the
// hop samples frame f starts; S of them a row, those the trimmed output
// covers) are split into one run a block, and a block walks its run row by
// row, in tiles of 64 consecutive frames.  The spectra arrive by 1-D bulk
// copies (cp.async.bulk) into a 2-stage ring on mbarriers, the next tile's
// while this one computes.  A frame row of 2 n_freq floats (100 bytes at
// n_fft 48) is no multiple of 16 bytes, so a 2-D tensor map over (F, n_freq)
// is illegal; a bulk copy needs a 16-byte aligned start and size, so a tile
// starts on a flat frame index b F + a that is a multiple of 4 and copies
// whole groups of 4 frames: the first tile of a run starts up to 3 frames
// before the M - 1 frames its first slot needs, and frames outside the row
// read as zeros.  When B F n_freq is not a multiple of 4, the last (at most
// 3) floats of each spectrum are loaded by the threads.  The frames go from
// the accumulators to a ring of 96 frame rows in shared memory, which keeps
// the M - 1 frames a tile's first slots need from the tile before (carried,
// not recomputed: a run's first tile computes its 3-6 frames of halo, in a
// run of ~3 100 slots at the head's shapes); each output sample is then M
// adds from shared memory (frame f first, then f - 1, ..., as the plain
// version's overlap-add) times the envelope, and a tile's overlap-add runs
// while the next tile's products do.  Where hop and n_fft / 2 are multiples
// of 4 (the head's 12 and 24) and M <= 4, four samples are one slot's four
// consecutive offsets, so each of the M frames is one 16-byte load, the
// envelope one more, and the store 16 bytes; elsewhere sample by sample.
// The envelope 1/env is periodic in hop away from the first and last M - 1
// frames (istft_inverse_envelope adds the same squared-window values in the
// same order there), so the kernel reads a table of (Fc - 1) hop + n_fft
// values (Fc = min(F, M): kernels/istft.py envelope_table), held in shared
// memory, instead of (F - 1) hop + n_fft of them.  What holds it back: the
// overlap-add on the CUDA cores.  Done sample by sample, with one warpgroup
// at two blocks an SM, its chains of dependent shared-memory loads made the
// first build about twice as slow (chip_smoke.py check_istft on an H100
// SXM at 32 x 25 600: 0.21 ms, against 0.107 now and a bound of 0.061).

// istft_kernel (every other n_fft and hop, and spectra that do not start on
// 16 bytes): output-stationary, one block per (FT frames' output samples,
// batch row), so blocks write disjoint samples and the overlap-add needs no
// atomics.  A block copies the spectra of the FT + M - 1 frames whose
// windows reach its samples into shared memory in one coalesced pass, and
// the basis too when it fits (else it is read through L1); then each thread
// takes output samples, sums the M frames that cover each against the basis
// column of its offset, and scales by the envelope.  Its loop takes two
// shared-memory loads an FMA, so it runs at about an eighth of the fp32
// peak.  The TPU kernel's super-frame layout (P = 128/hop frames a row, two
// matmuls per tile) is a lane-width device and is not carried over; nor is
// its fallback for windows wider than a super-frame: any n_fft and hop whose
// frames' tile fits in shared memory is taken (the wrapper chooses FT and
// raises for the rest).

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void __launch_bounds__(kThreads)
istft_kernel(const float* __restrict__ real, const float* __restrict__ imag,
             const float* __restrict__ syn, const float* __restrict__ inv_env,
             float* __restrict__ out, int F, int n_fft, int hop, int FT,
             int syn_shared) {
  extern __shared__ float smem[];
  const int n_freq = n_fft / 2 + 1;
  const int F2 = 2 * n_freq;
  const int M = (n_fft - 1) / hop + 1;
  const int NF = FT + M - 1;           // spectrum frames this block needs
  float* spec = smem;                  // [NF][F2]: real | imag
  float* syn_s = spec + NF * F2;       // [F2][n_fft] when syn_shared

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;      // first frame whose samples we own
  const int g0 = f0 - (M - 1);         // first spectrum frame
  const long long plane = (long long)b * F * n_freq;

  for (int idx = tid; idx < NF * n_freq; idx += kThreads) {
    const int i = idx / n_freq, k = idx % n_freq;
    const int g = g0 + i;
    float re = 0.f, im = 0.f;
    if (g >= 0 && g < F) {
      const long long off = plane + (long long)g * n_freq + k;
      re = real[off];
      im = imag[off];
    }
    spec[i * F2 + k] = re;
    spec[i * F2 + n_freq + k] = im;
  }
  const float* basis = syn;
  if (syn_shared) {
    for (int idx = tid; idx < F2 * n_fft; idx += kThreads) syn_s[idx] = syn[idx];
    basis = syn_s;
  }
  __syncthreads();

  const int start = n_fft / 2;
  const long long out_len = (long long)(F - 1) * hop;
  float* ob = out + (long long)b * out_len;
  for (int idx = tid; idx < FT * hop; idx += kThreads) {
    const int jf = idx / hop, phi = idx % hop;
    const long long s_full = (long long)(f0 + jf) * hop + phi;
    const long long s_out = s_full - start;
    if (s_out < 0 || s_out >= out_len) continue;
    float a = 0.f;
    for (int m = 0; m < M; ++m) {
      const int n = phi + hop * m;     // offset of the sample in frame f0+jf-m
      if (n >= n_fft) break;
      const float* sp = spec + (jf + M - 1 - m) * F2;
      for (int kk = 0; kk < F2; ++kk) a = fmaf(sp[kk], basis[kk * n_fft + n], a);
    }
    ob[s_out] = a * inv_env[s_full];
  }
}

// ---------------------------------------------------------------------------
// istft_sm90_kernel: 3xTF32 inverse DFT on wgmma, spectra by bulk copy
// ---------------------------------------------------------------------------

namespace tc {

using namespace sm90;

constexpr int kThreads = 128;   // one warpgroup
constexpr int kTile = 64;       // frames a product (wgmma's M)
constexpr int kStages = 2;      // spectra ring depth
constexpr int kRing = 96;       // frame rows kept for the overlap-add
constexpr int kMaxM = kRing - kTile + 1;   // frames a sample sums, at most

// Shared memory of the kernel at window n_fft = N, in bytes from a
// 1024-aligned base: the basis hi and lo, the spectra ring, the frame ring,
// the barriers and the envelope table.
template <int N>
struct Layout {
  static constexpr int kFreq = N / 2 + 1;
  static constexpr int kK = 2 * kFreq;                   // [real | imag]
  static constexpr int kSteps = (kK + 7) / 8;            // k-steps of 8
  static constexpr int kPanels = (8 * kSteps + 31) / 32; // 32 k a panel
  static constexpr int kPanelBytes = N * 128;            // N rows of 128 B
  static constexpr int kBasisBytes = kPanels * kPanelBytes;
  static constexpr int kSpecFloats = kTile * kFreq;      // one spectrum's
  static constexpr int kStageBytes = 2 * 4 * kSpecFloats;
  static constexpr int kRowFloats = N + 8;   // float2 stores conflict-free
  static constexpr int kLo = kBasisBytes;
  static constexpr int kStage0 = 2 * kBasisBytes;
  static constexpr int kRing0 = kStage0 + kStages * kStageBytes;
  static constexpr int kBars = kRing0 + 4 * kRing * kRowFloats;
  static constexpr int kEnv = kBars + 8 * kStages;
  static constexpr int kEnvFloats = 2 * N;   // (Fc - 1) hop + N < 2 N
  static constexpr int kSmem = 1024 + kEnv + 4 * kEnvFloats;
};

// Byte offset of basis element (column n, k) in its K-major tile: panels
// of 32 k, each N rows of 128 bytes with 128-byte swizzle (16-byte chunk c
// of row n at chunk c ^ (n % 8)), as wgmma reads a K-major B.
template <int N>
__device__ __forceinline__ uint32_t basis_offset(int n, int k) {
  return (k / 32) * Layout<N>::kPanelBytes + n * 128 +
         ((((k % 32) / 4) ^ (n & 7)) << 4) + (k % 4) * 4;
}

// One block's walk: its run [g, g1) of the B * S slots, row by row; in a
// row, the slots [c0, c1) (slot f = frame f's first hop samples, f from
// s_lo) in tiles of 64 frames from a, the first a at the (M - 1)th frame
// before c0 moved down to a flat index b F + a that is a multiple of 4.
struct Walk {
  long long g, g1;
  int F, S, s_lo, M;
  int b, c0, c1, a;
  bool valid;

  __device__ void segment() {
    valid = g < g1;
    if (!valid) return;
    b = static_cast<int>(g / S);
    const int c = static_cast<int>(g - static_cast<long long>(b) * S);
    const int n = static_cast<int>(g1 - g < S - c ? g1 - g : S - c);
    c0 = s_lo + c;
    c1 = c0 + n;
    g += n;
    const long long row = static_cast<long long>(b) * F;
    a = static_cast<int>(((row + c0 - (M - 1)) & ~3LL) - row);
  }
  __device__ void next() {
    a += kTile;
    if (a >= c1) segment();
  }
};

// The copies of a tile: `bytes` of each spectrum (floats src.. into the
// stage at float dst..) by bulk copy, and the last `tail_n` floats (from
// tail_src, to tail_dst) by the threads, where the spectra end on no 16
// bytes.  Only the tile's frames inside its row are copied.
struct Copy {
  long long src, tail_src;
  int dst, bytes, tail_dst, tail_n;
};

__device__ __forceinline__ Copy plan(const Walk& w, int n_freq,
                                     long long n_floats) {
  Copy c{0, 0, 0, 0, 0, 0};
  const long long row = static_cast<long long>(w.b) * w.F;
  const long long fa = row + w.a;               // a multiple of 4
  const long long lo = fa > (row & ~3LL) ? fa : (row & ~3LL);
  const long long hi = fa + kTile < row + w.F ? fa + kTile : row + w.F;
  if (hi <= lo) return c;
  const long long end4 = n_floats & ~3LL;
  const long long f_lo = lo * n_freq;
  const long long f_hi = ((hi + 3) & ~3LL) * n_freq;
  const long long f_end = f_hi < end4 ? f_hi : end4;
  c.src = f_lo;
  c.dst = static_cast<int>(f_lo - fa * n_freq);
  c.bytes = f_end > f_lo ? static_cast<int>(4 * (f_end - f_lo)) : 0;
  const long long t_lo = f_lo > end4 ? f_lo : end4;
  const long long t_hi = hi * n_freq < n_floats ? hi * n_freq : n_floats;
  if (t_hi > t_lo) {
    c.tail_src = t_lo;
    c.tail_dst = static_cast<int>(t_lo - fa * n_freq);
    c.tail_n = static_cast<int>(t_hi - t_lo);
  }
  return c;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 3)
istft_sm90_kernel(const float* __restrict__ real,
                  const float* __restrict__ imag,
                  const float* __restrict__ syn,
                  const float* __restrict__ env_tab, float* __restrict__ out,
                  int B, int F, int hop, int Fc) {
  using L = Layout<N>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle
  unsigned char* smem = smem_raw + (base - raw);
  float* ring = reinterpret_cast<float*>(smem + L::kRing0);
  float* env = reinterpret_cast<float*>(smem + L::kEnv);
  auto stage = [&](int s) { return base + L::kStage0 + s * L::kStageBytes; };
  auto full = [&](int s) { return base + L::kBars + 8 * s; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int row0 = 16 * warp + lane / 4;   // this thread's rows: row0, +8
  const int M = (N - 1) / hop + 1;
  const int s_lo = (N / 2) / hop;
  const int S = (N / 2 + (F - 1) * hop - 1) / hop - s_lo + 1;
  const long long total = static_cast<long long>(B) * S;
  const long long n_floats = static_cast<long long>(B) * F * L::kFreq;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
  }
  // the basis, split into hi and lo once, zero past K
  for (int i = tid; i < N * 32 * L::kPanels; i += kThreads) {
    const int n = i / (32 * L::kPanels), k = i % (32 * L::kPanels);
    uint32_t hi, lo;
    split_tf32(k < L::kK ? syn[k * N + n] : 0.f, hi, lo);
    const uint32_t off = basis_offset<N>(n, k);
    *reinterpret_cast<uint32_t*>(smem + off) = hi;
    *reinterpret_cast<uint32_t*>(smem + L::kLo + off) = lo;
  }
  const int env_len = (Fc - 1) * hop + N;
  for (int i = tid; i < env_len; i += kThreads) env[i] = env_tab[i];
  fence_proxy_async();   // the basis is read by wgmma
  __syncthreads();

  Walk cons{total * blockIdx.x / gridDim.x,
            total * (blockIdx.x + 1) / gridDim.x, F, S, s_lo, M};
  cons.segment();
  Walk prod = cons;
  auto fetch = [&](int s, const Walk& w) {
    const Copy c = plan(w, L::kFreq, n_floats);
    mbar_expect_tx(full(s), 2 * c.bytes);
    if (c.bytes > 0) {
      bulk_load(stage(s) + 4 * c.dst, real + c.src, c.bytes, full(s));
      bulk_load(stage(s) + 4 * (L::kSpecFloats + c.dst), imag + c.src,
                c.bytes, full(s));
    }
  };
  if (tid == 0)
    for (int s = 0; s < kStages && prod.valid; ++s) {
      fetch(s, prod);
      prod.next();
    }

  // overlap-add a tile's slots (those whose frames are all in the ring
  // once it is): row samples [r0, r1), four at a time on 16-byte groups of
  // the flat output
  const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int row_len = (F - 1) * hop;
  const bool vec_ola = vec_out && hop % 4 == 0 && (N / 2) % 4 == 0 &&
                       hop <= N && M <= 4;
  auto overlap_add = [&](const Walk& w) {
    const int e0 = w.c0 > w.a ? w.c0 : w.a;
    const int e1 = w.a + kTile < w.c1 ? w.a + kTile : w.c1;
    const int r0 = e0 * hop - N / 2 > 0 ? e0 * hop - N / 2 : 0;
    const int r1 = e1 * hop - N / 2 < row_len ? e1 * hop - N / 2 : row_len;
    const long long o_row = static_cast<long long>(w.b) * row_len;
    if (vec_ola) {
      for (long long q = ((o_row + r0) >> 2) + tid; 4 * q < o_row + r1;
           q += kThreads) {
        const int s = static_cast<int>(4 * q - o_row) + N / 2;
        const int f = s / hop, phi = s - f * hop;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m < M && phi + m * hop < N) {
            const float4 x = *reinterpret_cast<const float4*>(
                ring + ((f - m + kRing) % kRing) * L::kRowFloats + phi +
                m * hop);
            a.x += x.x;
            a.y += x.y;
            a.z += x.z;
            a.w += x.w;
          }
        }
        const int j = f < F ? (f < M - 1 ? f : M - 1) : f - F + Fc;
        const float4 en =
            *reinterpret_cast<const float4*>(env + j * hop + phi);
        *reinterpret_cast<float4*>(out + 4 * q) =
            make_float4(a.x * en.x, a.y * en.y, a.z * en.z, a.w * en.w);
      }
      return;
    }
    for (long long q = ((o_row + r0) >> 2) + tid; 4 * q < o_row + r1;
         q += kThreads) {
      const int o = static_cast<int>(4 * q - o_row);   // >= r0 - 3
      int f = (o + N / 2) / hop;
      int phi = o + N / 2 - f * hop;
      float v[4];
      bool in[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        in[e] = o + e >= r0 && o + e < r1;
        v[e] = 0.f;
        if (in[e] && phi < N) {   // no frame reaches phi >= N
          float a = 0.f;
          for (int m = 0; m < M && phi + m * hop < N; ++m)
            a += ring[((f - m + kRing) % kRing) * L::kRowFloats + phi +
                      m * hop];
          const int j = f < F ? (f < M - 1 ? f : M - 1) : f - F + Fc;
          v[e] = a * env[j * hop + phi];
        }
        if (++phi == hop) {
          phi = 0;
          ++f;
        }
      }
      if (vec_out && in[0] && in[3]) {
        *reinterpret_cast<float4*>(out + 4 * q) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (in[e]) out[4 * q + e] = v[e];
      }
    }
  };

  // Tile t: its products run while the threads overlap-add tile t - 1.
  Walk prev = cons;
  prev.valid = false;
  for (int t = 0; cons.valid; ++t) {
    const int st = t % kStages;
    float* sp = reinterpret_cast<float*>(smem + (stage(st) - base));
    mbar_wait(full(st), (t / kStages) & 1);
    if (cons.b == B - 1 && cons.a + kTile > F - 4) {
      const Copy c = plan(cons, L::kFreq, n_floats);
      if (c.tail_n > 0) {   // the spectra's last floats, on no 16 bytes
        if (tid < c.tail_n) {
          sp[c.tail_dst + tid] = real[c.tail_src + tid];
          sp[L::kSpecFloats + c.tail_dst + tid] = imag[c.tail_src + tid];
          fence_proxy_async();   // the stage is refilled by bulk copies
        }
        __syncthreads();
      }
    }

    // A fragments, hi and lo: element i of k-step kk is frame a + row0 +
    // 8 (i % 2), column 8 kk + quad + 4 (i / 2) of [real | imag | 0];
    // frames outside the row are zeros
    uint32_t ahi[4 * L::kSteps], alo[4 * L::kSteps];
    bool in_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int f = cons.a + row0 + 8 * r;
      in_row[r] = f >= 0 && f < F;
    }
#pragma unroll
    for (int kk = 0; kk < L::kSteps; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 8 * (i % 2);
        const int col = 8 * kk + quad + 4 * (i / 2);
        const bool ok = in_row[i % 2] && col < L::kK;
        const int idx = row * L::kFreq + col +
                        (col >= L::kFreq ? L::kSpecFloats - L::kFreq : 0);
        const float x = sp[ok ? idx : 0];
        split_tf32(ok ? x : 0.f, ahi[4 * kk + i], alo[4 * kk + i]);
      }
    __syncthreads();   // stage st read; tile t - 1's frames in the ring

    // frames = A @ basis in 3xTF32
    float acc[N / 2];
    fence_regs(ahi);
    fence_regs(alo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kSteps; ++kk) {
      const uint32_t panel = base + (kk / 4) * L::kPanelBytes;
      const uint64_t dh = desc128(panel) + 2 * (kk % 4);
      const uint64_t dl = desc128(panel + L::kLo) + 2 * (kk % 4);
      const uint32_t* h = ahi + 4 * kk;
      const uint32_t* l = alo + 4 * kk;
      wgmma_tf32_n<N>(acc, h[0], h[1], h[2], h[3], dh, kk > 0);
      wgmma_tf32_n<N>(acc, h[0], h[1], h[2], h[3], dl, 1);
      wgmma_tf32_n<N>(acc, l[0], l[1], l[2], l[3], dh, 1);
    }
    wgmma_commit();
    if (tid == 0 && prod.valid) {
      fetch(st, prod);
      prod.next();
    }
    if (prev.valid) overlap_add(prev);
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ahi);
    fence_regs(alo);
    __syncthreads();   // tile t - 1's overlap-add done: its rows may go

    // into the frame ring: acc[4j + 2r + e] is frame a + row0 + 8r, sample
    // 8j + 2 quad + e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* dst = ring + ((cons.a + row0 + 8 * r + kRing) % kRing) *
                              L::kRowFloats + 2 * quad;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
    prev = cons;
    cons.next();
  }
  __syncthreads();
  if (prev.valid) overlap_add(prev);
}

template <int N>
int launch(const float* real, const float* imag, const float* syn,
           const float* env_tab, float* out, int B, int F, int hop, int Fc,
           int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      istft_sm90_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<N>::kSmem);
  if (err != cudaSuccess) return (int)err;
  istft_sm90_kernel<N><<<grid, kThreads, Layout<N>::kSmem, stream>>>(
      real, imag, syn, env_tab, out, B, F, hop, Fc);
  return (int)cudaGetLastError();
}

template <int N>
int occupancy(int* blocks_per_sm, int* smem_bytes) {
  *smem_bytes = Layout<N>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      istft_sm90_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<N>::kSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, istft_sm90_kernel<N>, kThreads, Layout<N>::kSmem);
}

}  // namespace tc

}  // namespace

// real, imag (B, F, n_fft/2 + 1) fp32 contiguous; syn (2*n_freq, n_fft)
// fp32; inv_env ((F-1)*hop + n_fft,) fp32; out (B, (F-1)*hop) fp32.  FT:
// frames of output per block; syn_shared: 1 to stage the basis in shared
// memory.  Returns a cudaError_t (0 on success).
extern "C" int istft_fwd(const float* real, const float* imag,
                         const float* syn, const float* inv_env, float* out,
                         int B, int F, int n_fft, int hop, int FT,
                         int syn_shared, void* stream) {
  if (B < 1 || F < 2 || n_fft < 2 || hop < 1 || FT < 1)
    return (int)cudaErrorInvalidValue;
  const int n_freq = n_fft / 2 + 1;
  const int M = (n_fft - 1) / hop + 1;
  const size_t smem = sizeof(float) *
      ((size_t)(FT + M - 1) * 2 * n_freq +
       (syn_shared ? (size_t)2 * n_freq * n_fft : 0));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      istft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // frames whose samples land in the trimmed output: [0, last_frame]
  const int last_frame = (n_fft / 2 + (F - 1) * hop - 1) / hop;
  dim3 grid(last_frame / FT + 1, B);
  istft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      real, imag, syn, inv_env, out, F, n_fft, hop, FT, syn_shared);
  return (int)cudaGetLastError();
}

// The sm90 kernel (n_fft 16, 32, 48 or 64): real, imag (B, F, n_fft/2 + 1)
// fp32 contiguous, both 16-byte aligned; syn (2*n_freq, n_fft) fp32; env_tab
// the envelope table ((Fc-1)*hop + n_fft,) fp32 with Fc = min(F, M), M =
// ceil(n_fft / hop); out (B, (F-1)*hop) fp32; grid: the persistent blocks.
// Returns a cudaError_t (0 on success).
extern "C" int istft_sm90_fwd(const float* real, const float* imag,
                              const float* syn, const float* env_tab,
                              float* out, int B, int F, int n_fft, int hop,
                              int Fc, int grid, void* stream) {
  if (B < 1 || F < 2 || hop < 1 || grid < 1 || n_fft < 2)
    return (int)cudaErrorInvalidValue;
  const int M = (n_fft - 1) / hop + 1;
  if (M > tc::kMaxM || Fc != (F < M ? F : M) ||
      (reinterpret_cast<uintptr_t>(real) | reinterpret_cast<uintptr_t>(imag)) %
              16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 16:
      return tc::launch<16>(real, imag, syn, env_tab, out, B, F, hop, Fc,
                            grid, st);
    case 32:
      return tc::launch<32>(real, imag, syn, env_tab, out, B, F, hop, Fc,
                            grid, st);
    case 48:
      return tc::launch<48>(real, imag, syn, env_tab, out, B, F, hop, Fc,
                            grid, st);
    case 64:
      return tc::launch<64>(real, imag, syn, env_tab, out, B, F, hop, Fc,
                            grid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks per SM and dynamic shared memory per block of the sm90 kernel at
// window n_fft (it does not depend on hop).  Returns a cudaError_t.
extern "C" int istft_sm90_occupancy(int n_fft, int* blocks_per_sm,
                                    int* smem_bytes) {
  switch (n_fft) {
    case 16: return tc::occupancy<16>(blocks_per_sm, smem_bytes);
    case 32: return tc::occupancy<32>(blocks_per_sm, smem_bytes);
    case 48: return tc::occupancy<48>(blocks_per_sm, smem_bytes);
    case 64: return tc::occupancy<64>(blocks_per_sm, smem_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

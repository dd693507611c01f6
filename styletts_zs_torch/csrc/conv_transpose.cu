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
// K/r = 2 of the K = 10 at the vocoder's r = 5, so the useful work at the
// long-form shapes is 51 GFLOP (512 -> 256 channels over 4 x 4864 frames)
// and 64 GFLOP (256 -> 128 over 4 x 24 320) against 20 + 50 MB and
// 50 + 125 MB moved: bound by operations at the bf16 tensor-core peak
// (~52 and ~64 us).
//
// Design: output-stationary, as the Pallas kernel is: one block per (tile
// of input frames q, phase phi, tile of output channels, batch row) writes
// out[q r + phi] for its tile, so blocks write disjoint samples and need no
// atomics.  The phase is the fastest grid index, so the r blocks of a tile
// run together and their interleaved samples meet in the L2 cache before
// they reach device memory.  Per chunk of input channels it stages the
// window of frames q0 - m_hi .. q0 + tile - 1 - m_lo (with the leaky ReLU
// applied on the load) and the phase's tap matrices, which it reads
// straight from the (K, Cin, Cout) weight: a tap is a contiguous
// (Cin, Cout) matrix, so no reordered tap matrix is built.  Taps of other phases are skipped, not
// multiplied by zero rows.  x may have any strides; neighbouring threads
// load neighbouring frames, so the vocoder's (B, C, T)-major activations
// are read in place, with coalesced loads and no transposing copy.
// Two variants, chosen by dtype:
//  - bf16 (the main path): the tap products on the tensor cores as
//    16x16x16 warp MMAs with fp32 accumulation; 128 frames x 128 output
//    channels per block, eight warps of 32 x 64, two blocks an SM.  While a
//    chunk's products run, the next chunk's taps are copied into a second
//    buffer with cp.async; a thread starts all of its loads of a chunk's
//    window before it stores any, so a chunk waits on one round trip to
//    memory, not one per load, and the other block's products fill it;
//  - fp32: exact FMAs on the CUDA cores, 64 x 64 per block, each of 256
//    threads owning a 4 x 4 tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

// The taps of phase phi: m in [m_lo, m_hi], i.e. 0 <= phi + p + m r < K.
struct Phase {
  int m_lo, m_hi;
};
__device__ __forceinline__ Phase phase_taps(int phi, int p, int r, int K) {
  return {-((phi + p) / r), (K - 1 - phi - p) / r};
}

// ---------------------------------------------------------------------------
// bf16 tensor-core variant
// ---------------------------------------------------------------------------

constexpr int kBM = 128;            // input frames per block
constexpr int kBN = 128;            // output channels per block
constexpr int kCK = 32;             // input channels per chunk
constexpr int kTcThreads = 256;     // 8 warps: 4 along frames x 2 along channels
constexpr int kLdA = kCK + 16;      // 48 bf16 = 96 bytes: rows start 32-byte aligned
constexpr int kLdB = kBN + 8;       // 136 bf16 = 272 bytes: 8 rows hit 8 bank groups
constexpr int kLdC = kBN + 4;
constexpr int kMaxSpan = 32;        // the window's extra rows the bf16 variant takes
constexpr int kRowIt = (kBM + kMaxSpan) / 32;         // window rows per lane
constexpr int kChIt = kCK / (kTcThreads / 32);        // channels per warp
constexpr int kVB = kBN / 8;        // 8-wide weight vectors per staged row

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kTcThreads, 2)
conv_transpose_tc_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ out, int T, int C_in,
                         int C_out, int K, int r, int p, int span,
                         long long x_sb, long long x_st, long long x_sc,
                         int leaky, float slope) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int b_stage = (span + 1) * kCK * kLdB;                      // one weight buffer
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBM + span][kLdA]
  __nv_bfloat16* Bs = As + (kBM + span) * kLdA;                     // [2][taps][kCK][kLdB]
  float* Cs = reinterpret_cast<float*>(smem_raw);                   // [kBM][kLdC]

  const int q0 = (blockIdx.x / r) * kBM;
  const int phi = blockIdx.x % r;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const Phase ph = phase_taps(phi, p, r, K);
  const int n_taps = ph.m_hi - ph.m_lo + 1;
  const int rows = kBM + ph.m_hi - ph.m_lo;
  const int q_first = q0 - ph.m_hi;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;

  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + b * x_sb;

  // A lane loads window rows lane + 32 j of channels warp + 8 k: the lanes
  // of a warp read neighbouring frames, the vocoder's contiguous dimension.
  unsigned short xr[kRowIt][kChIt];
  auto load_a = [&](int c0) {
#pragma unroll
    for (int j = 0; j < kRowIt; ++j)
#pragma unroll
      for (int k = 0; k < kChIt; ++k) {
        const int rho = lane + 32 * j, c = c0 + warp + 8 * k;
        const int q = q_first + rho;
        xr[j][k] = (rho < rows && q >= 0 && q < T && c < C_in)
                       ? xb[q * x_st + c * x_sc] : (unsigned short)0;
      }
  };
  auto store_a = [&]() {
#pragma unroll
    for (int j = 0; j < kRowIt; ++j)
#pragma unroll
      for (int k = 0; k < kChIt; ++k) {
        const int rho = lane + 32 * j;
        if (rho >= rows) continue;
        float a = __bfloat162float(__ushort_as_bfloat16(xr[j][k]));
        if (leaky && !(a > 0.f)) a *= slope;
        As[rho * kLdA + warp + 8 * k] = __float2bfloat16(a);
      }
  };
  // the phase's tap matrices of a chunk, copied asynchronously
  auto fetch_b = [&](__nv_bfloat16* dst, int c0) {
    for (int v = tid; v < n_taps * kCK * kVB; v += kTcThreads) {
      const int j = v / (kCK * kVB);             // tap m = m_lo + j
      const int i = (v / kVB) % kCK;
      const int o8 = (v % kVB) * 8;
      const int c = c0 + i, o = n0 + o8;
      const int tap = K - 1 - (phi + p + (ph.m_lo + j) * r);
      const bool ok = c < C_in && o < C_out;
      cp_async16(dst + (j * kCK + i) * kLdB + o8,
                 ok ? w + ((long long)tap * C_in + c) * C_out + o : w, ok);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch_b(Bs, 0);
  const int n_chunks = (C_in + kCK - 1) / kCK;
  for (int ci = 0; ci < n_chunks; ++ci) {
    load_a(ci * kCK);        // all of a thread's loads in flight at once
    store_a();               // As is free: the last chunk's products are done
    cp_async_wait_all();     // this chunk's taps have landed
    __syncthreads();
    if (ci + 1 < n_chunks)   // the next chunk's taps fly during the products
      fetch_b(Bs + ((ci + 1) % 2) * b_stage, (ci + 1) * kCK);
    const __nv_bfloat16* Bc = Bs + (ci % 2) * b_stage;
    for (int j = 0; j < n_taps; ++j) {
      // tap m reads a[q - m]: window row i + m_hi - m
      const __nv_bfloat16* Aj = As + (32 * wm + ph.m_hi - (ph.m_lo + j)) * kLdA;
      const __nv_bfloat16* Bj = Bc + j * kCK * kLdB + 64 * wn;
#pragma unroll
      for (int kk = 0; kk < kCK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], Aj + 16 * i * kLdA + 16 * kk, kLdA);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(bf, Bj + 16 * kk * kLdB + 16 * jj, kLdB);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][jj], a[i], bf, acc[i][jj]);
        }
      }
    }
    __syncthreads();         // As and this weight buffer are consumed
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (32 * wm + 16 * i) * kLdC + 64 * wn + 16 * j,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  // out[b, o, q r + phi]: neighbouring threads take neighbouring frames
  const long long T_out = (long long)T * r;
  __nv_bfloat16* ob = out + (long long)b * C_out * T_out;
  for (int v = tid; v < kBM * kBN; v += kTcThreads) {
    const int i = v % kBM, j = v / kBM;
    const int q = q0 + i, o = n0 + j;
    if (q < T && o < C_out)
      ob[o * T_out + (long long)q * r + phi] = __float2bfloat16(Cs[i * kLdC + j]);
  }
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

// dtype: 0 = float32, 1 = bfloat16.  x (B, T, C_in) with any strides (in
// elements), w contiguous (K, C_in, C_out) in x's dtype, out contiguous
// (B, C_out, T*r).  K >= r.  leaky != 0 applies leaky_relu(x, slope) on
// the load.  bf16 needs C_out % 8 == 0 and at most 33 taps a phase (the
// wrapper checks).  Returns a
// cudaError_t (0 on success).
extern "C" int conv_transpose_fwd(int dtype, const void* x, const void* w,
                                  void* out, int B, int T, int C_in, int C_out,
                                  int K, int r, long long x_sb, long long x_st,
                                  long long x_sc, int leaky, float slope,
                                  void* stream) {
  if (T < 1 || C_in < 1 || C_out < 1 || r < 1 || K < r)
    return (int)cudaErrorInvalidValue;
  const int p = (K - r) / 2;
  int span = 0;   // the most taps of any phase, less one
  for (int phi = 0; phi < r; ++phi) {
    const int s = (K - 1 - phi - p) / r + (phi + p) / r;
    span = s > span ? s : span;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid_tc((T + kBM - 1) / kBM * r, (C_out + kBN - 1) / kBN, B);
  if (dtype == 1) {
    if (C_out % 8 != 0 || span > kMaxSpan) return (int)cudaErrorInvalidValue;
    const size_t tiles = sizeof(__nv_bfloat16) *
                         ((size_t)(kBM + span) * kLdA + 2 * (size_t)(span + 1) * kCK * kLdB);
    const size_t epi = sizeof(float) * kBM * kLdC;
    const size_t smem = tiles > epi ? tiles : epi;
    cudaError_t err = cudaFuncSetAttribute(
        conv_transpose_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    conv_transpose_tc_kernel<<<grid_tc, kTcThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), T, C_in, C_out, K, r, p, span, x_sb,
        x_st, x_sc, leaky, slope);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
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

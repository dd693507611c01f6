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
// The weight is read flipped and transposed where it lies: the staged tile
// of tap k is w[K-1-k] as (c, o) rows, which the tensor cores take as the
// column-major (o, c) operand, so no flipped weight is built per call.
//
// What bounds it on this card: at the train step's shapes (B 16, T 1024,
// C = C_out = 512, K 5) one pass does 43 GFLOP of products and moves
// ~84 MB (dc, x, scale, shift read once, dh written once), so it is bound
// by operations: ~43 us at the bf16 tensor-core peak.
//
// Design: row 6 (csrc/adain_conv.cu) turned around.  One block per (tile of
// frames, tile of output channels c, batch row); the block walks the
// reduction channels o in chunks, staging the window of tile + 2 halo frames
// of dc (zeros outside [0, T)) and the K taps' weights, then runs the K tap
// products [window rows k d .. k d + tile) @ w[K-1-k]^T.  The epilogue
// recomputes the modulation from x, scale, shift and the statistics and
// multiplies by silu'.  bf16 (the main path): 16x16x16 warp MMAs with fp32
// accumulation, 128 frames x 128 channels per block, eight warps of 32 x 64;
// fp32: exact FMAs on the CUDA cores, 64 x 64 per block, each of 256
// threads owning a 4 x 4 tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

// the pass's modulation recomputed, then silu'
__device__ __forceinline__ float dsilu_mod(float x, float mean, float rstd,
                                           float sc, float sh) {
  const float u = (x - mean) * rstd * (1.f + sc) + sh;
  const float sig = 1.f / (1.f + expf(-u));
  return sig * (1.f + u * (1.f - sig));
}

// ---------------------------------------------------------------------------
// bf16 tensor-core variant
// ---------------------------------------------------------------------------

constexpr int kBM = 128;            // frames per block
constexpr int kBN = 128;            // output channels c per block
constexpr int kCK = 32;             // reduction channels o per chunk
constexpr int kTcThreads = 256;     // 8 warps: 4 along frames x 2 along channels
constexpr int kLdA = kCK + 16;      // 48 bf16 = 96 bytes: rows start 32-byte aligned
constexpr int kLdC = kBN + 4;       // fp32 epilogue rows

union Vec8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

__global__ void __launch_bounds__(kTcThreads)
adain_bwd_data_tc_kernel(const __nv_bfloat16* __restrict__ dc,
                         const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ sc,
                         const __nv_bfloat16* __restrict__ sh,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ out, int T, int C,
                         int C_out, int K, int dil, long long x_sb,
                         long long x_st, long long s_sb, long long s_st,
                         long long h_sb, long long h_st) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int halo = (K - 1) * dil / 2;
  const int rows = kBM + 2 * halo;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [rows][kLdA]
  __nv_bfloat16* Bs = As + rows * kLdA;                             // [K][kBN][kLdA]
  float* Cs = reinterpret_cast<float*>(smem_raw);                   // [kBM][kLdC]

  const int t0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;   // warp tile: frames 32 wm.., channels 64 wn..

  const __nv_bfloat16* dcb = dc + (long long)b * T * C_out;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  constexpr int kVA = kCK / 8;     // 8-wide vectors per staged row
  for (int o0 = 0; o0 < C_out; o0 += kCK) {
    __syncthreads();   // the previous chunk's tiles are consumed
    for (int v = tid; v < rows * kVA; v += kTcThreads) {
      const int r = v / kVA;
      const int ov = (v % kVA) * 8;
      const int t = t0 - halo + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (t >= 0 && t < T && o0 + ov < C_out)
        val = *reinterpret_cast<const uint4*>(dcb + (long long)t * C_out + o0 + ov);
      *reinterpret_cast<uint4*>(As + r * kLdA + ov) = val;
    }
    // tap k's tile: w[K-1-k][n0 + j][o0 .. o0 + kCK), one (c) row each
    for (int v = tid; v < K * kBN * kVA; v += kTcThreads) {
      const int k = v / (kBN * kVA);
      const int j = (v / kVA) % kBN;
      const int ov = (v % kVA) * 8;
      const int c = n0 + j, o = o0 + ov;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c < C && o < C_out)
        val = *reinterpret_cast<const uint4*>(
            w + ((long long)(K - 1 - k) * C + c) * C_out + o);
      *reinterpret_cast<uint4*>(Bs + (k * kBN + j) * kLdA + ov) = val;
    }
    __syncthreads();

    for (int k = 0; k < K; ++k) {
      const __nv_bfloat16* Ak = As + (32 * wm + k * dil) * kLdA;
      const __nv_bfloat16* Bk = Bs + (k * kBN + 64 * wn) * kLdA;
#pragma unroll
      for (int kk = 0; kk < kCK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], Ak + 16 * i * kLdA + 16 * kk, kLdA);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // (o, c) = w[K-1-k][c][o]: column-major over the staged (c) rows
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bf;
          wmma::load_matrix_sync(bf, Bk + 16 * j * kLdA + 16 * kk, kLdA);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], bf, acc[i][j]);
        }
      }
    }
  }

  __syncthreads();   // the tiles are consumed; Cs reuses their memory
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (32 * wm + 16 * i) * kLdC + 64 * wn + 16 * j,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  const __nv_bfloat16* xb = x + b * x_sb;
  const __nv_bfloat16* scb = sc + b * s_sb;
  const __nv_bfloat16* shb = sh + b * h_sb;
  const float* mb = mean + (long long)b * C;
  const float* rb = rstd + (long long)b * C;
  __nv_bfloat16* ob = out + (long long)b * T * C;
  constexpr int kVB = kBN / 8;
  for (int v = tid; v < kBM * kVB; v += kTcThreads) {
    const int r = v / kVB;
    const int j = (v % kVB) * 8;
    const int t = t0 + r, c = n0 + j;
    if (t >= T || c >= C) continue;
    Vec8 xv, sv, bv, yv;
    xv.u = *reinterpret_cast<const uint4*>(xb + t * x_st + c);
    sv.u = *reinterpret_cast<const uint4*>(scb + t * s_st + c);
    bv.u = *reinterpret_cast<const uint4*>(shb + t * h_st + c);
    const float4 m0 = *reinterpret_cast<const float4*>(mb + c);
    const float4 m1 = *reinterpret_cast<const float4*>(mb + c + 4);
    const float4 r0 = *reinterpret_cast<const float4*>(rb + c);
    const float4 r1 = *reinterpret_cast<const float4*>(rb + c + 4);
    const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
    const float rv[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      yv.h[e] = __float2bfloat16(
          Cs[r * kLdC + j + e] *
          dsilu_mod(__bfloat162float(xv.h[e]), mv[e], rv[e],
                    __bfloat162float(sv.h[e]), __bfloat162float(bv.h[e])));
    *reinterpret_cast<uint4*>(ob + (long long)t * C + c) = yv.u;
  }
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
// contiguous (B, T, C).  K odd and (K-1)*dilation even.  bf16 needs 16-byte
// aligned dc/x/scale/shift rows, strides in multiples of 8 and C, C_out
// multiples of 8 (the wrapper checks).  Returns a cudaError_t (0 on
// success).
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
  if (dtype == 1) {
    if (C % 8 != 0 || C_out % 8 != 0) return (int)cudaErrorInvalidValue;
    const size_t tiles = sizeof(__nv_bfloat16) *
                         ((size_t)(kBM + 2 * halo) * kLdA + (size_t)K * kBN * kLdA);
    const size_t epi = sizeof(float) * kBM * kLdC;
    const size_t smem = tiles > epi ? tiles : epi;
    cudaError_t err = cudaFuncSetAttribute(
        adain_bwd_data_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + kBM - 1) / kBM, (C + kBN - 1) / kBN, B);
    adain_bwd_data_tc_kernel<<<grid, kTcThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(dc),
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(scale),
        static_cast<const __nv_bfloat16*>(shift), mean, rstd,
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
        T, C, C_out, K, dilation, x_sb, x_st, s_sb, s_st, h_sb, h_st);
    return (int)cudaGetLastError();
  }
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

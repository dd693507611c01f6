// Chunk-local attention forward, written by hand for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/attention_kernel.py::_local_attn_kernel
// (the pallas_call in _local_attention_impl, wrapper local_attention_pallas).
//
// What it computes: for the queries of chunk i (chunk c), attention over the
// keys of the clipped window [s0, s0 + 3c), s0 = clip((i-1)c, 0, T-3c); a key
// counts when it lies in the band [(i-1)c, (i+2)c) and below lengths[b].
// Masked logits are -1e30 (not -inf), so a query with no valid key averages
// the whole clipped window uniformly, as the Pallas kernel does.  Softmax in
// fp32; inputs fp32 or bf16, (B, T, H, D) with any strides on B, T and H and
// the last dimension contiguous, so the q/k/v views of a fused qkv
// projection need no transpose or copy.
//
// What bounds it on this card: at the decoder's shapes (B 32, T 1024, H 8,
// D 64, c 256) it reads 3 x 33.5 MB / 3 bf16 tensors and does ~51 GFLOP of
// products, so a tensor-core kernel would be bound by operations (~52 us at
// 989 TFLOP/s) and a CUDA-core kernel by the FMA and shared-memory rate.
//
// Design: one block per (query tile of 64, head, batch); the 3c-key window
// is walked in tiles of 64 keys with an online (flash-style) softmax, so no
// (T, 3c) score matrix reaches device memory.  Two variants, chosen by
// dtype and alignment:
//  - bf16 with 16-byte-aligned rows (the main path): QK^T and PV run on the
//    tensor cores as 16x16x16 warp MMAs with fp32 accumulation; four warps
//    of 16 query rows each; the softmax runs in fp32 on the CUDA cores, two
//    lanes per row, and each row's output stays in those two lanes'
//    registers, rescaled per tile.  P is rounded to bf16 before PV.
//  - fp32 (and unaligned bf16): 256 threads, each owning a 4x4 micro-tile
//    of the 64x64 score tile and of the 64x64 output tile (rows ty + 16a,
//    columns tx + 16j) on the CUDA cores; rows padded to 65 floats so the
//    Q/K reads are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kD = 64;        // head dimension
constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 16 x 16
constexpr int kPad = kD + 1;  // smem row stride (floats)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
local_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lengths,
                      T* __restrict__ out, int T_total, int H, int chunk,
                      long long q_sb, long long q_st, long long q_sh,
                      long long k_sb, long long k_st, long long k_sh,
                      long long v_sb, long long v_st, long long v_sh,
                      float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kBQ][kPad]
  float* Ks = Qs + kBQ * kPad;      // [kBK][kPad]
  float* Vs = Ks + kBK * kPad;      // [kBK][kPad]
  float* Ps = Vs + kBK * kPad;      // [kBQ][kPad]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const int ci = q0 / chunk;                       // chunk of this query tile
  int s0 = (ci - 1) * chunk;
  s0 = max(0, min(s0, T_total - 3 * chunk));
  const int band_lo = (ci - 1) * chunk;
  const int band_hi = (ci + 2) * chunk;
  const int len = lengths[b];

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < kBQ * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD;
    Qs[r * kPad + d] = to_f(qb[(long long)(q0 + r) * q_st + d]);
  }

  float m_run[4], l_run[4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = kNegInf;
    l_run[a] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  }

  const int n_tiles = 3 * chunk / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kbase = s0 + kt * kBK;
    __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed
    for (int idx = tid; idx < kBK * kD; idx += kThreads) {
      const int r = idx / kD, d = idx % kD;
      Ks[r * kPad + d] = to_f(kb[(long long)(kbase + r) * k_st + d]);
      Vs[r * kPad + d] = to_f(vb[(long long)(kbase + r) * v_st + d]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float qa[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = Qs[(ty + 16 * a) * kPad + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * kPad + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = fmaf(qa[a], kv[j], s[a][j]);
    }

    // mask, then the online softmax update; a row's 64 keys live on the 16
    // lanes that share ty, so the row reductions stay inside a half warp
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kbase + tx + 16 * j;
        const bool valid = key >= band_lo && key < band_hi && key < len;
        s[a][j] = valid ? s[a][j] * scale : kNegInf;
        mx = fmaxf(mx, s[a][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[a], mx);
      const float alpha = expf(m_run[a] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[a][j] - m_new);
        rsum += p;
        Ps[(ty + 16 * a) * kPad + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_run[a] = l_run[a] * alpha + rsum;
      m_run[a] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = Ps[(ty + 16 * a) * kPad + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * kPad + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(pa[a], vv[j], acc[a][j]);
    }
  }

  T* ob = out + ((long long)b * T_total * H + h) * kD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float inv = 1.f / fmaxf(l_run[a], 1e-30f);
    const long long row = q0 + ty + 16 * a;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ob[row * H * kD + tx + 16 * j] = from_f<T>(acc[a][j] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core variant
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;    // 4 warps x 16 query rows
constexpr int kLdh = kD + 8;       // bf16 row stride: 144 bytes
constexpr int kLds = kD + 4;       // fp32 row stride: 272 bytes

__global__ void __launch_bounds__(kTcThreads)
local_attn_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ lengths,
                         __nv_bfloat16* __restrict__ out, int T_total, int H,
                         int chunk, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_st,
                         long long k_sh, long long v_sb, long long v_st,
                         long long v_sh, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][kLdh]
  __nv_bfloat16* Ks = Qs + kBQ * kLdh;                              // [64][kLdh]
  __nv_bfloat16* Vs = Ks + kBK * kLdh;                              // [64][kLdh]
  __nv_bfloat16* Ps = Vs + kBK * kLdh;                              // [64][kLdh]
  float* Ss = reinterpret_cast<float*>(Ps + kBQ * kLdh);            // [64][kLds]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row = 16 * warp + lane / 2;     // this lane's query row
  const int half = lane % 2;                // and its 32 keys / 32 dims

  const int ci = q0 / chunk;
  int s0 = (ci - 1) * chunk;
  s0 = max(0, min(s0, T_total - 3 * chunk));
  const int band_lo = (ci - 1) * chunk;
  const int band_hi = (ci + 2) * chunk;
  const int len = lengths[b];

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // 16-byte vectors: 8 per 64-element row
  for (int idx = tid; idx < kBQ * 8; idx += kTcThreads) {
    const int r = idx / 8, c = idx % 8;
    *reinterpret_cast<uint4*>(Qs + r * kLdh + 8 * c) =
        *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * q_st + 8 * c);
  }

  float m_run = kNegInf, l_run = 0.f;
  float o[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) o[d] = 0.f;

  const int n_tiles = 3 * chunk / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kbase = s0 + kt * kBK;
    __syncthreads();  // every warp is done with the previous Ks/Vs
    for (int idx = tid; idx < kBK * 8; idx += kTcThreads) {
      const int r = idx / 8, c = idx % 8;
      *reinterpret_cast<uint4*>(Ks + r * kLdh + 8 * c) =
          *reinterpret_cast<const uint4*>(kb + (long long)(kbase + r) * k_st + 8 * c);
      *reinterpret_cast<uint4*>(Vs + r * kLdh + 8 * c) =
          *reinterpret_cast<const uint4*>(vb + (long long)(kbase + r) * v_st + 8 * c);
    }
    __syncthreads();

    // S[16 rows of this warp][64 keys] = Q K^T
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(sf[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + 16 * warp * kLdh + 16 * kk, kLdh);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bk;
          wmma::load_matrix_sync(bk, Ks + 16 * j * kLdh + 16 * kk, kLdh);
          wmma::mma_sync(sf[j], a, bk, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Ss + 16 * warp * kLds + 16 * j, sf[j], kLds,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax for this lane's row over its 32 keys; the pair of
    // lanes (row, half 0/1) combines with one shuffle
    float* srow = Ss + row * kLds + 32 * half;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = kbase + 32 * half + j;
      const bool valid = key >= band_lo && key < band_hi && key < len;
      const float sv = valid ? srow[j] * scale : kNegInf;
      srow[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float rsum = 0.f;
    __nv_bfloat16* prow = Ps + row * kLdh + 32 * half;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(srow[j] - m_new);
      rsum += p;
      prow[j] = __float2bfloat16(p);
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    l_run = l_run * alpha + rsum;
    m_run = m_new;
    __syncwarp();

    // this tile's P V for the warp's rows, through Ss
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(of[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + 16 * warp * kLdh + 16 * kk, kLdh);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bv;
          wmma::load_matrix_sync(bv, Vs + 16 * kk * kLdh + 16 * j, kLdh);
          wmma::mma_sync(of[j], a, bv, of[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Ss + 16 * warp * kLds + 16 * j, of[j], kLds,
                                wmma::mem_row_major);
    }
    __syncwarp();
    const float* pv = Ss + row * kLds + 32 * half;
#pragma unroll
    for (int d = 0; d < 32; ++d) o[d] = o[d] * alpha + pv[d];
  }

  const float inv = 1.f / fmaxf(l_run, 1e-30f);
  __nv_bfloat16* orow =
      out + (((long long)b * T_total + q0 + row) * H + h) * kD + 32 * half;
#pragma unroll
  for (int d = 0; d < 32; d += 2)
    *reinterpret_cast<__nv_bfloat162*>(orow + d) =
        __floats2bfloat162_rn(o[d] * inv, o[d + 1] * inv);
}

int launch_tc(const void* q, const void* k, const void* v, const int* lengths,
              void* out, int B, int T_total, int H, int chunk,
              const long long* qs, const long long* ks, const long long* vs,
              float scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * 4 * kBQ * kLdh +
                      sizeof(float) * kBQ * kLds;
  cudaError_t err = cudaFuncSetAttribute(
      local_attn_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T_total / kBQ, H, B);
  local_attn_fwd_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths,
      static_cast<__nv_bfloat16*>(out), T_total, H, chunk, qs[0], qs[1], qs[2],
      ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, const long long* strides) {
  if (reinterpret_cast<unsigned long long>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int T_total, int H, int chunk,
           const long long* qs, const long long* ks, const long long* vs,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * kBQ * kPad;
  cudaError_t err = cudaFuncSetAttribute(
      local_attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T_total / kBQ, H, B);
  local_attn_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), T_total, H,
      chunk, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (b, t, h) for
// each of q, k, v; the output is contiguous (B, T, H, D).  Returns a
// cudaError_t (0 on success).
extern "C" int local_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   void* out, int B, int T, int H, int D,
                                   int chunk, long long q_sb, long long q_st,
                                   long long q_sh, long long k_sb,
                                   long long k_st, long long k_sh,
                                   long long v_sb, long long v_st,
                                   long long v_sh, float scale, void* stream) {
  if (D != kD || chunk % kBQ != 0 || T % chunk != 0 || T < 3 * chunk)
    return (int)cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_st, q_sh};
  const long long ks[3] = {k_sb, k_st, k_sh};
  const long long vs[3] = {v_sb, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, out, B, T, H, chunk, qs, ks, vs,
                         scale, st);
  if (dtype == 1 && aligned16(q, qs) && aligned16(k, ks) && aligned16(v, vs))
    return launch_tc(q, k, v, lengths, out, B, T, H, chunk, qs, ks, vs, scale,
                     st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, B, T, H, chunk, qs,
                                 ks, vs, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Chunk-local attention forward, written by hand for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/attention_kernel.py:35 _local_attn_kernel
// (the pallas_call in _local_attention_impl, wrapper local_attention_pallas)
// and, through the entry point local_attention_fwd_lse, ::_local_attn_fwd_
// lse_kernel (the pallas_call in _local_attention_fwd_lse_impl, wrapper
// local_attention_fwd_pallas): the same pass that also writes each query's
// log-sum-exp lse = m + log(max(sum, 1e-30)) in fp32, (B, H, T), for the
// backward kernels of csrc/local_attention_bwd.cu.  A query with no valid
// key gets lse = -1e30 + log W = -1e30 in fp32, as in the Pallas kernel.
//
// What it computes: for the queries of chunk i (chunk c), attention over the
// keys of the clipped window [s0, s0 + W), W = min(3c, T),
// s0 = clip((i-1)c, 0, T-W); a key counts when it lies in the band
// [(i-1)c, (i+2)c) and below lengths[b].  T is a multiple of c and at least
// 2c: at T = 2c the window is the whole sequence, as the band is (the
// Pallas kernel stops at 3c; T <= c is full attention, which the wrapper
// sends to csrc/full_attention.cu).
// Masked logits are -1e30 (not -inf), so a query with no valid key averages
// the whole clipped window uniformly, as the Pallas kernel does.  Softmax in
// fp32; inputs fp32 or bf16, (B, T, H, D) with any strides on B, T and H and
// the last dimension contiguous, so the q/k/v views of a fused qkv
// projection need no transpose or copy.
//
// What bounds it on this card: at the decoder's shapes (B 32, T 1024, H 8,
// D 64, c 256, bf16, every length T) the call moves 134 MB of q/k/v/out (40 us at 3.35
// TB/s) and does ~43 GFLOP of products over the (query, key) pairs in band
// and length (43 us at 989 TFLOP/s): bytes and tensor-core operations in
// balance.
//
// Design: one block per (query tile of 64, head, batch) walks key tiles of
// 64 with an online (flash-style) softmax, so no (T, W) score matrix
// reaches device memory.  Two variants, chosen by dtype and alignment:
//  - bf16 with 16-byte-aligned rows (rows 1 and 3; row 3 with the core's
//    kLse output): attention_fwd_sm90.cuh with LocalBandPolicy -- TMA ring
//    of K/V tiles, wgmma for Q K^T and P V with S, P and O in registers,
//    and only the key tiles of [max(s0, band_lo), min(s0 + W, band_hi,
//    length)) walked (kernels/local_attention.py::valid_key_tiles; the
//    whole window when that is empty).
//  - fp32 (and unaligned bf16): 256 threads, each owning a 4x4 micro-tile
//    of the 64x64 score tile and of the 64x64 output tile (rows ty + 16a,
//    columns tx + 16j) on the CUDA cores; rows padded to 65 floats so the
//    Q/K reads are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_fwd_sm90.cuh"

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

template <typename T, bool kLse>
__global__ void __launch_bounds__(kThreads)
local_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lengths,
                      T* __restrict__ out, float* __restrict__ lse,
                      int T_total, int H, int chunk,
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
  const int win = min(3 * chunk, T_total);         // keys in the window
  int s0 = (ci - 1) * chunk;
  s0 = max(0, min(s0, T_total - win));
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

  const int n_tiles = win / kBK;
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
    // m_run and l_run are the whole row's on all 16 lanes of the row
    if (kLse && tx == 0)
      lse[((long long)b * H + h) * T_total + row] =
          m_run[a] + logf(fmaxf(l_run[a], 1e-30f));
  }
}

bool aligned16(const void* p, const long long* strides) {
  if (reinterpret_cast<unsigned long long>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

template <typename T, bool kLse>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* lse, int B, int T_total, int H, int chunk,
           const long long* qs, const long long* ks, const long long* vs,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * kBQ * kPad;
  cudaError_t err = cudaFuncSetAttribute(
      local_attn_fwd_kernel<T, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T_total / kBQ, H, B);
  local_attn_fwd_kernel<T, kLse><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), lse, T_total,
      H, chunk, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      scale);
  return (int)cudaGetLastError();
}

template <bool kLse>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const int* lengths, void* out, float* lse, int B, int T, int H,
             int D, int chunk, const long long* qs, const long long* ks,
             const long long* vs, float scale, void* stream) {
  if (D != kD || chunk % kBQ != 0 || T % chunk != 0 || T < 2 * chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kLse>(q, k, v, lengths, out, lse, B, T, H, chunk, qs,
                               ks, vs, scale, st);
  if (dtype == 1 && aligned16(q, qs) && aligned16(k, ks) && aligned16(v, vs))
    return attn_sm90::launch<attn_sm90::LocalBandPolicy, kLse>(
        q, k, v, out, lse, B, T, T, H, qs, ks, vs,
        attn_sm90::LocalBandPolicy{lengths, T, chunk}, 0, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, kLse>(q, k, v, lengths, out, lse, B, T, H,
                                       chunk, qs, ks, vs, scale, st);
  return (int)cudaErrorInvalidValue;
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
  const long long qs[3] = {q_sb, q_st, q_sh};
  const long long ks[3] = {k_sb, k_st, k_sh};
  const long long vs[3] = {v_sb, v_st, v_sh};
  return dispatch<false>(dtype, q, k, v, lengths, out, nullptr, B, T, H, D,
                         chunk, qs, ks, vs, scale, stream);
}

// The same, and each query's log-sum-exp into lse, contiguous (B, H, T) fp32.
extern "C" int local_attention_fwd_lse(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const int* lengths, void* out,
                                       float* lse, int B, int T, int H, int D,
                                       int chunk, long long q_sb,
                                       long long q_st, long long q_sh,
                                       long long k_sb, long long k_st,
                                       long long k_sh, long long v_sb,
                                       long long v_st, long long v_sh,
                                       float scale, void* stream) {
  const long long qs[3] = {q_sb, q_st, q_sh};
  const long long ks[3] = {k_sb, k_st, k_sh};
  const long long vs[3] = {v_sb, v_st, v_sh};
  return dispatch<true>(dtype, q, k, v, lengths, out, lse, B, T, H, D, chunk,
                        qs, ks, vs, scale, stream);
}

// Blocks per SM and dynamic shared memory per block of row 1's bf16 kernel
// (attention_fwd_sm90.cuh).  Returns a cudaError_t.
extern "C" int local_attention_fwd_occupancy(int* blocks_per_sm,
                                             int* smem_bytes) {
  return attn_sm90::occupancy<attn_sm90::LocalBandPolicy>(0, blocks_per_sm,
                                                          smem_bytes);
}

// Full attention with a per-key mask, written by hand for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/attention_kernel.py:123 _full_attn_kernel
// (the pallas_call in _full_attention_impl, wrapper full_attention_pallas).
//
// What it computes: out[b, i, h] = softmax_j(q_i . k_j * D^-0.5) v_j over
// the Tk keys of batch row b, where a key with mask[b, j] == 0 gets the
// logit -1e30 (not -inf), so a query whose row has no valid key averages
// all Tk keys uniformly, as the Pallas kernel does.  The mask is any
// (B, Tk) byte mask (the denoiser's cross-attention mask is
// [text | padding | prompt], not a length); no mask means every key is
// valid.  Softmax in fp32; inputs fp32 or bf16, (B, T, H, D) with any
// strides on B, T and H and the last dimension contiguous, so the q/k/v
// views of a fused projection need no copy (bf16 rows must start on 16
// bytes: pointers aligned, strides in multiples of 8; anything else is
// refused).  The output is contiguous.  Any Tq and Tk: the grid covers the
// queries and the loop walks the key tiles.
//
// What bounds it on this card: at the denoiser's cross-attention (B 64,
// Tq 50, Tk 272, H 8, D 64, fp32, the most-launched shape) it reads 85 MB
// and does 1.8 GFLOP of products on the CUDA cores (~27 us at 67 TFLOP/s
// fp32, ~25 us of bytes at 3.35 TB/s); at the text encoder's self-attention
// (B 32, T 256, bf16) 1.1 GFLOP on the tensor cores against 34 MB of
// q/k/v/out (10 us of bytes): both are small, and what costs is staging,
// the block's latency and the launch, not the arithmetic.
//
// Design: one block per (query tile of 64, head, batch) walks the keys in
// tiles of 64 with an online (flash-style) softmax, so no (Tq, Tk) score
// matrix reaches device memory.  Query rows past Tq load as zeros and are
// not stored; key rows past Tk load as zeros and take the logit -inf, so
// they add nothing (a masked key inside Tk takes -1e30 and counts when its
// whole row is masked).
//  - bf16 (the encoders): attention_fwd_sm90.cuh with KeyMaskPolicy -- TMA
//    ring of K/V tiles (zero-filled past Tk), wgmma for Q K^T and P V with
//    S, P and O in registers; the block first reads its mask row into one
//    64-bit word per key tile and walks only the tiles with a valid key
//    (kernels/full_attention.py::valid_key_tiles; every tile when there is
//    none).  Shared memory grows by 12 bytes per key tile.
//  - fp32 (the denoiser): 256 threads, each a 4x4 micro-tile of the 64x64
//    score and output tiles, every product an fp32 FMA on the CUDA cores;
//    rows padded to 65 floats (no bank conflicts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "attention_fwd_sm90.cuh"

namespace {

constexpr int kD = 64;        // head dimension
constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 16 x 16
constexpr int kPad = kD + 1;  // smem row stride (floats)
constexpr float kNegInf = -1e30f;

// The logit of key `key`: -inf past Tk (no key), -1e30 where masked.
__device__ __forceinline__ float masked_logit(float s, int key, int Tk,
                                              const uint8_t* mrow,
                                              float scale) {
  if (key >= Tk) return -CUDART_INF_F;
  if (mrow != nullptr && mrow[key] == 0) return kNegInf;
  return s * scale;
}

// ---------------------------------------------------------------------------
// fp32 variant
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
full_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ out, int Tq, int Tk, int H,
                     long long q_sb, long long q_st, long long q_sh,
                     long long k_sb, long long k_st, long long k_sh,
                     long long v_sb, long long v_st, long long v_sh,
                     long long m_sb, float scale) {
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

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + b * m_sb;

  for (int idx = tid; idx < kBQ * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD;
    Qs[r * kPad + d] = q0 + r < Tq ? qb[(long long)(q0 + r) * q_st + d] : 0.f;
  }

  float m_run[4], l_run[4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = kNegInf;
    l_run[a] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  }

  const int n_tiles = (Tk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kbase = kt * kBK;
    __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed
    for (int idx = tid; idx < kBK * kD; idx += kThreads) {
      const int r = idx / kD, d = idx % kD;
      const bool in = kbase + r < Tk;
      Ks[r * kPad + d] = in ? kb[(long long)(kbase + r) * k_st + d] : 0.f;
      Vs[r * kPad + d] = in ? vb[(long long)(kbase + r) * v_st + d] : 0.f;
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
        s[a][j] = masked_logit(s[a][j], kbase + tx + 16 * j, Tk, mrow, scale);
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

  float* ob = out + ((long long)b * Tq * H + h) * kD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Tq) continue;
    const float inv = 1.f / fmaxf(l_run[a], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ob[(long long)row * H * kD + tx + 16 * j] = acc[a][j] * inv;
  }
}

struct Args {
  const void *q, *k, *v;
  const uint8_t* mask;
  void* out;
  int B, Tq, Tk, H;
  long long qs[3], ks[3], vs[3], m_sb;
  float scale;
};

int launch_sm90(const Args& a, cudaStream_t stream) {
  const attn_sm90::KeyMaskPolicy pol{a.mask, a.m_sb, a.Tk};
  return attn_sm90::launch(a.q, a.k, a.v, a.out, nullptr, a.B, a.Tq, a.Tk,
                           a.H, a.qs, a.ks, a.vs, pol,
                           attn_sm90::KeyMaskPolicy::scratch_bytes(a.Tk),
                           a.scale, stream);
}

int launch_fp32(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * kBQ * kPad;
  cudaError_t err = cudaFuncSetAttribute(
      full_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + kBQ - 1) / kBQ, a.H, a.B);
  full_attn_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<float*>(a.out),
      a.Tq, a.Tk, a.H, a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2],
      a.vs[0], a.vs[1], a.vs[2], a.m_sb, a.scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, const long long* strides) {
  if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (16-byte aligned rows).  Strides are in
// elements, (b, t, h) for each of q, k, v; mask is a (B, Tk) byte mask with
// batch stride m_sb and unit key stride, or null (every key valid); the
// output is contiguous (B, Tq, H, D).  Returns a cudaError_t (0 on
// success).
extern "C" int full_attention_fwd(int dtype, const void* q, const void* k,
                                  const void* v, const void* mask, void* out,
                                  int B, int Tq, int Tk, int H, int D,
                                  long long q_sb, long long q_st,
                                  long long q_sh, long long k_sb,
                                  long long k_st, long long k_sh,
                                  long long v_sb, long long v_st,
                                  long long v_sh, long long m_sb, float scale,
                                  void* stream) {
  if (D != kD || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const uint8_t*>(mask), out, B, Tq, Tk, H,
               {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
               m_sb, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fp32(a, st);
  if (dtype == 1 && aligned16(q, a.qs) && aligned16(k, a.ks) &&
      aligned16(v, a.vs))
    return launch_sm90(a, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks per SM and dynamic shared memory per block of the bf16 kernel
// (attention_fwd_sm90.cuh) at Tk keys.  Returns a cudaError_t.
extern "C" int full_attention_fwd_occupancy(int Tk, int* blocks_per_sm,
                                            int* smem_bytes) {
  return attn_sm90::occupancy<attn_sm90::KeyMaskPolicy>(
      attn_sm90::KeyMaskPolicy::scratch_bytes(Tk), blocks_per_sm,
      smem_bytes);
}

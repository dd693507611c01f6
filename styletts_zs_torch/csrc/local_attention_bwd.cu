// Chunk-local attention backward, written by hand for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/attention_kernel.py::_local_attn_bwd_dq_
// kernel and ::_local_attn_bwd_dkv_kernel (the two pallas_calls in
// _local_attention_bwd_impl, wrapper local_attention_bwd_pallas).
//
// What they compute, from q, k, v, the output's cotangent g (each
// (B, T, H, D)), the forward's per-query log-sum-exp lse and
// delta = sum_d g * out (both (B, H, T) fp32; delta is a PyTorch reduction,
// as JAX leaves it to XLA) and the key lengths:
//   p   = exp(s - lse),  s = q k^T * D^-0.5 with masked keys at -1e30,
//   dS  = p * (g v^T - delta),
//   dq  = D^-0.5 * dS k           over the query chunk's window (row 4: the
//                                 clipped window [s0, s0 + W), W = min(3c, T),
//                                 keys outside the band [(i-1)c, (i+2)c) or
//                                 past the length masked);
//   dk  = D^-0.5 * sum dS^T q,  dv = sum p^T g
//                                 over the query chunks j-1..j+1 inside
//                                 [0, n) of key chunk j (row 5: only the
//                                 length masks a key; the chunk walk is the
//                                 band).
// p and dS are rounded to the input dtype before their products, sums are
// fp32, outputs in the input dtype: the Pallas kernels' rounding points.  A
// query with no valid key has lse = -1e30, so its p is 1 on every masked key
// (the Pallas function, reproduced as it is; the decoder zeroes such rows'
// cotangent).
//
// What bounds them on this card: at the train step's shapes (B 16, T 1024,
// H 8, D 64, c 256) each kernel reads q, k, v, g (4 x 16.8 MB bf16) and
// writes 1 or 2 such tensors, and does three (dq) or four (dk, dv) products
// over the 16 x 8 x 1024 x 640 (query, key) pairs in band: ~27 GFLOP (dq)
// and ~36 GFLOP (dk/dv), ~30-40 us at the bf16 tensor-core peak against ~25
// us of bytes: bound by operations.
//
// Design: like the forward (csrc/local_attention.cu), one block per (tile of
// 64 queries -- or keys --, head, batch), four warps of 16 rows; the other
// side is walked in tiles of 64 staged in shared memory.  bf16 (the main
// path): the products run on the tensor cores as 16x16x16 warp MMAs with
// fp32 accumulation; S and g v^T of a warp's rows go through shared memory
// in fp32, where each lane turns its row's 32 entries into p and dS (bf16);
// the dq (or dk and dv) accumulators stay in MMA fragments across the walk.
// fp32: one thread per row on the CUDA cores, exact FMAs, so that the fp32
// card path is held to the CPU's (slow; not on the bf16 main path).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kD = 64;         // head dimension
constexpr int kBT = 64;        // rows per block, and per walked tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kLdh = kD + 8;   // bf16 row stride: 144 bytes
constexpr int kLds = kD + 4;   // fp32 row stride: 272 bytes
constexpr int kPad = kD + 1;   // fp32 rows of the CUDA-core variant
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, t, h;
};

// Copy 64 rows of 64 bf16 from (B, T, H, D) memory into [64][kLdh] smem.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long st, int tid) {
  for (int idx = tid; idx < kBT * 8; idx += kThreads) {
    const int r = idx / 8, c = idx % 8;
    *reinterpret_cast<uint4*>(dst + r * kLdh + 8 * c) =
        *reinterpret_cast<const uint4*>(src + (long long)r * st + 8 * c);
  }
}

using namespace nvcuda;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// dst[16][64] (fp32, row stride kLds) = A[16 rows][64] @ B[64 rows][64]^T,
// A and B bf16 with row stride kLdh.
__device__ __forceinline__ void mm_abt(float* dst, const __nv_bfloat16* A,
                                       const __nv_bfloat16* B) {
  FragC c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(c[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, A + 16 * kk, kLdh);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBt bt;
      wmma::load_matrix_sync(bt, B + 16 * j * kLdh + 16 * kk, kLdh);
      wmma::mma_sync(c[j], a, bt, c[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(dst + 16 * j, c[j], kLds, wmma::mem_row_major);
}

// acc[4] (16 x 64) += A[16 rows][64] @ B[64 rows][64], bf16, stride kLdh.
__device__ __forceinline__ void mm_ab_acc(FragC* acc, const __nv_bfloat16* A,
                                          const __nv_bfloat16* B) {
#pragma unroll
  for (int kk = 0; kk < kBT / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, A + 16 * kk, kLdh);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragB bf;
      wmma::load_matrix_sync(bf, B + 16 * kk * kLdh + 16 * j, kLdh);
      wmma::mma_sync(acc[j], a, bf, acc[j]);
    }
  }
}

// Write a warp's 16 x 64 fp32 accumulator (through smem at `tmp`, the warp's
// rows) times `scale` as bf16 rows of the contiguous (B, T, H, D) output.
__device__ __forceinline__ void store_rows(FragC* acc, float* tmp,
                                           __nv_bfloat16* dst_row0, int H,
                                           int lane, float scale) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(tmp + 16 * j, acc[j], kLds, wmma::mem_row_major);
  __syncwarp();
  const int r = lane / 2, half = lane % 2;
  const float* src = tmp + r * kLds + 32 * half;
  __nv_bfloat16* d = dst_row0 + (long long)r * H * kD + 32 * half;
#pragma unroll
  for (int e = 0; e < 32; e += 2)
    *reinterpret_cast<__nv_bfloat162*>(d + e) =
        __floats2bfloat162_rn(src[e] * scale, src[e + 1] * scale);
  __syncwarp();
}

// ---------------------------------------------------------------------------
// row 4: dq, bf16 tensor cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int* __restrict__ lengths, __nv_bfloat16* __restrict__ dq,
             int T_total, int H, int chunk, Strides qs, Strides ks, Strides vs,
             Strides gs, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + kBT * kLdh;
  __nv_bfloat16* Ks = Gs + kBT * kLdh;
  __nv_bfloat16* Vs = Ks + kBT * kLdh;
  __nv_bfloat16* Ps = Vs + kBT * kLdh;                       // dS, bf16
  float* Ss = reinterpret_cast<float*>(Ps + kBT * kLdh);     // s
  float* DPs = Ss + kBT * kLds;                              // g v^T

  const int q0 = blockIdx.x * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row = 16 * warp + lane / 2;
  const int half = lane % 2;

  const int ci = q0 / chunk;
  const int win = min(3 * chunk, T_total);
  const int s0 = max(0, min((ci - 1) * chunk, T_total - win));
  const int band_lo = (ci - 1) * chunk;
  const int band_hi = (ci + 2) * chunk;
  const int len = lengths[b];
  const long long stat = ((long long)b * H + h) * T_total + q0 + row;
  const float lse_r = lse[stat];
  const float delta_r = delta[stat];

  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  stage_bf16(Qs, q + b * qs.b + h * qs.h + (long long)q0 * qs.t, qs.t, tid);
  stage_bf16(Gs, g + b * gs.b + h * gs.h + (long long)q0 * gs.t, gs.t, tid);

  FragC acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  float* srow_w = Ss + 16 * warp * kLds;
  float* dprow_w = DPs + 16 * warp * kLds;
  for (int kbase = s0; kbase < s0 + win; kbase += kBT) {
    __syncthreads();  // every warp is done with the previous Ks/Vs
    stage_bf16(Ks, kb + (long long)kbase * ks.t, ks.t, tid);
    stage_bf16(Vs, vb + (long long)kbase * vs.t, vs.t, tid);
    __syncthreads();

    mm_abt(srow_w, Qs + 16 * warp * kLdh, Ks);    // s of the warp's rows
    mm_abt(dprow_w, Gs + 16 * warp * kLdh, Vs);   // g v^T
    __syncwarp();
    const float* srow = Ss + row * kLds + 32 * half;
    const float* dprow = DPs + row * kLds + 32 * half;
    __nv_bfloat16* prow = Ps + row * kLdh + 32 * half;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = kbase + 32 * half + j;
      const bool valid = key >= band_lo && key < band_hi && key < len;
      const float s = valid ? srow[j] * scale : kNegInf;
      const float p = expf(s - lse_r);
      prow[j] = __float2bfloat16(p * (dprow[j] - delta_r));
    }
    __syncwarp();
    mm_ab_acc(acc, Ps + 16 * warp * kLdh, Ks);    // dq += dS k
  }
  store_rows(acc, srow_w,
             dq + (((long long)b * T_total + q0 + 16 * warp) * H + h) * kD, H,
             lane, scale);
}

// ---------------------------------------------------------------------------
// row 5: dk and dv, bf16 tensor cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ lengths, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int T_total, int H, int chunk,
              Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kBT * kLdh;
  __nv_bfloat16* Qs = Vs + kBT * kLdh;
  __nv_bfloat16* Gs = Qs + kBT * kLdh;
  __nv_bfloat16* Ps = Gs + kBT * kLdh;                       // p^T, bf16
  __nv_bfloat16* DSs = Ps + kBT * kLdh;                      // dS^T, bf16
  float* Ss = reinterpret_cast<float*>(DSs + kBT * kLdh);    // s^T
  float* DPs = Ss + kBT * kLds;                              // v g^T
  float* lse_s = DPs + kBT * kLds;                           // [kBT]
  float* delta_s = lse_s + kBT;                              // [kBT]

  const int k0 = blockIdx.x * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row = 16 * warp + lane / 2;     // this lane's key
  const int half = lane % 2;                // and its 32 queries

  const int n = T_total / chunk;
  const int j = k0 / chunk;
  const int q_lo = max(j - 1, 0) * chunk;
  const int q_hi = min(j + 2, n) * chunk;
  const bool key_valid = k0 + row < lengths[b];
  const long long stat0 = ((long long)b * H + h) * T_total;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* gb = g + b * gs.b + h * gs.h;
  stage_bf16(Ks, k + b * ks.b + h * ks.h + (long long)k0 * ks.t, ks.t, tid);
  stage_bf16(Vs, v + b * vs.b + h * vs.h + (long long)k0 * vs.t, vs.t, tid);

  FragC acc_k[4], acc_v[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    wmma::fill_fragment(acc_k[jj], 0.f);
    wmma::fill_fragment(acc_v[jj], 0.f);
  }

  float* srow_w = Ss + 16 * warp * kLds;
  float* dprow_w = DPs + 16 * warp * kLds;
  for (int qbase = q_lo; qbase < q_hi; qbase += kBT) {
    __syncthreads();  // every warp is done with the previous Qs/Gs
    stage_bf16(Qs, qb + (long long)qbase * qs.t, qs.t, tid);
    stage_bf16(Gs, gb + (long long)qbase * gs.t, gs.t, tid);
    for (int i = tid; i < kBT; i += kThreads) {
      lse_s[i] = lse[stat0 + qbase + i];
      delta_s[i] = delta[stat0 + qbase + i];
    }
    __syncthreads();

    mm_abt(srow_w, Ks + 16 * warp * kLdh, Qs);    // s^T of the warp's keys
    mm_abt(dprow_w, Vs + 16 * warp * kLdh, Gs);   // (g v^T)^T
    __syncwarp();
    const float* srow = Ss + row * kLds + 32 * half;
    const float* dprow = DPs + row * kLds + 32 * half;
    __nv_bfloat16* prow = Ps + row * kLdh + 32 * half;
    __nv_bfloat16* dsrow = DSs + row * kLdh + 32 * half;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qi = 32 * half + i;
      const float s = key_valid ? srow[i] * scale : kNegInf;
      const float p = expf(s - lse_s[qi]);
      prow[i] = __float2bfloat16(p);
      dsrow[i] = __float2bfloat16(p * (dprow[i] - delta_s[qi]));
    }
    __syncwarp();
    mm_ab_acc(acc_k, DSs + 16 * warp * kLdh, Qs);  // dk += dS^T q
    mm_ab_acc(acc_v, Ps + 16 * warp * kLdh, Gs);   // dv += p^T g
  }
  const long long out0 = (((long long)b * T_total + k0 + 16 * warp) * H + h) * kD;
  store_rows(acc_k, srow_w, dk + out0, H, lane, scale);
  store_rows(acc_v, srow_w, dv + out0, H, lane, 1.f);
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core variants: one thread per row, exact FMAs
// ---------------------------------------------------------------------------

// Copy 64 rows of 64 fp32 into [64][kPad] smem.
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long st, int tid, int n_thr) {
  for (int idx = tid; idx < kBT * kD; idx += n_thr) {
    const int r = idx / kD, d = idx % kD;
    dst[r * kPad + d] = src[(long long)r * st + d];
  }
}

constexpr int kFThreads = kBT;   // one thread per row

__global__ void __launch_bounds__(kFThreads)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ lengths, float* __restrict__ dq,
              int T_total, int H, int chunk, Strides qs, Strides ks,
              Strides vs, Strides gs, float scale) {
  extern __shared__ float fsmem[];
  float* Qs = fsmem;                // [64][kPad]
  float* Gs = Qs + kBT * kPad;
  float* Ks = Gs + kBT * kPad;
  float* Vs = Ks + kBT * kPad;

  const int q0 = blockIdx.x * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r = threadIdx.x;

  const int ci = q0 / chunk;
  const int win = min(3 * chunk, T_total);
  const int s0 = max(0, min((ci - 1) * chunk, T_total - win));
  const int band_lo = (ci - 1) * chunk;
  const int band_hi = (ci + 2) * chunk;
  const int len = lengths[b];
  const long long stat = ((long long)b * H + h) * T_total + q0 + r;
  const float lse_r = lse[stat];
  const float delta_r = delta[stat];

  stage_f32(Qs, q + b * qs.b + h * qs.h + (long long)q0 * qs.t, qs.t, r,
            kFThreads);
  stage_f32(Gs, g + b * gs.b + h * gs.h + (long long)q0 * gs.t, gs.t, r,
            kFThreads);
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  const float* qr = Qs + r * kPad;
  const float* gr = Gs + r * kPad;
  for (int kbase = s0; kbase < s0 + win; kbase += kBT) {
    __syncthreads();
    stage_f32(Ks, kb + (long long)kbase * ks.t, ks.t, r, kFThreads);
    stage_f32(Vs, vb + (long long)kbase * vs.t, vs.t, r, kFThreads);
    __syncthreads();
    for (int j = 0; j < kBT; ++j) {
      const float* kr = Ks + j * kPad;
      const float* vr = Vs + j * kPad;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(gr[d], vr[d], dp);
      }
      const int key = kbase + j;
      const bool valid = key >= band_lo && key < band_hi && key < len;
      const float p = expf((valid ? s * scale : kNegInf) - lse_r);
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
    }
  }
  float* out = dq + (((long long)b * T_total + q0 + r) * H + h) * kD;
#pragma unroll
  for (int d = 0; d < kD; ++d) out[d] = acc[d] * scale;
}

__global__ void __launch_bounds__(kFThreads)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ lengths, float* __restrict__ dk,
               float* __restrict__ dv, int T_total, int H, int chunk,
               Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
  extern __shared__ float fsmem[];
  float* Ks = fsmem;                // [64][kPad]
  float* Vs = Ks + kBT * kPad;
  float* Qs = Vs + kBT * kPad;
  float* Gs = Qs + kBT * kPad;
  float* lse_s = Gs + kBT * kPad;   // [64]
  float* delta_s = lse_s + kBT;     // [64]

  const int k0 = blockIdx.x * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r = threadIdx.x;

  const int n = T_total / chunk;
  const int j = k0 / chunk;
  const int q_lo = max(j - 1, 0) * chunk;
  const int q_hi = min(j + 2, n) * chunk;
  const bool key_valid = k0 + r < lengths[b];
  const long long stat0 = ((long long)b * H + h) * T_total;

  stage_f32(Ks, k + b * ks.b + h * ks.h + (long long)k0 * ks.t, ks.t, r,
            kFThreads);
  stage_f32(Vs, v + b * vs.b + h * vs.h + (long long)k0 * vs.t, vs.t, r,
            kFThreads);
  const float* qb = q + b * qs.b + h * qs.h;
  const float* gb = g + b * gs.b + h * gs.h;

  float acc_k[kD], acc_v[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    acc_k[d] = 0.f;
    acc_v[d] = 0.f;
  }
  const float* kr = Ks + r * kPad;
  const float* vr = Vs + r * kPad;
  for (int qbase = q_lo; qbase < q_hi; qbase += kBT) {
    __syncthreads();
    stage_f32(Qs, qb + (long long)qbase * qs.t, qs.t, r, kFThreads);
    stage_f32(Gs, gb + (long long)qbase * gs.t, gs.t, r, kFThreads);
    lse_s[r] = lse[stat0 + qbase + r];
    delta_s[r] = delta[stat0 + qbase + r];
    __syncthreads();
    for (int i = 0; i < kBT; ++i) {
      const float* qr = Qs + i * kPad;
      const float* gr = Gs + i * kPad;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        s = fmaf(kr[d], qr[d], s);
        dp = fmaf(vr[d], gr[d], dp);
      }
      const float p = expf((key_valid ? s * scale : kNegInf) - lse_s[i]);
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        acc_k[d] = fmaf(ds, qr[d], acc_k[d]);
        acc_v[d] = fmaf(p, gr[d], acc_v[d]);
      }
    }
  }
  const long long out0 = (((long long)b * T_total + k0 + r) * H + h) * kD;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    dk[out0 + d] = acc_k[d] * scale;
    dv[out0 + d] = acc_v[d];
  }
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.t % 8 == 0 && s.h % 8 == 0;
}

int check_shape(int D, int chunk, int T) {
  if (D != kD || chunk % kBT != 0 || T % chunk != 0 || T < 2 * chunk)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g must then be 16-byte aligned
// with strides in multiples of 8).  q/k/v/g strides in elements, (b, t, h)
// each, last dimension contiguous; lse and delta contiguous (B, H, T) fp32;
// outputs contiguous (B, T, H, D).  T a multiple of chunk, at least 2 chunks,
// chunk % 64 == 0, D == 64.  Returns a cudaError_t (0 on success).
extern "C" int local_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, const int* lengths, void* dq, int B,
    int T, int H, int D, int chunk, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long g_sb,
    long long g_st, long long g_sh, float scale, void* stream) {
  if (int rc = check_shape(D, chunk, T)) return rc;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, gs{g_sb, g_st, g_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(T / kBT, H, B);
  if (dtype == 1) {
    if (!(aligned16(q, qs) && aligned16(k, ks) && aligned16(v, vs) &&
          aligned16(g, gs)))
      return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(__nv_bfloat16) * 5 * kBT * kLdh +
                        sizeof(float) * 2 * kBT * kLds;
    cudaError_t err = set_smem(dq_tc_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dq_tc_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g),
        lse, delta, lengths, static_cast<__nv_bfloat16*>(dq), T, H, chunk, qs,
        ks, vs, gs, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    const size_t smem = sizeof(float) * 4 * kBT * kPad;
    cudaError_t err = set_smem(dq_f32_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dq_f32_kernel<<<grid, kFThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
        lengths, static_cast<float*>(dq), T, H, chunk, qs, ks, vs, gs, scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int local_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, const int* lengths, void* dk,
    void* dv, int B, int T, int H, int D, int chunk, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long g_sb, long long g_st, long long g_sh, float scale,
    void* stream) {
  if (int rc = check_shape(D, chunk, T)) return rc;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, gs{g_sb, g_st, g_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(T / kBT, H, B);
  if (dtype == 1) {
    if (!(aligned16(q, qs) && aligned16(k, ks) && aligned16(v, vs) &&
          aligned16(g, gs)))
      return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(__nv_bfloat16) * 6 * kBT * kLdh +
                        sizeof(float) * (2 * kBT * kLds + 2 * kBT);
    cudaError_t err = set_smem(dkv_tc_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dkv_tc_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g),
        lse, delta, lengths, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), T, H, chunk, qs, ks, vs, gs, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    const size_t smem = sizeof(float) * (4 * kBT * kPad + 2 * kBT);
    cudaError_t err = set_smem(dkv_f32_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dkv_f32_kernel<<<grid, kFThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
        lengths, static_cast<float*>(dk), static_cast<float*>(dv), T, H, chunk,
        qs, ks, vs, gs, scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

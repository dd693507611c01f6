// Chunk-local attention backward, written by hand for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/attention_kernel.py:268 _local_attn_bwd_
// dq_kernel and :301 _local_attn_bwd_dkv_kernel (the two pallas_calls in
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
// us of bytes: bound by operations, so every product must run on wgmma.
//
// Design of the bf16 kernels (the main path), on the pieces of sm90.cuh that
// the forward core (attention_fwd_sm90.cuh) also uses:
//  - One warpgroup (128 threads) per block owns 64 rows: 64 queries (row 4,
//    dq_sm90_kernel) or 64 keys (row 5, dkv_sm90_kernel); grid (T/64, H, B).
//  - The block's own tiles (Q and g; K and V) are loaded once by TMA; the
//    other side's tiles of 64 rows (K and V; Q, g and their 64 lse and 64
//    delta values, two 256-byte bulk copies on the same mbarrier) stream
//    through a 2-stage TMA ring, one thread issuing the copies, the tile
//    after next requested as soon as a stage is released.  128-byte
//    swizzle, the (b, t, h) strides of the caller's views.
//  - Every product is an m64n64k16 wgmma with fp32 accumulators in
//    registers.  Row 4: S = Q K^T and dP = g V^T (A and B K-major in shared
//    memory), then dq += dS K with dS rounded to bf16 in registers as the A
//    operand (the accumulator's layout is the A fragment's) and K MN-major.
//    Row 5 the same transposed: S^T = K Q^T and dP^T = V g^T, then
//    dv += P^T g and dk += dS^T Q, P^T and dS^T from registers.  Each
//    thread keeps the lse and delta of its two rows (row 4) in registers;
//    row 5 reads its 16 query columns' from the stage's shared memory.
//  - Mask before the exponent: s = valid ? s * scale : -1e30, then
//    p = exp2((s - lse) log2 e), so a query with no valid key gets
//    exp(-1e30 - (-1e30)) = 1 exactly, as the Pallas kernels give it.
//  - dq (or dk and dv) stays in 32 fp32 registers a thread across the walk,
//    is scaled once at the end and written through shared memory as
//    16-byte rows.  Row 4 takes 50 200 bytes of shared memory and 142
//    registers, row 5 51 224 bytes and 168: three blocks an SM each
//    (chip_smoke.py's build phase prints both).  At the train step's shapes
//    they run at 2.4-2.7x their bounds, the pair 2.3-2.4x below SDPA's
//    whole backward (PERF.md).
//  - Exact tile skipping, each kernel walking what its Pallas kernel sums
//    (the two differ on a query chunk with no valid key):
//    row 4 (kernels/local_attention.py::valid_key_tiles): a query chunk
//    with a valid key walks the key tiles of [max(s0, band_lo), min(s0 + W,
//    band_hi, length)), the keys outside having p = exp(-1e30 - lse) = 0;
//    one without walks its whole window, where every key is masked, so p is
//    the row's exp(-1e30 - lse) whatever the scores: no Q K^T, no Q.
//    Row 5 (kernels/local_attention.py::bwd_dkv_query_tiles): a key tile
//    takes the query tiles of chunks j-1..j+1 inside [0, n); those of a
//    chunk with a valid key are skipped when the key tile lies wholly at or
//    past the length (p = 0 on every pair) and walked in full otherwise;
//    those of a chunk without one (then the key tile lies past the length)
//    take p = exp(-1e30 - lse) on every key: no K Q^T and no K.  A key tile
//    with nothing to walk writes zeros.
// fp32 (the card-vs-CPU gradient check): one thread per row on the CUDA
// cores, exact FMAs, so that the fp32 card path is held to the CPU's (slow;
// not on the bf16 main path).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kD = 64;         // head dimension
constexpr int kBT = 64;        // rows per block, and per walked tile
constexpr int kPad = kD + 1;   // fp32 rows of the CUDA-core variant
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, t, h;
};

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA tiles
// ---------------------------------------------------------------------------

namespace bwd_sm90 {

using namespace sm90;

constexpr int kThreads = 128;                  // one warpgroup
constexpr int kStages = 2;                     // ring depth
constexpr int kTileBytes = kBT * kD * 2;       // one 64 x 64 bf16 tile
constexpr int kStageBytes = 2 * kTileBytes;    // two tiles a stage
constexpr int kStatBytes = 2 * kBT * 4;        // row 5: lse, delta of a stage
constexpr int kDqBarOffset = 2 * kTileBytes + kStages * kStageBytes;
constexpr int kDkvBarOffset = kDqBarOffset + kStages * kStatBytes;
constexpr int kDqSmem = 1024 + kDqBarOffset + 8 * (1 + kStages);
constexpr int kDkvSmem = 1024 + kDkvBarOffset + 8 * (1 + kStages);
constexpr float kLog2e = 1.4426950408889634f;

// Row 4's walk for the queries of chunk ci (kernels/local_attention.py::
// valid_key_tiles): key tiles [first, first + 64 n); with a valid key the
// keys at or past `hi` are masked, without one every key is.
struct DqWalk {
  int first, n, hi;
  bool has_key;
};

__device__ __forceinline__ DqWalk dq_walk(int ci, int T, int chunk, int len) {
  const int win = min(3 * chunk, T);
  const int s0 = max(0, min((ci - 1) * chunk, T - win));
  const int lo = max(s0, (ci - 1) * chunk);   // a multiple of the tile
  const int hi = min(min(s0 + win, (ci + 2) * chunk), len);
  if (hi > lo) return {lo, (hi - lo + kBT - 1) / kBT, hi, true};
  return {s0, win / kBT, 0, false};
}

// Row 5's walk for the key tile at k0 (kernels/local_attention.py::
// bwd_dkv_query_tiles): query tiles [first, first + 64 n).  A query chunk
// has a valid key when the length passes the start of its band, so the
// chunks with one come first; if the key tile holds a key below the length,
// every chunk of j-1..j+1 has one and all are walked in full; if not, the
// pairs with those chunks add exactly 0 and only the chunks without one are
// walked, every key at -1e30 ("ones": p = exp(-1e30 - lse)).  So a block's
// pairs are all of one mode.
struct DkvWalk {
  int first, n;
  bool ones;
};

__device__ __forceinline__ DkvWalk dkv_walk(int k0, int T, int chunk,
                                            int len) {
  const int j = k0 / chunk;
  const int c_lo = max(j - 1, 0), c_hi = min(j + 2, T / chunk);
  const bool ones = k0 >= len;
  int first = c_lo;
  if (ones) {   // the first chunk of [c_lo, c_hi) without a valid key
    first = c_hi;
    for (int i = c_hi - 1; i >= c_lo; --i)
      if (!dq_walk(i, T, chunk, len).has_key) first = i;
  }
  return {first * chunk, (c_hi - first) * chunk / kBT, ones};
}

// One stage of a ring: two tiles of rows [t0, t0 + 64).
__device__ __forceinline__ void load_pair(uint32_t s0, uint32_t s1,
                                          uint32_t bar,
                                          const CUtensorMap* m0,
                                          const CUtensorMap* m1, int t0,
                                          int h, int b, uint32_t extra) {
  mbar_expect_tx(bar, kStageBytes + extra);
  tma_load_tile(s0, m0, bar, t0, h, b);
  tma_load_tile(s1, m1, bar, t0, h, b);
}

// Write a warpgroup's 64 x 64 fp32 accumulator times `scale` as bf16 into
// the swizzled tile at `tile` (16-byte chunks, no bank conflicts).
__device__ __forceinline__ void stage_out(unsigned char* tile,
                                          const float (&acc)[32], float scale,
                                          int warp, int lane) {
  const int quad = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + lane / 4 + 8 * r;
      const int idx = 4 * j + 2 * r;
      *reinterpret_cast<uint32_t*>(tile + row * 128 + ((j ^ (row & 7)) << 4) +
                                   4 * quad) =
          pack_bf16(acc[idx] * scale, acc[idx + 1] * scale);
    }
}

// Copy a staged tile to rows [t0, t0 + 64) of head h, batch b of a
// contiguous (B, T, H, 64) output as 16-byte rows.
__device__ __forceinline__ void store_tile(__nv_bfloat16* out,
                                           const unsigned char* tile, int b,
                                           int t0, int h, int T, int H,
                                           int tid) {
#pragma unroll
  for (int u = 0; u < kBT * 8 / kThreads; ++u) {
    const int idx = tid + kThreads * u;
    const int row = idx / 8, c = idx % 8;
    *reinterpret_cast<uint4*>(
        out + ((static_cast<long long>(b) * T + t0 + row) * H + h) * kD +
        8 * c) =
        *reinterpret_cast<const uint4*>(tile + row * 128 +
                                        ((c ^ (row & 7)) << 4));
  }
}

// ---------------------------------------------------------------------------
// row 4: dq.  Accumulator entries of a thread: d[4j + 2r + e] is row
// 16 warp + lane/4 + 8r, column 8j + 2(lane%4) + e.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 3)
dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ lengths, __nv_bfloat16* __restrict__ dq,
               int T, int H, int chunk, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle: 1024
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sG = base + kTileBytes;
  auto sK = [&](int s) { return base + 2 * kTileBytes + s * kStageBytes; };
  auto sV = [&](int s) { return sK(s) + kTileBytes; };
  const uint32_t bar_qg = base + kDqBarOffset;
  auto full = [&](int s) { return bar_qg + 8 * (1 + s); };

  const int q0 = blockIdx.x * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const DqWalk w = dq_walk(q0 / chunk, T, chunk, lengths[b]);

  if (tid == 0) {
    mbar_init(bar_qg, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
    mbar_expect_tx(bar_qg, w.has_key ? 2 * kTileBytes : kTileBytes);
    if (w.has_key) tma_load_tile(sQ, &tm_q, bar_qg, q0, h, b);
    tma_load_tile(sG, &tm_g, bar_qg, q0, h, b);
    for (int s = 0; s < kStages && s < w.n; ++s)
      load_pair(sK(s), sV(s), full(s), &tm_k, &tm_v, w.first + kBT * s, h, b,
                0);
  }
  float lse_r[2], delta_r[2], p_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = (static_cast<long long>(b) * H + h) * T + q0 +
                        16 * warp + lane / 4 + 8 * r;
    lse_r[r] = lse[i];
    delta_r[r] = delta[i];
    // without a valid key every key of the window is masked: p = this
    p_row[r] = expf(kNegInf - lse_r[r]);
  }
  __syncthreads();   // the barriers are initialised

  float acc[32], s[32], dp[32];
  uint32_t ds[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = dp[i] = 0.f;
  const uint64_t desc_q = desc128(sQ), desc_g = desc128(sG);

  mbar_wait(bar_qg, 0);
  for (int i = 0; i < w.n; ++i) {
    const int st = i % kStages;
    const int key0 = w.first + kBT * i;
    mbar_wait(full(st), (i / kStages) & 1);

    // dP = g V^T and (with a valid key) S = Q K^T, over D in four k-steps
    const uint64_t desc_k = desc128(sK(st)), desc_v = desc128(sV(st));
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dp, desc_g + 2 * kk, desc_v + 2 * kk, kk > 0);
    if (w.has_key) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    if (w.has_key) {
      const bool whole = key0 + kBT <= w.hi;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = key0 + 8 * (e / 4) + 2 * quad + e % 2;
        const float sv =
            (whole || key < w.hi) ? __fmul_rn(s[e], scale) : kNegInf;
        s[e] = fast_exp2((sv - lse_r[(e / 2) % 2]) * kLog2e);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = p_row[(e / 2) % 2];
    }
    // dS = p (dP - delta), rounded to bf16: the A fragment of dS K
#pragma unroll
    for (int e = 0; e < 16; ++e)
      ds[e] = pack_bf16(s[2 * e] * (dp[2 * e] - delta_r[e % 2]),
                        s[2 * e + 1] * (dp[2 * e + 1] - delta_r[e % 2]));

    // dq += dS K over the tile's keys in four k-steps of 16
    fence_regs(acc);
    fence_regs(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk)
      wgmma_rs(acc, ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2],
               ds[4 * kk + 3], desc_k + 128 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ds);

    __syncthreads();   // every warp is done with stage st
    if (tid == 0 && i + kStages < w.n)
      load_pair(sK(st), sV(st), full(st), &tm_k, &tm_v,
                w.first + kBT * (i + kStages), h, b, 0);
  }

  stage_out(smem, acc, scale, warp, lane);   // through Q's tile
  __syncthreads();
  store_tile(dq, smem, b, q0, h, T, H, tid);
}

// ---------------------------------------------------------------------------
// row 5: dk and dv.  Accumulator rows are keys, columns queries (S^T, dP^T)
// or head dimensions (dk, dv).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_g,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int* __restrict__ lengths,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int T, int H, int chunk, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + kTileBytes;
  auto sQ = [&](int s) { return base + 2 * kTileBytes + s * kStageBytes; };
  auto sG = [&](int s) { return sQ(s) + kTileBytes; };
  auto sStat = [&](int s) {
    return base + 2 * kTileBytes + kStages * kStageBytes + s * kStatBytes;
  };
  const uint32_t bar_kv = base + kDkvBarOffset;
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };

  const int k0 = blockIdx.x * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int len = lengths[b];
  const DkvWalk w = dkv_walk(k0, T, chunk, len);
  const long long stat0 = (static_cast<long long>(b) * H + h) * T;

  if (w.n == 0) {   // every pair adds exactly 0
#pragma unroll
    for (int u = 0; u < kBT * 8 / kThreads; ++u) {
      const int idx = tid + kThreads * u;
      const long long o =
          ((static_cast<long long>(b) * T + k0 + idx / 8) * H + h) * kD +
          8 * (idx % 8);
      *reinterpret_cast<uint4*>(dk + o) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv + o) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  auto load_stage = [&](int s, int q_start) {
    const uint32_t bar = full(s);
    load_pair(sQ(s), sG(s), bar, &tm_q, &tm_g, q_start, h, b, kStatBytes);
    bulk_load(sStat(s), lse + stat0 + q_start, kBT * 4, bar);
    bulk_load(sStat(s) + kBT * 4, delta + stat0 + q_start, kBT * 4, bar);
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
    mbar_expect_tx(bar_kv, w.ones ? kTileBytes : 2 * kTileBytes);
    if (!w.ones) tma_load_tile(sK, &tm_k, bar_kv, k0, h, b);
    tma_load_tile(sV, &tm_v, bar_kv, k0, h, b);
    for (int s = 0; s < kStages && s < w.n; ++s)
      load_stage(s, w.first + kBT * s);
  }
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_ok[r] = k0 + 16 * warp + lane / 4 + 8 * r < len;
  __syncthreads();   // the barriers are initialised

  float acc_k[32], acc_v[32], s[32], dp[32];
  uint32_t pt[16], dst[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = s[i] = dp[i] = 0.f;
  const uint64_t desc_k = desc128(sK), desc_v = desc128(sV);

  mbar_wait(bar_kv, 0);
  for (int i = 0; i < w.n; ++i) {
    const int st = i % kStages;
    mbar_wait(full(st), (i / kStages) & 1);

    // dP^T = V g^T and (unless every key is masked) S^T = K Q^T
    const uint64_t desc_q = desc128(sQ(st)), desc_g = desc128(sG(st));
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dp, desc_v + 2 * kk, desc_g + 2 * kk, kk > 0);
    if (!w.ones) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss(s, desc_k + 2 * kk, desc_q + 2 * kk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // p^T and dS^T; this thread's 16 query columns' lse and delta from the
    // stage's shared memory
    const float* lse_s =
        reinterpret_cast<const float*>(smem + (sStat(st) - base));
    const float* delta_s = lse_s + kBT;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = 8 * (e / 4) + 2 * quad + e % 2;
      const float l = lse_s[col];
      float p;
      if (w.ones) {
        p = expf(kNegInf - l);
      } else {
        const float sv = key_ok[(e / 2) % 2] ? __fmul_rn(s[e], scale)
                                             : kNegInf;
        p = fast_exp2((sv - l) * kLog2e);
      }
      s[e] = p;
      dp[e] = p * (dp[e] - delta_s[col]);
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      pt[e] = pack_bf16(s[2 * e], s[2 * e + 1]);
      dst[e] = pack_bf16(dp[2 * e], dp[2 * e + 1]);
    }

    // dv += P^T g and dk += dS^T Q over the tile's queries
    fence_regs(acc_k);
    fence_regs(acc_v);
    fence_regs(pt);
    fence_regs(dst);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk) {
      wgmma_rs(acc_v, pt[4 * kk], pt[4 * kk + 1], pt[4 * kk + 2],
               pt[4 * kk + 3], desc_g + 128 * kk);
      wgmma_rs(acc_k, dst[4 * kk], dst[4 * kk + 1], dst[4 * kk + 2],
               dst[4 * kk + 3], desc_q + 128 * kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_k);
    fence_regs(acc_v);
    fence_regs(pt);
    fence_regs(dst);

    __syncthreads();   // every warp is done with stage st
    if (tid == 0 && i + kStages < w.n)
      load_stage(st, w.first + kBT * (i + kStages));
  }

  // through K's and V's tiles
  stage_out(smem, acc_k, scale, warp, lane);
  stage_out(smem + kTileBytes, acc_v, 1.f, warp, lane);
  __syncthreads();
  store_tile(dk, smem, b, k0, h, T, H, tid);
  store_tile(dv, smem + kTileBytes, b, k0, h, T, H, tid);
}

// Launch row 4 (dkv false) or row 5 on bf16 (B, T, H, 64) views.
int launch(bool dkv, const void* q, const void* k, const void* v,
           const void* g, const float* lse, const float* delta,
           const int* lengths, void* out0, void* out1, int B, int T, int H,
           int chunk, const Strides& qs, const Strides& ks, const Strides& vs,
           const Strides& gs, float scale, cudaStream_t stream) {
  if (reinterpret_cast<unsigned long long>(lse) % 16 ||
      reinterpret_cast<unsigned long long>(delta) % 16)
    return (int)cudaErrorInvalidValue;   // row 5's bulk copies
  CUtensorMap tq, tk, tv, tg;
  const long long q3[3] = {qs.b, qs.t, qs.h}, k3[3] = {ks.b, ks.t, ks.h},
                  v3[3] = {vs.b, vs.t, vs.h}, g3[3] = {gs.b, gs.t, gs.h};
  if (!encode_view(&tq, q, B, T, H, q3) || !encode_view(&tk, k, B, T, H, k3) ||
      !encode_view(&tv, v, B, T, H, v3) || !encode_view(&tg, g, B, T, H, g3))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(T / kBT, H, B);
  const int smem = dkv ? kDkvSmem : kDqSmem;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = dkv ? cudaFuncSetAttribute(dkv_sm90_kernel, attr, smem)
                        : cudaFuncSetAttribute(dq_sm90_kernel, attr, smem);
  if (err != cudaSuccess) return (int)err;
  if (dkv)
    dkv_sm90_kernel<<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, tg, lse, delta, lengths,
        static_cast<__nv_bfloat16*>(out0), static_cast<__nv_bfloat16*>(out1),
        T, H, chunk, scale);
  else
    dq_sm90_kernel<<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, tg, lse, delta, lengths,
        static_cast<__nv_bfloat16*>(out0), T, H, chunk, scale);
  return (int)cudaGetLastError();
}

}  // namespace bwd_sm90

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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, lse and delta must then be
// 16-byte aligned, q/k/v/g strides in multiples of 8).  q/k/v/g strides in
// elements, (b, t, h) each, last dimension contiguous; lse and delta
// contiguous (B, H, T) fp32; outputs contiguous (B, T, H, D).  T a multiple
// of chunk, at least 2 chunks, chunk % 64 == 0, D == 64.  Returns a
// cudaError_t (0 on success).
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
    return bwd_sm90::launch(false, q, k, v, g, lse, delta, lengths, dq,
                            nullptr, B, T, H, chunk, qs, ks, vs, gs, scale,
                            st);
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
    return bwd_sm90::launch(true, q, k, v, g, lse, delta, lengths, dk, dv, B,
                            T, H, chunk, qs, ks, vs, gs, scale, st);
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

// Blocks per SM and dynamic shared memory per block of row 4's (dkv 0) or
// row 5's (dkv 1) bf16 kernel.  Returns a cudaError_t.
extern "C" int local_attention_bwd_occupancy(int dkv, int* blocks_per_sm,
                                             int* smem_bytes) {
  *smem_bytes = dkv ? bwd_sm90::kDkvSmem : bwd_sm90::kDqSmem;
  cudaError_t err = dkv ? set_smem(bwd_sm90::dkv_sm90_kernel, *smem_bytes)
                        : set_smem(bwd_sm90::dq_sm90_kernel, *smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return dkv ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, bwd_sm90::dkv_sm90_kernel,
                   bwd_sm90::kThreads, *smem_bytes)
             : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, bwd_sm90::dq_sm90_kernel,
                   bwd_sm90::kThreads, *smem_bytes);
}

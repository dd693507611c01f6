// The bf16 flash-attention forward for Hopper (sm_90a) shared by chunk-local
// attention (csrc/local_attention.cu: row 1, and row 3, the same function
// with each query's log-sum-exp) and full attention with a key mask
// (csrc/full_attention.cu, row 2).  Each source includes this header and
// instantiates attn_fwd_sm90_kernel with its mask policy and lse flag; the
// policies live here too, so that the one core is written and read once.
// Row 2's fp32 kernel (full_attention.cu, 3xTF32) takes KeyMaskPolicy,
// online_softmax and uniform_weights from here as well.
//
// What it computes, for one (64-query tile, head, batch) per block: the
// online softmax of q.k * D^-0.5 over the key tiles the policy walks, in
// fp32, and the normalised sum of p.v, stored as bf16 (with kLse, also the
// row's log-sum-exp in fp32, natural log).  A masked key inside
// the keys takes the logit -1e30, a key past Tk takes -inf; a row with no
// valid key therefore averages its keys uniformly, as the Pallas kernels do.
// Like the earlier tensor-core kernel it rounds the unnormalised p to bf16
// for P.V and divides by the fp32 row sum at the end; the plain versions
// round the normalised p.  The two agree within chip_smoke.py's
// TOL[...][bf16] = (1e-2, 1e-2).
//
// What bounds it: at row 1's main shape (B 32, T 1024, H 8, D 64, c 256,
// every length T) the call reads q/k/v and writes out, 134 MB (40 us at
// 3.35 TB/s), and does ~43 GFLOP of products over the valid (query, key)
// pairs (43 us at 989 TFLOP/s bf16): a balance of bytes and tensor-core
// operations, so the products must run on wgmma and each byte must be read
// from device memory about once.  Shorter lengths need fewer of both: K and
// V below the length, V of the windows with no valid key, no products there.
//
// Design:
//  - One warpgroup (128 threads) per block owns 64 query rows; grid
//    (ceil(Tq/64), H, B); 42 KB of shared memory and five blocks an SM.
//  - Q (64 x 64 bf16) is loaded once by TMA; K and V tiles of 64 keys arrive
//    by TMA in a ring of kStages stages, each completing on an mbarrier.  One
//    thread issues the copies; the tile after the next is requested as soon
//    as a stage is released, so a copy is always in flight while the
//    products of the current tile run.  The tensor maps use the (b, t, h)
//    strides of the views the caller hands over (the q/k/v views of a fused
//    projection), 128-byte swizzle: a 64-wide bf16 row is one swizzle row.
//  - S = Q K^T: four wgmma.m64n64k16 (A = Q and B = K from shared memory,
//    both K-major); the fp32 accumulator stays in registers.
//  - The scale, the mask and the online max / sum run on the accumulator
//    fragment: a thread holds 16 keys of two rows, the row max reduces over
//    the 4 lanes of a quad, the row sum stays per thread until the end.
//  - O += P V: P is rounded to bf16 in registers and is wgmma's A operand
//    from registers (the accumulator's layout is the A fragment's, so no
//    shuffle); B = V from shared memory, MN-major (the transpose bit).  O
//    stays in 32 fp32 registers a thread, rescaled per tile, normalised once
//    and written through shared memory as 16-byte rows.
//  - Key tiles with no valid key are skipped.  The mask depends on the key
//    and the batch row only (row 1's band is one per query chunk, and a
//    query tile lies in one chunk), so a block's rows all have a valid key
//    or none do.  With a valid key, a skipped tile would add exp(-1e30 - m)
//    = 0 to every sum, so skipping changes only the order of the remaining
//    sums.  With none, the block walks every tile, all at equal weight:
//    every logit there is -1e30 (or -inf past Tk), so p = 1 (or 0) exactly
//    whatever the scores, and the block loads no K, computes no scores
//    and runs P V alone.  The rule is that of
//    kernels/local_attention.py::valid_key_tiles (row 1: the tiles of
//    [max(s0, band_lo), min(s0 + W, band_hi, length))) and
//    kernels/full_attention.py::valid_key_tiles (row 2: the tiles whose mask
//    bytes hold a 1).
//  - Tried and not kept (chip_smoke.py --against, H100 SXM): a 3-stage ring
//    (58 KB, so 3 blocks an SM: up to 12 % slower) and overlapping tile i's
//    P V with tile i+1's softmax inside the warpgroup (7-25 % slower with a
//    3-stage ring at 3 blocks an SM, 28-47 % with 2 stages at 5); several
//    blocks an SM already overlap one block's softmax with another's
//    products.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "sm90.cuh"

namespace attn_sm90 {
namespace {

constexpr int kD = 64;           // head dimension
constexpr int kTile = 64;        // queries per block, keys per tile
constexpr int kThreads = 128;    // one warpgroup
constexpr int kStages = 2;       // K/V ring depth
constexpr int kTileBytes = kTile * kD * 2;        // one 64 x 64 bf16 tile
constexpr int kStageBytes = 2 * kTileBytes;       // K and V
constexpr int kBarOffset = kTileBytes + kStages * kStageBytes;
constexpr int kScratchOffset = kBarOffset + 8 * (1 + kStages);
constexpr int kBaseSmem = 1024 + kScratchOffset;  // + 1024 to align the base
constexpr float kMasked = -1e30f;   // a masked key's logit (a key past Tk: -inf)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using namespace sm90;

// One stage of the ring: the K (unless the block needs no scores) and V
// tiles of keys [key0, key0 + 64).
__device__ __forceinline__ void load_kv(uint32_t sk, uint32_t sv, uint32_t bar,
                                        const CUtensorMap* mk,
                                        const CUtensorMap* mv, int key0, int h,
                                        int b, bool with_k) {
  mbar_expect_tx(bar, with_k ? kStageBytes : kTileBytes);
  if (with_k) tma_load_tile(sk, mk, bar, key0, h, b);
  tma_load_tile(sv, mv, bar, key0, h, b);
}

// Bits [a, b) of a 64-bit word, a and b clipped to [0, 64].
__device__ __forceinline__ uint64_t bit_range(int a, int b) {
  a = max(a, 0);
  b = min(b, 64);
  if (b <= a) return 0ull;
  const uint64_t below_b = b >= 64 ? ~0ull : (1ull << b) - 1;
  const uint64_t below_a = (1ull << a) - 1;
  return below_b & ~below_a;
}

// ---------------------------------------------------------------------------
// Mask policies.  prepare() runs on every thread of the block before the
// walk, returns the number of key tiles to walk and sets none_valid when
// the block's rows have no valid key; key(i) is the first key of the i-th
// tile walked; valid(i, key0) the tile's keys that count (bit j = key
// key0 + j), in_keys(key0) those that exist (the others take -inf).
// ---------------------------------------------------------------------------

// Row 1: the queries of chunk ci attend to the clipped window [s0, s0 + W),
// W = min(3c, T), keys in the band [(ci-1)c, (ci+2)c) below the length.
struct LocalBandPolicy {
  const int* lengths;
  int T, chunk;
  int first, lo, hi;   // set by prepare: first key walked, valid [lo, hi)
  bool none_valid;

  __device__ int prepare(int q0, int b, unsigned char* /*scratch*/) {
    const int ci = q0 / chunk;
    const int win = min(3 * chunk, T);
    const int s0 = max(0, min((ci - 1) * chunk, T - win));
    lo = max(s0, (ci - 1) * chunk);
    hi = min(min(s0 + win, (ci + 2) * chunk), lengths[b]);
    none_valid = hi <= lo;
    if (!none_valid) {   // lo is a multiple of the chunk, so of the tile
      first = lo;
      return (hi - lo + kTile - 1) / kTile;
    }
    first = s0;          // the whole window, every key at -1e30
    lo = hi = 0;
    return win / kTile;
  }
  __device__ int key(int i) const { return first + kTile * i; }
  __device__ uint64_t valid(int /*i*/, int key0) const {
    return bit_range(lo - key0, hi - key0);
  }
  __device__ uint64_t in_keys(int /*key0*/) const { return ~0ull; }
};

// Row 2: a (B, Tk) byte mask (or none), any Tk.  prepare() writes each key
// tile's valid bits and the list of tiles to walk into the scratch shared
// memory: the tiles with a valid key, or every tile if there is none.
struct KeyMaskPolicy {
  const uint8_t* mask;   // null: every key valid
  long long m_sb;
  int Tk;
  const uint64_t* bits;  // set by prepare: valid bits per tile
  const int* list;       // tiles to walk
  bool none_valid;

  static __host__ __device__ int n_tiles(int Tk) {
    return (Tk + kTile - 1) / kTile;
  }
  static __host__ int scratch_bytes(int Tk) { return 12 * n_tiles(Tk) + 16; }

  __device__ int prepare(int /*q0*/, int b, unsigned char* scratch) {
    const int nt = n_tiles(Tk);
    uint64_t* tile_bits = reinterpret_cast<uint64_t*>(scratch);
    int* tiles = reinterpret_cast<int*>(scratch + 8 * nt);
    int* count = tiles + nt;
    const uint8_t* mrow = mask == nullptr ? nullptr : mask + b * m_sb;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int t = warp; t < nt; t += kThreads / 32) {
      const int k0 = kTile * t + lane, k1 = k0 + 32;
      const bool v0 = k0 < Tk && (mrow == nullptr || mrow[k0] != 0);
      const bool v1 = k1 < Tk && (mrow == nullptr || mrow[k1] != 0);
      const uint32_t lo32 = __ballot_sync(0xffffffffu, v0);
      const uint32_t hi32 = __ballot_sync(0xffffffffu, v1);
      if (lane == 0) tile_bits[t] = lo32 | (static_cast<uint64_t>(hi32) << 32);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int n = 0;
      for (int t = 0; t < nt; ++t)
        if (tile_bits[t] != 0) tiles[n++] = t;
      count[1] = n == 0;
      if (n == 0)    // no valid key: every tile, every key at -1e30
        for (; n < nt; ++n) tiles[n] = n;
      count[0] = n;
    }
    __syncthreads();
    bits = tile_bits;
    list = tiles;
    none_valid = count[1] != 0;
    return count[0];
  }
  __device__ int key(int i) const { return kTile * list[i]; }
  __device__ uint64_t valid(int i, int /*key0*/) const {
    return bits[list[i]];
  }
  __device__ uint64_t in_keys(int key0) const { return bit_range(0, Tk - key0); }
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// One tile's online softmax on the S accumulator, in place: mask and scale
// (log2 domain), the row max over the quad, the rescale factor alpha of the
// rows' earlier sums, s = exp2(s - m) and this thread's share of the row
// sums.  d[4j + 2r + e] is row 16 warp + lane/4 + 8r, key 8j + 2(lane%4) + e
// of the tile; `valid` and `in_keys` hold one bit per key of the tile.
__device__ __forceinline__ void online_softmax(float (&s)[32], uint64_t valid,
                                               uint64_t in_keys, int quad,
                                               float scale_log2,
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&alpha)[2]) {
  float mx[2] = {kMasked, kMasked};
  if (valid == ~0ull) {   // every key counts: the common tile
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] *= scale_log2;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
  } else {
    const float no_key = __int_as_float(0xff800000);   // -inf
    const uint64_t vbits = valid >> (2 * quad);
    const uint64_t kbits = in_keys >> (2 * quad);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int bit = 8 * (i / 4) + i % 2;
      s[i] = ((vbits >> bit) & 1)   ? s[i] * scale_log2
             : ((kbits >> bit) & 1) ? kMasked
                                    : no_key;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = fast_exp2(m_run[r] - m_new);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = fast_exp2(s[i] - m_run[(i / 2) % 2]);
    l_run[(i / 2) % 2] += s[i];
  }
}

// The weights of a block whose rows have no valid key: each of them takes
// every key of its window at -1e30, so p = exp2(-1e30 - (-1e30)) = 1 on
// every key that exists and 0 past Tk, whatever the scores; they need no
// scores, no max and no exp.
__device__ __forceinline__ void uniform_weights(float (&s)[32],
                                                uint64_t in_keys, int quad,
                                                float (&l_run)[2]) {
  const uint64_t kbits = in_keys >> (2 * quad);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ((kbits >> (8 * (i / 4) + i % 2)) & 1) ? 1.f : 0.f;
    l_run[(i / 2) % 2] += s[i];
  }
}

// P = s rounded to bf16 pairs: wgmma's A fragment for the four k-steps of
// 16 keys (the accumulator's layout is the A fragment's: p[4kk + q] = keys
// 16kk + 8(q/2) + 2(lane%4) + {0, 1}, row + 8(q%2)).
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&p)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// At most 102 registers a thread, so five blocks fit an SM (42 KB of
// shared memory each): 4-7 % faster than four at row 1's shapes on an H100
// SXM (chip_smoke.py --against a tree without the bound).
// kLse (row 3): also store each query's log-sum-exp in natural log, fp32
// (B, H, Tq): lse = m ln 2 + log(max(l, 1e-30)) from the base-2 running
// max m and the row sum l; a row with no valid key keeps m = -1e30, so its
// lse is -1e30 + log W = -1e30 in fp32, as the Pallas kernel gives it.
// kLse = false (rows 1, 2) compiles none of it.
template <class Policy, bool kLse>
__global__ void __launch_bounds__(kThreads, 5)
attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Policy policy, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int Tq, int H,
                     float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle: 1024
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t bar_q = base + kBarOffset;
  auto sK = [&](int s) { return base + kTileBytes + s * kStageBytes; };
  auto sV = [&](int s) { return sK(s) + kTileBytes; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  if (tid == 0) {   // Q first: its copy overlaps the policy's mask reads
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
    mbar_expect_tx(bar_q, kTileBytes);
    tma_load_tile(sQ, &tm_q, bar_q, q0, h, b);
  }
  Policy pol = policy;
  const int n = pol.prepare(q0, b, smem + kScratchOffset);
  __syncthreads();

  if (tid == 0)
    for (int s = 0; s < kStages && s < n; ++s)
      load_kv(sK(s), sV(s), full(s), &tm_k, &tm_v, pol.key(s), h, b,
              !pol.none_valid);

  // This thread's accumulator entries: d[4j + 2r + e] is row
  // 16 warp + lane/4 + 8r, column 8j + 2(lane%4) + e.
  const int quad = lane % 4;
  float o[32], s[32], alpha[2];
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = s[i] = 0.f;
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};   // this thread's share of the row sums
  const uint64_t desc_q = desc128(sQ);

  mbar_wait(bar_q, 0);   // also before a block without scores may exit
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const int key0 = pol.key(i);
    mbar_wait(full(st), (i / kStages) & 1);

    if (pol.none_valid) {
      uniform_weights(s, pol.in_keys(key0), quad, l_run);
    } else {
      // S = Q K^T over D in four k-steps of 16 (32 bytes of a swizzled row)
      const uint64_t desc_k = desc128(sK(st));
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      online_softmax(s, pol.valid(i, key0), pol.in_keys(key0), quad,
                     scale_log2, m_run, l_run, alpha);
#pragma unroll
      for (int j = 0; j < 32; ++j) o[j] *= alpha[(j / 2) % 2];
    }
    pack_p(s, p);

    // O += P V over the tile's keys in four k-steps of 16 (2048 bytes of V)
    const uint64_t desc_v = desc128(sV(st));
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               desc_v + 128 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p);

    __syncthreads();   // every warp is done with stage st
    if (tid == 0 && i + kStages < n)
      load_kv(sK(st), sV(st), full(st), &tm_k, &tm_v, pol.key(i + kStages), h,
              b, !pol.none_valid);
  }

  // normalise; write the tile through Q's shared memory (swizzled 16-byte
  // chunks, no bank conflicts) and out as 16-byte rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if constexpr (kLse) {
      const int row = q0 + 16 * warp + lane / 4 + 8 * r;
      if (quad == 0 && row < Tq)
        lse[(static_cast<long long>(b) * H + h) * Tq + row] =
            (pol.none_valid ? kMasked : m_run[r] * kLn2) +
            logf(fmaxf(l_run[r], 1e-30f));
    }
    l_run[r] = 1.f / fmaxf(l_run[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + lane / 4 + 8 * r;
      const int idx = 4 * j + 2 * r;
      *reinterpret_cast<uint32_t*>(smem + row * 128 + ((j ^ (row & 7)) << 4) +
                                   4 * quad) =
          pack_bf16(o[idx] * l_run[r], o[idx + 1] * l_run[r]);
    }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kTile * 8 / kThreads; ++u) {
    const int idx = tid + kThreads * u;
    const int row = idx / 8, c = idx % 8;
    if (q0 + row < Tq)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<long long>(b) * Tq + q0 + row) * H + h) * kD +
          8 * c) =
          *reinterpret_cast<const uint4*>(smem + row * 128 +
                                          ((c ^ (row & 7)) << 4));
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Launch on `stream`: q (B, Tq, H, 64), k/v (B, Tk, H, 64) bf16 views with
// element strides (b, t, h), 16-byte aligned; out contiguous (B, Tq, H, 64);
// with kLse, lse contiguous (B, H, Tq) fp32 (else null).  scratch: the
// policy's shared memory beyond the tiles.  Returns a cudaError_t.
template <class Policy, bool kLse = false>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Tq, int Tk, int H, const long long* qs,
           const long long* ks, const long long* vs, const Policy& policy,
           int scratch, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_view(&tq, q, B, Tq, H, qs) || !encode_view(&tk, k, B, Tk, H, ks) ||
      !encode_view(&tv, v, B, Tk, H, vs))
    return (int)cudaErrorInvalidValue;
  const int smem = kBaseSmem + scratch;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_sm90_kernel<Policy, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kTile - 1) / kTile, H, B);
  attn_fwd_sm90_kernel<Policy, kLse><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, policy, static_cast<__nv_bfloat16*>(out), lse, Tq, H,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// Blocks per SM and dynamic shared memory per block of the kernel.
template <class Policy, bool kLse = false>
int occupancy(int scratch, int* blocks_per_sm, int* smem_bytes) {
  *smem_bytes = kBaseSmem + scratch;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_sm90_kernel<Policy, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, attn_fwd_sm90_kernel<Policy, kLse>, kThreads,
      *smem_bytes);
}

}  // namespace
}  // namespace attn_sm90

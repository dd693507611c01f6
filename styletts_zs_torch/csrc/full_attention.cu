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
// valid.  Softmax in fp32; inputs fp32 or bf16, (B, T, H, D) with strides
// on B, T and H and the last dimension contiguous, so the q/k/v views of a
// fused projection need no copy; TMA needs rows that start on 16 bytes
// (pointers aligned, strides in multiples of 4 fp32 or 8 bf16 elements: the
// denoiser's fp32 views have row strides of 1536 and 1024), and anything
// else is refused.  The output is contiguous.  Any Tq and Tk: the grid
// covers the queries and the loop walks the key tiles.
//
// What bounds it on this card: at the denoiser's cross-attention (B 64,
// Tq 50, Tk 272, H 8, D 64, fp32, the most-launched shape) with every key
// valid, the function reads q, k, v and writes out, 85 MB (25 us at
// 3.35 TB/s), and does 1.8 GFLOP of products: 27 us as fp32 FMAs at
// 67 TFLOP/s, ~11 us as 3xTF32 (three TF32 products each) at 495 TFLOP/s.
// With the mask's invalid keys left out (K and V of valid keys only, the
// products over (query, valid key) pairs, as chip_smoke.py's
// _full_attention_work counts them) the bound at its random text lengths is
// 0.016 ms, of bytes.  At the text encoder's self-attention (B 32, T 256,
// bf16) 1.1 GFLOP on the tensor cores against 34 MB of q/k/v/out (10 us of
// bytes).  Both variants therefore run their products on the tensor cores
// and read each byte about once.
//
// Design: one block per (query tile of 64, head, batch) walks the key tiles
// of 64 with an online (flash-style) softmax, so no (Tq, Tk) score matrix
// reaches device memory; the grid is (1, 8, 64) at the denoiser's shapes.
// The block first reads its mask row into one 64-bit word per key tile and
// walks only the tiles with a valid key (kernels/full_attention.py::
// valid_key_tiles; every tile, all keys at weight 1 and no scores, when
// there is none): a skipped tile would add exactly 0.  Query rows past Tq
// load as zeros and are not stored; key rows past Tk load as zeros and take
// the logit -inf, so they add nothing (a masked key inside Tk takes -1e30
// and counts when its whole row is masked).
//  - bf16 (the encoders): attention_fwd_sm90.cuh with KeyMaskPolicy -- TMA
//    ring of K/V tiles, wgmma for Q K^T and P V with S, P and O in
//    registers.  Shared memory grows by 12 bytes per key tile.
//  - fp32 (the denoiser): full_attn_f32_sm90_kernel, the same walk (the
//    policy, the online softmax on the accumulator fragment and the uniform
//    weights are the bf16 core's) with every product in 3xTF32 on wgmma
//    (m64n64k8, fp32 accumulation): each operand x is split into TF32
//    values hi = rna(x) and lo = rna(x - hi), and x y is taken as
//    hi_x hi_y + hi_x lo_y + lo_x hi_y (sm90.cuh split_tf32), within about
//    2^-21 of x y relative.  One warpgroup owns 64 queries; Q's hi and lo
//    are wgmma's A fragments in registers for the whole walk.  K and V
//    tiles (two 32-float boxes each, 128-byte swizzle) arrive by TMA in a
//    2-stage ring on mbarriers.  Per tile the threads split K in place
//    (hi where it lies, lo beside it: both stay K-major for S = Q K^T) and
//    V into V_hi^T (over V's own room, once every thread holds its share)
//    and V_lo^T: TF32 wgmma takes only a K-major B, so P V needs V with
//    the keys contiguous, and the transpose comes with the split.  P is
//    split in registers and is the A operand of P V; the accumulator holds
//    keys 2c and 2c+1 of each 8 where TF32's A fragment wants c and c+4,
//    so V^T's keys are stored in that order (0 2 4 6 1 3 5 7 in each 8)
//    instead of shuffling P.  O stays in registers and is stored from them.
//    99 KB of shared memory and 255 registers a thread: two blocks an SM.
//    What bounds it (timed on an H100 SXM while building it, 64 x 50 x 272
//    masked, 0.045 ms): each block's steps run one after the other --
//    wait, split, 24 chained products, softmax, 24 more -- and two blocks
//    an SM overlap little of it; leaving out S's products, the lo products
//    or the split's stores each takes off 12-25 %.  Tried and not kept:
//    splitting V while S's products run (0.060 ms) and transposing V in
//    4 x 4 register blocks with 16-byte stores (0.052 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_fwd_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 variant: 3xTF32 on wgmma
// ---------------------------------------------------------------------------

namespace f32 {

using namespace sm90;
using attn_sm90::KeyMaskPolicy;

constexpr int kD = 64;                          // head dimension
constexpr int kTile = 64;                       // queries a block, keys a tile
constexpr int kThreads = 128;                   // one warpgroup
constexpr int kStages = 2;                      // K/V ring depth
constexpr int kPanelBytes = kTile * 128;        // 64 rows x 32 floats
constexpr int kTileBytes = 2 * kPanelBytes;     // 64 x 64 fp32: two panels
constexpr int kStageBytes = 2 * kTileBytes;     // K (then K_hi), V (then V_hi^T)
constexpr int kKLoOffset = kStages * kStageBytes;   // K_lo (Q before the walk)
constexpr int kVLoOffset = kKLoOffset + kTileBytes; // V_lo^T
constexpr int kBarOffset = kVLoOffset + kTileBytes;
constexpr int kScratchOffset = kBarOffset + 8 * (1 + kStages);
constexpr int kBaseSmem = 1024 + kScratchOffset;    // + 1024 to align the base
constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of element (row, col) of a 64 x 64 fp32 tile laid out as two
// panels of 32 columns, each 64 rows of 128 bytes with 128-byte swizzle (as
// TMA writes them, and as wgmma reads a K-major operand): the 16-byte chunk
// c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  return (col / 32) * kPanelBytes + row * 128 +
         ((((col % 32) / 4) ^ (row & 7)) << 4) + (col % 4) * 4;
}

// wgmma descriptor of k-step kk (8 columns) of such a tile.
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int kk) {
  return desc128(tile + (kk / 4) * kPanelBytes) + 2 * (kk % 4);
}

// The position of key r of a tile in V^T: within each 8 keys, key 2c at c
// and key 2c + 1 at c + 4 (the columns of P's A fragment, see above).
__device__ __forceinline__ int v_position(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// A 64 x 64 fp32 tile at (t, h, b) of a view's tensor map: two boxes.
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int t, int h, int b) {
  tma_load_4d(dst, map, bar, 0, t, h, b);
  tma_load_4d(dst + kPanelBytes, map, bar, 32, t, h, b);
}

__global__ void __launch_bounds__(kThreads, 2)
full_attn_f32_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const KeyMaskPolicy policy, float* __restrict__ out,
                          int Tq, int H, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle: 1024
  unsigned char* smem = smem_raw + (base - raw);
  auto sK = [&](int s) { return base + s * kStageBytes; };
  auto sV = [&](int s) { return sK(s) + kTileBytes; };
  const uint32_t sKlo = base + kKLoOffset;
  const uint32_t sVlo = base + kVLoOffset;
  const uint32_t bar_q = base + kBarOffset;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto at = [&](uint32_t addr) { return smem + (addr - base); };

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int row0 = 16 * warp + lane / 4;   // this thread's rows: row0, row0 + 8

  if (tid == 0) {   // Q (into K_lo's room) first: it overlaps the mask reads
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
    mbar_expect_tx(bar_q, kTileBytes);
    load_tile(sKlo, &tm_q, bar_q, q0, h, b);
  }
  KeyMaskPolicy pol = policy;
  const int n = pol.prepare(q0, b, smem + kScratchOffset);
  __syncthreads();

  auto load_kv = [&](int s, int key0) {
    mbar_expect_tx(full(s), pol.none_valid ? kTileBytes : 2 * kTileBytes);
    if (!pol.none_valid) load_tile(sK(s), &tm_k, full(s), key0, h, b);
    load_tile(sV(s), &tm_v, full(s), key0, h, b);
  };
  if (tid == 0)
    for (int s = 0; s < kStages && s < n; ++s) load_kv(s, pol.key(s));

  // Q's A fragments, hi and lo, for the eight k-steps of 8: element i of
  // k-step kk is row row0 + 8 (i % 2), column 8 kk + quad + 4 (i / 2)
  uint32_t qhi[32], qlo[32];
  mbar_wait(bar_q, 0);
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(*reinterpret_cast<const float*>(
                     at(sKlo + tile_offset(row0 + 8 * (i % 2),
                                           8 * kk + quad + 4 * (i / 2)))),
                 qhi[4 * kk + i], qlo[4 * kk + i]);
  __syncthreads();   // Q is read before the first tile's K_lo replaces it

  // o[4j + 2r + e] and s[...]: row row0 + 8r, column 8j + 2 quad + e
  float o[32], s[32], alpha[2];
  uint32_t phi[32], plo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = s[i] = 0.f;
  float m_run[2] = {attn_sm90::kMasked, attn_sm90::kMasked};
  float l_run[2] = {0.f, 0.f};   // this thread's share of the row sums

  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const int key0 = pol.key(i);
    mbar_wait(full(st), (i / kStages) & 1);

    // Split the tile.  Each thread takes 16-byte chunks (key r, columns
    // 4c .. 4c + 3): the 32 lanes of a warp take 32 keys of one chunk
    // column, so both the chunk reads and V^T's transposed word writes are
    // free of bank conflicts.
    float4 vr[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int item = tid + kThreads * u;
      vr[u] = *reinterpret_cast<const float4*>(
          at(sV(st) + tile_offset(item % kTile, 4 * (item / kTile))));
    }
    if (!pol.none_valid) {   // K: hi in place, lo into K_lo
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int item = tid + kThreads * u;
        const uint32_t off = tile_offset(item % kTile, 4 * (item / kTile));
        const float4 x = *reinterpret_cast<const float4*>(at(sK(st) + off));
        uint4 hi, lo;
        split_tf32(x.x, hi.x, lo.x);
        split_tf32(x.y, hi.y, lo.y);
        split_tf32(x.z, hi.z, lo.z);
        split_tf32(x.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(at(sK(st) + off)) = hi;
        *reinterpret_cast<uint4*>(at(sKlo + off)) = lo;
      }
    }
    __syncthreads();   // every thread holds its V: V_hi^T may replace it
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int item = tid + kThreads * u;
      const int pos = v_position(item % kTile);
      const int d0 = 4 * (item / kTile);
      const float x[4] = {vr[u].x, vr[u].y, vr[u].z, vr[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hi, lo;
        split_tf32(x[e], hi, lo);
        const uint32_t off = tile_offset(d0 + e, pos);
        *reinterpret_cast<uint32_t*>(at(sV(st) + off)) = hi;
        *reinterpret_cast<uint32_t*>(at(sVlo + off)) = lo;
      }
    }
    fence_proxy_async();   // the split tiles are read by wgmma
    __syncthreads();

    if (pol.none_valid) {
      attn_sm90::uniform_weights(s, pol.in_keys(key0), quad, l_run);
    } else {
      // S = Q K^T over D in eight k-steps of 8, three TF32 products each
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk) {
        const uint64_t dh = tile_desc(sK(st), kk);
        const uint64_t dl = tile_desc(sKlo, kk);
        const uint32_t* a = qhi + 4 * kk;
        const uint32_t* al = qlo + 4 * kk;
        wgmma_tf32(s, a[0], a[1], a[2], a[3], dh, kk > 0);
        wgmma_tf32(s, a[0], a[1], a[2], a[3], dl, 1);
        wgmma_tf32(s, al[0], al[1], al[2], al[3], dh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      attn_sm90::online_softmax(s, pol.valid(i, key0), pol.in_keys(key0),
                                quad, scale_log2, m_run, l_run, alpha);
#pragma unroll
      for (int j = 0; j < 32; ++j) o[j] *= alpha[(j / 2) % 2];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) split_tf32(s[j], phi[j], plo[j]);

    // O += P V over the tile's keys in eight k-steps of 8: P's fragment
    // (row, column c) is key 8 kk + 2c for c < 4 and 8 kk + 2(c - 4) + 1
    // above, the order V^T holds them in
    fence_regs(o);
    fence_regs(phi);
    fence_regs(plo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 8; ++kk) {
      const uint64_t dh = tile_desc(sV(st), kk);
      const uint64_t dl = tile_desc(sVlo, kk);
      const uint32_t* a = phi + 4 * kk;
      const uint32_t* al = plo + 4 * kk;
      wgmma_tf32(o, a[0], a[2], a[1], a[3], dh, 1);
      wgmma_tf32(o, a[0], a[2], a[1], a[3], dl, 1);
      wgmma_tf32(o, al[0], al[2], al[1], al[3], dh, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(phi);
    fence_regs(plo);

    __syncthreads();   // every warp is done with stage st, K_lo and V_lo^T
    if (tid == 0 && i + kStages < n) load_kv(st, pol.key(i + kStages));
  }

  // normalise and store each row's 8-byte pairs straight from the fragment
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = 1.f / fmaxf(l_run[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= Tq) continue;
    float* orow = out + ((static_cast<long long>(b) * Tq + row) * H + h) * kD +
                  2 * quad;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(o[4 * j + 2 * r] * l_run[r],
                      o[4 * j + 2 * r + 1] * l_run[r]);
  }
}

}  // namespace f32

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
  CUtensorMap tq, tk, tv;
  if (!sm90::encode_view(&tq, a.q, a.B, a.Tq, a.H, a.qs, true) ||
      !sm90::encode_view(&tk, a.k, a.B, a.Tk, a.H, a.ks, true) ||
      !sm90::encode_view(&tv, a.v, a.B, a.Tk, a.H, a.vs, true))
    return (int)cudaErrorInvalidValue;
  const attn_sm90::KeyMaskPolicy pol{a.mask, a.m_sb, a.Tk};
  const int smem =
      f32::kBaseSmem + attn_sm90::KeyMaskPolicy::scratch_bytes(a.Tk);
  cudaError_t err = cudaFuncSetAttribute(
      f32::full_attn_f32_sm90_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + f32::kTile - 1) / f32::kTile, a.H, a.B);
  f32::full_attn_f32_sm90_kernel<<<grid, f32::kThreads, smem, stream>>>(
      tq, tk, tv, pol, static_cast<float*>(a.out), a.Tq, a.H,
      a.scale * f32::kLog2e);
  return (int)cudaGetLastError();
}

// TMA reads rows that start on 16 bytes: the pointer aligned and the (b, t,
// h) strides in multiples of 16 bytes (8 bf16 or 4 fp32 elements).
bool aligned16(const void* p, const long long* strides, int elems) {
  if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % elems != 0) return false;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rows start on 16 bytes (pointers
// aligned, strides in multiples of 4 fp32 or 8 bf16 elements).  Strides are in
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
  if (D != f32::kD || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const uint8_t*>(mask), out, B, Tq, Tk, H,
               {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
               m_sb, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elems = dtype == 0 ? 4 : 8;
  if (!aligned16(q, a.qs, elems) || !aligned16(k, a.ks, elems) ||
      !aligned16(v, a.vs, elems))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_fp32(a, st);
  if (dtype == 1) return launch_sm90(a, st);
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

// The same for the fp32 kernel (full_attn_f32_sm90_kernel).  Returns a
// cudaError_t.
extern "C" int full_attention_f32_occupancy(int Tk, int* blocks_per_sm,
                                            int* smem_bytes) {
  *smem_bytes = f32::kBaseSmem + attn_sm90::KeyMaskPolicy::scratch_bytes(Tk);
  cudaError_t err = cudaFuncSetAttribute(
      f32::full_attn_f32_sm90_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, f32::full_attn_f32_sm90_kernel, f32::kThreads,
      *smem_bytes);
}

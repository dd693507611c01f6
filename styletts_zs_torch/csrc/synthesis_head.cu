// Fused vocoder synthesis head, written by hand for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/vocoder_kernels.py::_synth_head_kernel
// (the pallas_call in synthesis_head_pallas).
//
// What it computes, for x (B, T, C) and a K-tap head conv w (K, C, 3F) + b,
// F = n_fft/2 + 1:
//   h        = leaky_relu(x, 0.1)                       (in x's dtype)
//   y        = round_to_x_dtype(round_to_x_dtype(conv_SAME(h, w)) + b)
//   mag      = exp(clip(y[:F], -12, 6)),  n = rsqrt(pc^2 + ps^2 + 1e-7)
//   real     = mag * pc * n,  imag = mag * ps * n       (fp32; frames < T)
//   wav      = overlap_add([real | imag] @ syn, hop) * inv_env,
// trimmed by n_fft/2 on the left to (T-1)*hop samples, fp32.  syn is the
// (2F, n_fft) windowed irfft basis and inv_env = 1/max(envelope, 1e-8); the
// wrapper builds both in numpy once and copies them to the card.
//
// What bounds it on this card: at the main path's shapes (B 32, T 25600,
// C 128, K 7, n_fft 48, hop 12) it reads 210 MB of bf16 x and writes 39 MB
// of fp32 audio (~75 us at 3.35 TB/s), but the conv does 7*128*75 MACs per
// frame, ~110 GFLOP in all: bound by operations (~0.11 ms at the bf16
// tensor-core peak).
//
// Design: output-stationary, one block per (tile of frames' output samples,
// batch row), so blocks write disjoint samples and the overlap-add needs no
// atomics.  A block loads the input rows its frames need (the frames of its
// tile, the M-1 frames before it that overlap its samples, and the K-1 conv
// halo rows) into shared memory with leaky_relu applied, computes the head
// conv for those frames (the M-1 halo frames are recomputed by the
// neighbour block, a few percent extra), keeps conv output, magnitude/phase
// and the spectra in shared memory, and writes only the finished audio.
// Nothing between x and the waveform goes to device memory.
//
// The conv runs one of two ways, chosen by dtype and shape:
//  - bf16 with C % 16 == 0 (the main path): on the tensor cores, as K
//    shifted-row products [rows s .. s+127 of x] @ w[s] with warp-level
//    16x16x16 bf16 MMA (fp32 accumulate).  128 frames per block, one
//    16-row tile per warp, up to 5 16-column output tiles per pass; the
//    weights of one tap at a time stream through shared memory.
//  - fp32 (and any other shape): a register-tiled FMA loop on the CUDA
//    cores, 64 frames per block, each of the 256 threads owning 8 frames x
//    RO output channels (columns tx + 32j), weights in chunks of 32 input
//    channels; exact fp32 sums, so the fp32 check is tight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 32;   // threads along output channels
constexpr int kTY = 8;    // threads along frames
constexpr int kRF = 8;    // frames per thread: NFc = FT + M - 1 <= 64
constexpr int kCC = 32;   // input channels per weight chunk
constexpr int kMaxFrames = kTY * kRF;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// leaky_relu(x, 0.1) rounded as the JAX twin rounds it: the negative branch
// is a product in x's dtype (0.1 itself rounded to bf16 for bf16 input)
__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : x * 0.1f; }
__device__ __forceinline__ float leaky(__nv_bfloat16 x) {
  const float xf = __bfloat162float(x);
  if (xf >= 0.f) return xf;
  const float slope = __bfloat162float(__float2bfloat16(0.1f));
  return __bfloat162float(__float2bfloat16(xf * slope));
}

// conv + bias, each rounded to the compute dtype before the fp32 epilogue
__device__ __forceinline__ float add_bias(float acc, float bias) { return acc + bias; }
__device__ __forceinline__ float add_bias(float acc, __nv_bfloat16 bias) {
  const float a = __bfloat162float(__float2bfloat16(acc));
  return __bfloat162float(__float2bfloat16(a + __bfloat162float(bias)));
}

struct HeadShape {
  int T, C, K, n_freq, n_fft, hop, M, FT, out_len;
};

__host__ __device__ inline int rows_of(const HeadShape& s) {
  return s.FT + s.M - 1 + s.K - 1;
}

template <int RO>
__host__ __device__ inline size_t smem_floats(const HeadShape& s) {
  const int nfc = s.FT + s.M - 1;
  const int nop = kTX * RO;
  const int xs = rows_of(s) * s.C;
  const int yb = nfc * nop;
  return (size_t)(xs > yb ? xs : yb) + kCC * nop + nfc * 2 * s.n_freq +
         2 * s.n_freq * s.n_fft;
}

template <typename T, int RO>
__global__ void __launch_bounds__(kThreads)
synth_head_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, const float* __restrict__ syn,
                  const float* __restrict__ inv_env, float* __restrict__ out,
                  HeadShape s) {
  extern __shared__ float smem[];
  constexpr int NOP = kTX * RO;
  const int NO = 3 * s.n_freq;
  const int F2 = 2 * s.n_freq;
  const int NFc = s.FT + s.M - 1;       // frames whose spectra this block needs
  const int NR = rows_of(s);            // input rows those frames need
  const int xs_size = NR * s.C > NFc * NOP ? NR * s.C : NFc * NOP;
  float* xs = smem;                     // [NR][C]; later yb [NFc][NOP]
  float* ws = xs + xs_size;             // [kCC][NOP]
  float* spec = ws + kCC * NOP;         // [NFc][2F]
  float* syn_s = spec + NFc * F2;       // [2F][n_fft]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * s.FT;     // first frame whose samples we own
  const int g0 = f0 - (s.M - 1);        // first spectrum frame
  const int r0 = g0 - (s.K - 1) / 2;    // first input row
  const T* xb = x + (long long)b * s.T * s.C;

  for (int idx = tid; idx < NR * s.C; idx += kThreads) {
    const int row = r0 + idx / s.C;
    xs[idx] = (row >= 0 && row < s.T) ? leaky(xb[(long long)row * s.C + idx % s.C]) : 0.f;
  }
  for (int idx = tid; idx < F2 * s.n_fft; idx += kThreads) syn_s[idx] = syn[idx];

  float acc[kRF][RO];
#pragma unroll
  for (int r = 0; r < kRF; ++r)
#pragma unroll
    for (int j = 0; j < RO; ++j) acc[r][j] = 0.f;

  for (int tap = 0; tap < s.K; ++tap) {
    for (int c0 = 0; c0 < s.C; c0 += kCC) {
      __syncthreads();
      for (int idx = tid; idx < kCC * NOP; idx += kThreads) {
        const int cc = idx / NOP, o = idx % NOP;
        ws[idx] = (o < NO && c0 + cc < s.C)
                      ? to_f(w[((long long)tap * s.C + c0 + cc) * NO + o])
                      : 0.f;
      }
      __syncthreads();
      const int cn = min(kCC, s.C - c0);
      for (int cc = 0; cc < cn; ++cc) {
        float av[kRF], wv[RO];
#pragma unroll
        for (int r = 0; r < kRF; ++r) {
          const int i = ty + kTY * r;
          av[r] = i < NFc ? xs[(i + tap) * s.C + c0 + cc] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < RO; ++j) wv[j] = ws[cc * NOP + tx + kTX * j];
#pragma unroll
        for (int r = 0; r < kRF; ++r)
#pragma unroll
          for (int j = 0; j < RO; ++j) acc[r][j] = fmaf(av[r], wv[j], acc[r][j]);
      }
    }
  }
  __syncthreads();  // xs is dead: reuse it for the conv output

  float* yb = xs;
#pragma unroll
  for (int r = 0; r < kRF; ++r) {
    const int i = ty + kTY * r;
#pragma unroll
    for (int j = 0; j < RO; ++j) {
      const int o = tx + kTX * j;
      if (i < NFc && o < NO) yb[i * NOP + o] = add_bias(acc[r][j], bias[o]);
    }
  }
  __syncthreads();

  for (int idx = tid; idx < NFc * s.n_freq; idx += kThreads) {
    const int i = idx / s.n_freq, kf = idx % s.n_freq;
    const int g = g0 + i;
    float re = 0.f, im = 0.f;
    if (g >= 0 && g < s.T) {
      const float lm = yb[i * NOP + kf];
      const float pc = yb[i * NOP + s.n_freq + kf];
      const float ps = yb[i * NOP + 2 * s.n_freq + kf];
      const float mag = expf(fminf(fmaxf(lm, -12.f), 6.f));
      const float nrm = rsqrtf(pc * pc + ps * ps + 1e-7f);
      re = mag * pc * nrm;
      im = mag * ps * nrm;
    }
    spec[i * F2 + kf] = re;
    spec[i * F2 + s.n_freq + kf] = im;
  }
  __syncthreads();

  const int start = s.n_fft / 2;
  float* ob = out + (long long)b * s.out_len;
  for (int idx = tid; idx < s.FT * s.hop; idx += kThreads) {
    const int jf = idx / s.hop, phi = idx % s.hop;
    const long long s_full = (long long)(f0 + jf) * s.hop + phi;
    const long long s_out = s_full - start;
    if (s_out < 0 || s_out >= s.out_len) continue;
    float a = 0.f;
    for (int m = 0; m < s.M; ++m) {
      const int n = phi + s.hop * m;
      if (n >= s.n_fft) break;
      const float* sp = spec + (jf + s.M - 1 - m) * F2;
      for (int kk = 0; kk < F2; ++kk) a = fmaf(sp[kk], syn_s[kk * s.n_fft + n], a);
    }
    ob[s_out] = a * inv_env[s_full];
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core variant
// ---------------------------------------------------------------------------

constexpr int kTcFrames = 128;   // spectrum frames per block: 8 warps x 16
constexpr int kTcGroup = 5;      // 16-column output tiles per pass

struct TcLayout {
  int ldx, ldw, ldy, n_tiles;
  size_t xs, ws, yb, syn, total;   // byte offsets into shared memory
};

__host__ __device__ inline size_t round_up(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}

__host__ __device__ inline TcLayout tc_layout(const HeadShape& s) {
  TcLayout L;
  L.ldx = s.C + 16;                      // 32-byte-aligned row stride
  L.ldw = 16 * kTcGroup;
  L.n_tiles = (3 * s.n_freq + 15) / 16;
  L.ldy = 16 * L.n_tiles;
  const int nr = kTcFrames + s.K - 1;
  L.xs = 0;                              // bf16 [nr][ldx]; later spectra
  size_t xs_bytes = (size_t)nr * L.ldx * 2;
  const size_t spec_bytes = (size_t)kTcFrames * 2 * s.n_freq * 4;
  if (spec_bytes > xs_bytes) xs_bytes = spec_bytes;
  L.ws = round_up(L.xs + xs_bytes, 128);           // bf16 [C][ldw]
  L.yb = round_up(L.ws + (size_t)s.C * L.ldw * 2, 128);   // f32 [128][ldy]
  L.syn = round_up(L.yb + (size_t)kTcFrames * L.ldy * 4, 128);
  L.total = L.syn + (size_t)2 * s.n_freq * s.n_fft * 4;
  return L;
}

__global__ void __launch_bounds__(kThreads)
synth_head_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ bias,
                     const float* __restrict__ syn,
                     const float* __restrict__ inv_env,
                     float* __restrict__ out, HeadShape s) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TcLayout L = tc_layout(s);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.xs);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.ws);
  float* yb = reinterpret_cast<float*>(smem_raw + L.yb);
  float* spec = reinterpret_cast<float*>(smem_raw + L.xs);   // after the conv
  float* syn_s = reinterpret_cast<float*>(smem_raw + L.syn);

  const int NO = 3 * s.n_freq;
  const int F2 = 2 * s.n_freq;
  const int NR = kTcFrames + s.K - 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * s.FT;
  const int g0 = f0 - (s.M - 1);
  const int r0 = g0 - (s.K - 1) / 2;
  const __nv_bfloat16* xb = x + (long long)b * s.T * s.C;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int idx = tid; idx < NR * s.C; idx += kThreads) {
    const int r = idx / s.C, c = idx % s.C;
    const int row = r0 + r;
    xs[r * L.ldx + c] = (row >= 0 && row < s.T)
        ? __float2bfloat16(leaky(xb[(long long)row * s.C + c])) : zero;
  }
  for (int idx = tid; idx < F2 * s.n_fft; idx += kThreads) syn_s[idx] = syn[idx];

  for (int t0 = 0; t0 < L.n_tiles; t0 += kTcGroup) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTcGroup];
#pragma unroll
    for (int j = 0; j < kTcGroup; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int tap = 0; tap < s.K; ++tap) {
      __syncthreads();
      for (int idx = tid; idx < s.C * L.ldw; idx += kThreads) {
        const int c = idx / L.ldw, o = 16 * t0 + idx % L.ldw;
        ws[idx] = o < NO ? w[((long long)tap * s.C + c) * NO + o] : zero;
      }
      __syncthreads();
      for (int kk = 0; kk < s.C / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + (16 * warp + tap) * L.ldx + 16 * kk,
                               L.ldx);
#pragma unroll
        for (int j = 0; j < kTcGroup; ++j) {
          if (t0 + j < L.n_tiles) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> bw;
            wmma::load_matrix_sync(bw, ws + 16 * kk * L.ldw + 16 * j, L.ldw);
            wmma::mma_sync(acc[j], a, bw, acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kTcGroup; ++j)
      if (t0 + j < L.n_tiles)
        wmma::store_matrix_sync(yb + 16 * warp * L.ldy + 16 * (t0 + j),
                                acc[j], L.ldy, wmma::mem_row_major);
  }
  __syncthreads();  // yb complete; xs is dead and becomes the spectra

  for (int idx = tid; idx < kTcFrames * s.n_freq; idx += kThreads) {
    const int i = idx / s.n_freq, kf = idx % s.n_freq;
    const int g = g0 + i;
    float re = 0.f, im = 0.f;
    if (g >= 0 && g < s.T) {
      const float* y = yb + i * L.ldy;
      const float lm = add_bias(y[kf], bias[kf]);
      const float pc = add_bias(y[s.n_freq + kf], bias[s.n_freq + kf]);
      const float ps = add_bias(y[2 * s.n_freq + kf], bias[2 * s.n_freq + kf]);
      const float mag = expf(fminf(fmaxf(lm, -12.f), 6.f));
      const float nrm = rsqrtf(pc * pc + ps * ps + 1e-7f);
      re = mag * pc * nrm;
      im = mag * ps * nrm;
    }
    spec[i * F2 + kf] = re;
    spec[i * F2 + s.n_freq + kf] = im;
  }
  __syncthreads();

  const int start = s.n_fft / 2;
  float* ob = out + (long long)b * s.out_len;
  for (int idx = tid; idx < s.FT * s.hop; idx += kThreads) {
    const int jf = idx / s.hop, phi = idx % s.hop;
    const long long s_full = (long long)(f0 + jf) * s.hop + phi;
    const long long s_out = s_full - start;
    if (s_out < 0 || s_out >= s.out_len) continue;
    float a = 0.f;
    for (int m = 0; m < s.M; ++m) {
      const int n = phi + s.hop * m;
      if (n >= s.n_fft) break;
      const float* sp = spec + (jf + s.M - 1 - m) * F2;
      for (int kk = 0; kk < F2; ++kk) a = fmaf(sp[kk], syn_s[kk * s.n_fft + n], a);
    }
    ob[s_out] = a * inv_env[s_full];
  }
}

int launch_tc(const void* x, const void* w, const void* bias, const float* syn,
              const float* inv_env, float* out, int B, HeadShape s,
              cudaStream_t stream) {
  s.FT = kTcFrames - (s.M - 1);
  const size_t smem = tc_layout(s).total;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      synth_head_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int last_frame = (s.n_fft / 2 + s.out_len - 1) / s.hop;
  dim3 grid(last_frame / s.FT + 1, B);
  synth_head_tc_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), syn, inv_env, out, s);
  return (int)cudaGetLastError();
}

template <typename T, int RO>
int launch(const void* x, const void* w, const void* bias, const float* syn,
           const float* inv_env, float* out, int B, const HeadShape& s,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<RO>(s);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      synth_head_kernel<T, RO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // frames whose samples land in the trimmed output: [0, last_frame]
  const int last_frame = (s.n_fft / 2 + s.out_len - 1) / s.hop;
  dim3 grid(last_frame / s.FT + 1, B);
  synth_head_kernel<T, RO><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), syn, inv_env, out, s);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_ro(const void* x, const void* w, const void* bias,
                const float* syn, const float* inv_env, float* out, int B,
                const HeadShape& s, cudaStream_t stream) {
  const int NO = 3 * s.n_freq;
  if (NO <= kTX * 3) return launch<T, 3>(x, w, bias, syn, inv_env, out, B, s, stream);
  if (NO <= kTX * 6) return launch<T, 6>(x, w, bias, syn, inv_env, out, B, s, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and bias share it).  x (B, T, C),
// w (K, C, 3*n_freq), bias (3*n_freq,), syn (2*n_freq, n_fft) fp32,
// inv_env ((T-1)*hop + n_fft,) fp32, out (B, (T-1)*hop) fp32, all
// contiguous.  Returns a cudaError_t (0 on success).
extern "C" int synthesis_head_fwd(int dtype, const void* x, const void* w,
                                  const void* bias, const float* syn,
                                  const float* inv_env, float* out, int B,
                                  int T, int C, int K, int n_fft, int hop,
                                  void* stream) {
  HeadShape s;
  s.T = T;
  s.C = C;
  s.K = K;
  s.n_freq = n_fft / 2 + 1;
  s.n_fft = n_fft;
  s.hop = hop;
  s.M = (n_fft - 1) / hop + 1;
  s.FT = kMaxFrames - (s.M - 1);
  s.out_len = (T - 1) * hop;
  if (K % 2 == 0 || s.FT < 1 || T < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_ro<float>(x, w, bias, syn, inv_env, out, B, s, st);
  if (dtype == 1 && C % 16 == 0 && s.M - 1 < kTcFrames)
    return launch_tc(x, w, bias, syn, inv_env, out, B, s, st);
  if (dtype == 1)
    return dispatch_ro<__nv_bfloat16>(x, w, bias, syn, inv_env, out, B, s, st);
  return (int)cudaErrorInvalidValue;
}

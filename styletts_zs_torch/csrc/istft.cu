// Standalone centred iSTFT overlap-add, written by hand for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/vocoder_kernels.py::_istft_sf_kernel
// (the pallas_call of istft_pallas).
//
// What it computes, for real and imag (B, F, n_freq) fp32, n_freq =
// n_fft/2 + 1, window length n_fft:
//   frame_t = [real_t | imag_t] @ syn          syn: the (2 n_freq, n_fft)
//                                              irfft basis times the Hann
//                                              window, over n_fft
//   wav     = overlap_add(frames, hop) * inv_env,  inv_env = 1/max(sum of
//                                              the squared windows, 1e-8)
// trimmed by n_fft/2 on the left to (F-1)*hop samples, fp32.  The wrapper
// builds syn and inv_env in numpy once and copies them to the card.
//
// What bounds it on this card: per frame it reads 2 n_freq fp32 values and
// writes hop samples, against 2 * 2 n_freq * n_fft FLOPs; at the vocoder
// head's geometry (n_fft 48, hop 12) 200 bytes in and 48 out against 4 800
// FLOPs a frame, so bytes and fp32 operations are about even (~0.06 ms
// each at 32 x 25 600 frames).
//
// Design: output-stationary, one block per (FT frames' output samples,
// batch row), so blocks write disjoint samples and the overlap-add needs no
// atomics.  A block copies the spectra of the FT + M - 1 frames whose
// windows reach its samples (M = ceil(n_fft / hop)) into shared memory in
// one coalesced pass, and the basis too when it fits (else it is read
// through L1); then each thread takes output samples, sums the M frames
// that cover each against the basis column of its offset, and scales by
// the envelope.  The TPU kernel's super-frame layout (P = 128/hop frames a
// row, two matmuls per tile) is a lane-width device and is not carried
// over; nor is its fallback for windows wider than a super-frame: any
// n_fft and hop whose frames' tile fits in shared memory is taken (the
// wrapper chooses FT and raises for the rest).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void __launch_bounds__(kThreads)
istft_kernel(const float* __restrict__ real, const float* __restrict__ imag,
             const float* __restrict__ syn, const float* __restrict__ inv_env,
             float* __restrict__ out, int F, int n_fft, int hop, int FT,
             int syn_shared) {
  extern __shared__ float smem[];
  const int n_freq = n_fft / 2 + 1;
  const int F2 = 2 * n_freq;
  const int M = (n_fft - 1) / hop + 1;
  const int NF = FT + M - 1;           // spectrum frames this block needs
  float* spec = smem;                  // [NF][F2]: real | imag
  float* syn_s = spec + NF * F2;       // [F2][n_fft] when syn_shared

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;      // first frame whose samples we own
  const int g0 = f0 - (M - 1);         // first spectrum frame
  const long long plane = (long long)b * F * n_freq;

  for (int idx = tid; idx < NF * n_freq; idx += kThreads) {
    const int i = idx / n_freq, k = idx % n_freq;
    const int g = g0 + i;
    float re = 0.f, im = 0.f;
    if (g >= 0 && g < F) {
      const long long off = plane + (long long)g * n_freq + k;
      re = real[off];
      im = imag[off];
    }
    spec[i * F2 + k] = re;
    spec[i * F2 + n_freq + k] = im;
  }
  const float* basis = syn;
  if (syn_shared) {
    for (int idx = tid; idx < F2 * n_fft; idx += kThreads) syn_s[idx] = syn[idx];
    basis = syn_s;
  }
  __syncthreads();

  const int start = n_fft / 2;
  const long long out_len = (long long)(F - 1) * hop;
  float* ob = out + (long long)b * out_len;
  for (int idx = tid; idx < FT * hop; idx += kThreads) {
    const int jf = idx / hop, phi = idx % hop;
    const long long s_full = (long long)(f0 + jf) * hop + phi;
    const long long s_out = s_full - start;
    if (s_out < 0 || s_out >= out_len) continue;
    float a = 0.f;
    for (int m = 0; m < M; ++m) {
      const int n = phi + hop * m;     // offset of the sample in frame f0+jf-m
      if (n >= n_fft) break;
      const float* sp = spec + (jf + M - 1 - m) * F2;
      for (int kk = 0; kk < F2; ++kk) a = fmaf(sp[kk], basis[kk * n_fft + n], a);
    }
    ob[s_out] = a * inv_env[s_full];
  }
}

}  // namespace

// real, imag (B, F, n_fft/2 + 1) fp32 contiguous; syn (2*n_freq, n_fft)
// fp32; inv_env ((F-1)*hop + n_fft,) fp32; out (B, (F-1)*hop) fp32.  FT:
// frames of output per block; syn_shared: 1 to stage the basis in shared
// memory.  Returns a cudaError_t (0 on success).
extern "C" int istft_fwd(const float* real, const float* imag,
                         const float* syn, const float* inv_env, float* out,
                         int B, int F, int n_fft, int hop, int FT,
                         int syn_shared, void* stream) {
  if (B < 1 || F < 2 || n_fft < 2 || hop < 1 || FT < 1)
    return (int)cudaErrorInvalidValue;
  const int n_freq = n_fft / 2 + 1;
  const int M = (n_fft - 1) / hop + 1;
  const size_t smem = sizeof(float) *
      ((size_t)(FT + M - 1) * 2 * n_freq +
       (syn_shared ? (size_t)2 * n_freq * n_fft : 0));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      istft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // frames whose samples land in the trimmed output: [0, last_frame]
  const int last_frame = (n_fft / 2 + (F - 1) * hop - 1) / hop;
  dim3 grid(last_frame / FT + 1, B);
  istft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      real, imag, syn, inv_env, out, F, n_fft, hop, FT, syn_shared);
  return (int)cudaGetLastError();
}

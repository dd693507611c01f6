// Fused sampler step tail (CFG combine + score + Euler step / Heun
// correction), written by hand for Hopper (sm_90a).
//
// Replaces styletts_zs_tpu/kernels/sampler_kernel.py::_euler_kernel
// (fused_euler_step) and ::_heun_kernel (fused_heun_correction).
//
// What they compute, elementwise over the B*K*D fp32 style latents:
//   Euler: den = du + g (dc - du); d = (x - den) / s_cur;
//          x_out = x + ds * d, d_out = d                 (ds = s_next - s_cur)
//   Heun:  den2 = du + g (dc - du); d2 = (xe - den2) / s_div;
//          x_out = x + h (d1 + d2)          (h = ds / 2, s_div = max(s_next, 1e-8))
// The sigmas come from the schedule on the host, already rounded to float32
// (ds and the clamp too, as the JAX kernel takes them), as float arguments:
// nothing of the schedule goes through device memory.  dc and du are the
// two halves of the CFG-doubled denoiser output, passed as two pointers
// into the one (2B, K, D) tensor.
//
// What bounds them on this card: bytes.  At the sampler's shape (32, 50,
// 128) Euler reads 3 and writes 2 tensors of 819 KB (~1.2 us at 3.35 TB/s),
// Heun reads 5 and writes 1 (~1.5 us); a few FLOPs per value.  Design: one
// pass, each thread a float4 of every operand (every pointer must be 16-byte
// aligned, as the denoiser's halves are; the tail of at most 3 values goes
// value by value), a grid sized to the data so the whole tensor is one
// wave.  The rounding is
// spelled out with the _rn intrinsics, so nvcc neither contracts nor
// splits anything: the two products that XLA fuses into FMAs (g (dc - du)
// + du and the update's ds d + x, resp. h (d1 + d2) + x) are FMAs here too,
// the rest is rounded op by op, and the division is IEEE.  The result is
// then the plain version's (and XLA's on the CPU) to the last bit, bar a
// rare double rounding in the plain version's float64 FMA.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void euler_one(float x, float dc, float du,
                                          float s_cur, float ds, float g,
                                          float& x_out, float& d_out) {
  const float den = __fmaf_rn(g, __fsub_rn(dc, du), du);
  const float d = __fdiv_rn(__fsub_rn(x, den), s_cur);
  x_out = __fmaf_rn(ds, d, x);
  d_out = d;
}

__device__ __forceinline__ float heun_one(float x, float xe, float dc,
                                          float du, float d1, float h,
                                          float s_div, float g) {
  const float den2 = __fmaf_rn(g, __fsub_rn(dc, du), du);
  const float d2 = __fdiv_rn(__fsub_rn(xe, den2), s_div);
  return __fmaf_rn(h, __fadd_rn(d1, d2), x);
}

__global__ void __launch_bounds__(kThreads)
euler_kernel(const float* __restrict__ x, const float* __restrict__ dc,
             const float* __restrict__ du, float* __restrict__ x_out,
             float* __restrict__ d_out, long long n, float s_cur, float ds,
             float g) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long n4 = n / 4;
  if (i < n4) {
    const float4 a = reinterpret_cast<const float4*>(x)[i];
    const float4 c = reinterpret_cast<const float4*>(dc)[i];
    const float4 u = reinterpret_cast<const float4*>(du)[i];
    float4 xo, dd;
    euler_one(a.x, c.x, u.x, s_cur, ds, g, xo.x, dd.x);
    euler_one(a.y, c.y, u.y, s_cur, ds, g, xo.y, dd.y);
    euler_one(a.z, c.z, u.z, s_cur, ds, g, xo.z, dd.z);
    euler_one(a.w, c.w, u.w, s_cur, ds, g, xo.w, dd.w);
    reinterpret_cast<float4*>(x_out)[i] = xo;
    reinterpret_cast<float4*>(d_out)[i] = dd;
  }
  const long long t = 4 * n4 + i;  // the tail: at most 3 values
  if (i < 4 && t < n)
    euler_one(x[t], dc[t], du[t], s_cur, ds, g, x_out[t], d_out[t]);
}

__global__ void __launch_bounds__(kThreads)
heun_kernel(const float* __restrict__ x, const float* __restrict__ xe,
            const float* __restrict__ dc, const float* __restrict__ du,
            const float* __restrict__ d1, float* __restrict__ x_out,
            long long n, float h, float s_div, float g) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long n4 = n / 4;
  if (i < n4) {
    const float4 a = reinterpret_cast<const float4*>(x)[i];
    const float4 e = reinterpret_cast<const float4*>(xe)[i];
    const float4 c = reinterpret_cast<const float4*>(dc)[i];
    const float4 u = reinterpret_cast<const float4*>(du)[i];
    const float4 p = reinterpret_cast<const float4*>(d1)[i];
    float4 o;
    o.x = heun_one(a.x, e.x, c.x, u.x, p.x, h, s_div, g);
    o.y = heun_one(a.y, e.y, c.y, u.y, p.y, h, s_div, g);
    o.z = heun_one(a.z, e.z, c.z, u.z, p.z, h, s_div, g);
    o.w = heun_one(a.w, e.w, c.w, u.w, p.w, h, s_div, g);
    reinterpret_cast<float4*>(x_out)[i] = o;
  }
  const long long t = 4 * n4 + i;  // the tail: at most 3 values
  if (i < 4 && t < n)
    x_out[t] = heun_one(x[t], xe[t], dc[t], du[t], d1[t], h, s_div, g);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// one thread per float4, and at least the 4 threads that take the tail
unsigned int n_blocks(long long n) {
  return (unsigned int)((std::max(n / 4, 4LL) + kThreads - 1) / kThreads);
}

}  // namespace

// x, den_cond, den_uncond -> x_out, d_out; n fp32 values each, contiguous
// and 16-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int sampler_euler_fwd(const float* x, const float* dc,
                                 const float* du, float* x_out, float* d_out,
                                 long long n, float s_cur, float ds, float g,
                                 void* stream) {
  if (n <= 0 || !(aligned16(x) && aligned16(dc) && aligned16(du) &&
                  aligned16(x_out) && aligned16(d_out)))
    return (int)cudaErrorInvalidValue;
  euler_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dc, du, x_out, d_out, n, s_cur, ds, g);
  return (int)cudaGetLastError();
}

// x, x_euler, den2_cond, den2_uncond, d_cur -> x_out; h = (s_next - s_cur)/2,
// s_div = max(s_next, 1e-8); contiguous and 16-byte aligned.  Returns a
// cudaError_t (0 on success).
extern "C" int sampler_heun_fwd(const float* x, const float* xe,
                                const float* dc, const float* du,
                                const float* d1, float* x_out, long long n,
                                float h, float s_div, float g, void* stream) {
  if (n <= 0 || !(aligned16(x) && aligned16(xe) && aligned16(dc) &&
                  aligned16(du) && aligned16(d1) && aligned16(x_out)))
    return (int)cudaErrorInvalidValue;
  heun_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, xe, dc, du, d1, x_out, n, h, s_div, g);
  return (int)cudaGetLastError();
}

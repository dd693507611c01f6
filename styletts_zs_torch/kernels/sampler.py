"""Fused sampler step tail: the CUDA kernels' wrappers and plain versions.

Port of ``styletts_zs_tpu/kernels/sampler_kernel.py``: ``_euler_kernel``
(``fused_euler_step``) and ``_heun_kernel`` (``fused_heun_correction``).
The kernels are ``csrc/sampler.cu``.  Each is one elementwise fp32 pass
over the (B, K, D) style latents, after the CFG-doubled denoiser call:

    Euler:  den = du + g (dc - du);  d = (x - den) / s_cur;
            x' = x + (s_next - s_cur) d                       -> (x', d)
    Heun:   den2 = du2 + g (dc2 - du2);
            d2 = (x_e - den2) / max(s_next, 1e-8);
            x' = x + ((s_next - s_cur) / 2) (d1 + d2)        -> x'

``dc``/``du`` are the two halves of the doubled denoiser output, taken as
views.  The schedule lives on the host, so the sigmas arrive as Python
numbers; the step ``s_next - s_cur`` and the 1e-8 clamp are taken in
float32, as the JAX kernel takes them.  The guidance combine and the update
are fused multiply-adds, as XLA compiles the JAX kernel and its twin (each
rounded once): at sigma 80 the update ``x + ds d`` cancels most of x, and
two roundings there would leave an error of an ulp of x (~1e-5) in a
result of order 1.
"""
from __future__ import annotations

import numpy as np
import torch

from styletts_zs_torch.kernels import build, plain

# CUDA kernel launches; the ``*_cuda`` wrappers add one each
launches = {"sampler_euler": 0, "sampler_heun": 0}


def _sigmas(s_cur, s_next):
    """(s_cur, s_next, s_next - s_cur, max(s_next, 1e-8)) in float32."""
    s_cur, s_next = np.float32(s_cur), np.float32(s_next)
    return (s_cur, s_next, np.float32(s_next - s_cur),
            np.maximum(s_next, np.float32(1e-8)))


def check_operands(x, *others) -> None:
    """What the kernels and their plain versions take: fp32 tensors of one
    shape with a contiguous last dimension, on one device.  Raises on
    anything else (the sampler always hands over such tensors)."""
    for t in (x, *others):
        if t.dtype != torch.float32 or t.shape != x.shape or \
                t.device != x.device or t.stride(-1) != 1:
            raise ValueError(
                f"sampler kernels take fp32 tensors shaped like x "
                f"{tuple(x.shape)} on {x.device} with a contiguous last "
                f"dimension; got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"strides {t.stride()}")


def _fma(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 a*b + c rounded once: the product of two fp32 values is exact
    in fp64, and so is the sum up to a rare double rounding."""
    return (float(a) * b.double() + c.double()).float()


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE a / b on any device: PyTorch's CUDA division by a host number
    multiplies by its reciprocal instead, which can differ in the last
    bit, so the divisor is a tensor."""
    return a / torch.full_like(a, float(b))


def euler_step_plain(x, den_cond, den_uncond, s_cur, s_next, *,
                     guidance: float):
    """Plain PyTorch version of the Euler kernel: (x_euler, d), both fp32."""
    plain.note("sampler_euler", x)
    s_cur, _, ds, _ = _sigmas(s_cur, s_next)
    x, dc, du = x.float(), den_cond.float(), den_uncond.float()
    den = _fma(np.float32(guidance), dc - du, du)
    d = _div(x - den, s_cur)
    return _fma(ds, d, x), d


def heun_correction_plain(x, x_euler, den2_cond, den2_uncond, d_cur, s_cur,
                          s_next, *, guidance: float):
    """Plain PyTorch version of the Heun kernel: x_next, fp32."""
    plain.note("sampler_heun", x)
    _, _, ds, s_div = _sigmas(s_cur, s_next)
    dc, du = den2_cond.float(), den2_uncond.float()
    den2 = _fma(np.float32(guidance), dc - du, du)
    d2 = _div(x_euler.float() - den2, s_div)
    return _fma(ds * np.float32(0.5), d_cur.float() + d2, x.float())


def _check_cuda(*ts) -> None:
    """The kernels walk B*K*D contiguous values as float4s: the denoiser's
    halves are contiguous views of its (2B, K, D) output, 16-byte aligned
    when B*K*D divides by 4, so nothing is copied."""
    if not ts[0].is_cuda:
        raise ValueError(f"need CUDA tensors, got {ts[0].device}")
    check_operands(*ts)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("the sampler kernels take contiguous tensors that "
                         "start on 16 bytes")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def euler_step_cuda(x, den_cond, den_uncond, s_cur, s_next, *,
                    guidance: float):
    """Launch ``sampler_euler_fwd`` on the current stream; (x_euler, d)."""
    _check_cuda(x, den_cond, den_uncond)
    s_cur, _, ds, _ = _sigmas(s_cur, s_next)
    x_out = torch.empty_like(x)
    d_out = torch.empty_like(x)
    rc = build.library().lib.sampler_euler_fwd(
        x.data_ptr(), den_cond.data_ptr(), den_uncond.data_ptr(),
        x_out.data_ptr(), d_out.data_ptr(), x.numel(), float(s_cur),
        float(ds), float(np.float32(guidance)), _stream(x))
    build.check(rc, "sampler_euler_fwd")
    launches["sampler_euler"] += 1
    return x_out, d_out


def heun_correction_cuda(x, x_euler, den2_cond, den2_uncond, d_cur, s_cur,
                         s_next, *, guidance: float):
    """Launch ``sampler_heun_fwd`` on the current stream; x_next."""
    _check_cuda(x, x_euler, den2_cond, den2_uncond, d_cur)
    _, _, ds, s_div = _sigmas(s_cur, s_next)
    out = torch.empty_like(x)
    rc = build.library().lib.sampler_heun_fwd(
        x.data_ptr(), x_euler.data_ptr(), den2_cond.data_ptr(),
        den2_uncond.data_ptr(), d_cur.data_ptr(), out.data_ptr(), x.numel(),
        float(ds * np.float32(0.5)), float(s_div),
        float(np.float32(guidance)), _stream(x))
    build.check(rc, "sampler_heun_fwd")
    launches["sampler_heun"] += 1
    return out

"""Fused AdaIN -> SiLU -> dilated conv: the CUDA kernel's wrapper, its plain
version and the decoder block built from two passes.

Port of ``styletts_zs_tpu/kernels/decoder_kernels.py::_mod_conv_kernel``
(``_mod_conv_pass``, ``adain_conv_block_pallas``).  The kernel is
``csrc/adain_conv.cu``.  One pass, for x (B, T, C), scale/shift (B, T, C)
or (B, C), the instance statistics mean/rstd (B, C) of x and a weight
(K, C, C_out) in the JAX layout:

    h = silu((x - mean) * rstd * (1 + scale) + shift)   in fp32, rounded
        once to x's dtype (the Pallas kernel's rounding);
    y = SAME conv of h with the weight, dilation d     fp32 sums, x's dtype.

The block is pass 1 with dilation d, the statistics of its output, pass 2
with dilation 1, then ``(x + h2) / sqrt(2)`` in fp32 rounded to x's dtype
(h2 is rounded to x's dtype first, as JAX's block rounds it).  The
statistics are fp32 ``torch.var_mean`` over T, as JAX takes them in XLA
outside the Pallas kernel (``_instance_stats``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from styletts_zs_torch.kernels import build, plain

launches = 0   # CUDA kernel launches; ``adain_conv_pass_cuda`` adds one each

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def instance_stats(x: torch.Tensor, eps: float = 1e-5):
    """fp32 (mean, rstd) over the time axis, each (B, C)."""
    var, mean = torch.var_mean(x.float(), dim=1, unbiased=False)
    return mean, torch.rsqrt(var + eps)


def shifted(h: torch.Tensor, s: int) -> torch.Tensor:
    """g[:, t] = h[:, t + s] along the time axis, zeros outside [0, T)."""
    T = h.shape[1]
    if s == 0:
        return h
    if abs(s) >= T:
        return torch.zeros_like(h)
    if s > 0:
        return F.pad(h[:, s:], (0, 0, 0, s))
    return F.pad(h[:, :T + s], (0, 0, -s, 0))


def adain_conv_pass_plain(x, scale, shift, mean, rstd, w, *,
                          dilation: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the modulation, then the conv
    written out as K shifted products, summed in fp32."""
    plain.note("adain_conv", x)
    if scale.ndim == 2:
        scale, shift = scale[:, None], shift[:, None]
    h = ((x.float() - mean[:, None]) * rstd[:, None] * (1.0 + scale.float())
         + shift.float())
    h = F.silu(h).to(x.dtype).float()
    K = w.shape[0]
    halo = (K - 1) * dilation // 2
    wf = w.to(x.dtype).float()
    y = sum(shifted(h, k * dilation - halo) @ wf[k] for k in range(K))
    return y.to(x.dtype)


def _rows_aligned(t: torch.Tensor) -> bool:
    """16-byte aligned rows: the bf16 kernel's vector loads."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1])


def adain_conv_pass_cuda(x, scale, shift, mean, rstd, w, *,
                         dilation: int) -> torch.Tensor:
    """Launch ``csrc/adain_conv.cu`` on the current stream.

    x (B, T, C) and scale/shift (B, T, C) or (B, C): CUDA tensors of one
    dtype (fp32 or bf16) with a contiguous channel dimension and any other
    strides, so the scale/shift views of the decoder's style projection go
    in without a copy (bf16: 16-byte aligned rows and C, C_out multiples of
    8); mean/rstd (B, C) fp32; w (K, C, C_out), cast to x's dtype.  K odd
    and (K-1)*dilation even.  Raises on anything else.
    """
    global launches
    B, T, C = x.shape
    K, _, C_out = w.shape
    if not x.is_cuda or x.dtype not in _DTYPES:
        raise ValueError(f"x: need an fp32/bf16 CUDA tensor, got {x.device} "
                         f"{x.dtype}")
    for name, s in (("scale", scale), ("shift", shift)):
        if s.dtype != x.dtype or s.device != x.device or \
                s.shape not in ((B, T, C), (B, C)) or s.stride(-1) != 1:
            raise ValueError(f"{name}: need (B, T, C) or (B, C) like x with "
                             f"a contiguous channel dimension, got {s.dtype} "
                             f"{tuple(s.shape)} strides {s.stride()}")
    if x.stride(-1) != 1:
        raise ValueError("x: the channel dimension must be contiguous")
    if x.dtype == torch.bfloat16 and not (
            all(_rows_aligned(t) for t in (x, scale, shift))
            and C % 8 == 0 and C_out % 8 == 0):
        raise ValueError("bf16 needs 16-byte aligned rows and C, C_out "
                         "multiples of 8")
    if w.shape != (K, C, C_out) or K % 2 != 1 or (K - 1) * dilation % 2:
        raise ValueError(f"w {tuple(w.shape)}: need (K, C, C_out) with K odd "
                         f"and (K-1)*dilation even, dilation {dilation}")
    for name, s in (("mean", mean), ("rstd", rstd)):
        if s.shape != (B, C) or s.dtype != torch.float32 or \
                s.device != x.device:
            raise ValueError(f"{name}: need (B, C) fp32 on x's device")
    mean, rstd = mean.contiguous(), rstd.contiguous()
    wt = w.to(x.dtype).contiguous()

    def strides(s):
        return s.stride(0), (s.stride(1) if s.ndim == 3 else 0)

    out = torch.empty(B, T, C_out, dtype=x.dtype, device=x.device)
    rc = build.library().lib.adain_conv_fwd(
        _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), wt.data_ptr(), out.data_ptr(),
        B, T, C, C_out, K, dilation, *strides(x), *strides(scale),
        *strides(shift), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "adain_conv_fwd")
    launches += 1
    return out


def adain_conv_block(x, scale, shift, kernel1, kernel2, *, dilation: int,
                     conv_pass) -> torch.Tensor:
    """(x + pass2(pass1(x))) / sqrt(2); ``conv_pass`` is the kernel's
    wrapper or its plain version.  scale/shift are (B, T, 2C) or (B, 2C):
    channels [0, C) for pass 1, [C, 2C) for pass 2, taken as views."""
    C = x.shape[-1]
    h = conv_pass(x, scale[..., :C], shift[..., :C], *instance_stats(x),
                  kernel1, dilation=dilation)
    h2 = conv_pass(h, scale[..., C:], shift[..., C:], *instance_stats(h),
                   kernel2, dilation=1)
    return ((x.float() + h2.float())
            * np.float32(1.0 / np.sqrt(2.0))).to(x.dtype)

"""Stride-r transposed conv (vocoder upsampling): the CUDA kernel's wrapper
and its plain version.

Port of ``styletts_zs_tpu/kernels/vocoder_kernels.py::_shift_matmul_kernel``
(``conv_transpose1d_pallas``, ``_convt_plan``).  The kernel is
``csrc/conv_transpose.cu``.  For x (B, T, Cin), a kernel (K, Cin, Cout) in
the JAX layout, stride r and the HiFi-GAN trim p = (K - r) // 2, the
output (B, T*r, Cout) is, phase by phase,

    out[q*r + phi] = sum_m a[q - m] @ kernel[K - 1 - (phi + p + m*r)]

over the m with 0 <= phi + p + m*r < K (``ops.conv.conv_transpose1d``'s
function: the taps of the flipped kernel), a = x, or leaky_relu(x, slope)
rounded to x's dtype when ``negative_slope`` is given (the vocoder's
activation, fused into the kernel's load), zero outside [0, T).  Each tap
is a contiguous (Cin, Cout) slice of the weight as it is, so the kernel
needs no reordered tap matrix and nothing is rebuilt per call.
``ConvTranspose`` is the op's ``autograd.Function``: the kernel forward, and
the gradient of leaky ReLU and the twin ``ops.conv.conv_transpose1d``
backward (JAX has no backward kernel for it, ``dispatch.py:223-244``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from styletts_zs_torch.kernels import build, plain
from styletts_zs_torch.kernels.adain_conv import shifted
from styletts_zs_torch.ops import conv as conv_ops

launches = 0   # CUDA kernel launches; ``conv_transpose1d_cuda`` adds one each

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def phase_taps(K: int, r: int) -> list[list[tuple[int, int]]]:
    """For each phase phi: its (m, weight tap) pairs, the port's copy of
    ``_convt_plan`` without the zero taps."""
    p = (K - r) // 2
    return [[(m, K - 1 - (phi + p + m * r))
             for m in range(-((phi + p) // r), (K - 1 - phi - p) // r + 1)]
            for phi in range(r)]


def conv_transpose1d_plain(x, kernel, *, stride: int,
                           negative_slope: float | None = None):
    """Plain PyTorch version of the kernel: each phase a sum of shifted
    products in fp32, rounded to x's dtype, the phases interleaved."""
    plain.note("conv_transpose", x)
    if negative_slope is not None:
        x = F.leaky_relu(x, negative_slope)
    B, T, _ = x.shape
    K, _, C_out = kernel.shape
    xf, wf = x.float(), kernel.to(x.dtype).float()
    phases = [sum(shifted(xf, -m) @ wf[tap] for m, tap in taps).to(x.dtype)
              for taps in phase_taps(K, stride)]
    return torch.stack(phases, dim=2).reshape(B, T * stride, C_out)


# What the bf16 kernel (wgmma on TMA tiles) takes: the vocoder's K and
# stride, output channels in tiles of 64, frames in multiples of 8 (16-byte
# aligned output rows and TMA strides).
BF16_K, BF16_STRIDE, BF16_COUT_TILE = 10, 5, 64


def bf16_layout(x, kernel, stride: int) -> str:
    """The layout in which the bf16 kernel reads x: ``"frames"`` (x a
    (B, T, Cin) view of (B, Cin, T) memory, as the vocoder hands it over)
    or ``"channels"`` (channels last).  Raises ``ValueError`` on what the
    kernel does not take: another K or stride, Cout not a multiple of 64,
    T not a multiple of 8, x or its strides not 16-byte aligned (TMA), or x
    with neither frames nor channels contiguous.  Reads shapes, strides and
    the address only, so it runs on any device."""
    B, T, C_in = x.shape
    K, _, C_out = kernel.shape
    sb, st, sc = x.stride()
    if (K, stride) != (BF16_K, BF16_STRIDE) or C_out % BF16_COUT_TILE:
        raise ValueError(f"bf16 takes K {BF16_K}, stride {BF16_STRIDE} and "
                         f"Cout a multiple of {BF16_COUT_TILE}; got K {K}, "
                         f"stride {stride}, Cout {C_out}")
    if T % 8 or x.data_ptr() % 16 or (B > 1 and sb % 8):
        raise ValueError(f"bf16 needs T % 8 == 0 and x 16-byte aligned with "
                         f"its batch stride a multiple of 8; got T {T}, "
                         f"strides {x.stride()}")
    if st == 1 and (sc % 8 == 0 or C_in == 1):
        return "frames"
    if sc == 1 and st % 8 == 0:
        return "channels"
    raise ValueError(f"bf16 needs x with frames or channels contiguous and "
                     f"the other stride a multiple of 8; got strides "
                     f"{x.stride()}")


def conv_transpose1d_cuda(x, kernel, *, stride: int,
                          negative_slope: float | None = None):
    """Launch ``csrc/conv_transpose.cu`` on the current stream.

    x (B, T, Cin): an fp32 or bf16 CUDA tensor (the vocoder's (B, C,
    T)-major activations are read in place); kernel (K, Cin, Cout), cast to
    x's dtype, K >= stride.  fp32 takes any strides; bf16 what
    ``bf16_layout`` takes.  Returns (B, T*stride, Cout) as a view of (B,
    Cout, T*stride) memory, the layout the vocoder's resblock convs take
    without a copy.  Raises on anything else.
    """
    global launches
    B, T, C_in = x.shape
    K, _, C_out = kernel.shape
    if not x.is_cuda or x.dtype not in _DTYPES:
        raise ValueError(f"x: need an fp32/bf16 CUDA tensor, got {x.device} "
                         f"{x.dtype}")
    if kernel.shape != (K, C_in, C_out) or K < stride or stride < 1:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit x "
                         f"{tuple(x.shape)} at stride {stride}")
    if x.dtype == torch.bfloat16:
        bf16_layout(x, kernel, stride)
    w = kernel.to(x.dtype).contiguous()
    out = torch.empty(B, C_out, T * stride, dtype=x.dtype, device=x.device)
    rc = build.library().lib.conv_transpose_fwd(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
        B, T, C_in, C_out, K, stride, *x.stride(),
        int(negative_slope is not None), float(negative_slope or 0.0),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "conv_transpose_fwd")
    launches += 1
    return out.transpose(1, 2)


class ConvTranspose(torch.autograd.Function):
    """``fwd`` (the kernel's wrapper or its plain version) forward; the
    twin's gradient backward."""

    @staticmethod
    def forward(ctx, x, kernel, stride, negative_slope, fwd):
        ctx.save_for_backward(x, kernel)
        ctx.stride, ctx.slope = stride, negative_slope
        return fwd(x, kernel, stride=stride, negative_slope=negative_slope)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors

        def twin(x, w):
            if ctx.slope is not None:
                x = F.leaky_relu(x, ctx.slope)
            return conv_ops.conv_transpose1d(x, w, stride=ctx.stride)
        dx, dw = plain.twin_vjp("conv_transpose", twin, (x, kernel), g)
        return dx, dw, None, None, None

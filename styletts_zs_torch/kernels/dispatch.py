"""Routing between the hand-written kernels and their plain versions.

Counterpart of ``styletts_zs_tpu/kernels/dispatch.py``.  Seven ops go to a
kernel written by hand for the card: chunk-local attention, the fused
AdaIN conv pass and the fused synthesis head (Pallas on the JAX synthesis
path, or its parity route for the AdaIN pass), full attention, the
transposed conv (both of which JAX sends to its XLA twin), and the
sampler's Euler step and Heun correction.  The device of the tensor
decides, nothing else: a CUDA tensor launches the kernel or the wrapper
raises, a CPU tensor takes the kernel's plain version (counted in
``plain_calls``).  No shape gate of the JAX package is copied: those are
TPU tiling limits, and there is no route by which a CUDA tensor reaches a
plain version.  Chunk-local attention over T <= chunk is one chunk, full
attention over the length, and goes to the full-attention op.
"""
from __future__ import annotations

import torch

from styletts_zs_torch.kernels import adain_conv as ac_kernel
from styletts_zs_torch.kernels import conv_transpose as ct_kernel
from styletts_zs_torch.kernels import full_attention as fa_kernel
from styletts_zs_torch.kernels import local_attention as la_kernel
from styletts_zs_torch.kernels import sampler as sampler_kernel
from styletts_zs_torch.kernels import synthesis_head as head_kernel

# Calls that took a kernel's plain version because the tensor lay on the CPU
# (the CUDA launches are counted by the wrappers themselves; the AdaIN conv
# counts passes, two per block).
plain_calls = {"local_attention": 0, "synthesis_head": 0, "full_attention": 0,
               "sampler_euler": 0, "sampler_heun": 0, "adain_conv": 0,
               "conv_transpose": 0}


def local_attention(q, k, v, *, chunk: int,
                    kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Chunk-local self-attention (B, T, H, D); chunks attend to ±1 neighbours.

    ``kv_mask`` is a contiguous (B, T) bool length mask, as every mask here
    is.  T <= chunk is full attention over the length; a longer T must be
    a multiple of the chunk.
    """
    B, T = q.shape[:2]
    if T <= chunk:        # one chunk: the band covers every key
        return full_attention(q, k, v, kv_mask=kv_mask)
    if kv_mask is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=q.device)
    else:
        lengths = kv_mask.sum(-1, dtype=torch.int32)
    if q.is_cuda:
        return la_kernel.local_attention_cuda(q, k, v, lengths, chunk=chunk)
    plain_calls["local_attention"] += 1
    return la_kernel.local_attention_plain(q, k, v, lengths, chunk=chunk)


def full_attention(q, k, v, *, kv_mask: torch.Tensor | None = None):
    """Full (cross- or self-) attention (B, Tq, H, D) x (B, Tk, H, D);
    ``kv_mask`` is any (B, Tk) key mask."""
    if q.is_cuda:
        return fa_kernel.full_attention_cuda(q, k, v, kv_mask)
    plain_calls["full_attention"] += 1
    return fa_kernel.full_attention_plain(q, k, v, kv_mask)


def fused_euler_step(x, den_cond, den_uncond, s_cur, s_next, *,
                     guidance: float):
    """CFG combine + score + Euler step: (x_euler, d), fp32.  The sigmas
    are host numbers from the schedule."""
    if x.is_cuda:
        return sampler_kernel.euler_step_cuda(x, den_cond, den_uncond, s_cur,
                                              s_next, guidance=guidance)
    sampler_kernel.check_operands(x, den_cond, den_uncond)
    plain_calls["sampler_euler"] += 1
    return sampler_kernel.euler_step_plain(x, den_cond, den_uncond, s_cur,
                                           s_next, guidance=guidance)


def fused_heun_correction(x, x_euler, den2_cond, den2_uncond, d_cur, s_cur,
                          s_next, *, guidance: float):
    """CFG combine + Heun correction: x_next, fp32."""
    if x.is_cuda:
        return sampler_kernel.heun_correction_cuda(
            x, x_euler, den2_cond, den2_uncond, d_cur, s_cur, s_next,
            guidance=guidance)
    sampler_kernel.check_operands(x, x_euler, den2_cond, den2_uncond, d_cur)
    plain_calls["sampler_heun"] += 1
    return sampler_kernel.heun_correction_plain(
        x, x_euler, den2_cond, den2_uncond, d_cur, s_cur, s_next,
        guidance=guidance)


def adain_conv_block(x, scale, shift, kernel1, kernel2, *, dilation: int = 1):
    """AdaIN -> SiLU -> dilated conv, twice, with a (x + h)/sqrt(2) residual
    (``ac_kernel.adain_conv_block``); kernels in the JAX (K, C_in, C_out)
    layout, scale/shift (B, T, 2C) or (B, 2C), views taken as they are."""
    if x.is_cuda:
        conv_pass = ac_kernel.adain_conv_pass_cuda
    else:
        def conv_pass(*args, **kw):
            plain_calls["adain_conv"] += 1
            return ac_kernel.adain_conv_pass_plain(*args, **kw)
    return ac_kernel.adain_conv_block(x, scale, shift, kernel1, kernel2,
                                      dilation=dilation, conv_pass=conv_pass)


def conv_transpose1d(x, kernel, *, stride: int,
                     negative_slope: float | None = None):
    """Vocoder upsampling transposed conv, kernel (K, C_in, C_out), of
    ``leaky_relu(x, negative_slope)`` when a slope is given."""
    if x.is_cuda:
        return ct_kernel.conv_transpose1d_cuda(x, kernel, stride=stride,
                                               negative_slope=negative_slope)
    plain_calls["conv_transpose"] += 1
    return ct_kernel.conv_transpose1d_plain(x, kernel, stride=stride,
                                            negative_slope=negative_slope)


def synthesis_head(x, w, b, *, n_fft: int, hop: int) -> torch.Tensor:
    """Fused vocoder synthesis head: (B, T, C) activations -> (B, (T-1)*hop)
    fp32 waveform.  On the card the head's geometry must lie inside the
    kernel's gate (``head_kernel.supported``), or the wrapper raises."""
    if x.is_cuda:
        # the vocoder's convs hand over a (B, C, T)-major view; the kernel
        # reads (B, T, C) rows
        return head_kernel.synthesis_head_cuda(x.contiguous(), w, b,
                                               n_fft=n_fft, hop=hop)
    plain_calls["synthesis_head"] += 1
    return head_kernel.synthesis_head_plain(x, w, b, n_fft=n_fft, hop=hop)

"""Routing between the hand-written kernels and plain PyTorch.

Counterpart of ``styletts_zs_tpu/kernels/dispatch.py``.  Five ops go to a
kernel written by hand for the card: chunk-local attention and the fused
synthesis head (which the JAX package launches as Pallas kernels on the
synthesis path), full attention (which JAX sends to its XLA twin, but
which the denoiser runs ~500 times a multi-step call), and the sampler's
Euler step and Heun correction (Pallas under ``use_pallas=True``).  Each
goes to its CUDA kernel for CUDA tensors and to the kernel's plain version
for CPU tensors; outside the JAX package's shape gates of chunk-local
attention and the synthesis head a call takes the plain op, as JAX takes
its XLA twin (full attention and the sampler have no gate).  Otherwise the
device of the tensor decides, nothing else: a CUDA tensor launches the
kernel or the wrapper raises.

The AdaIN conv block and the transposed conv are plain PyTorch here, as
the JAX dispatcher sends their forward to XLA; their hand-written kernels
are later work (``ROADMAP.md``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from styletts_zs_torch.kernels import full_attention as fa_kernel
from styletts_zs_torch.kernels import local_attention as la_kernel
from styletts_zs_torch.kernels import sampler as sampler_kernel
from styletts_zs_torch.kernels import synthesis_head as head_kernel
from styletts_zs_torch.ops import attention as attn_ops
from styletts_zs_torch.ops import conv as conv_ops
from styletts_zs_torch.ops import norm as norm_ops

# Calls that took a kernel's plain version because the tensor lay on the CPU
# (the CUDA launches are counted by the wrappers themselves).
plain_calls = {"local_attention": 0, "synthesis_head": 0, "full_attention": 0,
               "sampler_euler": 0, "sampler_heun": 0}


def local_attention(q, k, v, *, chunk: int,
                    kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Chunk-local self-attention (B, T, H, D); chunks attend to ±1 neighbours.

    ``kv_mask`` is a contiguous length mask, as every mask here is.
    """
    B, T = q.shape[:2]
    if not la_kernel.supported(T, chunk):
        return attn_ops.local_attention(q, k, v, chunk=chunk, kv_mask=kv_mask)
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
    """AdaIN -> SiLU -> dilated conv, twice, with a (x + h)/sqrt(2) residual.

    The JAX production forward (``_adain_conv_xla``); kernels in the JAX
    (K, C_in, C_out) layout.
    """
    C = x.shape[-1]
    h = F.silu(norm_ops.adain(x, scale[..., :C], shift[..., :C]))
    h = conv_ops.conv1d(h, kernel1, dilation=dilation)
    h = F.silu(norm_ops.adain(h, scale[..., C:], shift[..., C:]))
    h = conv_ops.conv1d(h, kernel2)
    return ((x.float() + h.float())
            * np.float32(1.0 / np.sqrt(2.0))).to(x.dtype)


def conv_transpose1d(x, kernel, *, stride: int):
    """Vocoder upsampling transposed conv, kernel (K, C_in, C_out)."""
    return conv_ops.conv_transpose1d(x, kernel, stride=stride)


def synthesis_head(x, w, b, *, n_fft: int, hop: int) -> torch.Tensor:
    """Fused vocoder synthesis head: (B, T, C) activations -> (B, (T-1)*hop)
    fp32 waveform."""
    if not head_kernel.supported(n_fft=n_fft, hop=hop, K=w.shape[0],
                                 dtype=x.dtype):
        return head_kernel.synthesis_head_plain(x, w, b, n_fft=n_fft, hop=hop)
    if x.is_cuda:
        # the vocoder's convs hand over a (B, C, T)-major view; the kernel
        # reads (B, T, C) rows
        return head_kernel.synthesis_head_cuda(x.contiguous(), w, b,
                                               n_fft=n_fft, hop=hop)
    plain_calls["synthesis_head"] += 1
    return head_kernel.synthesis_head_plain(x, w, b, n_fft=n_fft, hop=hop)

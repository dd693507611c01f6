"""Routing between the hand-written kernels and their plain versions.

Counterpart of ``styletts_zs_tpu/kernels/dispatch.py``.  Eight ops go to a
kernel written by hand for the card: chunk-local attention, the fused
AdaIN conv pass and the fused synthesis head (Pallas on the JAX synthesis
path, or its parity route for the AdaIN pass), full attention, the
transposed conv (both of which JAX sends to its XLA twin), the sampler's
Euler step and Heun correction, and the standalone iSTFT (``istft_head``,
which no model path calls, as in JAX).  The device of the tensor
decides, nothing else: a CUDA tensor launches the kernel or the wrapper
raises, a CPU tensor takes the kernel's plain version (counted in
``plain_calls``).  No shape gate of the JAX package is copied: those are
TPU tiling limits, and there is no route by which a CUDA tensor reaches a
plain version.  Chunk-local attention over T <= chunk is one chunk, full
attention over the length, and goes to the full-attention op.

Training: where grad is enabled and an input requires it, the ops go through
their ``torch.autograd.Function``s.  Chunk-local attention and the AdaIN
conv block have dedicated backward kernels, as in JAX (the forward that
saves the log-sum-exp, row 3; dq and dk/dv, rows 4 and 5; the conv's
backward-data with silu', row 7); full attention, the transposed conv, the
synthesis head and the iSTFT take their kernel forward and the gradient of
their twin in ``ops/`` backward (counted in ``plain.twin_vjp_calls``).
Under ``torch.inference_mode()`` or ``no_grad`` every op launches what it
launched before.
"""
from __future__ import annotations

import torch

from styletts_zs_torch.kernels import adain_conv as ac_kernel
from styletts_zs_torch.kernels import conv_transpose as ct_kernel
from styletts_zs_torch.kernels import full_attention as fa_kernel
from styletts_zs_torch.kernels import istft as istft_kernel
from styletts_zs_torch.kernels import local_attention as la_kernel
from styletts_zs_torch.kernels import sampler as sampler_kernel
from styletts_zs_torch.kernels import synthesis_head as head_kernel

# Calls that took a kernel's plain version because the tensor lay on the CPU
# (the CUDA launches are counted by the wrappers themselves; the AdaIN conv
# counts passes, two per block).
plain_calls = {"local_attention": 0, "synthesis_head": 0, "full_attention": 0,
               "sampler_euler": 0, "sampler_heun": 0, "adain_conv": 0,
               "conv_transpose": 0, "local_attention_fwd_lse": 0,
               "local_attention_bwd_dq": 0, "local_attention_bwd_dkv": 0,
               "adain_conv_bwd_data": 0, "istft": 0}


def _route(name: str, x: torch.Tensor, cuda_fn, plain_fn):
    """The kernel's wrapper for a CUDA tensor; for a CPU tensor its plain
    version, counted in ``plain_calls``."""
    if x.is_cuda:
        return cuda_fn

    def counted(*args, **kw):
        plain_calls[name] += 1
        return plain_fn(*args, **kw)
    return counted


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


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
    if _needs_grad(q, k, v):
        return la_kernel.LocalAttention.apply(
            q, k, v, lengths, chunk,
            _route("local_attention_fwd_lse", q,
                   la_kernel.local_attention_fwd_lse_cuda,
                   la_kernel.local_attention_fwd_lse_plain),
            _route("local_attention_bwd_dq", q,
                   la_kernel.local_attention_bwd_dq_cuda,
                   la_kernel.local_attention_bwd_dq_plain),
            _route("local_attention_bwd_dkv", q,
                   la_kernel.local_attention_bwd_dkv_cuda,
                   la_kernel.local_attention_bwd_dkv_plain))
    return _route("local_attention", q, la_kernel.local_attention_cuda,
                  la_kernel.local_attention_plain)(q, k, v, lengths,
                                                   chunk=chunk)


def full_attention(q, k, v, *, kv_mask: torch.Tensor | None = None):
    """Full (cross- or self-) attention (B, Tq, H, D) x (B, Tk, H, D);
    ``kv_mask`` is any (B, Tk) key mask."""
    fwd = _route("full_attention", q, fa_kernel.full_attention_cuda,
                 fa_kernel.full_attention_plain)
    if _needs_grad(q, k, v):
        return fa_kernel.FullAttention.apply(q, k, v, kv_mask, fwd)
    return fwd(q, k, v, kv_mask)


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


def adain_conv_block(x, scale, shift, kernel1, kernel2, *, dilation: int = 1,
                     model=None):
    """AdaIN -> SiLU -> dilated conv, twice, with a (x + h)/sqrt(2) residual
    (``ac_kernel.adain_conv_block``); kernels in the JAX (K, C_in, C_out)
    layout, scale/shift (B, T, 2C) or (B, 2C), views taken as they are.
    ``model`` (a ``parallel.tensor.ModelAxis``): the kernels hold this
    rank's chunk of the output channels."""
    conv_pass = _route("adain_conv", x, ac_kernel.adain_conv_pass_cuda,
                       ac_kernel.adain_conv_pass_plain)
    if _needs_grad(x, scale, shift, kernel1, kernel2):
        return ac_kernel.AdaINConvBlock.apply(
            x, scale, shift, kernel1, kernel2, dilation, conv_pass,
            _route("adain_conv_bwd_data", x,
                   ac_kernel.adain_conv_bwd_data_cuda,
                   ac_kernel.adain_conv_bwd_data_plain), model)
    return ac_kernel.adain_conv_block(x, scale, shift, kernel1, kernel2,
                                      dilation=dilation, conv_pass=conv_pass,
                                      model=model)


def conv_transpose1d(x, kernel, *, stride: int,
                     negative_slope: float | None = None):
    """Vocoder upsampling transposed conv, kernel (K, C_in, C_out), of
    ``leaky_relu(x, negative_slope)`` when a slope is given."""
    fwd = _route("conv_transpose", x, ct_kernel.conv_transpose1d_cuda,
                 ct_kernel.conv_transpose1d_plain)
    if _needs_grad(x, kernel):
        return ct_kernel.ConvTranspose.apply(x, kernel, stride,
                                             negative_slope, fwd)
    return fwd(x, kernel, stride=stride, negative_slope=negative_slope)


def synthesis_head(x, w, b, *, n_fft: int, hop: int) -> torch.Tensor:
    """Fused vocoder synthesis head: (B, T, C) activations -> (B, (T-1)*hop)
    fp32 waveform.  On the card the head's geometry must lie inside the
    kernel's gate (``head_kernel.supported``), or the wrapper raises; the
    vocoder's (B, C, T)-major view goes in as it is."""
    fwd = _route("synthesis_head", x, head_kernel.synthesis_head_cuda,
                 head_kernel.synthesis_head_plain)
    if _needs_grad(x, w, b):
        return head_kernel.SynthesisHead.apply(x, w, b, n_fft, hop, fwd)
    return fwd(x, w, b, n_fft=n_fft, hop=hop)


def istft_head(real, imag, *, n_fft: int, hop: int) -> torch.Tensor:
    """Centred iSTFT overlap-add (window n_fft): real/imag (B, F, n_freq)
    -> (B, (F-1)*hop) fp32 waveform."""
    fwd = _route("istft", real, istft_kernel.istft_cuda,
                 istft_kernel.istft_plain)
    if _needs_grad(real, imag):
        return istft_kernel.ISTFT.apply(real, imag, n_fft, hop, fwd)
    return fwd(real, imag, n_fft=n_fft, hop=hop)

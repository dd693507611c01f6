"""Routing between the hand-written kernels and plain PyTorch.

Counterpart of ``styletts_zs_tpu/kernels/dispatch.py``, which under
production routing (``use_pallas=True``) launches exactly two Pallas kernels
on the synthesis path: chunk-local attention and the fused synthesis head.
Here those two go to their CUDA kernels for CUDA tensors and to the
kernels' plain versions for CPU tensors; outside the JAX package's shape
gates a call takes the plain op, as JAX takes its XLA twin.  The device of
the tensor decides, nothing else: a CUDA tensor launches the kernel or the
wrapper raises.

Full attention, the AdaIN conv block and the transposed conv are plain
PyTorch here, as the JAX dispatcher sends their forward to XLA; their
hand-written kernels are later work (``ROADMAP.md``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from styletts_zs_torch.kernels import local_attention as la_kernel
from styletts_zs_torch.kernels import synthesis_head as head_kernel
from styletts_zs_torch.ops import attention as attn_ops
from styletts_zs_torch.ops import conv as conv_ops
from styletts_zs_torch.ops import norm as norm_ops

# Calls that took a kernel's plain version because the tensor lay on the CPU
# (the CUDA launches are counted by the wrappers themselves).
plain_calls = {"local_attention": 0, "synthesis_head": 0}


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
    """Full (cross- or self-) attention (B, Tq, H, D) x (B, Tk, H, D)."""
    return attn_ops.cross_attention(q, k, v, kv_mask=kv_mask)


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

"""1-D convolution primitives in (B, T, C) layout, plain torch.

Counterpart of ``styletts_zs_tpu/ops/conv.py``.  Kernels keep the JAX layout
(K, C_in, C_out) at these functions, so the raw parameters that the
JAX models hold in that layout pass through unchanged; ``torch_conv_weight``
turns one into torch's (C_out, C_in // groups, K) once, where a module keeps
its weight.  Only SAME padding is used by the models.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def torch_conv_weight(kernel: torch.Tensor) -> torch.Tensor:
    """(K, C_in, C_out) JAX layout -> (C_out, C_in, K)."""
    return kernel.permute(2, 1, 0)


def same_padding(k: int, dilation: int = 1) -> tuple[int, int]:
    """SAME padding as JAX places it: ``k_eff // 2`` on the left."""
    k_eff = (k - 1) * dilation + 1
    return k_eff // 2, k_eff - 1 - k_eff // 2


def conv1d_torch_weight(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None, *,
                        dilation: int = 1) -> torch.Tensor:
    """SAME conv with a torch-layout weight (C_out, C_in, K).

    x: (B, T, C_in) -> (B, T, C_out), in x's dtype.
    """
    left, right = same_padding(weight.shape[-1], dilation)
    h = F.pad(x.transpose(1, 2), (left, right))
    y = F.conv1d(h, weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype),
                 dilation=dilation)
    return y.transpose(1, 2)


def conv1d(x: torch.Tensor, kernel: torch.Tensor, *,
           dilation: int = 1) -> torch.Tensor:
    """SAME conv.  x: (B, T, C_in), kernel: (K, C_in, C_out) -> (B, T, C_out)."""
    return conv1d_torch_weight(x, torch_conv_weight(kernel),
                               dilation=dilation)


def conv_transpose1d(x: torch.Tensor, kernel: torch.Tensor, *,
                     stride: int) -> torch.Tensor:
    """Transposed 1-D conv (vocoder upsampling) with HiFi-GAN-style trim.

    x: (B, T, C_in), kernel: (K, C_in, C_out) -> (B, T*stride, C_out) after
    trimming ``(K - stride) // 2`` on the left of the full output.
    ``jax.lax.conv_transpose`` does not flip the kernel, torch's transposed
    conv does, so the taps are reversed here.
    """
    K = kernel.shape[0]
    padding = (K - stride) // 2
    w = kernel.flip(0).permute(1, 2, 0).to(x.dtype)     # (C_in, C_out, K)
    full = F.conv_transpose1d(x.transpose(1, 2), w, stride=stride)
    out = full[:, :, padding: full.shape[-1] - (K - stride - padding)]
    return out.transpose(1, 2)

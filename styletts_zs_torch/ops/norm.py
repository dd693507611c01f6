"""Normalization + style conditioning: LayerNorm, InstanceNorm, AdaIN, AdaLN.

Counterpart of ``styletts_zs_tpu/ops/norm.py``.  Statistics in fp32 with the
biased variance (``unbiased=False``, as ``jnp.var``); the result is cast back
to the input dtype.
"""
from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channel (last) axis, no affine; stats in fp32."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def instance_norm(x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the time axis, per channel; stats in fp32.

    x: (B, T, C).  The statistics run over the whole (padded) T, with no
    mask, as in JAX.
    """
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _modulate(y, x, scale, shift):
    if scale.ndim == 2:
        scale = scale[:, None, :]
        shift = shift[:, None, :]
    return ((1.0 + scale.float()) * y.float() + shift.float()).to(x.dtype)


def adain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
          eps: float = 1e-5) -> torch.Tensor:
    """Adaptive InstanceNorm.  scale/shift: (B, C) or (B, T, C)."""
    return _modulate(instance_norm(x, eps=eps), x, scale, shift)


def adaln(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
          eps: float = 1e-5) -> torch.Tensor:
    """Adaptive LayerNorm (DiT-style).  scale/shift: (B, C) or (B, T, C)."""
    return _modulate(layer_norm(x, eps=eps), x, scale, shift)

"""Duration and prosody (F0/energy) predictors.

Counterpart of ``styletts_zs_tpu/models/predictors.py``: style-conditioned
conv stacks, with deterministic integer durations at inference and dropout
(from an explicit generator, ``rng``) in training.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from styletts_zs_torch.config import PredictorConfig
from styletts_zs_torch.models.layers import Conv, Dense, LayerNorm, dropout


class _StyledConvStack(nn.Module):
    def __init__(self, c_in: int, dim: int, n_layers: int, kernel: int,
                 rate: float = 0.0):
        super().__init__()
        self.n_layers, self.rate = n_layers, rate
        for i in range(n_layers):
            self.add_module(f"conv{i}", Conv(c_in if i == 0 else dim, dim,
                                             kernel))
            self.add_module(f"LayerNorm_{i}", LayerNorm(dim))

    def forward(self, x, style, *, mask=None, rng=None):
        """x: (B, T, C); style: (B, S) global or (B, T, S) per-position."""
        if style.ndim == 2:
            style = style[:, None, :].expand(x.shape[0], x.shape[1], -1)
        h = torch.cat([x, style.to(x.dtype)], dim=-1)
        for i in range(self.n_layers):
            h = getattr(self, f"conv{i}")(h)
            h = F.silu(getattr(self, f"LayerNorm_{i}")(h))
            h = dropout(h, self.rate, rng)
            if mask is not None:
                h = h * mask[..., None].to(h.dtype)
        return h


class DurationPredictor(nn.Module):
    """Per-phoneme log-duration regression; deterministic rounding."""

    def __init__(self, cfg: PredictorConfig, c_in: int):
        super().__init__()
        self.cfg = cfg
        self._StyledConvStack_0 = _StyledConvStack(c_in, cfg.dim, cfg.n_layers,
                                                   cfg.conv_kernel, cfg.dropout)
        self.out = Dense(cfg.dim, 1)

    def forward(self, prosody_enc, style, *, mask=None, rng=None):
        """log1p-duration predictions (B, T_text), masked to 0."""
        h = self._StyledConvStack_0(prosody_enc, style, mask=mask, rng=rng)
        log_dur = self.out(h)[..., 0]
        if mask is not None:
            log_dur = log_dur * mask.to(log_dur.dtype)
        return log_dur

    def to_frames(self, log_dur, mask=None):
        """Integer frame counts; ``torch.round`` rounds half to even, as
        ``jnp.round`` does."""
        dur = torch.round(torch.expm1(torch.clamp(log_dur.float(), 0.0, 10.0)))
        dur = torch.clamp(dur, 0.0, float(self.cfg.max_duration))
        if mask is not None:
            dur = dur * mask.to(dur.dtype)
        return dur.to(torch.int32)


class ProsodyPredictor(nn.Module):
    """Frame-level F0 and energy from aligned prosody features + style."""

    def __init__(self, cfg: PredictorConfig, c_in: int):
        super().__init__()
        self._StyledConvStack_0 = _StyledConvStack(c_in, cfg.dim, cfg.n_layers,
                                                   cfg.conv_kernel, cfg.dropout)
        self.out = Dense(cfg.dim, 2)

    def forward(self, aligned_prosody, style, *, mask=None, rng=None):
        """(f0, energy), each (B, T_frames)."""
        out = self.out(self._StyledConvStack_0(aligned_prosody, style,
                                               mask=mask, rng=rng))
        f0, energy = out[..., 0], out[..., 1]
        if mask is not None:
            m = mask.to(f0.dtype)
            f0, energy = f0 * m, energy * m
        return f0, energy

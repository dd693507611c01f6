"""Mel decoder: AdaIN residual conv blocks with chunk-local attention.

Counterpart of ``styletts_zs_tpu/models/decoder.py``.  Style enters as
time-varying per-frame vectors through AdaIN in every block; after every
``attn_every``-th block a transformer block with chunk-local attention
(chunk ``attn_window``) runs — the hand-written local-attention kernel's
call site (3 per call at the default 6 blocks).
"""
from __future__ import annotations

import torch
from torch import nn

from styletts_zs_torch.config import DecoderConfig
from styletts_zs_torch.models.layers import (AdaINResBlock, Conv, Dense,
                                             LayerNorm, TransformerBlock)

DILATIONS = (1, 3, 9)


class MelDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, n_mels: int = 80,
                 text_dim: int = 512, style_dim: int = 128):
        super().__init__()
        self.cfg = cfg
        self.pros_in = Conv(2, cfg.dim // 4, 3)
        self.text_in = Dense(text_dim, cfg.dim)
        self.in_proj = Dense(cfg.dim + cfg.dim // 4, cfg.dim)
        for i in range(cfg.n_blocks):
            self.add_module(f"res{i}", AdaINResBlock(
                cfg.dim, style_dim, cfg.conv_kernel,
                DILATIONS[i % len(DILATIONS)]))
            if (i + 1) % cfg.attn_every == 0:
                self.add_module(f"attn{i}", TransformerBlock(
                    cfg.dim, cfg.n_heads, chunk=cfg.attn_window))
        self.LayerNorm_0 = LayerNorm(cfg.dim)
        self.mel_out = Dense(cfg.dim, n_mels)

    def forward(self, aligned_text, f0, energy, style, *, mask=None):
        """aligned_text (B, T, C_text); f0/energy (B, T); style (B, T, S).

        Returns (mel (B, T, n_mels), hidden (B, T, dim)).
        """
        c = self.cfg
        dt = self.text_in.weight.dtype
        pros = self.pros_in(torch.stack([f0, energy], dim=-1).to(dt))
        x = self.in_proj(torch.cat([self.text_in(aligned_text), pros], dim=-1))
        for i in range(c.n_blocks):
            x = getattr(self, f"res{i}")(x, style)
            if (i + 1) % c.attn_every == 0:
                x = getattr(self, f"attn{i}")(x, mask=mask)
            if mask is not None:
                x = x * mask[..., None].to(x.dtype)
        hidden = self.LayerNorm_0(x)
        mel = self.mel_out(hidden)
        if mask is not None:
            mel = mel * mask[..., None].to(mel.dtype)
        return mel, hidden

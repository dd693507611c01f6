"""Phoneme text encoder + prosodic text encoder.

Counterpart of ``styletts_zs_tpu/models/text_encoder.py``: conv + transformer
stacks in place of the lineage's BiLSTM and PL-BERT.
"""
from __future__ import annotations

from torch import nn

from styletts_zs_torch.config import ProsodyEncoderConfig, TextEncoderConfig
from styletts_zs_torch.models.layers import (ConvBlock, Dense, Embed,
                                             LayerNorm, TransformerBlock,
                                             position_table)


def _masked(x, mask):
    return x if mask is None else x * mask[..., None].to(x.dtype)


class TextEncoder(nn.Module):
    """Phoneme IDs -> contextual text encodings (B, T_text, dim)."""

    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.phoneme_embed = Embed(cfg.vocab_size, cfg.dim)
        for i in range(cfg.n_conv_layers):
            self.add_module(f"conv{i}", ConvBlock(
                cfg.dim, cfg.dim, cfg.conv_kernel, dropout=cfg.dropout))
        for i in range(cfg.n_attn_layers):
            self.add_module(f"attn{i}", TransformerBlock(
                cfg.dim, cfg.n_heads, dropout=cfg.dropout))
        self.LayerNorm_0 = LayerNorm(cfg.dim)

    def forward(self, phoneme_ids, *, mask=None, rng=None):
        """``rng``: the dropout generator (None: no dropout)."""
        c = self.cfg
        x = self.phoneme_embed(phoneme_ids)
        x = x + position_table(phoneme_ids.shape[1], c.dim, x)
        for i in range(c.n_conv_layers):
            x = _masked(getattr(self, f"conv{i}")(x, rng=rng), mask)
        for i in range(c.n_attn_layers):
            x = getattr(self, f"attn{i}")(x, mask=mask, rng=rng)
        return _masked(self.LayerNorm_0(x), mask)


class ProsodyTextEncoder(nn.Module):
    """Text-side prosody features for duration/F0/energy prediction."""

    def __init__(self, cfg: ProsodyEncoderConfig, vocab_size: int = 192,
                 text_dim: int = 512):
        super().__init__()
        self.cfg = cfg
        self.prosody_embed = Embed(vocab_size, cfg.dim)
        self.text_proj = Dense(text_dim, cfg.dim)
        for i in range(cfg.n_layers):
            self.add_module(f"block{i}", TransformerBlock(
                cfg.dim, cfg.n_heads, dropout=cfg.dropout))
        self.LayerNorm_0 = LayerNorm(cfg.dim)

    def forward(self, phoneme_ids, text_enc, *, mask=None, rng=None):
        c = self.cfg
        x = self.prosody_embed(phoneme_ids)
        x = x + self.text_proj(text_enc)
        x = x + position_table(phoneme_ids.shape[1], c.dim, x)
        for i in range(c.n_layers):
            x = getattr(self, f"block{i}")(x, mask=mask, rng=rng)
        return _masked(self.LayerNorm_0(x), mask)

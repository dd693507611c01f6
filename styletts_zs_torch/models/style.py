"""Style system: extractor (mel -> K codes), FSQ quantizer, prompt encoder.

Counterpart of ``styletts_zs_tpu/models/style.py``.  The inference path
uses ``PromptEncoder`` and ``StyleQuantizer.project_style``; stage-1
training runs the extractor on the ground-truth mel (with its frame mask)
and ``StyleQuantizer.forward`` (down -> FSQ with a straight-through
gradient -> up).
"""
from __future__ import annotations

import torch
from torch import nn

from styletts_zs_torch.config import PromptEncoderConfig, StyleConfig
from styletts_zs_torch.models.layers import (CrossAttention, Dense, LayerNorm,
                                             TransformerBlock, position_table)
from styletts_zs_torch.ops import fsq
from styletts_zs_torch.parallel import tensor as tp


class StyleExtractor(nn.Module):
    """Reference mel -> K continuous style vectors (B, K, d_style)."""

    def __init__(self, cfg: StyleConfig, n_mels: int = 80):
        super().__init__()
        self.cfg = cfg
        d = cfg.extractor_dim
        self.mel_in = Dense(n_mels, d)
        for i in range(cfg.extractor_layers):
            self.add_module(f"enc{i}", TransformerBlock(d, cfg.n_heads))
        self.queries = nn.Parameter(torch.empty(cfg.n_codes, d))
        self.pool0 = CrossAttention(d, cfg.n_heads)
        self.pool1 = CrossAttention(d, cfg.n_heads)
        self.LayerNorm_0 = LayerNorm(d)   # before pool0
        self.LayerNorm_1 = LayerNorm(d)   # before pool1
        self.LayerNorm_2 = LayerNorm(d)   # output
        self.style_out = Dense(d, cfg.d_style)

    def forward(self, mel, *, mask=None):
        c = self.cfg
        h = self.mel_in(mel)
        h = h + position_table(mel.shape[1], c.extractor_dim, h)
        for i in range(c.extractor_layers):
            h = getattr(self, f"enc{i}")(h, mask=mask)
        q = tp.whole_param(self, "queries").to(h.dtype)[None].expand(
            mel.shape[0], -1, -1)
        q = q + self.pool0(self.LayerNorm_0(q), h, ctx_mask=mask)
        q = q + self.pool1(self.LayerNorm_1(q), h, ctx_mask=mask)
        return self.style_out(self.LayerNorm_2(q))


class StyleQuantizer(nn.Module):
    """FSQ bottleneck (d_style -> len(fsq_levels) -> d_style).

    ``project_style`` snaps a continuous style onto the lattice by least
    squares through ``up``, from fp32 master copies of ``up``'s weight and
    bias that ``keep_master`` takes before the module is cast to the
    compute dtype (``style.py:103-116``: one canonical precision keeps the
    discrete decision the same in every variant).
    """

    def __init__(self, cfg: StyleConfig):
        super().__init__()
        self.cfg = cfg
        d = len(cfg.fsq_levels)
        self.down = Dense(cfg.d_style, d)
        self.up = Dense(d, cfg.d_style)
        self._up_master = None

    def keep_master(self) -> None:
        """Keep fp32 copies of ``up`` (plain attributes: a later dtype cast
        of the module leaves them alone)."""
        self._up_master = (self.up.weight.detach().float().clone(),
                           self.up.bias.detach().float().clone())

    def forward(self, style: torch.Tensor):
        """(quantized style (B, K, d_style), codes (B, K, d_fsq), indices)."""
        codes = fsq.quantize(self.down(style), self.cfg.fsq_levels)
        indices = fsq.codes_to_indices(codes, self.cfg.fsq_levels)
        return self.up(codes), codes, indices

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """FSQ-grid codes (B, K, d_fsq) -> style vectors (B, K, d_style)."""
        return self.up(codes)

    def project_style(self, style: torch.Tensor) -> torch.Tensor:
        if self._up_master is None:
            raise RuntimeError("keep_master() must run before project_style "
                               "(build_models does it before the dtype cast)")
        w_t, bias = self._up_master                  # (d_style, d), (d_style,)
        W = w_t.T                                    # (d, d_style), JAX layout
        s = style.float() - bias
        G = W @ W.T
        z = (s @ W.T) @ torch.linalg.inv(G)
        lv = torch.tensor(self.cfg.fsq_levels, dtype=torch.float32,
                          device=style.device)
        digit_c = torch.minimum(
            torch.clamp((z + 1.0) * (lv - 1.0) / 2.0, min=0.0), lv - 1.0)
        # straight-through: the rounding's gradient is the identity (stage 3
        # differentiates its perceptual loss through this projection)
        digit = digit_c + (torch.round(digit_c) - digit_c).detach()
        codes = 2.0 * digit / (lv - 1.0) - 1.0
        return self.up(codes.to(style.dtype))

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        return self.up(fsq.indices_to_codes(indices, self.cfg.fsq_levels))


class PromptEncoder(nn.Module):
    """~3 s reference mel -> (B, n_prompt_tokens, dim) tokens + (B, dim)
    summary."""

    def __init__(self, cfg: PromptEncoderConfig, n_mels: int = 80):
        super().__init__()
        self.cfg = cfg
        self.mel_in = Dense(n_mels, cfg.dim)
        for i in range(cfg.n_layers):
            self.add_module(f"enc{i}", TransformerBlock(cfg.dim, cfg.n_heads))
        self.queries = nn.Parameter(torch.empty(cfg.n_prompt_tokens, cfg.dim))
        self.pool = CrossAttention(cfg.dim, cfg.n_heads)
        self.LayerNorm_0 = LayerNorm(cfg.dim)

    def forward(self, ref_mel, *, mask=None):
        c = self.cfg
        h = self.mel_in(ref_mel)
        h = h + position_table(ref_mel.shape[1], c.dim, h)
        for i in range(c.n_layers):
            h = getattr(self, f"enc{i}")(h, mask=mask)
        q = tp.whole_param(self, "queries").to(h.dtype)[None].expand(
            ref_mel.shape[0], -1, -1)
        q = q + self.pool(q, h, ctx_mask=mask)
        tokens = self.LayerNorm_0(q)
        return tokens, tokens.mean(dim=1)

"""Time-varying style diffusion: the EDM denoiser and the 1-step sampler.

Counterpart of ``styletts_zs_tpu/models/diffusion.py`` for the main path:
``StyleDenoiser`` and ``StyleDiffusion.sample_onestep`` — one CFG-doubled
denoiser call at sigma_max.  The initial noise is an input (a tensor, or a
``torch.Generator`` to draw it from), so a test can hand in JAX's noise.
The diffusion net runs in fp32 whatever the compute dtype
(``RuntimeConfig.diffusion_dtype``).  The multi-step Heun sampler and the
training loss are later slices.
"""
from __future__ import annotations

import torch
from torch import nn

from styletts_zs_torch.config import DiffusionConfig, StyleConfig
from styletts_zs_torch.models.layers import (MLP, AdaLNTransformerBlock, Dense,
                                             LayerNorm, position_table,
                                             sinusoidal_embedding)


class StyleDenoiser(nn.Module):
    """Transformer denoiser over the (B, K, d_style) style latents, wrapped
    in EDM preconditioning."""

    def __init__(self, cfg: DiffusionConfig, style_cfg: StyleConfig,
                 ctx_dim: int = 512):
        super().__init__()
        self.cfg, self.style_cfg = cfg, style_cfg
        self.in_proj = Dense(style_cfg.d_style, cfg.dim)
        self.t_mlp = MLP(cfg.dim, expand=2)
        self.prompt_proj = Dense(ctx_dim, cfg.dim)
        for i in range(cfg.n_layers):
            self.add_module(f"block{i}", AdaLNTransformerBlock(
                cfg.dim, cfg.n_heads, ctx_dim))
        self.LayerNorm_0 = LayerNorm(cfg.dim)
        self.out_proj = Dense(cfg.dim, style_cfg.d_style)

    def raw(self, x, c_noise, ctx, ctx_mask, prompt_summary):
        """F(x; sigma, cond): (B, K, d_style) -> (B, K, d_style)."""
        c = self.cfg
        h = self.in_proj(x)
        h = h + position_table(x.shape[1], c.dim, h)
        dt = self.in_proj.weight.dtype
        cond = self.t_mlp(sinusoidal_embedding(c_noise * 1000.0, c.dim).to(dt))
        cond = cond + self.prompt_proj(prompt_summary)
        for i in range(c.n_layers):
            h = getattr(self, f"block{i}")(h, cond, ctx=ctx, ctx_mask=ctx_mask)
        return self.out_proj(self.LayerNorm_0(h))

    def forward(self, x_sigma, sigma, ctx, ctx_mask, prompt_summary):
        """EDM-preconditioned D(x; sigma) ~ E[x0 | x_sigma]; sigma: (B,)."""
        sd = self.cfg.sigma_data
        sigma = sigma.float()
        s2 = sigma ** 2
        c_skip = (sd ** 2 / (s2 + sd ** 2))[:, None, None]
        c_out = (sigma * sd / torch.sqrt(s2 + sd ** 2))[:, None, None]
        c_in = (1.0 / torch.sqrt(s2 + sd ** 2))[:, None, None]
        c_noise = torch.log(torch.clamp(sigma, min=1e-8)) / 4.0
        xf = x_sigma.float()
        f = self.raw((c_in * xf).to(self.in_proj.weight.dtype), c_noise, ctx,
                     ctx_mask, prompt_summary)
        return c_skip * xf + c_out * f.float()


class StyleDiffusion(nn.Module):
    """Denoiser + CFG machinery (learned null conditioning)."""

    def __init__(self, cfg: DiffusionConfig, style_cfg: StyleConfig,
                 ctx_dim: int = 512):
        super().__init__()
        self.cfg, self.style_cfg = cfg, style_cfg
        self.denoiser = StyleDenoiser(cfg, style_cfg, ctx_dim)
        self.null_prompt_summary = nn.Parameter(torch.empty(ctx_dim))
        self.null_prompt_tokens = nn.Parameter(torch.empty(1, ctx_dim))

    def _cfg_context(self, text_enc, prompt_tokens, prompt_summary,
                     text_mask):
        """[cond | uncond] contexts, masks and summaries on a doubled batch.

        The uncond half replaces the prompt with the learned nulls, cast to
        the prompt's dtype as JAX casts them.
        """
        B, P, C = prompt_tokens.shape
        null_tok = self.null_prompt_tokens.to(prompt_tokens.dtype)[None] \
            .expand(B, P, C)
        ctx2 = torch.cat([torch.cat([text_enc, prompt_tokens], dim=1),
                          torch.cat([text_enc, null_tok], dim=1)], dim=0)
        mask2 = None
        if text_mask is not None:
            pm = torch.ones(B, P, dtype=torch.bool, device=text_mask.device)
            m = torch.cat([text_mask, pm], dim=1)
            mask2 = torch.cat([m, m], dim=0)
        null_sum = self.null_prompt_summary.to(prompt_summary.dtype)[None] \
            .expand_as(prompt_summary)
        summary2 = torch.cat([prompt_summary, null_sum], dim=0)
        return ctx2, mask2, summary2

    def sample_onestep(self, noise, text_enc, prompt_tokens, prompt_summary,
                       *, text_mask=None, guidance: float | None = None):
        """Distilled 1-step path: one CFG-doubled denoiser call at sigma_max.

        ``noise`` is the (B, K, d_style) standard-normal draw, or a
        ``torch.Generator`` to draw it from on the input's device.
        """
        c = self.cfg
        guidance = c.cfg_scale if guidance is None else guidance
        B = text_enc.shape[0]
        if isinstance(noise, torch.Generator):
            noise = torch.randn(B, self.style_cfg.n_codes,
                                self.style_cfg.d_style, generator=noise,
                                device=noise.device).to(text_enc.device)
        x = noise.float() * c.sigma_max
        ctx2, mask2, summary2 = self._cfg_context(
            text_enc, prompt_tokens, prompt_summary, text_mask)
        sig2 = torch.full((2 * B,), c.sigma_max, dtype=torch.float32,
                          device=x.device)
        den2 = self.denoiser(torch.cat([x, x], dim=0), sig2, ctx2, mask2,
                             summary2)
        d_cond, d_uncond = den2[:B], den2[B:]
        den = d_uncond + guidance * (d_cond - d_uncond)
        return den.to(self.denoiser.in_proj.weight.dtype)

"""Time-varying style diffusion: the EDM denoiser and its two samplers.

Counterpart of ``styletts_zs_tpu/models/diffusion.py``: ``StyleDenoiser``,
the multi-step Heun sampler over the Karras schedule
(``StyleDiffusion.sample``) and the distilled 1-step path
(``sample_onestep``), each step one CFG-doubled denoiser call.  The
initial noise is an input (a tensor, or a ``torch.Generator`` to draw it
from), so a test can hand in JAX's noise.  The schedule lives on the host
and the step loop is a Python loop, in place of JAX's ``lax.scan`` and
``lax.cond``; the step tail (CFG combine, score, Euler / Heun update) goes
through ``dispatch.fused_euler_step`` / ``fused_heun_correction``.  The
diffusion net runs in fp32 whatever the compute dtype
(``RuntimeConfig.diffusion_dtype``).  ``StyleDiffusion.forward`` is the
EDM training loss (stage 2), its draws inputs as the sampler's noise is.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from styletts_zs_torch.config import DiffusionConfig, StyleConfig
from styletts_zs_torch.kernels import dispatch
from styletts_zs_torch.models.layers import (MLP, AdaLNTransformerBlock, Dense,
                                             LayerNorm, position_table,
                                             sinusoidal_embedding)
from styletts_zs_torch.parallel import tensor as tp


def karras_sigmas(cfg: DiffusionConfig, n_steps: int) -> np.ndarray:
    """Karras et al. noise schedule, length n_steps+1 (last = 0): computed
    in float64 and rounded to float32, as the JAX package does."""
    i = np.arange(n_steps, dtype=np.float64)
    inv_rho = 1.0 / cfg.rho
    s = (cfg.sigma_max ** inv_rho
         + i / max(n_steps - 1, 1) * (cfg.sigma_min ** inv_rho
                                      - cfg.sigma_max ** inv_rho)) ** cfg.rho
    return np.concatenate([s, [0.0]]).astype(np.float32)


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

    def _context(self, text_enc, prompt_tokens, text_mask, drop_prompt=None):
        """[text; prompt] context and its mask; where ``drop_prompt`` (B,)
        is True the prompt tokens are the learned null, cast to their dtype
        as JAX casts it (training-time CFG dropout and the uncond branch)."""
        B, P, C = prompt_tokens.shape
        if drop_prompt is not None:
            null_tok = tp.whole_param(self, "null_prompt_tokens").to(
                prompt_tokens.dtype)[None].expand(B, P, C)
            prompt_tokens = torch.where(drop_prompt[:, None, None], null_tok,
                                        prompt_tokens)
        ctx = torch.cat([text_enc, prompt_tokens], dim=1)
        ctx_mask = None
        if text_mask is not None:
            pm = torch.ones(B, P, dtype=torch.bool, device=text_mask.device)
            ctx_mask = torch.cat([text_mask, pm], dim=1)
        return ctx, ctx_mask

    def _summary(self, prompt_summary, drop_prompt=None):
        """The prompt summary, the learned null where ``drop_prompt``."""
        if drop_prompt is None:
            return prompt_summary
        null = self.null_prompt_summary.to(prompt_summary.dtype)[None] \
            .expand_as(prompt_summary)
        return torch.where(drop_prompt[:, None], null, prompt_summary)

    def _cfg_context(self, text_enc, prompt_tokens, prompt_summary,
                     text_mask):
        """[cond | uncond] contexts, masks and summaries on a doubled batch:
        the uncond half with every prompt dropped."""
        B = text_enc.shape[0]
        keep = torch.zeros(B, dtype=torch.bool, device=text_enc.device)
        drop = torch.ones_like(keep)
        ctx_c, mask_c = self._context(text_enc, prompt_tokens, text_mask,
                                      keep)
        ctx_u, mask_u = self._context(text_enc, prompt_tokens, text_mask,
                                      drop)
        mask2 = None if mask_c is None else torch.cat([mask_c, mask_u], dim=0)
        summary2 = torch.cat([self._summary(prompt_summary, keep),
                              self._summary(prompt_summary, drop)], dim=0)
        return torch.cat([ctx_c, ctx_u], dim=0), mask2, summary2

    # -- training -----------------------------------------------------------

    def forward(self, style_target, text_enc, prompt_tokens, prompt_summary,
                *, text_mask=None, drop_prompt=None, n=None, noise=None,
                rng: torch.Generator | None = None):
        """The EDM denoising loss: (loss, {"sigma", "denoised"}).

        style_target: (B, K, d_style) clean latents from the frozen
        extractor.  The draws are inputs, since the JAX PRNG cannot be
        reproduced: ``n`` (B,) standard normal for the log-normal sigma,
        ``noise`` (B, K, d_style) standard normal; each is drawn from
        ``rng`` on the target's device when not given.  ``drop_prompt`` (B,)
        bool nulls the prompt (None: no drop).
        """
        sd = self.cfg.sigma_data
        B = style_target.shape[0]
        dev = style_target.device
        if n is None:
            n = torch.randn(B, generator=rng, device=dev)
        if noise is None:
            noise = torch.randn(style_target.shape, generator=rng, device=dev)
        sigma = torch.exp(n.float() * 1.2 - 1.2) * sd / 0.5
        target = style_target.float()
        x_sigma = target + sigma[:, None, None] * noise.float()
        ctx, ctx_mask = self._context(text_enc, prompt_tokens, text_mask,
                                      drop_prompt)
        summary = self._summary(prompt_summary, drop_prompt)
        denoised = self.denoiser(x_sigma, sigma, ctx, ctx_mask, summary)
        w = ((sigma ** 2 + sd ** 2) / (sigma * sd) ** 2)[:, None, None]
        loss = torch.mean(w * (denoised - target) ** 2)
        return loss, {"sigma": sigma, "denoised": denoised}

    def init_all(self, style_target, text_enc, prompt_tokens, prompt_summary,
                 rng: torch.Generator | None = None, *, n=None, noise=None):
        """The loss with no prompt dropped (JAX initialises through it)."""
        keep = torch.zeros(style_target.shape[0], dtype=torch.bool,
                           device=style_target.device)
        loss, _ = self(style_target, text_enc, prompt_tokens, prompt_summary,
                       drop_prompt=keep, n=n, noise=noise, rng=rng)
        return loss

    # -- sampling -----------------------------------------------------------

    def _denoise_pair(self, x, sigma, ctx2, mask2, summary2):
        """One CFG-doubled denoiser call at the host number ``sigma``:
        returns (d_cond, d_uncond), views of the (2B, K, d) output."""
        B = x.shape[0]
        sig2 = torch.full((2 * B,), float(sigma), dtype=torch.float32,
                          device=x.device)
        den2 = self.denoiser(torch.cat([x, x], dim=0), sig2, ctx2, mask2,
                             summary2)
        return den2[:B], den2[B:]

    def _noise(self, noise, like):
        """The (B, K, d_style) standard-normal draw, or draw it from a
        ``torch.Generator`` on its device."""
        if isinstance(noise, torch.Generator):
            noise = torch.randn(like.shape[0], self.style_cfg.n_codes,
                                self.style_cfg.d_style, generator=noise,
                                device=noise.device)
        return noise.to(like.device).float()

    def sample(self, noise, text_enc, prompt_tokens, prompt_summary, *,
               text_mask=None, n_steps: int | None = None,
               guidance: float | None = None):
        """Multi-step Heun sampler over the Karras schedule (acceptance
        config 3): each step one CFG-doubled denoiser call, the fused Euler
        step, and, unless the next sigma is 0, a second call and the fused
        Heun correction.  The schedule is host numpy float32, so the branch
        needs no device sync.  Returns (B, K, d_style) in the denoiser's
        dtype."""
        c = self.cfg
        n_steps = n_steps or c.n_steps
        g = float(c.cfg_scale if guidance is None else guidance)
        sigmas = karras_sigmas(c, n_steps)
        x = self._noise(noise, text_enc) * float(sigmas[0])
        ctx2, mask2, summary2 = self._cfg_context(
            text_enc, prompt_tokens, prompt_summary, text_mask)
        for i in range(n_steps):
            s_cur, s_next = sigmas[i], sigmas[i + 1]
            dc, du = self._denoise_pair(x, s_cur, ctx2, mask2, summary2)
            x_euler, d_cur = dispatch.fused_euler_step(
                x, dc, du, s_cur, s_next, guidance=g)
            if s_next > 0:
                dc2, du2 = self._denoise_pair(x_euler, s_next, ctx2, mask2,
                                              summary2)
                x = dispatch.fused_heun_correction(
                    x, x_euler, dc2, du2, d_cur, s_cur, s_next, guidance=g)
            else:
                x = x_euler
        return x.to(self.denoiser.in_proj.weight.dtype)

    def sample_onestep(self, noise, text_enc, prompt_tokens, prompt_summary,
                       *, text_mask=None, guidance: float | None = None):
        """Distilled 1-step path: one CFG-doubled denoiser call at sigma_max.

        ``noise`` is the (B, K, d_style) standard-normal draw, or a
        ``torch.Generator`` to draw it from on the input's device.
        """
        c = self.cfg
        guidance = c.cfg_scale if guidance is None else guidance
        x = self._noise(noise, text_enc) * c.sigma_max
        ctx2, mask2, summary2 = self._cfg_context(
            text_enc, prompt_tokens, prompt_summary, text_mask)
        d_cond, d_uncond = self._denoise_pair(x, c.sigma_max, ctx2, mask2,
                                              summary2)
        den = d_uncond + guidance * (d_cond - d_uncond)
        return den.to(self.denoiser.in_proj.weight.dtype)

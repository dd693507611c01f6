"""Zero-shot inference: phonemes + ~3 s reference audio -> waveform.

Counterpart of ``styletts_zs_tpu/pipelines/infer.py``: prompt encoding,
text encoding, the CFG style diffusion (the distilled 1-step path, or the
multi-step Heun sampler with ``one_step=False``), lattice projection,
duration and prosody prediction, mel decoding and the vocoder, in one
call.  The initial diffusion noise is an input (a (B, K, d_style) tensor
or a ``torch.Generator``).
"""
from __future__ import annotations

import torch

from styletts_zs_torch.config import Config
from styletts_zs_torch.ops import stft as stft_ops
from styletts_zs_torch.ops.attention import length_mask
from styletts_zs_torch.pipelines.factory import (Models, build_models,
                                                 resolve_device)


def _synthesis_program(models: Models, cfg: Config, *, one_step: bool = True,
                       n_steps=None, guidance=None, n_frames=None,
                       with_vocoder: bool = True):
    ac, df, vo = models.acoustic, models.diffusion, models.vocoder
    frames = n_frames or cfg.model.max_frames

    @torch.inference_mode()
    def fn(phonemes, text_lengths, ref_mel, ref_lengths, noise):
        text_mask = length_mask(text_lengths, phonemes.shape[1])
        ref_mask = length_mask(ref_lengths, ref_mel.shape[1])
        tokens, summary = ac.encode_prompt(ref_mel, ref_mask)
        encoded = ac.encode_text(phonemes, text_mask)
        if one_step:
            style = df.sample_onestep(noise, encoded[0], tokens, summary,
                                      text_mask=text_mask, guidance=guidance)
        else:
            style = df.sample(noise, encoded[0], tokens, summary,
                              text_mask=text_mask, n_steps=n_steps,
                              guidance=guidance)
        styled = ac.quantize_style(style)
        out = ac.text_to_mel(phonemes, styled, text_mask=text_mask,
                             n_frames=frames, encoded=encoded)
        if not with_vocoder:
            return out, None
        return out, vo(out.mel, mask=out.frame_mask)

    return fn


def make_synthesis_fn(cfg: Config, params, *, one_step: bool = True,
                      n_steps: int | None = None,
                      guidance: float | None = None,
                      n_frames: int | None = None,
                      with_vocoder: bool = True, device=None):
    """The zero-shot synthesis program on ``device`` (the card by default):

        fn(phonemes, text_lengths, ref_mel, ref_lengths, noise)
            -> (AcousticOutput, waveform | None)

    ``one_step=False`` samples the style with the multi-step Heun sampler
    (``n_steps``, default ``DiffusionConfig.n_steps``).
    """
    return _synthesis_program(build_models(cfg, params, device=device), cfg,
                              one_step=one_step, n_steps=n_steps,
                              guidance=guidance, n_frames=n_frames,
                              with_vocoder=with_vocoder)


def _fixed_style_program(models: Models, cfg: Config, *, n_frames=None):
    frames = n_frames or cfg.model.max_frames

    @torch.inference_mode()
    def fn(phonemes, text_lengths, style):
        text_mask = length_mask(text_lengths, phonemes.shape[1])
        return models.acoustic.text_to_mel(phonemes, style,
                                           text_mask=text_mask,
                                           n_frames=frames)

    return fn


def make_fixed_style_fn(cfg: Config, params, *, n_frames: int | None = None,
                        device=None):
    """Deterministic text -> mel with a given (B, K, d_style) style."""
    return _fixed_style_program(build_models(cfg, params, device=device), cfg,
                                n_frames=n_frames)


class Synthesizer:
    """User-facing API: holds the models on one device."""

    def __init__(self, cfg: Config, params, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.models = build_models(cfg, params, device=self.device)

    def synthesize(self, phonemes, ref_wav, *, text_lengths=None, noise=None,
                   one_step: bool = True, n_steps=None, guidance=None,
                   n_frames=None, with_vocoder: bool = True):
        """phonemes (B, T_text) int; ref_wav (B, T_samples) ~3 s audio;
        ``noise`` as for ``StyleDiffusion.sample_onestep`` (default: a
        generator seeded 0 on the model's device); ``one_step=False`` runs
        the multi-step sampler with ``n_steps``."""
        B = phonemes.shape[0]
        phonemes = phonemes.to(self.device)
        if text_lengths is None:
            text_lengths = torch.full((B,), phonemes.shape[1],
                                      dtype=torch.int32, device=self.device)
        if noise is None:
            noise = torch.Generator(device=self.device).manual_seed(0)
        ref_mel = stft_ops.mel_spectrogram(ref_wav.to(self.device),
                                           self.cfg.model.audio)
        ref_lengths = torch.full((B,), ref_mel.shape[1], dtype=torch.int32,
                                 device=self.device)
        fn = _synthesis_program(self.models, self.cfg, one_step=one_step,
                                n_steps=n_steps, guidance=guidance,
                                n_frames=n_frames, with_vocoder=with_vocoder)
        return fn(phonemes, text_lengths.to(self.device), ref_mel,
                  ref_lengths, noise)

    def synthesize_fixed_style(self, phonemes, style, *, text_lengths=None,
                               n_frames=None):
        B = phonemes.shape[0]
        if text_lengths is None:
            text_lengths = torch.full((B,), phonemes.shape[1],
                                      dtype=torch.int32)
        fn = _fixed_style_program(self.models, self.cfg, n_frames=n_frames)
        return fn(phonemes.to(self.device), text_lengths.to(self.device),
                  style.to(self.device))

"""Top-level acoustic model (text + style -> mel).

Counterpart of ``styletts_zs_tpu/models/tts.py``: text encoding, duration
prediction, monotonic expansion, prosody prediction and the AdaIN mel
decoder, with the style codes as an input; and the stage-1 training
forwards: ``extract_style`` (ground-truth mel -> quantized style),
``reconstruct`` (style from the ground truth, durations and F0/energy
targets given) and ``align_energies`` (the built-in aligner's energies).
Dropout draws from an explicit generator (``rng``); None turns it off.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from styletts_zs_torch.config import ModelConfig
from styletts_zs_torch.models.decoder import MelDecoder
from styletts_zs_torch.models.layers import Dense
from styletts_zs_torch.models.predictors import (DurationPredictor,
                                                 ProsodyPredictor)
from styletts_zs_torch.models.style import (PromptEncoder, StyleExtractor,
                                            StyleQuantizer)
from styletts_zs_torch.models.text_encoder import (ProsodyTextEncoder,
                                                   TextEncoder)
from styletts_zs_torch.ops import align
from styletts_zs_torch.ops.attention import length_mask


@dataclass
class AcousticOutput:
    """Output of the synthesis path."""

    mel: torch.Tensor            # (B, T_frames, n_mels)
    hidden: torch.Tensor         # (B, T_frames, dim) decoder features
    log_dur: torch.Tensor        # (B, T_text) predicted log1p durations
    durations: torch.Tensor      # (B, T_text) int frames actually used
    f0: torch.Tensor             # (B, T_frames)
    energy: torch.Tensor         # (B, T_frames)
    frame_lengths: torch.Tensor  # (B,)
    frame_mask: torch.Tensor     # (B, T_frames) bool


class StyleTTSZS(nn.Module):
    """Acoustic model: phonemes + time-varying style -> mel (+ prosody)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = c = cfg
        text_dim, pros_dim = c.text_encoder.dim, c.prosody_encoder.dim
        d_style = c.style.d_style
        self.text_encoder = TextEncoder(c.text_encoder)
        self.prosody_encoder = ProsodyTextEncoder(
            c.prosody_encoder, vocab_size=c.text_encoder.vocab_size,
            text_dim=text_dim)
        self.style_extractor = StyleExtractor(c.style, n_mels=c.audio.n_mels)
        self.quantizer = StyleQuantizer(c.style)
        self.prompt_encoder = PromptEncoder(c.prompt_encoder,
                                            n_mels=c.audio.n_mels)
        self.duration_predictor = DurationPredictor(c.predictor,
                                                    pros_dim + d_style)
        self.prosody_predictor = ProsodyPredictor(c.predictor,
                                                  pros_dim + d_style)
        self.decoder = MelDecoder(c.decoder, n_mels=c.audio.n_mels,
                                  text_dim=text_dim, style_dim=d_style)
        self.align_mel_proj = Dense(c.audio.n_mels, 128)
        self.align_text_proj = Dense(text_dim, 128)

    def encode_text(self, phoneme_ids, text_mask, *, rng=None):
        text_enc = self.text_encoder(phoneme_ids, mask=text_mask, rng=rng)
        pros_enc = self.prosody_encoder(phoneme_ids, text_enc, mask=text_mask,
                                        rng=rng)
        return text_enc, pros_enc

    def extract_style(self, mel, frame_mask):
        """Training path: mel -> (quantized style (B, K, d_style), codes,
        indices)."""
        return self.quantizer(self.style_extractor(mel, mask=frame_mask))

    def encode_prompt(self, ref_mel, ref_mask=None):
        return self.prompt_encoder(ref_mel, mask=ref_mask)

    def quantize_style(self, style):
        """Snap a sampled continuous style onto the FSQ lattice."""
        return self.quantizer.project_style(style)

    def text_to_mel(self, phoneme_ids, style, *, text_mask,
                    durations=None, f0_target=None, energy_target=None,
                    n_frames: int | None = None, encoded=None,
                    rng=None) -> AcousticOutput:
        """The core synthesis path.  ``durations`` (B, T_text) overrides
        the predictor's (training with aligner targets); ``f0_target`` and
        ``energy_target`` (B, T_frames) go to the decoder in place of the
        predictions, which are returned all the same.  ``encoded`` is
        ``encode_text``'s (text_enc, pros_enc) when the caller has it."""
        n_frames = n_frames or self.cfg.max_frames
        text_enc, pros_enc = (encoded if encoded is not None
                              else self.encode_text(phoneme_ids, text_mask,
                                                    rng=rng))
        log_dur = self.duration_predictor(pros_enc, style.mean(dim=1),
                                          mask=text_mask, rng=rng)
        if durations is None:
            durations = self.duration_predictor.to_frames(log_dur, text_mask)
        frame_lengths = torch.clamp(durations.sum(-1), max=n_frames) \
            .to(torch.int32)
        frame_mask = length_mask(frame_lengths, n_frames)
        aligned_text = align.expand_by_duration(text_enc, durations, n_frames)
        aligned_pros = align.expand_by_duration(pros_enc, durations, n_frames)
        style_frames = align.stretch_style_codes(style, frame_lengths,
                                                 n_frames)
        f0, energy = self.prosody_predictor(aligned_pros, style_frames,
                                            mask=frame_mask, rng=rng)
        mel, hidden = self.decoder(
            aligned_text, f0 if f0_target is None else f0_target,
            energy if energy_target is None else energy_target, style_frames,
            mask=frame_mask)
        return AcousticOutput(mel=mel, hidden=hidden, log_dur=log_dur,
                              durations=durations, f0=f0, energy=energy,
                              frame_lengths=frame_lengths,
                              frame_mask=frame_mask)

    def align_energies(self, text_enc, mel, *, text_mask=None):
        """Alignment energies (B, T_frames, T_text), fp32: scaled products of
        the projected mel frames and text encodings, masked text at -1e9."""
        q = self.align_mel_proj(mel)
        k = self.align_text_proj(text_enc)
        energies = torch.bmm(q.float(), k.float().transpose(1, 2)) \
            * 128 ** -0.5
        if text_mask is not None:
            energies = energies.masked_fill(~text_mask[:, None, :], -1e9)
        return energies

    def reconstruct(self, phoneme_ids, mel_gt, durations, *, text_mask=None,
                    frame_mask=None, f0_target=None, energy_target=None,
                    rng=None):
        """Stage-1 training forward: the style from the ground-truth mel.
        Returns (AcousticOutput, codes, quantized style)."""
        styled, codes, _ = self.extract_style(mel_gt, frame_mask)
        out = self.text_to_mel(
            phoneme_ids, styled, text_mask=text_mask, durations=durations,
            f0_target=f0_target, energy_target=energy_target,
            n_frames=mel_gt.shape[1], rng=rng)
        return out, codes, styled

"""Top-level acoustic model (text + style -> mel).

Counterpart of ``styletts_zs_tpu/models/tts.py``: text encoding, duration
prediction, monotonic expansion, prosody prediction and the AdaIN mel
decoder, with the style codes as an input.  The training forwards
(``reconstruct``, ``align_energies``) belong to the training slice; the
modules they use are here so the whole parameter tree has a home.
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

    def encode_text(self, phoneme_ids, text_mask):
        text_enc = self.text_encoder(phoneme_ids, mask=text_mask)
        pros_enc = self.prosody_encoder(phoneme_ids, text_enc, mask=text_mask)
        return text_enc, pros_enc

    def encode_prompt(self, ref_mel, ref_mask=None):
        return self.prompt_encoder(ref_mel, mask=ref_mask)

    def quantize_style(self, style):
        """Snap a sampled continuous style onto the FSQ lattice."""
        return self.quantizer.project_style(style)

    def text_to_mel(self, phoneme_ids, style, *, text_mask,
                    n_frames: int | None = None,
                    encoded=None) -> AcousticOutput:
        """The core synthesis path.  ``encoded`` is ``encode_text``'s
        (text_enc, pros_enc) when the caller has it already."""
        n_frames = n_frames or self.cfg.max_frames
        text_enc, pros_enc = (encoded if encoded is not None
                              else self.encode_text(phoneme_ids, text_mask))
        log_dur = self.duration_predictor(pros_enc, style.mean(dim=1),
                                          mask=text_mask)
        durations = self.duration_predictor.to_frames(log_dur, text_mask)
        frame_lengths = torch.clamp(durations.sum(-1), max=n_frames) \
            .to(torch.int32)
        frame_mask = length_mask(frame_lengths, n_frames)
        aligned_text = align.expand_by_duration(text_enc, durations, n_frames)
        aligned_pros = align.expand_by_duration(pros_enc, durations, n_frames)
        style_frames = align.stretch_style_codes(style, frame_lengths,
                                                 n_frames)
        f0, energy = self.prosody_predictor(aligned_pros, style_frames,
                                            mask=frame_mask)
        mel, hidden = self.decoder(aligned_text, f0, energy, style_frames,
                                   mask=frame_mask)
        return AcousticOutput(mel=mel, hidden=hidden, log_dur=log_dur,
                              durations=durations, f0=f0, energy=energy,
                              frame_lengths=frame_lengths,
                              frame_mask=frame_mask)

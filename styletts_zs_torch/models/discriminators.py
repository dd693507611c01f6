"""Multi-modal discriminators of stage-1 training and their LSGAN losses.

Counterpart of ``styletts_zs_tpu/models/discriminators.py``: a multi-period
waveform critic (MPD), a multi-resolution spectrogram critic (MRD) and a
mel-patch critic, each returning per-scale logits and its feature maps for
the feature-matching loss.  The JAX package's layouts are kept, since they
change what is computed: the MPD folds the phase axis into the batch (a 1-D
conv over T/p per phase, the canonical (5, 1) 2-D kernels' function), and
the MRD folds 128-wide frequency bands into the batch and drops the
Nyquist bin.  The strided convs pad as XLA's SAME does, which is
asymmetric (``ops.conv.same_padding_strided``).  Submodules carry the Flax
names (``mpd_p2/conv0``...), so ``convert_params`` maps the JAX tree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from styletts_zs_torch.config import AudioConfig, DiscriminatorConfig
from styletts_zs_torch.models.layers import Conv
from styletts_zs_torch.ops import stft as stft_ops


def _leaky(x):
    return F.leaky_relu(x, 0.1)


class PeriodDiscriminator(nn.Module):
    """Waveform folded at one period, phase into batch -> conv stack."""

    def __init__(self, period: int, channels: int, max_channels: int):
        super().__init__()
        self.period = period
        c_in, ch = 1, channels
        for i in range(4):
            c_out = min(ch, max_channels)
            self.add_module(f"conv{i}", Conv(c_in, c_out, 5, stride=3))
            c_in, ch = c_out, ch * 4
        self.conv4 = Conv(c_in, max_channels, 5)
        self.out = Conv(max_channels, 1, 3)

    def forward(self, wav):
        """wav (B, T) -> (logits (B, p * T''), feature maps)."""
        B, T = wav.shape
        p = self.period
        T_pad = -(-T // p) * p
        x = F.pad(wav[:, None], (0, T_pad - T), mode="reflect")[:, 0]
        x = x.reshape(B, T_pad // p, p).transpose(1, 2) \
            .reshape(B * p, T_pad // p, 1)
        feats = []
        for i in range(5):
            x = _leaky(getattr(self, f"conv{i}")(x))
            feats.append(x)
        return self.out(x).reshape(B, -1), feats


class ResolutionDiscriminator(nn.Module):
    """Magnitude spectrogram at one resolution, band-folded -> conv stack."""

    def __init__(self, n_fft: int, hop: int, channels: int,
                 max_channels: int):
        super().__init__()
        self.audio = AudioConfig(n_fft=n_fft, win_length=n_fft,
                                 hop_length=hop)
        F_bins = n_fft // 2 + 1
        bw = 128 if (F_bins - 1) % 128 == 0 else F_bins - 1
        self.bw = bw
        wide = min(2 * bw, max(max_channels, bw))
        widths, strides = (bw, bw, wide, wide), (1, 1, 2, 2)
        c_in = bw
        for i, (w, s) in enumerate(zip(widths, strides)):
            self.add_module(f"conv{i}", Conv(c_in, w, 5, stride=s))
            c_in = w
        self.out = Conv(c_in, 1, 3)

    def forward(self, wav):
        mag = stft_ops.spectrogram(wav, self.audio)           # (B, T', F)
        B, T, F_bins = mag.shape
        bands = (F_bins - 1) // self.bw
        x = mag[..., :F_bins - 1].to(self.out.weight.dtype)
        x = x.reshape(B, T, bands, self.bw).transpose(1, 2) \
            .reshape(B * bands, T, self.bw)
        feats = []
        for i in range(4):
            x = _leaky(getattr(self, f"conv{i}")(x))
            feats.append(x)
        return self.out(x).reshape(B, -1), feats


class MelPatchDiscriminator(nn.Module):
    """Mel-spectrogram patch critic: a strided conv1d stack over time."""

    def __init__(self, n_mels: int, channels: int, max_channels: int):
        super().__init__()
        c_in, ch = n_mels, 4 * channels
        for i in range(4):
            c_out = min(ch, max_channels)
            self.add_module(f"conv{i}", Conv(c_in, c_out, 5, stride=2))
            c_in, ch = c_out, ch * 2
        self.out = Conv(c_in, 1, 3)

    def forward(self, mel):
        """mel (B, T, n_mels)."""
        x = mel
        feats = []
        for i in range(4):
            x = _leaky(getattr(self, f"conv{i}")(x))
            feats.append(x)
        return self.out(x).reshape(mel.shape[0], -1), feats


class MultiModalDiscriminator(nn.Module):
    """The critic ensemble over the waveform and the spectral modalities."""

    def __init__(self, cfg: DiscriminatorConfig, n_mels: int = 80):
        super().__init__()
        self.cfg = cfg
        for p in cfg.mpd_periods:
            self.add_module(f"mpd_p{p}", PeriodDiscriminator(
                p, cfg.channels, cfg.max_channels))
        for n_fft, hop in zip(cfg.mrd_ffts, cfg.mrd_hops):
            self.add_module(f"mrd_{n_fft}", ResolutionDiscriminator(
                n_fft, hop, cfg.channels, cfg.max_channels))
        self.melpatch = MelPatchDiscriminator(n_mels, cfg.channels,
                                              cfg.max_channels)

    def forward(self, wav, mel):
        """(list of logits, list of feature lists), one per critic."""
        outs = [getattr(self, f"mpd_p{p}")(wav) for p in self.cfg.mpd_periods]
        outs += [getattr(self, f"mrd_{n}")(wav) for n in self.cfg.mrd_ffts]
        outs.append(self.melpatch(mel))
        return [lg for lg, _ in outs], [ft for _, ft in outs]


# ---------------------------------------------------------------------------
# LSGAN losses, fp32
# ---------------------------------------------------------------------------

def discriminator_loss(real_logits, fake_logits):
    loss = sum(torch.mean((r.float() - 1.0) ** 2) + torch.mean(f.float() ** 2)
               for r, f in zip(real_logits, fake_logits))
    return loss / len(real_logits)


def generator_adv_loss(fake_logits):
    return sum(torch.mean((f.float() - 1.0) ** 2)
               for f in fake_logits) / len(fake_logits)


def feature_matching_loss(real_feats, fake_feats):
    terms = [torch.mean(torch.abs(r.float() - f.float()))
             for rf, ff in zip(real_feats, fake_feats)
             for r, f in zip(rf, ff)]
    return sum(terms) / max(len(terms), 1)

"""Vocoder: transposed-conv upsampling + MRF resblocks + fused synthesis head.

Counterpart of ``styletts_zs_tpu/models/vocoder.py``.  Mel frames are
upsampled by prod(upsample_rates) with transposed convs (leaky ReLU and
transposed conv in one call of ``dispatch.conv_transpose1d``, the
hand-written kernel on the card), each followed by the average of parallel
dilated resblocks; the head (leaky ReLU, K=7 conv, magnitude/phase
epilogue, iSTFT overlap-add) is one call of ``dispatch.synthesis_head`` —
the hand-written head kernel on the card.
``up{i}_kernel`` and ``istft_head.{kernel,bias}`` keep the JAX layouts.
An ``up{i}_kernel`` split over the model ranks (``parallel/sharding.py``)
gives this rank's output channels, gathered in the kernel's (B, C, T)
layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from styletts_zs_torch.config import VocoderConfig
from styletts_zs_torch.kernels import dispatch
from styletts_zs_torch.models.layers import Conv
from styletts_zs_torch.parallel import tensor as tp

HEAD_KERNEL = 7


class ResBlock(nn.Module):
    """Dilated residual conv block (multi-receptive-field component)."""

    def __init__(self, dim: int, kernel: int, dilations: tuple[int, ...]):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"conv{i}a", Conv(dim, dim, kernel, dilation=d))
            self.add_module(f"conv{i}b", Conv(dim, dim, kernel))

    def forward(self, x):
        for i in range(self.n):
            h = getattr(self, f"conv{i}a")(F.leaky_relu(x, 0.1))
            x = x + getattr(self, f"conv{i}b")(F.leaky_relu(h, 0.1))
        return x


class _HeadParams(nn.Module):
    """Head-conv parameters in the JAX layout: kernel (K, C, 3*n_freq)."""

    def __init__(self, c_in: int, features: int, kernel_size: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_size, c_in, features))
        self.bias = nn.Parameter(torch.empty(features))


class Vocoder(nn.Module):
    def __init__(self, cfg: VocoderConfig, n_mels: int = 80):
        super().__init__()
        self.cfg = c = cfg
        self.conv_in = Conv(n_mels, c.dims[0], 7)
        for i, kern in enumerate(c.upsample_kernels):
            self.register_parameter(f"up{i}_kernel", nn.Parameter(
                torch.empty(kern, c.dims[i], c.dims[i + 1])))
            for j, rk in enumerate(c.resblock_kernels):
                self.add_module(f"mrf{i}_{j}", ResBlock(
                    c.dims[i + 1], rk, c.resblock_dilations))
        n_freq = c.istft_n_fft // 2 + 1
        self.istft_head = _HeadParams(c.dims[-1], 3 * n_freq, HEAD_KERNEL)

    def forward(self, mel, *, mask=None):
        """mel (B, T, n_mels) -> waveform (B, (T*prod(rates) - 1) * hop)."""
        c = self.cfg
        x = self.conv_in(mel)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        for i, rate in enumerate(c.upsample_rates):
            # the leaky ReLU runs inside the kernel's load, which reads the
            # resblocks' (B, C, T)-major output in place
            x = self._upsample(i, x, rate)
            acc = None
            for j in range(len(c.resblock_kernels)):
                h = getattr(self, f"mrf{i}_{j}")(x)
                acc = h if acc is None else acc + h
            x = acc / len(c.resblock_kernels)
        wav = dispatch.synthesis_head(x, self.istft_head.kernel,
                                      self.istft_head.bias,
                                      n_fft=c.istft_n_fft, hop=c.istft_hop)
        return wav.to(self.conv_in.weight.dtype)

    def _upsample(self, i: int, x, rate: int):
        """Stage i's transposed conv; with a sharded kernel, this rank's
        output channels, gathered along C of the (B, C, T) memory the
        kernel writes, so the result has the layout of a whole kernel's."""
        leaf = f"up{i}_kernel"
        s = tp.shard_of(self, leaf)
        if s is None:
            return dispatch.conv_transpose1d(x, getattr(self, leaf),
                                             stride=rate, negative_slope=0.1)
        y = dispatch.conv_transpose1d(tp.copy_to_model(x, s.group),
                                      getattr(self, leaf), stride=rate,
                                      negative_slope=0.1)
        return tp.gather_features(y.transpose(1, 2), 1,
                                  s.group).transpose(1, 2)

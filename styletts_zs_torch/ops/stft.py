"""Mel/STFT frontend and the inverse STFT, plain torch.

Counterpart of ``styletts_zs_tpu/ops/stft.py``, with the same conventions:
reflect-pad center framing, a periodic Hann window of ``win_length`` centred
inside the ``n_fft`` frame, a Slaney mel filterbank, and an inverse STFT by
overlap-add normalised by the squared-window envelope; ``spectrogram`` (the
MRD discriminator's input) and ``frame_signal`` as in JAX.  The constants are
built in numpy on the host (float64, cast to float32 once); the transforms
frame the signal with ``unfold`` and multiply by the windowed DFT basis.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from styletts_zs_torch.config import AudioConfig


# ---------------------------------------------------------------------------
# numpy-side constant builders (host, once per config)
# ---------------------------------------------------------------------------

def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window(periodic=True))."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def dft_basis(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis restricted to the window support.

    Follows the torch.stft convention: a win_length window is centered inside
    the n_fft frame (offset pad_w = (n_fft - win)//2), so the DFT phase of
    window sample n is k*(n + pad_w).  Returns (cos_basis, sin_basis), each
    (n_freq, win_length), such that for the win_length signal slice x under
    the window:  real_k = cos_basis[k] @ x ,  imag_k = -sin_basis[k] @ x.
    """
    n_freq = n_fft // 2 + 1
    pad_w = (n_fft - win_length) // 2
    n = np.arange(win_length)[None, :] + pad_w
    k = np.arange(n_freq)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    win = hann_window(win_length)[None, :]
    return (np.cos(ang) * win), (np.sin(ang) * win)


def _hz_to_mel(f):
    """Slaney mel scale (linear below 1 kHz, log above)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    log_region = f >= min_log_hz
    mel = np.where(log_region, min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    log_region = m >= min_log_mel
    f = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)
    return f


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_freq)."""
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freq)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, n_freq), dtype=np.float64)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney norm: each filter integrates to ~2/bandwidth
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb


@functools.lru_cache(maxsize=8)
def stft_constants(cfg: AudioConfig):
    """Cached per-config constants as float32 numpy arrays."""
    cos_b, sin_b = dft_basis(cfg.n_fft, cfg.win_length)
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    return (cos_b.astype(np.float32), sin_b.astype(np.float32),
            fb.astype(np.float32))


@functools.lru_cache(maxsize=8)
def istft_synthesis_basis(n_fft: int, win_length: int) -> np.ndarray:
    """(2 * n_freq, win_length) float32: rows [syn_cos; -syn_sin].

    A frame's samples are ``[real | imag] @ basis``: the irfft restricted to
    the window support, times the synthesis window, over n_fft.
    """
    n_freq = n_fft // 2 + 1
    weights = np.full((n_freq,), 2.0)
    weights[0] = 1.0
    if n_fft % 2 == 0:
        weights[-1] = 1.0
    pad_w = (n_fft - win_length) // 2
    n = np.arange(win_length)[None, :] + pad_w
    k = np.arange(n_freq)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    win = hann_window(win_length)[None, :]
    syn_c = weights[:, None] * np.cos(ang) * win / n_fft
    syn_s = weights[:, None] * np.sin(ang) * win / n_fft
    return np.concatenate([syn_c, -syn_s], axis=0).astype(np.float32)


@functools.lru_cache(maxsize=8)
def istft_inverse_envelope(win_length: int, hop: int,
                           n_frames: int) -> np.ndarray:
    """1 / max(env, 1e-8) over the whole overlap-add output, float32.

    ``env`` is the sum of the squared synthesis windows of ``n_frames``
    frames ``hop`` apart: length (n_frames - 1) * hop + win_length.
    """
    w2 = hann_window(win_length) ** 2
    M = -(-win_length // hop)
    env = np.zeros(((n_frames + M - 1) * hop,))
    for m in range(M):
        seg = w2[m * hop:(m + 1) * hop]
        view = env[m * hop: (m + n_frames) * hop].reshape(n_frames, hop)
        view[:, :len(seg)] += seg
    env = env[:(n_frames - 1) * hop + win_length]
    return (1.0 / np.maximum(env, 1e-8)).astype(np.float32)


# ---------------------------------------------------------------------------
# torch transforms
# ---------------------------------------------------------------------------

def stft(wav: torch.Tensor,
         cfg: AudioConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Centred real STFT. wav: (B, T) -> (real, imag): (B, F, n_freq),
    F = T//hop + 1 (reflect padding of n_fft//2 on each side)."""
    cos_b, sin_b = stft_constants(cfg)[:2]
    pad_w = (cfg.n_fft - cfg.win_length) // 2
    pad = cfg.n_fft // 2
    x = F.pad(wav.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x[:, pad_w:].unfold(1, cfg.win_length, cfg.hop_length)
    frames = frames[:, :wav.shape[1] // cfg.hop_length + 1]
    real = frames @ torch.as_tensor(cos_b, device=wav.device).T
    imag = -(frames @ torch.as_tensor(sin_b, device=wav.device).T)
    return real, imag


def spectrogram(wav: torch.Tensor, cfg: AudioConfig, *, power: float = 1.0,
                eps: float = 1e-9) -> torch.Tensor:
    """Magnitude (power=1) or power (power=2) spectrogram, (B, F, n_freq)."""
    re, im = stft(wav, cfg)
    mag_sq = re * re + im * im
    if power == 2.0:
        return mag_sq
    return torch.sqrt(mag_sq + eps)


def frame_signal(wav: torch.Tensor, frame_length: int,
                 hop: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, frame_length), n_frames = 1 + (T - len)//hop."""
    return wav.unfold(1, frame_length, hop)


def mel_spectrogram(wav: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Log-mel spectrogram, (B, F, n_mels).  The canonical acoustic feature."""
    mag = spectrogram(wav, cfg)
    fb = torch.as_tensor(stft_constants(cfg)[2], device=wav.device)
    mel = mag @ fb.T
    return torch.log(torch.clamp(mel, min=cfg.log_floor))


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, F, win) frames ``hop`` apart -> (B, (F-1)*hop + win) sum."""
    B, n_frames, win = frames.shape
    M = -(-win // hop)
    fr = F.pad(frames, (0, M * hop - win)).reshape(B, n_frames, M, hop)
    out = frames.new_zeros(B, n_frames + M - 1, hop)
    for m in range(M):
        out[:, m:m + n_frames] += fr[:, :, m]
    return out.reshape(B, -1)[:, :(n_frames - 1) * hop + win]


def istft(real: torch.Tensor, imag: torch.Tensor,
          cfg: AudioConfig) -> torch.Tensor:
    """Centred inverse STFT by overlap-add + window-envelope normalisation.

    real/imag: (B, F, n_freq) -> wav (B, (F-1)*hop).
    """
    n_fft, win, hop = cfg.n_fft, cfg.win_length, cfg.hop_length
    basis = torch.as_tensor(istft_synthesis_basis(n_fft, win),
                            device=real.device)
    spec = torch.cat([real.float(), imag.float()], dim=-1)
    wav = overlap_add(spec @ basis, hop)
    inv_env = istft_inverse_envelope(win, hop, real.shape[1])
    wav = wav * torch.as_tensor(inv_env, device=real.device)
    start = n_fft // 2 - (n_fft - win) // 2
    return wav[:, start: start + (real.shape[1] - 1) * hop]

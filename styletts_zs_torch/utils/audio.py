"""Host-side audio DSP: framing, F0 and energy features, the polyphase
resampler.

Copies of ``frame_audio``, ``estimate_f0``, ``normalized_log_f0``,
``frame_energy`` and ``resample_poly_np`` from
``styletts_zs_tpu/utils/audio.py``: the port keeps its own so that it
imports nothing of the JAX package.  F0 is autocorrelation-based with
YIN-style cumulative-mean normalisation and parabolic interpolation, run on
the host as a data-prep step.  As in JAX, ``estimate_f0`` takes the native
frontend (``native/frontend.py``, built by g++ at first use) when it is
available and the numpy twin otherwise, with one line on stderr; the two
agree on voicing to ~97 % and on F0 to 5e-3 relative, so the route decides
the features.  ``frame_energy`` is numpy on either route, as in JAX, and
so is the resampler of ``pipelines/corpus.py`` (``tests/test_torch_cli.py``
holds it bit for bit to JAX's numpy twin; JAX takes the native resampler,
within 2e-6 of it).
"""
from __future__ import annotations

import functools
import math

import numpy as np


def frame_audio(wav: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    """(T,) -> (n_frames, frame_length) with zero-padded tail."""
    n_frames = max(1, 1 + (len(wav) - frame_length + hop - 1) // hop)
    out = np.zeros((n_frames, frame_length), wav.dtype)
    for i in range(n_frames):
        seg = wav[i * hop: i * hop + frame_length]
        out[i, : len(seg)] = seg
    return out


def estimate_f0(wav: np.ndarray, sample_rate: int, *, hop: int = 300,
                frame_length: int = 1200, fmin: float = 60.0,
                fmax: float = 400.0, threshold: float = 0.1):
    """Frame-level F0 (Hz) and voicing via the normalised difference
    function (YIN-style): (f0 (n_frames,) float32, voiced (n_frames,)
    bool).  The native frontend when it is built, else the numpy twin."""
    native = _native()
    if native is not None:
        return native.estimate_f0(wav, sample_rate, hop=hop,
                                  frame_length=frame_length, fmin=fmin,
                                  fmax=fmax, threshold=threshold)
    frames = frame_audio(wav.astype(np.float64), frame_length, hop)
    tau_min = max(2, int(sample_rate / fmax))
    tau_max = min(frame_length - 2, int(sample_rate / fmin))
    n = frames.shape[0]
    f0 = np.zeros(n)
    voiced = np.zeros(n, bool)
    for i in range(n):
        x = frames[i]
        if np.abs(x).max() < 1e-4:
            continue
        # difference function via autocorrelation: d(t) = r(0)+r_t(0)-2corr(t)
        spec = np.fft.rfft(x, 2 * frame_length)
        corr = np.fft.irfft(spec * np.conj(spec))[:tau_max + 1]
        cumsum = np.cumsum(x * x)
        r0 = cumsum[-1]
        rt = r0 - np.concatenate([[0.0], cumsum[:-1]])
        d = r0 + rt[: tau_max + 1] - 2 * corr
        # cumulative-mean normalization
        dn = np.ones_like(d)
        run = np.cumsum(d[1:])
        dn[1:] = d[1:] * np.arange(1, tau_max + 1) / np.maximum(run, 1e-12)
        seg = dn[tau_min: tau_max]
        if seg.size == 0:
            continue
        # first dip under threshold (then walk to its local minimum, per
        # YIN), else global min
        under = np.nonzero(seg < threshold)[0]
        if under.size:
            tau = under[0] + tau_min
            while tau + 1 < tau_max and dn[tau + 1] < dn[tau]:
                tau += 1
        else:
            tau = int(np.argmin(seg)) + tau_min
        if dn[tau] < 0.5:  # voicing decision
            # parabolic interpolation around tau
            if 1 <= tau < tau_max - 1:
                a, b, c = dn[tau - 1], dn[tau], dn[tau + 1]
                denom = a - 2 * b + c
                shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
                tau = tau + np.clip(shift, -1.0, 1.0)
            f0[i] = sample_rate / tau
            voiced[i] = True
    return f0.astype(np.float32), voiced


def normalized_log_f0(f0: np.ndarray, voiced: np.ndarray,
                      *, center: float = 5.0) -> np.ndarray:
    """log-F0 shifted by ``center`` (~148 Hz); 0 where unvoiced (the
    synthetic data's convention)."""
    out = np.zeros_like(f0, np.float32)
    v = voiced & (f0 > 1.0)
    out[v] = np.log(f0[v]) - center
    return out


def frame_energy(wav: np.ndarray, *, hop: int = 300,
                 frame_length: int = 1200) -> np.ndarray:
    """Log-RMS energy per frame."""
    frames = frame_audio(wav.astype(np.float64), frame_length, hop)
    rms = np.sqrt(np.mean(frames * frames, axis=1))
    return np.log(np.maximum(rms, 1e-5)).astype(np.float32)


@functools.cache
def _native():
    """The native frontend module when its library is available, else None
    (the frontend says why on stderr, once)."""
    from styletts_zs_torch.native import frontend
    return frontend if frontend.available() else None


def resample_poly_np(wav: np.ndarray, sr_in: int, sr_out: int, *,
                     half: int = 10, beta: float = 8.6) -> np.ndarray:
    """Kaiser-windowed-sinc polyphase rational resampler (numpy).

    ``half`` zero crossings per branch; Kaiser ``beta`` 8.6 gives ~80 dB
    stopband.
    """
    g = math.gcd(int(sr_in), int(sr_out))
    L, M = sr_out // g, sr_in // g
    x = np.asarray(wav, np.float64)
    n = len(x)
    if L == M:
        return np.asarray(wav, np.float32)
    lm = max(L, M)
    N = 2 * half * lm + 1
    center = N // 2
    fc = 0.5 / lm                      # cycles/sample on the upsampled grid
    t = np.arange(N, dtype=np.float64) - center
    s = np.where(t == 0.0, 2.0 * fc,
                 np.sin(2.0 * np.pi * fc * t) / (np.pi * np.where(t == 0, 1,
                                                                  t)))
    r = t / center
    w = np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - r * r))) / np.i0(beta)
    h = L * s * w                      # (N,) float64
    # polyphase branches: Hp[p, q] = h[q*L + p]
    Q = (N - 1) // L + 1
    Hp = np.zeros((L, Q), np.float64)
    idx = np.arange(Q) * L
    for p in range(L):
        valid = idx + p < N
        Hp[p, valid] = h[idx[valid] + p]
    out_n = (n * L + M - 1) // M
    y = np.empty(out_n, np.float32)
    qs = np.arange(Q, dtype=np.int64)[None, :]
    # chunked so the (chunk, Q) gather temporaries stay a few MB
    chunk = 65536
    for off in range(0, out_n, chunk):
        u = np.arange(off, min(off + chunk, out_n), dtype=np.int64) * M \
            + center
        p = (u % L).astype(np.int64)
        b = u // L
        k = b[:, None] - qs                                  # (chunk, Q)
        ok = (k >= 0) & (k < n)
        xg = np.where(ok, x[np.clip(k, 0, n - 1)], 0.0)
        y[off: off + len(u)] = np.einsum("oq,oq->o", Hp[p], xg)
    return y

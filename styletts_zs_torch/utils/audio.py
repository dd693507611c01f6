"""Host-side audio DSP: the polyphase resampler.

A copy of ``resample_poly_np`` from ``styletts_zs_tpu/utils/audio.py``: the
port keeps its own copy so that it imports nothing of the JAX package
(``tests/test_torch_cli.py`` checks that the two agree bit for bit).  The
F0 and energy features and the native frontend come with the corpus path.
"""
from __future__ import annotations

import math

import numpy as np


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

"""WAV reading and writing, and resampling, on the host.

Copies of ``read_wav``, ``write_wav`` and ``resample`` of ``styletts_zs_tpu/pipelines/corpus.py``, in the standard
library and numpy (``tests/test_torch_cli.py`` checks them against it).
``synth --ref`` reads its reference speaker through them.  ``resample`` is the
numpy polyphase resampler (``utils.audio.resample_poly_np``), which the JAX
package's native one is tested against; the on-disk corpus (``DiskCorpus``
and its loader) comes with the corpus path.
"""
from __future__ import annotations

import wave

import numpy as np

from styletts_zs_torch.utils import audio as audio_utils


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Mono float32 in [-1, 1] and the sample rate.

    Supports 16/32-bit integer PCM (``wave`` rejects IEEE-float WAVs at
    open, so a float32 file fails loudly there rather than being
    misdecoded).
    """
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} ({path})")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """16-bit PCM writer."""
    pcm = np.asarray(wav, np.float32) * 32768.0
    pcm = np.clip(np.rint(pcm), -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Anti-aliased polyphase resampler (``resample_poly_np``)."""
    if sr_in == sr_out:
        return np.asarray(wav, np.float32)
    return audio_utils.resample_poly_np(wav, sr_in, sr_out)

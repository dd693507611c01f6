"""Corpus preprocessing on the host: raw wav -> training features.

Copies of ``Utterance``, ``ref_window``, ``featurize`` and ``collate`` from
``styletts_zs_tpu/pipelines/preprocess.py`` (``tests/test_torch_corpus.py``
and ``tests/test_torch_cli.py`` check them against it): F0 through
``utils.audio.estimate_f0`` (native when built), log-RMS energy, the
durations clipped into the frame budget, padding, and the 3 s reference
window.  Durations come from annotations, or from monotonic alignment
search at train time (``TrainConfig.use_mas_durations``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from styletts_zs_torch.config import ModelConfig
from styletts_zs_torch.utils import audio as audio_dsp


@dataclass
class Utterance:
    phonemes: np.ndarray      # (T_text,) int32
    wav: np.ndarray           # (T_samples,) float32 at cfg sample rate
    durations: np.ndarray | None = None  # optional per-phoneme frames


def ref_window(wav: np.ndarray, sample_rate: int,
               seconds: int = 3) -> np.ndarray:
    """The reference-speaker enrollment window: ``wav`` truncated or
    zero-padded to ``seconds`` of audio (training features and ``synth
    --ref``)."""
    n = seconds * sample_rate
    out = np.zeros((n,), np.float32)
    src = np.asarray(wav, np.float32)
    L = min(len(src), n)
    out[:L] = src[:L]
    return out


def featurize(utt: Utterance, cfg: ModelConfig, *, n_frames: int,
              text_len: int, ref_wav: np.ndarray | None = None) -> dict:
    """One utterance -> the padded training-example dict (the batch keys,
    unbatched).  ``ref_wav`` should be another utterance of the same
    speaker; the utterance itself when absent."""
    a = cfg.audio
    hop = a.hop_length
    wav = np.asarray(utt.wav, np.float32)
    frames = min(len(wav) // hop, n_frames)
    wav = wav[: n_frames * hop]
    if len(wav) < n_frames * hop:
        wav = np.pad(wav, (0, n_frames * hop - len(wav)))

    f0_hz, voiced = audio_dsp.estimate_f0(
        wav, a.sample_rate, hop=hop, frame_length=min(a.win_length, 4 * hop))
    f0 = audio_dsp.normalized_log_f0(f0_hz, voiced)[:n_frames]
    energy = audio_dsp.frame_energy(
        wav, hop=hop, frame_length=min(a.win_length, 4 * hop))[:n_frames]
    f0 = np.pad(f0, (0, n_frames - len(f0)))
    energy = np.pad(energy, (0, n_frames - len(energy)),
                    constant_values=np.log(1e-5))

    phon = np.zeros((text_len,), np.int32)
    n_ph = min(len(utt.phonemes), text_len)
    phon[:n_ph] = utt.phonemes[:n_ph]
    durs = np.zeros((text_len,), np.int32)
    if utt.durations is not None:
        d = np.asarray(utt.durations, np.int64)[:n_ph]
        # clip cumulative durations into the frame budget
        cum = np.minimum(np.cumsum(d), frames)
        durs[:n_ph] = np.diff(np.concatenate([[0], cum])).astype(np.int32)

    ref = ref_window(ref_wav if ref_wav is not None else utt.wav,
                     a.sample_rate)

    return {
        "phonemes": phon, "text_lengths": np.int32(n_ph),
        "durations": durs, "wav": wav, "f0": f0, "energy": energy,
        "frame_lengths": np.int32(max(frames, 8)), "ref_wav": ref,
    }


def collate(examples: list[dict]) -> dict:
    """Stack featurized examples into the training batch dict."""
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}

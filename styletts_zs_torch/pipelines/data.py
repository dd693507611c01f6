"""Data pipeline: synthetic paired (wav, phonemes, durations, F0, energy).

A copy of ``SyntheticDataset`` and ``Batch`` from
``styletts_zs_tpu/pipelines/data.py`` (numpy only; the grain loader is left
out): the port imports nothing of the JAX package, so it keeps its own.
The same seed gives the same batches, bit for bit
(``tests/test_torch_train.py`` checks it).  Each "phoneme" contributes a
voiced harmonic segment whose pitch/energy follow smooth random curves; the
wav is synthesized additively, so (text, audio, alignment) are consistent.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from styletts_zs_torch.config import ModelConfig


@dataclass
class Batch:
    phonemes: np.ndarray      # (B, T_text) int32
    text_lengths: np.ndarray  # (B,)
    durations: np.ndarray     # (B, T_text) int32 frames
    mel: np.ndarray           # (B, T_frames, n_mels) float32  (filled by caller)
    wav: np.ndarray           # (B, T_samples) float32
    f0: np.ndarray            # (B, T_frames) float32 normalized log-f0
    energy: np.ndarray        # (B, T_frames) float32 log-energy
    frame_lengths: np.ndarray  # (B,)
    ref_wav: np.ndarray       # (B, T_ref) float32 ~3 s same-speaker reference


class SyntheticDataset:
    def __init__(self, cfg: ModelConfig, *, batch_size: int, seed: int = 0,
                 n_frames: int | None = None, text_len: int | None = None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.n_frames = n_frames or min(cfg.max_frames, 256)
        self.text_len = text_len or min(cfg.max_text_len, 48)
        self.ref_samples = 3 * cfg.audio.sample_rate

    def _speaker(self):
        """A random 'speaker': pitch + spectral tilt + timbre + rate.

        ``harm``/``breath`` are UTTERANCE-STABLE timbre cues (per-harmonic
        gain profile, breath-noise floor) and ``rate`` a stable speaking-rate
        factor.  r3's diagnostic showed the corpus carried too little stable
        speaker information: on ground-truth audio the best achievable
        embedding separation was weak (retrieval 0.31,
        ``docs/artifacts/diagnose_quality_r3.json`` q2) because f0_base was
        essentially the only cue surviving per-utterance randomness.  The
        harmonic-gain profile gives every speaker a distinct spectral
        envelope — exactly what a mel-based prompt encoder can latch onto
        (VERDICT r3 missing item 3)."""
        return {
            "f0_base": float(self.rng.uniform(90.0, 280.0)),
            "tilt": float(self.rng.uniform(-0.5, 0.5)),
            "vibrato": float(self.rng.uniform(3.0, 7.0)),
            "harm": self.rng.uniform(0.4, 1.6, size=5),
            "breath": float(self.rng.uniform(0.004, 0.025)),
            "rate": float(self.rng.uniform(0.8, 1.25)),
        }

    def _utterance(self, spk, n_frames: int, text_len: int):
        a = self.cfg.audio
        hop, sr = a.hop_length, a.sample_rate
        n_ph = int(self.rng.integers(text_len // 2, text_len))
        phonemes = self.rng.integers(5, 40, size=(n_ph,)).astype(np.int32)
        # durations: deterministic per-phoneme base (2..7 frames, a fixed
        # hash of the id) x the speaker's rate x small lognormal jitter.
        # r3 drew them uniform(2,9) INDEPENDENT of phoneme and speaker —
        # pure noise, so the duration predictor's "frozen" MAE 1.666 /
        # exact 0.157 was exactly the irreducible floor of predicting the
        # mean (E|U{2..8}-5| = 12/7 = 1.71, P(U=5) = 1/7 = 0.143).  Now the
        # task is learnable: base from the ids, rate from the style/prompt
        # pathway (VERDICT r3 weak item 2, written analysis + fix).
        base = 2.0 + 5.0 * (((phonemes.astype(np.int64) * 2654435761)
                             % 997) / 996.0)
        jitter = np.exp(0.05 * self.rng.standard_normal(n_ph))
        dur = np.clip(np.round(base * spk["rate"] * jitter),
                      2, 8).astype(np.int32)
        cum = np.cumsum(dur)
        dur[cum > n_frames] = 0
        used = int(np.minimum(cum, n_frames).max()) if n_ph else 0
        if cum[-1] < n_frames and n_ph:
            dur[-1] += 0  # leave tail silent frames beyond frame_length
        frame_len = int(min(cum[-1], n_frames))

        t_frames = np.arange(n_frames) * hop / sr
        f0_curve = (spk["f0_base"]
                    * (1.0 + 0.08 * np.sin(2 * np.pi * spk["vibrato"] * t_frames)
                       + 0.1 * self.rng.standard_normal() *
                       np.sin(2 * np.pi * 0.7 * t_frames)))
        # per-phoneme voicing: ids < 22 voiced
        voiced_ph = phonemes < 22
        voiced = np.zeros(n_frames, bool)
        pos = 0
        for v, d in zip(voiced_ph, dur):
            voiced[pos: pos + d] = v
            pos += d
        voiced[frame_len:] = False
        energy_curve = np.where(voiced, 1.0, 0.15) * (
            0.6 + 0.4 * self.rng.random())

        # additive synthesis at sample rate
        n_samp = n_frames * hop
        t = np.arange(n_samp) / sr
        f0_s = np.repeat(f0_curve, hop)[:n_samp]
        en_s = np.repeat(energy_curve, hop)[:n_samp]
        voiced_s = np.repeat(voiced, hop)[:n_samp]
        phase = 2 * np.pi * np.cumsum(f0_s) / sr
        wav = np.zeros(n_samp)
        for h in range(1, 6):
            wav += (0.5 ** (h - 1 + spk["tilt"])) * spk["harm"][h - 1] \
                * np.sin(h * phase)
        wav = wav * en_s * voiced_s * 0.2
        wav += spk["breath"] * self.rng.standard_normal(n_samp)  # breath noise
        wav[frame_len * hop:] *= 0.0

        logf0 = np.where(voiced, np.log(np.maximum(f0_curve, 1.0)) - 5.0, 0.0)
        energy = np.log(np.maximum(energy_curve, 1e-3))
        return (phonemes, dur, wav.astype(np.float32), logf0.astype(np.float32),
                energy.astype(np.float32), frame_len)

    def next_batch(self) -> Batch:
        B = self.batch_size
        Tt, Tf = self.text_len, self.n_frames
        a = self.cfg.audio
        phon = np.zeros((B, Tt), np.int32)
        tlen = np.zeros((B,), np.int32)
        durs = np.zeros((B, Tt), np.int32)
        wavs = np.zeros((B, Tf * a.hop_length), np.float32)
        f0s = np.zeros((B, Tf), np.float32)
        ens = np.zeros((B, Tf), np.float32)
        flens = np.zeros((B,), np.int32)
        refs = np.zeros((B, self.ref_samples), np.float32)
        for b in range(B):
            spk = self._speaker()
            ph, d, wav, f0, en, fl = self._utterance(spk, Tf, Tt)
            n = len(ph)
            phon[b, :n] = ph
            tlen[b] = n
            durs[b, :n] = d
            wavs[b] = wav
            f0s[b] = f0
            ens[b] = en
            flens[b] = max(fl, 8)
            # same-speaker reference: an independent utterance, cropped/padded
            _, _, rwav, _, _, _ = self._utterance(
                spk, min(Tf, 256), self.text_len)
            L = min(len(rwav), self.ref_samples)
            refs[b, :L] = rwav[:L]
        return Batch(phonemes=phon, text_lengths=tlen, durations=durs,
                     mel=np.zeros((B, Tf, a.n_mels), np.float32),
                     wav=wavs, f0=f0s, energy=ens, frame_lengths=flens,
                     ref_wav=refs)

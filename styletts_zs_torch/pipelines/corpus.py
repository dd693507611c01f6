"""On-disk corpus loading: a directory of wavs and transcripts -> training
batches, on the host.

Copies of ``read_wav``, ``write_wav``, ``resample``, ``CorpusEntry``,
``DiskCorpus``, ``make_corpus_loader`` and ``export_synthetic_corpus`` of
``styletts_zs_tpu/pipelines/corpus.py``, in the standard library, numpy
and torch (``tests/test_torch_corpus.py`` and ``tests/test_torch_cli.py``
check them against it).  The layout, one metadata line per utterance:

    corpus_root/
      metadata.jsonl     # {"id": ..., "speaker": ..., "text": ...} or
                         # {"id": ..., "speaker": ..., "phonemes": [ids]}
                         # optional: "durations": [frames per phoneme]
      wavs/<id>.wav      # 16/32-bit integer PCM WAV at any rate

Each utterance is read, resampled to the config's rate and featurized
(``preprocess.featurize``) with a same-speaker reference clip: the next
utterance of that speaker in corpus order, cyclic.  Without durations,
stage 1 trains with monotonic alignment search
(``TrainConfig.use_mas_durations``).  ``resample`` is the numpy polyphase
resampler (``utils.audio.resample_poly_np``) where JAX prefers its native
one (the two agree within 2e-6); ``synth --ref`` reads its reference
speaker through it too.  ``make_corpus_loader`` batches through
``data.make_loader`` (grain is not available on the card's machine).
"""
from __future__ import annotations

import json
import os
import wave
from dataclasses import dataclass

import numpy as np

from styletts_zs_torch.config import ModelConfig
from styletts_zs_torch.pipelines import data as data_lib
from styletts_zs_torch.pipelines.preprocess import Utterance, featurize
from styletts_zs_torch.utils import audio as audio_utils
from styletts_zs_torch.utils import text as text_lib


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


@dataclass
class CorpusEntry:
    uid: str
    speaker: str
    phonemes: np.ndarray             # (T_text,) int32
    durations: np.ndarray | None     # optional per-phoneme frames
    wav_path: str


class DiskCorpus:
    """Random-access view of an on-disk corpus (a map-style source):
    ``corpus[i]`` is the featurized training-example dict, with the
    same-speaker reference chosen deterministically (the next utterance of
    the speaker in corpus order, cyclic; itself when the speaker has one),
    so epochs are reproducible across hosts."""

    def __init__(self, root: str, cfg: ModelConfig, *, n_frames: int,
                 text_len: int):
        self.root = root
        self.cfg = cfg
        self.n_frames = n_frames
        self.text_len = text_len
        self.entries: list[CorpusEntry] = []
        by_speaker: dict[str, list[int]] = {}
        with open(os.path.join(root, "metadata.jsonl")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                uid = str(rec["id"])
                if "phonemes" in rec:
                    ids = np.asarray(rec["phonemes"], np.int32)
                else:
                    ids = np.asarray(text_lib.text_to_ids(rec["text"]),
                                     np.int32)
                dur = (np.asarray(rec["durations"], np.int32)
                       if "durations" in rec else None)
                spk = str(rec.get("speaker", "0"))
                self.entries.append(CorpusEntry(
                    uid=uid, speaker=spk, phonemes=ids, durations=dur,
                    wav_path=os.path.join(root, "wavs", uid + ".wav")))
                by_speaker.setdefault(spk, []).append(len(self.entries) - 1)
        if not self.entries:
            raise ValueError(f"empty corpus at {root}")
        self._ref_idx = np.arange(len(self.entries))
        for idxs in by_speaker.values():
            for j, i in enumerate(idxs):
                self._ref_idx[i] = idxs[(j + 1) % len(idxs)]

    def __len__(self) -> int:
        return len(self.entries)

    def _load_wav(self, path: str) -> np.ndarray:
        wav, sr = read_wav(path)
        return resample(wav, sr, self.cfg.audio.sample_rate)

    def __getitem__(self, idx: int) -> dict:
        e = self.entries[int(idx)]
        utt = Utterance(phonemes=e.phonemes,
                        wav=self._load_wav(e.wav_path),
                        durations=e.durations)
        ref = self._load_wav(self.entries[self._ref_idx[int(idx)]].wav_path)
        return featurize(utt, self.cfg, n_frames=self.n_frames,
                         text_len=self.text_len, ref_wav=ref)


def make_corpus_loader(root: str, cfg: ModelConfig, *, batch_size: int,
                       n_frames: int = 256, text_len: int = 48, seed: int = 0,
                       worker_count: int = 0, shard_index: int = 0,
                       shard_count: int = 1):
    """Per-host sharded, endless loader of collated numpy batches over an
    on-disk corpus (``data.make_loader``: a host passes its (rank, world
    size) as the shard)."""
    source = DiskCorpus(root, cfg, n_frames=n_frames, text_len=text_len)
    return data_lib.make_loader(source, batch_size=batch_size, seed=seed,
                                worker_count=worker_count,
                                shard_index=shard_index,
                                shard_count=shard_count)


def export_synthetic_corpus(root: str, cfg: ModelConfig, *, n_utts: int,
                            n_speakers: int = 4, n_frames: int = 128,
                            text_len: int = 24, seed: int = 0) -> None:
    """Write a synthetic corpus to disk in the ``DiskCorpus`` layout: the
    synthetic generator's (text, audio, alignment) triples as 16-bit WAV
    files and metadata lines, ``n_utts`` in all over ``n_speakers``."""
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    lines = []
    k = 0
    for s in range(n_speakers):
        # exactly n_utts total: distribute the remainder over early speakers
        per_spk = n_utts // n_speakers + (1 if s < n_utts % n_speakers else 0)
        ds = data_lib.SyntheticDataset(cfg, batch_size=1, seed=seed * 977 + s,
                                       n_frames=n_frames, text_len=text_len)
        spk = ds._speaker()
        for _ in range(per_spk):
            ph, dur, wav, _, _, _ = ds._utterance(spk, n_frames, text_len)
            uid = f"utt{k:05d}"
            write_wav(os.path.join(root, "wavs", uid + ".wav"), wav,
                      cfg.audio.sample_rate)
            lines.append(json.dumps({
                "id": uid, "speaker": f"spk{s}",
                "phonemes": [int(p) for p in ph],
                "durations": [int(d) for d in dur]}))
            k += 1
    with open(os.path.join(root, "metadata.jsonl"), "w") as f:
        f.write("\n".join(lines) + "\n")

"""Length-bucketed batch serving (acceptance level 5).

Counterpart of ``styletts_zs_tpu/pipelines/serve.py``, on one process:
  1. collect requests (phonemes and ~3 s of reference audio) with their
     frame-length estimates;
  2. exchange the bucket histogram and the per-request style table
     (``parallel.collectives``: identities on one process), so every
     process derives the same plan and dispatch order;
  3. order each bucket's requests round-robin over style clusters, so every
     batch mixes speakers;
  4. run the synthesis program of each bucket, batch by batch, padded to
     ``serve.batch_size``;
  5. requeue a batch whose run raises a ``RuntimeError`` (out of device
     memory, say); a shape error (``ValueError``, ``TypeError``) or a kernel
     fault (``kernels.build.KernelError``) propagates.
The models are built once, on ``device`` (the card by default): no module
depends on the bucket's frame count, so one program per (bucket, batch,
text length) shares them.  Every batch starts from the same initial noise,
as JAX's starts from ``PRNGKey(0)``: a generator seeded 0 afresh, or the
``noise`` tensor given to the server.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from styletts_zs_torch.config import Config
from styletts_zs_torch.ops import stft as stft_ops
from styletts_zs_torch.parallel import bucketing, collectives
from styletts_zs_torch.pipelines.factory import build_models, resolve_device
from styletts_zs_torch.pipelines.infer import _synthesis_program


@dataclass
class Request:
    uid: int
    phonemes: np.ndarray       # (T_text,) int32
    ref_wav: np.ndarray        # (T_samples,) float32
    est_frames: int            # caller's length estimate (or max)


@dataclass
class Result:
    uid: int
    mel: np.ndarray
    wav: Optional[np.ndarray]
    frames: int


class Server:
    """Serves batches of requests on one device with ``cfg.serve``'s
    settings.  ``noise`` (batch_size, n_codes, d_style), when given, is the
    initial noise of every batch."""

    _STYLE_CHUNK = 64  # references per prompt-encoder call

    def __init__(self, cfg: Config, params, *, device=None,
                 noise: torch.Tensor | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.models = build_models(cfg, params, device=self.device)
        self.noise = None if noise is None else noise.to(self.device)
        self._programs: dict[tuple, object] = {}
        self.requeued: list[Request] = []
        self.last_style_table: np.ndarray | None = None

    def _ref_mel(self, refs: np.ndarray) -> torch.Tensor:
        return stft_ops.mel_spectrogram(
            torch.from_numpy(refs).to(self.device), self.cfg.model.audio)

    def exchange_style_codes(self, requests: list[Request]) -> np.ndarray:
        """Per-request prompt-encoder summaries, (N, d), exchanged so every
        process holds the same global table: fixed-shape chunks of 64
        references zero-padded to 3 s, then
        ``collectives.process_concat_styles``."""
        ref_len = 3 * self.cfg.model.audio.sample_rate
        C = self._STYLE_CHUNK
        chunks = []
        for start in range(0, len(requests), C):
            group = requests[start: start + C]
            refs = np.zeros((C, ref_len), np.float32)
            for j, r in enumerate(group):
                L = min(len(r.ref_wav), ref_len)
                refs[j, :L] = r.ref_wav[:L]
            with torch.inference_mode():
                _, summary = self.models.acoustic.encode_prompt(
                    self._ref_mel(refs))
            chunks.append(summary[: len(group)].float().cpu().numpy())
        local = np.concatenate(chunks, axis=0) if chunks else \
            np.zeros((0, 1), np.float32)
        return collectives.process_concat_styles(local)

    def _program(self, n_frames: int, batch: int, text_len: int):
        key = (n_frames, batch, text_len)
        if key not in self._programs:
            s = self.cfg.serve
            self._programs[key] = _synthesis_program(
                self.models, self.cfg, one_step=s.one_step, n_steps=s.n_steps,
                guidance=s.guidance, n_frames=n_frames,
                with_vocoder=s.with_vocoder)
        return self._programs[key]

    def plan(self, requests: list[Request]) -> bucketing.BucketPlan:
        """The bucket plan every process derives from the summed histogram."""
        buckets = self.cfg.serve.frame_buckets
        lengths = np.asarray([r.est_frames for r in requests], np.int64)
        local_hist = bucketing.bucket_histogram(lengths, buckets)
        global_hist = collectives.process_sum_histogram(local_hist)
        return bucketing.plan_buckets(global_hist, self.cfg.serve.batch_size,
                                      buckets)

    def serve_batch(self, requests: list[Request]) -> list[Result]:
        """Serve up to ``serve.max_global_batch`` requests; results in
        dispatch order, requeued requests in ``self.requeued``."""
        cfg = self.cfg
        s = cfg.serve
        requests = requests[: s.max_global_batch]
        buckets_map = bucketing.assign_to_buckets(
            np.asarray([r.est_frames for r in requests]), s.frame_buckets)
        style_table = self.exchange_style_codes(requests)
        cluster_ids = bucketing.style_cluster_ids(style_table)
        self.last_style_table = style_table
        text_len = cfg.model.max_text_len
        ref_len = 3 * cfg.model.audio.sample_rate
        results: list[Result] = []

        for bucket, idxs in buckets_map.items():
            idxs = bucketing.mixed_speaker_order(idxs, cluster_ids)
            B = s.batch_size
            for start in range(0, len(idxs), B):
                group = [requests[i] for i in idxs[start: start + B]]
                phon = np.zeros((B, text_len), np.int32)
                tlen = np.ones((B,), np.int32)
                refs = np.zeros((B, ref_len), np.float32)
                for j, r in enumerate(group):
                    L = min(len(r.phonemes), text_len)
                    phon[j, :L] = r.phonemes[:L]
                    tlen[j] = L
                    R = min(len(r.ref_wav), ref_len)
                    refs[j, :R] = r.ref_wav[:R]
                try:
                    results.extend(self._dispatch(bucket, phon, tlen, refs,
                                                  group))
                except RuntimeError as e:
                    print(f"serve: bucket {bucket} batch of {len(group)} "
                          f"failed, requeued: {e!r}", file=sys.stderr)
                    self.requeued.extend(group)
        return results

    def _dispatch(self, bucket, phon, tlen, refs, group) -> list[Result]:
        B = phon.shape[0]
        fn = self._program(bucket, B, phon.shape[1])
        ref_mel = self._ref_mel(refs)
        ref_lengths = torch.full((B,), ref_mel.shape[1], dtype=torch.int32,
                                 device=self.device)
        noise = self.noise if self.noise is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        out, wav = fn(torch.from_numpy(phon).to(self.device),
                      torch.from_numpy(tlen).to(self.device), ref_mel,
                      ref_lengths, noise)
        # one copy to the host per batch
        mel_np = out.mel.cpu().float().numpy()
        frames = out.frame_lengths.cpu().numpy()
        wav_np = None if wav is None else wav.cpu().float().numpy()
        hop = self.cfg.model.audio.hop_length
        return [Result(uid=r.uid, mel=mel_np[j, : frames[j]],
                       wav=None if wav_np is None
                       else wav_np[j, : frames[j] * hop],
                       frames=int(frames[j]))
                for j, r in enumerate(group)]

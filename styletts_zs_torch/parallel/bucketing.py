"""Length bucketing for serving batches.

A copy of ``styletts_zs_tpu/parallel/bucketing.py`` (numpy only): the port
keeps its own copy so that it imports nothing of the JAX package
(``tests/test_torch_serve.py`` checks that the two agree).  Utterances are
rounded up to a small set of frame buckets, one synthesis program per
bucket; the per-process bucket histograms are summed before dispatch so
that every process derives the same plan.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Default frame buckets: 80 frames/s at hop 300 / 24 kHz.
DEFAULT_FRAME_BUCKETS = (256, 512, 1024, 2048, 4864)  # up to ~60 s
DEFAULT_TEXT_BUCKETS = (64, 128, 256, 512)


def bucket_for(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= length (last bucket if none fits — caller clips)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def bucket_histogram(lengths: np.ndarray,
                     buckets: tuple[int, ...] = DEFAULT_FRAME_BUCKETS) -> np.ndarray:
    """Counts per bucket — the per-host metadata exchanged via all_gather."""
    hist = np.zeros((len(buckets),), np.int32)
    for L in lengths:
        for i, b in enumerate(buckets):
            if L <= b:
                hist[i] += 1
                break
        else:
            hist[-1] += 1
    return hist


@dataclass
class BucketPlan:
    """A deterministic global schedule of (bucket, batch) work items."""
    buckets: tuple[int, ...]
    batches_per_bucket: dict[int, int]

    @property
    def total_batches(self) -> int:
        return sum(self.batches_per_bucket.values())


def plan_buckets(global_hist: np.ndarray, batch_size: int,
                 buckets: tuple[int, ...] = DEFAULT_FRAME_BUCKETS) -> BucketPlan:
    """Build the global bucket schedule from the summed histogram.

    global_hist: (n_buckets,) summed over hosts (after all_gather).  Every
    host derives the identical plan, so the compiled-program sequence (and
    therefore the collective schedule) is host-uniform.
    """
    batches = {}
    for i, b in enumerate(buckets):
        n = int(global_hist[i])
        if n:
            batches[b] = -(-n // batch_size)
    return BucketPlan(buckets=buckets, batches_per_bucket=batches)


def assign_to_buckets(lengths: np.ndarray,
                      buckets: tuple[int, ...] = DEFAULT_FRAME_BUCKETS):
    """Group utterance indices by bucket (host-local assembly step)."""
    groups: dict[int, list[int]] = {b: [] for b in buckets}
    for idx, L in enumerate(lengths):
        groups[bucket_for(int(L), buckets)].append(idx)
    return {b: np.asarray(v, np.int32) for b, v in groups.items() if v}


def style_cluster_ids(styles: np.ndarray, n_bits: int = 8) -> np.ndarray:
    """Deterministic coarse speaker-cluster ids from a style table.

    styles: (N, d) replicated style codes / prompt summaries (after
    ``collectives.gather_style_codes`` / ``process_concat_styles``).  The id
    is the sign pattern of the first ``n_bits`` centered dims — a locality
    hash good enough to spread same-speaker requests apart; every host
    computes the identical ids from the identical replicated table.
    """
    if styles.shape[0] == 0:   # empty request list
        return np.zeros((0,), np.int64)
    styles = np.asarray(styles, np.float32).reshape(styles.shape[0], -1)
    n_bits = min(n_bits, styles.shape[1])
    centered = styles[:, :n_bits] - np.median(styles[:, :n_bits], axis=0)
    bits = (centered > 0).astype(np.int64)
    return (bits * (1 << np.arange(n_bits))).sum(axis=1)


def mixed_speaker_order(idxs: np.ndarray,
                        cluster_ids: np.ndarray) -> np.ndarray:
    """Order one bucket's request indices so consecutive batch slices are
    mixed-speaker (``BASELINE.json:11`` "mixed-speaker batch").

    Round-robins across style clusters: stable-sorts each cluster's members,
    then interleaves cluster queues — any consecutive slice draws from as
    many distinct clusters as remain non-empty, independent of the caller's
    batch size (hence no batch_size parameter).  Deterministic
    given (idxs, cluster_ids) — both derived from replicated collective
    outputs, so every host produces the identical dispatch order.
    """
    idxs = np.asarray(idxs)
    cids = np.asarray(cluster_ids)[idxs]
    queues = [idxs[cids == c].tolist() for c in np.unique(cids)]
    out: list[int] = []
    while queues:
        for q in queues:
            out.append(q.pop(0))
        queues = [q for q in queues if q]
    return np.asarray(out, idxs.dtype)


def pad_batch(arrays: list[np.ndarray], target_len: int,
              pad_value=0) -> np.ndarray:
    """Stack variable-length (T, ...) arrays into (B, target_len, ...)."""
    out = []
    for a in arrays:
        a = a[:target_len]
        pad = [(0, target_len - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, pad, constant_values=pad_value))
    return np.stack(out)

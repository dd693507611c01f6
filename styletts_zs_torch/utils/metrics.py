"""Metrics: scalar logging, a fenced wall-clock timer and the real-time
factor.

Counterpart of ``styletts_zs_tpu/utils/metrics.py``: ``MetricsWriter``
(tensorboardX when it is installed and a log directory is given, and a
JSON line on stdout for every call), ``fenced_timer`` and ``rtf``.  JAX's
``force_fetch``, ``slope_time*`` and ``profile_trace`` are left out: they
work around the remote TPU runtime, whose ``block_until_ready`` does not
wait; on the card ``torch.cuda.synchronize`` does, and ``torch.profiler``
traces.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time

import torch


class MetricsWriter:
    """Tensorboard scalar writer with a stdout JSON fallback."""

    def __init__(self, logdir: str | None = None):
        self._tb = None
        if logdir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(logdir)

    def scalars(self, step: int, values: dict, prefix: str = ""):
        clean = {f"{prefix}{k}": float(v) for k, v in values.items()}
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)
        line = {"step": int(step), **{k: round(v, 6) for k, v in clean.items()}}
        print(json.dumps(line), file=sys.stdout, flush=True)

    def audio(self, step: int, tag: str, wav, sample_rate: int):
        if self._tb is not None:
            self._tb.add_audio(tag, wav[None, :], step, sample_rate)

    def close(self):
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def fenced_timer(result: dict, key: str = "seconds"):
    """Wall time of the block into ``result[key]``; when the card is in
    use, its queued work is waited for before the clock is read.  The
    yielded dict is JAX's ``holder`` (a ``"value"`` put there is not
    needed on the card)."""
    t0 = time.perf_counter()
    holder: dict = {}
    yield holder
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    result[key] = time.perf_counter() - t0


def rtf(audio_seconds: float, wall_seconds: float) -> float:
    """Real-time factor: >1 means faster than real time."""
    return audio_seconds / max(wall_seconds, 1e-9)

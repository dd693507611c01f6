"""Reference-clip preparation on the host.

A copy of ``ref_window`` from ``styletts_zs_tpu/pipelines/preprocess.py``
(``tests/test_torch_cli.py`` checks it against it); ``featurize`` and
``collate`` come with the corpus path.
"""
from __future__ import annotations

import numpy as np


def ref_window(wav: np.ndarray, sample_rate: int,
               seconds: int = 3) -> np.ndarray:
    """The reference-speaker enrollment window: ``wav`` truncated or
    zero-padded to ``seconds`` of audio (``synth --ref``)."""
    n = seconds * sample_rate
    out = np.zeros((n,), np.float32)
    src = np.asarray(wav, np.float32)
    L = min(len(src), n)
    out[:L] = src[:L]
    return out

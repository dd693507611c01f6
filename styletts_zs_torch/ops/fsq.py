"""Finite Scalar Quantization lattice: flat index -> code (inference half).

Counterpart of the index -> code map of ``styletts_zs_tpu/ops/fsq.py``,
which ``StyleQuantizer.decode_indices`` uses.  Per channel with L levels a
code is ``2 * digit / (L - 1) - 1`` for a digit in {0 .. L-1}; flat indices
are mixed-radix numbers with the first channel least significant.
"""
from __future__ import annotations

import numpy as np
import torch


def _basis(levels: tuple[int, ...]) -> np.ndarray:
    lv = np.asarray(levels)
    return np.concatenate([[1], np.cumprod(lv[:-1])]).astype(np.int64)


def indices_to_codes(indices: torch.Tensor,
                     levels: tuple[int, ...]) -> torch.Tensor:
    """Flat int indices -> FSQ-grid codes (..., d) in [-1, 1], fp32."""
    basis = torch.as_tensor(_basis(levels), device=indices.device)
    lv = torch.tensor(levels, dtype=torch.int64, device=indices.device)
    digits = (indices[..., None].long() // basis) % lv
    return 2.0 * digits.float() / (lv.float() - 1.0) - 1.0

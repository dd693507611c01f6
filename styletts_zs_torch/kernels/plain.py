"""Calls of the kernels' plain versions with CUDA tensors, by kernel.

On the card every op of ``dispatch`` launches its kernel; a plain version
that sees a CUDA tensor is either a comparison (``chip_smoke.py`` phase 3)
or a route that should not exist.  ``chip_smoke.py`` empties ``cuda_calls``
before each card path and fails unless it is still empty after it.
"""
from __future__ import annotations

import torch

cuda_calls: dict[str, int] = {}


def note(name: str, x: torch.Tensor) -> None:
    """Count a call of ``name``'s plain version if ``x`` lies on the card."""
    if x.is_cuda:
        cuda_calls[name] = cuda_calls.get(name, 0) + 1

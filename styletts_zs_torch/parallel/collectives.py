"""Host-level exchanges of the serving path.

Counterpart of ``process_concat_styles`` and ``process_sum_histogram`` in
``styletts_zs_tpu/parallel/collectives.py``: every process must hold the
same style table and bucket histogram so that all derive the same plan and
dispatch order.  On one process both are identities, as in JAX.  Across
processes (``torch.distributed`` initialised with more than one rank) they
raise ``NotImplementedError`` rather than return a table that only holds
this process's requests; the mesh exchanges come with the multi-GPU port.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist


def _one_process(what: str) -> None:
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{what} across {dist.get_world_size()} processes is not "
            f"ported yet")


def process_concat_styles(local: np.ndarray) -> np.ndarray:
    """Concatenate the per-process style tables (ordered by rank) so every
    process sees the global (N_total, ...) table."""
    _one_process("process_concat_styles")
    return np.asarray(local)


def process_sum_histogram(local_hist: np.ndarray) -> np.ndarray:
    """Sum the per-process bucket histograms so every process sees the
    global one."""
    _one_process("process_sum_histogram")
    return np.asarray(local_hist)

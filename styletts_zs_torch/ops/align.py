"""Alignment and upsampling ops: phoneme-rate -> frame-rate (inference half).

Counterpart of the inference functions of ``styletts_zs_tpu/ops/align.py``:
length expansion is a dense (T_frames x T_text) 0/1 alignment matrix, and
the K fixed-length style codes are stretched over each utterance by a
linear-interpolation matrix.  The training-time aligner (forward-sum loss,
monotonic alignment search) belongs to the training slice.
"""
from __future__ import annotations

import torch


def alignment_matrix(durations: torch.Tensor, n_frames: int) -> torch.Tensor:
    """durations: (B, T_text) -> A: (B, n_frames, T_text), A[b,t,i] = 1 iff
    frame t belongs to phoneme i."""
    d = durations.float()
    cum = torch.cumsum(d, dim=-1)
    start = cum - d
    t = torch.arange(n_frames, dtype=torch.float32,
                     device=durations.device)[None, :, None]
    return ((t >= start[:, None, :]) & (t < cum[:, None, :])).float()


def expand_by_duration(x: torch.Tensor, durations: torch.Tensor,
                       n_frames: int) -> torch.Tensor:
    """x: (B, T_text, C), durations: (B, T_text) -> (B, n_frames, C)."""
    A = alignment_matrix(durations, n_frames)
    return torch.bmm(A, x.float()).to(x.dtype)


def interp_style_matrix(lengths: torch.Tensor, n_codes: int,
                        n_frames: int) -> torch.Tensor:
    """(B,) frame counts -> W: (B, n_frames, K); frame t maps to code
    position t/(len-1)*(K-1), frames past ``lengths`` hold the last code."""
    t = torch.arange(n_frames, dtype=torch.float32,
                     device=lengths.device)[None, :]
    denom = torch.clamp(lengths.float() - 1.0, min=1.0)[:, None]
    pos = torch.clamp(t / denom, 0.0, 1.0) * (n_codes - 1)
    k = torch.arange(n_codes, dtype=torch.float32,
                     device=lengths.device)[None, None, :]
    w = torch.clamp(1.0 - torch.abs(pos[:, :, None] - k), min=0.0)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)


def stretch_style_codes(codes: torch.Tensor, lengths: torch.Tensor,
                        n_frames: int) -> torch.Tensor:
    """codes: (B, K, d) -> (B, n_frames, d)."""
    W = interp_style_matrix(lengths, codes.shape[1], n_frames)
    return torch.bmm(W, codes.float()).to(codes.dtype)

"""Alignment and upsampling ops: phoneme-rate -> frame-rate.

Counterpart of ``styletts_zs_tpu/ops/align.py``: length expansion is a
dense (T_frames x T_text) 0/1 alignment matrix, and the K fixed-length
style codes are stretched over each utterance by a linear-interpolation
matrix.  The training-time aligner's objective, ``forward_sum_loss``, is a
log-space DP over frames, a Python loop where JAX runs ``lax.scan``: about
five kernel launches a frame forward and twice that backward, so ~15 000 at
1024 frames.  ``monotonic_alignment_search`` (the duration targets of a
corpus without annotations, ``use_mas_durations``) is a Viterbi pass over
the frames and a backtrace, two Python loops where JAX runs two
``lax.scan``s, with the same adds and compares, so its durations equal
JAX's; no value is read back to the host inside the loops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def forward_sum_loss(log_probs: torch.Tensor, text_lengths: torch.Tensor,
                     frame_lengths: torch.Tensor) -> torch.Tensor:
    """CTC-style forward-sum loss over a (B, T_frames, T_text) lattice of
    log p(frame t | phoneme i): monotonic paths advance the text index by 0
    or 1 a frame and end at the last phoneme; frames past an utterance's
    length leave its alpha unchanged.  -mean(log-sum / frame length)."""
    B, T, N = log_probs.shape
    neg = -1e30
    alpha = F.pad(log_probs[:, 0, :1], (0, N - 1), value=neg)
    frame_valid = (torch.arange(1, T, device=log_probs.device)[:, None]
                   < frame_lengths[None, :])[..., None]      # (T-1, B, 1)
    for t in range(1, T):
        move = F.pad(alpha[:, :-1], (1, 0), value=neg)
        new = torch.logaddexp(alpha, move) + log_probs[:, t]
        alpha = torch.where(frame_valid[t - 1], new, alpha)
    final = alpha.gather(1, (text_lengths.long() - 1)[:, None])[:, 0]
    return -(final / torch.clamp(frame_lengths.float(), min=1.0)).mean()


def monotonic_alignment_search(energies: torch.Tensor,
                               text_lengths: torch.Tensor,
                               frame_lengths: torch.Tensor) -> torch.Tensor:
    """Hard durations (B, T_text) int32, summing to ``frame_lengths``, of
    the best monotonic path through the (B, T_frames, T_text) ``energies``
    (higher = better): a forward Viterbi over the frames in fp32 (a bf16
    lattice is promoted at its first add) that keeps whether each text
    index advanced entering each frame (strictly better: ``move > stay``),
    then a backtrace from each utterance's last phoneme.  Frames past an
    utterance's length leave its scores and bits unchanged."""
    B, T, N = energies.shape
    dev = energies.device
    neg = -1e30
    alpha = torch.full((B, N), neg, dtype=torch.float32, device=dev)
    alpha[:, 0] = energies[:, 0, 0]
    frame_valid = (torch.arange(T, device=dev)[:, None]
                   < frame_lengths[None, :])                 # (T, B)
    moves = torch.empty(max(T - 1, 0), B, N, dtype=torch.bool, device=dev)
    for t in range(1, T):
        move = F.pad(alpha[:, :-1], (1, 0), value=neg)
        took = move > alpha
        new = torch.where(took, move, alpha) + energies[:, t]
        valid = frame_valid[t][:, None]
        alpha = torch.where(valid, new, alpha)
        torch.logical_and(took, valid, out=moves[t - 1])
    # the text index at each frame, from the last frame back
    idx = torch.empty(T, B, dtype=torch.int64, device=dev)
    i_cur = text_lengths.long() - 1
    for t in range(T - 1, 0, -1):
        idx[t] = i_cur
        took = moves[t - 1].gather(1, i_cur[:, None])[:, 0]
        i_cur = i_cur - (took & frame_valid[t]).long()
    idx[0] = i_cur
    durations = torch.zeros(B, N, dtype=torch.int32, device=dev)
    return durations.scatter_add_(1, idx.T, frame_valid.T.to(torch.int32))

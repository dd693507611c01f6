"""Finite Scalar Quantization (FSQ) of the discrete style codes.

Counterpart of ``styletts_zs_tpu/ops/fsq.py``.  Per channel with L levels:

    bound(z) = tanh(z + shift) * half_l - offset
    digit    = round(bound(z)) + L // 2        in {0 .. L-1}
    code     = 2 * digit / (L - 1) - 1         in [-1, 1]

with a straight-through gradient through the round; flat indices are
mixed-radix numbers with the first channel least significant.  The
usage-entropy regulariser (``entropy_losses``) is the stage-1 loss's
codebook term.  The constants are built in numpy (float64, cast to float32
once), as JAX builds them.
"""
from __future__ import annotations

import numpy as np
import torch


def _basis(levels: tuple[int, ...]) -> np.ndarray:
    lv = np.asarray(levels)
    return np.concatenate([[1], np.cumprod(lv[:-1])]).astype(np.int64)


def _bound_params(levels: tuple[int, ...], device):
    lv = np.asarray(levels, dtype=np.float64)
    half_l = (lv - 1.0) * (1.0 - 1e-3) / 2.0
    offset = np.where(lv % 2 == 0, 0.5, 0.0)
    shift = np.arctanh(offset / half_l)
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (half_l, offset, shift, lv))


def bound(z: torch.Tensor, levels: tuple[int, ...]) -> torch.Tensor:
    half_l, offset, shift, _ = _bound_params(levels, z.device)
    return torch.tanh(z.float() + shift) * half_l - offset


def quantize(z: torch.Tensor, levels: tuple[int, ...]) -> torch.Tensor:
    """z (..., d) unbounded -> codes on the FSQ grid in z's dtype; the
    gradient is that of bound -> rescale (straight-through)."""
    lv = _bound_params(levels, z.device)[3]
    digit_c = bound(z, levels) + torch.div(lv, 2, rounding_mode="floor")
    digit = digit_c + (torch.round(digit_c) - digit_c).detach()
    return (2.0 * digit / (lv - 1.0) - 1.0).to(z.dtype)


def codes_to_indices(codes: torch.Tensor,
                     levels: tuple[int, ...]) -> torch.Tensor:
    """FSQ-grid codes (..., d) in [-1, 1] -> flat int32 lattice indices."""
    lv = torch.tensor(levels, dtype=torch.float32, device=codes.device)
    digits = torch.round((codes.float() + 1.0) * (lv - 1.0) / 2.0)
    basis = torch.as_tensor(_basis(levels), device=codes.device)
    return (digits.long() * basis).sum(-1).to(torch.int32)


def indices_to_codes(indices: torch.Tensor,
                     levels: tuple[int, ...]) -> torch.Tensor:
    """Flat int indices -> FSQ-grid codes (..., d) in [-1, 1], fp32."""
    basis = torch.as_tensor(_basis(levels), device=indices.device)
    lv = torch.tensor(levels, dtype=torch.int64, device=indices.device)
    digits = (indices[..., None].long() // basis) % lv
    return 2.0 * digits.float() / (lv.float() - 1.0) - 1.0


def soft_digit_probs(z: torch.Tensor, levels: tuple[int, ...],
                     tau: float = 1.0):
    """(probs (..., d, Lmax), level_mask (d, Lmax)): a softmax over the
    squared distance of the continuous digit to each valid level."""
    lv = _bound_params(levels, z.device)[3]
    digit_c = bound(z, levels) + torch.div(lv, 2, rounding_mode="floor")
    ks = torch.arange(max(levels), dtype=torch.float32, device=z.device)
    d2 = (digit_c[..., None] - ks) ** 2
    level_mask = ks[None, :] < lv[:, None]
    logits = torch.where(level_mask, -d2 / tau, torch.tensor(
        -1e9, device=z.device))
    return torch.softmax(logits, dim=-1), level_mask


def entropy_losses(z: torch.Tensor, levels: tuple[int, ...],
                   tau: float = 1.0, *, batch_mean=None):
    """(sample_entropy, codebook_entropy), per-dimension means in nats;
    the stage-1 loss minimises their difference.  ``batch_mean`` takes the
    (N, d, Lmax) probabilities to their mean over the batch's rows (by
    default these N; a data-parallel step averages over every rank's)."""
    p, level_mask = soft_digit_probs(z, levels, tau)
    flat = p.float().reshape(-1, *p.shape[-2:])           # (N, d, Lmax)
    eps = 1e-9
    sample_ent = -(flat * torch.log(flat + eps)).sum(-1).mean()
    marginal = (flat.mean(dim=0) if batch_mean is None
                else batch_mean(flat))                    # (d, Lmax)
    code_ent = -torch.where(level_mask, marginal * torch.log(marginal + eps),
                            torch.zeros((), device=z.device)).sum(-1)
    return sample_ent, code_ent.mean()

"""Attention ops: full MHA and chunk-local (windowed) attention, plain torch.

Counterpart of ``styletts_zs_tpu/ops/attention.py``.  Queries in chunk ``c``
attend to keys in chunks ``c-1, c, c+1``.  Layout (B, T, H, D); the softmax is
always fp32, masked logits are set to ``NEG_INF`` (not -inf) so a row with no
valid key averages uniformly, exactly as in JAX.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Full multi-head attention.

    q: (B, Tq, H, D), k/v: (B, Tk, H, D); mask: broadcastable to
    (B, H, Tq, Tk), True = attend.  Returns (B, Tq, H, D).
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) lengths -> (B, t) bool validity mask."""
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def local_attention(q, k, v, *, chunk: int,
                    kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Chunk-local self-attention, O(T·3W), over zero-padded neighbour chunks.

    The twin of ``styletts_zs_tpu.ops.attention.local_attention``: when the
    sequence fits in one chunk the band covers everything and this is full
    attention.
    """
    B, T, H, D = q.shape
    if T <= chunk:
        mask = None if kv_mask is None else kv_mask[:, None, None, :]
        return mha(q, k, v, mask=mask)
    if T % chunk != 0:
        raise ValueError(f"T={T} not a multiple of chunk={chunk}")
    n = T // chunk
    scale = D ** -0.5
    qc = q.reshape(B, n, chunk, H, D)

    def neighbors(x):  # (B, n, chunk, ...) -> (B, n, 3*chunk, ...)
        pad = torch.zeros_like(x[:, :1])
        prev = torch.cat([pad, x[:, :-1]], dim=1)
        nxt = torch.cat([x[:, 1:], pad], dim=1)
        return torch.cat([prev, x, nxt], dim=2)

    kn = neighbors(k.reshape(B, n, chunk, H, D))
    vn = neighbors(v.reshape(B, n, chunk, H, D))
    if kv_mask is None:
        valid = torch.ones(B, n, chunk, dtype=torch.bool, device=q.device)
    else:
        valid = kv_mask.reshape(B, n, chunk)
    kv_valid = neighbors(valid)                               # (B, n, 3c)

    logits = torch.einsum("bnqhd,bnkhd->bnhqk", qc.float(), kn.float()) * scale
    logits = logits.masked_fill(~kv_valid[:, :, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", probs.to(v.dtype).float(),
                       vn.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def cross_attention(q, k, v, *,
                    kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Full cross-attention with key-validity mask.  q:(B,Tq,H,D) k/v:(B,Tk,H,D)."""
    mask = None if kv_mask is None else kv_mask[:, None, None, :]
    return mha(q, k, v, mask=mask)

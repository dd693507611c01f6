"""Shared neural building blocks in (B, T, C) layout (PyTorch modules).

Counterpart of ``styletts_zs_tpu/models/layers.py``.  Submodules carry the
Flax modules' names (``qkv``, ``proj``, ``LayerNorm_0``, ``MLP_0``...), so a
Flax parameter path is a ``state_dict`` key after ``pipelines/convert.py``
renames the leaf and reorders its axes.  As in Flax, each layer computes in
the dtype of its parameters and casts its input to it; LayerNorm takes its
statistics in fp32 with eps 1e-6 (Flax's default); GELU is the tanh form
(``jax.nn.gelu``'s default).  Dropout, where JAX's modules have it, draws
its Bernoulli masks from an explicit ``torch.Generator`` handed down the
forward calls (``rng``, JAX's ``deterministic=False`` with a dropout key);
with ``rng=None`` it is the identity, as at inference.

Tensor parallelism: a Dense or Conv weight, an embedding table or an AdaIN
block's kernels may hold only this rank's chunk of their output channels
(``parallel.tensor.shard_modules``); the layer then computes its output
slice and gathers the slices over the model ranks, and adds the bias,
which stays whole, after the gather.  A layer whose weight is whole runs
as it always has.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from styletts_zs_torch.kernels import dispatch
from styletts_zs_torch.ops import conv as conv_ops
from styletts_zs_torch.ops import norm as norm_ops
from styletts_zs_torch.parallel import tensor as tp


def dropout(x: torch.Tensor, rate: float,
            rng: torch.Generator | None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability 1 - rate and scale by
    1 / (1 - rate), in x's dtype; the identity for ``rng=None`` or rate 0."""
    if rng is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=rng, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def sinusoidal_embedding(positions: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """positions: (...,) -> (..., dim) fp32 [cos | sin] features."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def position_table(n: int, dim: int, like: torch.Tensor) -> torch.Tensor:
    """(1, n, dim) sinusoidal table for positions 0..n-1, in like's dtype."""
    pos = torch.arange(n, device=like.device)
    return sinusoidal_embedding(pos, dim)[None].to(like.dtype)


class Dense(nn.Linear):
    """``nn.Dense``: the input is cast to the weight's dtype."""

    def forward(self, x):
        x = x.to(self.weight.dtype)
        s = tp.shard_of(self, "weight")
        if s is None:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(tp.copy_to_model(x, s.group), self.weight)
        return tp.gather_features(y, -1, s.group) + self.bias


class Embed(nn.Embedding):
    """``nn.Embed``: a table lookup (a sharded table looks up its feature
    chunk, then gathers)."""

    def forward(self, ids):
        y = F.embedding(ids, self.weight)
        s = tp.shard_of(self, "weight")
        return y if s is None else tp.gather_features(y, -1, s.group)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm``: eps 1e-6, statistics in fp32, output in the
    parameters' dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.weight.dtype)


class Conv(nn.Module):
    """``nn.Conv`` with SAME padding in (B, T, C) layout; torch weight
    layout (C_out, C_in, K)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, *,
                 dilation: int = 1, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel))
        self.bias = nn.Parameter(torch.empty(c_out))
        self.dilation, self.stride = dilation, stride

    def forward(self, x):
        x = x.to(self.weight.dtype)
        s = tp.shard_of(self, "weight")
        if s is None:
            return conv_ops.conv1d_torch_weight(
                x, self.weight, self.bias, dilation=self.dilation,
                stride=self.stride)
        y = conv_ops.conv1d_torch_weight(
            tp.copy_to_model(x, s.group), self.weight, dilation=self.dilation,
            stride=self.stride)
        return tp.gather_features(y, -1, s.group) + self.bias.to(x.dtype)


class MLP(nn.Module):
    def __init__(self, dim: int, expand: int = 4):
        super().__init__()
        self.Dense_0 = Dense(dim, dim * expand)
        self.Dense_1 = Dense(dim * expand, dim)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class SelfAttention(nn.Module):
    """Multi-head self-attention; full, or chunk-local when ``chunk`` is set."""

    def __init__(self, dim: int, n_heads: int, chunk: int | None = None):
        super().__init__()
        self.dim, self.n_heads, self.chunk = dim, n_heads, chunk
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x, *, mask=None):
        B, T, _ = x.shape
        D = self.dim // self.n_heads
        q, k, v = (t.reshape(B, T, self.n_heads, D)
                   for t in self.qkv(x).split(self.dim, dim=-1))
        if self.chunk is not None:
            out = dispatch.local_attention(q, k, v, chunk=self.chunk,
                                           kv_mask=mask)
        else:
            out = dispatch.full_attention(q, k, v, kv_mask=mask)
        return self.proj(out.reshape(B, T, self.dim))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int, ctx_dim: int | None = None):
        super().__init__()
        self.dim, self.n_heads = dim, n_heads
        self.q = Dense(dim, dim)
        self.kv = Dense(ctx_dim or dim, 2 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x, ctx, *, ctx_mask=None):
        B, T, _ = x.shape
        Tc = ctx.shape[1]
        D = self.dim // self.n_heads
        q = self.q(x).reshape(B, T, self.n_heads, D)
        k, v = (t.reshape(B, Tc, self.n_heads, D)
                for t in self.kv(ctx).split(self.dim, dim=-1))
        out = dispatch.full_attention(q, k, v, kv_mask=ctx_mask)
        return self.proj(out.reshape(B, T, self.dim))


class TransformerBlock(nn.Module):
    """Pre-LN transformer block with full or chunk-local self-attention,
    dropout after the attention and after the MLP."""

    def __init__(self, dim: int, n_heads: int, chunk: int | None = None,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.LayerNorm_0 = LayerNorm(dim)
        self.SelfAttention_0 = SelfAttention(dim, n_heads, chunk=chunk)
        self.LayerNorm_1 = LayerNorm(dim)
        self.MLP_0 = MLP(dim)

    def forward(self, x, *, mask=None, rng=None):
        h = self.SelfAttention_0(self.LayerNorm_0(x), mask=mask)
        x = x + dropout(h, self.dropout, rng)
        return x + dropout(self.MLP_0(self.LayerNorm_1(x)), self.dropout, rng)


class AdaLNTransformerBlock(nn.Module):
    """DiT-style block with AdaLN modulation from a conditioning vector and
    cross-attention to a context (the style denoiser's block)."""

    def __init__(self, dim: int, n_heads: int, ctx_dim: int | None = None):
        super().__init__()
        self.adaln_mod = Dense(dim, 9 * dim)
        self.SelfAttention_0 = SelfAttention(dim, n_heads)
        self.CrossAttention_0 = CrossAttention(dim, n_heads, ctx_dim)
        self.MLP_0 = MLP(dim)

    def forward(self, x, cond, *, ctx, ctx_mask=None):
        mod = self.adaln_mod(F.silu(cond))
        s1, b1, g1, s2, b2, g2, s3, b3, g3 = mod.chunk(9, dim=-1)
        h = self.SelfAttention_0(norm_ops.adaln(x, s1, b1))
        x = x + g1[:, None, :] * h
        h = self.CrossAttention_0(norm_ops.adaln(x, s3, b3), ctx,
                                  ctx_mask=ctx_mask)
        x = x + g3[:, None, :] * h
        h = self.MLP_0(norm_ops.adaln(x, s2, b2))
        return x + g2[:, None, :] * h


class ConvBlock(nn.Module):
    """Conv1d + LayerNorm + SiLU + dropout (text-encoder prenet style)."""

    def __init__(self, c_in: int, dim: int, kernel: int = 5,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.Conv_0 = Conv(c_in, dim, kernel)
        self.LayerNorm_0 = LayerNorm(dim)

    def forward(self, x, *, rng=None):
        return dropout(F.silu(self.LayerNorm_0(self.Conv_0(x))), self.dropout,
                       rng)


class AdaINResBlock(nn.Module):
    """Style-conditioned residual conv block of the mel decoder: two fused
    AdaIN -> SiLU -> conv passes (the hand-written kernel on the card).

    ``conv1``/``conv2`` keep the JAX raw-parameter layout (K, C, C).  The
    style projection's (B, T, 4C) output reaches the kernel as strided
    views (scale and shift of each pass at channel offsets 0, 2C, C, 3C),
    not copies.
    """

    def __init__(self, dim: int, style_dim: int, kernel: int = 5,
                 dilation: int = 1):
        super().__init__()
        self.dim, self.dilation = dim, dilation
        self.style_mod = Dense(style_dim, 4 * dim)
        self.conv1 = nn.Parameter(torch.empty(kernel, dim, dim))
        self.conv2 = nn.Parameter(torch.empty(kernel, dim, dim))

    def forward(self, x, style):
        """x: (B, T, C); style: (B, S) or (B, T, S) time-varying."""
        scale, shift = self.style_mod(F.silu(style)).split(2 * self.dim,
                                                          dim=-1)
        return dispatch.adain_conv_block(x, scale, shift, self.conv1,
                                         self.conv2, dilation=self.dilation,
                                         model=tp.model_axis(self, "conv1"))

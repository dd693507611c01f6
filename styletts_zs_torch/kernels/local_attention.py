"""Chunk-local attention: the CUDA kernels' wrappers and their plain versions.

Port of ``styletts_zs_tpu/kernels/attention_kernel.py::_local_attn_kernel``
(``local_attention_pallas``; row 1) and of its training kernels, the forward
that also saves each query's log-sum-exp (``_local_attn_fwd_lse_kernel``,
row 3) and the flash-style backward (``_local_attn_bwd_dq_kernel`` and
``_local_attn_bwd_dkv_kernel``, rows 4 and 5; ``local_attention_bwd_pallas``).
The kernels are ``csrc/local_attention.cu`` (rows 1 and 3) and
``csrc/local_attention_bwd.cu`` (rows 4 and 5).
The functions here take (B, T, H, D) q/k/v and (B,) int32 key lengths;
the forwards compute the Pallas kernel's function, at every T the XLA twin takes: the
queries of chunk i attend to the keys of the clipped window
[s0, s0 + W), W = min(3c, T), s0 = clip((i-1)c, 0, T-W), that lie in the
band [(i-1)c, (i+2)c) and below the length.  T > c must be a multiple of
c; T <= c is one chunk, full attention over the length (the twin's ``mha``
branch), which ``dispatch.local_attention`` sends to the full-attention
kernel on the card.  A query with no valid key averages its clipped window
uniformly (the Pallas kernel's behaviour; the XLA twin in
``ops.attention`` averages zero-padded neighbours instead — the decoder
zeroes such rows, so valid rows never depend on it).

The backward, from the cotangent g and delta = sum_d g * out (B, H, T),
recomputes p = exp(s - lse) with the saved lse (B, H, T) fp32: dq over each
query chunk's window, dk and dv over the query chunks j-1..j+1 of each key
chunk j, where only the length masks a key.  A query with no valid key has
lse = -1e30, so its p is 1 on every masked key (the Pallas function; its
cotangent is zero in the decoder).  p and dS are rounded to the input dtype
before their products, as in the Pallas kernels.  The bf16 kernels walk
only the tiles whose pairs can add anything: ``valid_key_tiles`` (rows 1,
3 and 4) and ``bwd_dkv_query_tiles`` (row 5) state which.
"""
from __future__ import annotations

import torch

from styletts_zs_torch.kernels import build, plain
from styletts_zs_torch.ops.attention import NEG_INF

# CUDA kernel launches, one added by each wrapper where it launches
launches = 0           # row 1, ``local_attention_cuda``
fwd_lse_launches = 0   # row 3, ``local_attention_fwd_lse_cuda``
bwd_dq_launches = 0    # row 4, ``local_attention_bwd_dq_cuda``
bwd_dkv_launches = 0   # row 5, ``local_attention_bwd_dkv_cuda``

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_tiling(T: int, chunk: int, tile: int) -> None:
    if chunk % tile or T % chunk or T < 2 * chunk:
        raise ValueError(f"the kernel takes chunk % {tile} == 0 and T a "
                         f"multiple of chunk, >= 2 chunks; got chunk={chunk} "
                         f"T={T}")


def valid_key_tiles(ci: int, T: int, chunk: int, length: int,
                    tile: int = 64) -> tuple[int, int, bool]:
    """The key tiles the bf16 kernels of rows 1, 3 and 4 walk for the
    queries of chunk ``ci``: (first key, number of tiles of ``tile`` keys,
    whether the chunk has a valid key).

    With a valid key, the tiles of [max(s0, band_lo), min(s0 + W, band_hi,
    length)): every key outside them is masked for every query of the chunk,
    so its probability is exactly 0 and skipping it is exact.  With none,
    every tile of the clipped window [s0, s0 + W), all at equal weight (the
    forward then needs no scores: P.V alone; row 4 takes p = exp(-1e30 -
    lse) = 1 on every key).  The kernel takes chunks that are multiples of
    the tile, so both ranges start and end on tile boundaries inside the
    window."""
    _check_tiling(T, chunk, tile)
    W = min(3 * chunk, T)
    s0 = max(0, min((ci - 1) * chunk, T - W))
    lo = max(s0, (ci - 1) * chunk)
    hi = min(s0 + W, (ci + 2) * chunk, length)
    if hi > lo:
        return lo, -(-(hi - lo) // tile), True
    return s0, W // tile, False


def bwd_dkv_query_tiles(k0: int, T: int, chunk: int, length: int,
                        tile: int = 64) -> list[tuple[int, str]]:
    """The query tiles row 5's bf16 kernel walks for the key tile of
    ``tile`` keys at ``k0``: (first query, mode) for each.

    The key tile lies in key chunk j; the kernel takes the query chunks
    j-1..j+1 inside [0, n), as the Pallas kernel does, and of each:
      - a chunk with a valid key (``valid_key_tiles``): every tile, "full"
        (scores, then p = exp(s - lse) with the keys past the length at
        -1e30), unless the key tile lies wholly at or past the length: then
        p = exp(-1e30 - lse) = 0 on every pair and the chunk is skipped;
      - a chunk without one (lse = -1e30 on its queries, and every key of
        the tile past the length): every tile, "ones" (p = exp(-1e30 - lse)
        = 1 on every pair, no scores needed).
    A key tile with no pair left has dk = dv = 0."""
    _check_tiling(T, chunk, tile)
    if k0 % tile or not 0 <= k0 < T:
        raise ValueError(f"k0={k0} is not the start of a key tile of T={T}")
    j = k0 // chunk
    walk = []
    for i in range(max(j - 1, 0), min(j + 2, T // chunk)):
        has_key = valid_key_tiles(i, T, chunk, length, tile)[2]
        if has_key and k0 >= length:
            continue
        walk += [(i * chunk + t, "full" if has_key else "ones")
                 for t in range(0, chunk, tile)]
    return walk


def _window(q, k, lengths, chunk: int):
    """fp32 logits of every query chunk over its clipped window, masked keys
    at ``NEG_INF``: (logits (B, n, H, c, W), window key indices (n, W))."""
    B, T, H, D = q.shape
    if T > chunk and T % chunk:        # the XLA twin raises there too
        raise ValueError(f"T={T} not a multiple of chunk={chunk}")
    W = min(3 * chunk, T)              # keys in a chunk's window
    chunk = min(chunk, T)              # T <= c: one chunk of T queries
    n = T // chunk
    ci = torch.arange(n, device=q.device)
    s0 = torch.clamp((ci - 1) * chunk, 0, T - W)
    key = s0[:, None] + torch.arange(W, device=q.device)           # (n, W)
    band = (key >= ((ci - 1) * chunk)[:, None]) & (key < ((ci + 2) * chunk)[:, None])
    valid = band[None] & (key[None] < lengths[:, None, None])       # (B, n, W)
    logits = torch.einsum("bnqhd,bnkhd->bnhqk",
                          q.reshape(B, n, chunk, H, D).float(),
                          k[:, key].float()) * D ** -0.5
    return logits.masked_fill(~valid[:, :, None, None, :], NEG_INF), key


def _attend(q, k, v, lengths, chunk: int):
    """(out, lse (B, H, T) fp32): the Pallas kernels' steps."""
    B, T, H, D = q.shape
    logits, key = _window(q, k, lengths, chunk)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    denom = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", (e / denom).to(v.dtype).float(),
                       v[:, key].float())
    lse = (m + torch.log(denom))[..., 0]                            # (B, n, H, c)
    return (out.reshape(B, T, H, D).to(q.dtype),
            lse.permute(0, 2, 1, 3).reshape(B, H, T))


def local_attention_plain(q, k, v, lengths, *, chunk: int) -> torch.Tensor:
    """Plain PyTorch version of row 1 (same function, fp32 softmax)."""
    plain.note("local_attention", q)
    return _attend(q, k, v, lengths, chunk)[0]


def local_attention_fwd_lse_plain(q, k, v, lengths, *, chunk: int):
    """Plain PyTorch version of row 3: (out, lse (B, H, T) fp32)."""
    plain.note("local_attention_fwd_lse", q)
    return _attend(q, k, v, lengths, chunk)


def _per_chunk(stat, n: int):
    """(B, H, T) statistics -> (B, n, H, c, 1), the logits' layout."""
    B, H, T = stat.shape
    return stat.reshape(B, H, n, T // n).permute(0, 2, 1, 3)[..., None]


def _bwd_dq_terms(q, k, v, g, lse, delta, lengths, chunk: int):
    """Row 4's p and dS (B, n, H, c, W), fp32, over each query chunk's
    clipped window, and the window key indices (n, W)."""
    B, T, H, D = q.shape
    logits, key = _window(q, k, lengths, chunk)
    n = logits.shape[1]
    p = torch.exp(logits - _per_chunk(lse, n))
    dp = torch.einsum("bnqhd,bnkhd->bnhqk",
                      g.reshape(B, n, T // n, H, D).float(), v[:, key].float())
    return p, p * (dp - _per_chunk(delta, n)), key


def local_attention_bwd_dq_plain(q, k, v, g, lse, delta, lengths, *,
                                 chunk: int) -> torch.Tensor:
    """Plain PyTorch version of row 4: dq over each query chunk's window."""
    plain.note("local_attention_bwd_dq", q)
    B, T, H, D = q.shape
    _, ds, key = _bwd_dq_terms(q, k, v, g, lse, delta, lengths, chunk)
    dq = torch.einsum("bnhqk,bnkhd->bnqhd", ds.to(q.dtype).float(),
                      k[:, key].float()) * D ** -0.5
    return dq.reshape(B, T, H, D).to(q.dtype)


def _bwd_dkv_terms(q, k, v, g, lse, delta, lengths, chunk: int):
    """Row 5's p and dS (B, n, H, 3c, c), fp32: key chunk j against its
    query chunks j-1..j+1 (zero where that chunk lies outside [0, n)), and
    the query indices (n, 3c) (clipped into [0, T))."""
    B, T, H, D = q.shape
    if T < 2 * chunk or T % chunk:
        raise ValueError(f"the backward takes T a multiple of chunk and at "
                         f"least 2 chunks, got T={T} chunk={chunk}")
    n = T // chunk
    dev = q.device
    iq = torch.arange(n, device=dev)[:, None] + torch.arange(-1, 2, device=dev)
    ok = ((iq >= 0) & (iq < n))[..., None].expand(n, 3, chunk).reshape(n, -1)
    qidx = (iq.clamp(0, n - 1)[..., None] * chunk
            + torch.arange(chunk, device=dev)).reshape(n, 3 * chunk)
    kj = k.reshape(B, n, chunk, H, D).float()
    vj = v.reshape(B, n, chunk, H, D).float()
    qw, gw = q[:, qidx].float(), g[:, qidx].float()           # (B, n, 3c, H, D)
    key_valid = torch.arange(T, device=dev).reshape(n, chunk)[None] \
        < lengths[:, None, None]                               # (B, n, c)
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qw, kj) * D ** -0.5
    s = s.masked_fill(~key_valid[:, :, None, None, :], NEG_INF)
    lse_w = lse[:, :, qidx].permute(0, 2, 1, 3)[..., None]     # (B, n, H, 3c, 1)
    delta_w = delta[:, :, qidx].permute(0, 2, 1, 3)[..., None]
    w = ok[None, :, None, :, None].float()
    p = torch.exp(s - lse_w) * w
    ds = p * (torch.einsum("bnqhd,bnkhd->bnhqk", gw, vj) - delta_w)
    return p, ds, qidx


def local_attention_bwd_dkv_plain(q, k, v, g, lse, delta, lengths, *,
                                  chunk: int):
    """Plain PyTorch version of row 5: (dk, dv), each key chunk j over the
    query chunks j-1..j+1 inside [0, n), keys masked by the length only."""
    plain.note("local_attention_bwd_dkv", q)
    B, T, H, D = q.shape
    p, ds, qidx = _bwd_dkv_terms(q, k, v, g, lse, delta, lengths, chunk)
    qw, gw = q[:, qidx].float(), g[:, qidx].float()
    dk = torch.einsum("bnhqk,bnqhd->bnkhd", ds.to(q.dtype).float(),
                      qw) * D ** -0.5
    dv = torch.einsum("bnhqk,bnqhd->bnkhd", p.to(q.dtype).float(), gw)
    return (dk.reshape(B, T, H, D).to(k.dtype),
            dv.reshape(B, T, H, D).to(v.dtype))


def _check_inputs(q, k, v, lengths, chunk: int, *more):
    B, T, H, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), *more):
        if not t.is_cuda or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name}: need a CUDA tensor like q, got "
                             f"{t.device} {t.dtype} {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dimension must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported")
    if D != 64 or chunk % 64 != 0 or T < 2 * chunk or T % chunk:
        raise ValueError(f"kernel takes D=64, chunk%64==0, T a multiple of "
                         f"chunk and >= 2 chunks; got D={D} chunk={chunk} "
                         f"T={T}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or \
            lengths.device != q.device:
        raise ValueError("lengths must be (B,) int32 on q's device")
    return lengths.contiguous()


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def local_attention_cuda(q, k, v, lengths, *, chunk: int) -> torch.Tensor:
    """Launch row 1 (``csrc/local_attention.cu``) on the current stream.

    q/k/v: (B, T, H, D) CUDA tensors of one dtype (fp32 or bf16), last
    dimension contiguous, any strides elsewhere; lengths (B,) int32.  The
    kernel takes D = 64, chunk % 64 == 0 and T >= 2c (a multiple of c), and
    raises on anything else.
    """
    global launches
    lengths = _check_inputs(q, k, v, lengths, chunk)
    B, T, H, D = q.shape
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    rc = build.library().lib.local_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, T, H, D, chunk,
        *_strides(q, k, v), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "local_attention_fwd")
    launches += 1
    return out


def local_attention_fwd_lse_cuda(q, k, v, lengths, *, chunk: int):
    """Launch row 3 (``csrc/local_attention.cu``, ``local_attention_fwd_lse``):
    row 1's output and each query's log-sum-exp, (out, lse (B, H, T) fp32).
    Takes what ``local_attention_cuda`` takes."""
    global fwd_lse_launches
    lengths = _check_inputs(q, k, v, lengths, chunk)
    B, T, H, D = q.shape
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    rc = build.library().lib.local_attention_fwd_lse(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, H, D, chunk,
        *_strides(q, k, v), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "local_attention_fwd_lse")
    fwd_lse_launches += 1
    return out, lse


def _check_bwd(q, k, v, g, lse, delta, lengths, chunk: int):
    lengths = _check_inputs(q, k, v, lengths, chunk, ("g", g))
    B, T, H, _ = q.shape
    for name, s in (("lse", lse), ("delta", delta)):
        if s.shape != (B, H, T) or s.dtype != torch.float32 or \
                s.device != q.device or not s.is_contiguous():
            raise ValueError(f"{name}: need contiguous (B, H, T) fp32 on q's "
                             f"device")
    if q.dtype == torch.bfloat16 and (any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v, g)) or lse.data_ptr() % 16 or
            delta.data_ptr() % 16):
        raise ValueError("bf16 needs 16-byte aligned q/k/v/g with strides in "
                         "multiples of 8, and 16-byte aligned lse and delta")
    return lengths


def local_attention_bwd_dq_cuda(q, k, v, g, lse, delta, lengths, *,
                                chunk: int) -> torch.Tensor:
    """Launch row 4 (``csrc/local_attention_bwd.cu``): dq, contiguous
    (B, T, H, D).  q/k/v/g as ``local_attention_cuda`` takes q/k/v (bf16:
    16-byte aligned, strides in multiples of 8); lse and delta contiguous
    (B, H, T) fp32.  Raises on anything else."""
    global bwd_dq_launches
    lengths = _check_bwd(q, k, v, g, lse, delta, lengths, chunk)
    B, T, H, D = q.shape
    dq = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    rc = build.library().lib.local_attention_bwd_dq(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
        dq.data_ptr(), B, T, H, D, chunk, *_strides(q, k, v, g), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "local_attention_bwd_dq")
    bwd_dq_launches += 1
    return dq


def local_attention_bwd_dkv_cuda(q, k, v, g, lse, delta, lengths, *,
                                 chunk: int):
    """Launch row 5 (``csrc/local_attention_bwd.cu``): (dk, dv), contiguous
    (B, T, H, D); takes what ``local_attention_bwd_dq_cuda`` takes."""
    global bwd_dkv_launches
    lengths = _check_bwd(q, k, v, g, lse, delta, lengths, chunk)
    B, T, H, D = q.shape
    dk = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    rc = build.library().lib.local_attention_bwd_dkv(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, H, D, chunk,
        *_strides(q, k, v, g), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "local_attention_bwd_dkv")
    bwd_dkv_launches += 1
    return dk, dv


class LocalAttention(torch.autograd.Function):
    """Chunk-local attention with the flash-style backward: row 3 forward,
    rows 4 and 5 backward.  ``fwd_lse``, ``bwd_dq`` and ``bwd_dkv`` are the
    kernels' wrappers or their plain versions (the caller picks by device);
    delta = sum_d g * out is a PyTorch reduction, as JAX leaves it to XLA
    (``attention_kernel.py:400``)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, chunk, fwd_lse, bwd_dq, bwd_dkv):
        out, lse = fwd_lse(q, k, v, lengths, chunk=chunk)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.chunk, ctx.bwd_dq, ctx.bwd_dkv = chunk, bwd_dq, bwd_dkv
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = ctx.bwd_dq(q, k, v, g, lse, delta, lengths, chunk=ctx.chunk)
        dk, dv = ctx.bwd_dkv(q, k, v, g, lse, delta, lengths, chunk=ctx.chunk)
        return dq, dk, dv, None, None, None, None, None

"""Chunk-local attention: the CUDA kernel's wrapper and its plain version.

Port of ``styletts_zs_tpu/kernels/attention_kernel.py::_local_attn_kernel``
(``local_attention_pallas``).  The kernel is ``csrc/local_attention.cu``.
Both functions here take (B, T, H, D) q/k/v and (B,) int32 key lengths and
compute the Pallas kernel's function, at every T the XLA twin takes: the
queries of chunk i attend to the keys of the clipped window
[s0, s0 + W), W = min(3c, T), s0 = clip((i-1)c, 0, T-W), that lie in the
band [(i-1)c, (i+2)c) and below the length.  T > c must be a multiple of
c; T <= c is one chunk, full attention over the length (the twin's ``mha``
branch), which ``dispatch.local_attention`` sends to the full-attention
kernel on the card.  A query with no valid key averages its clipped window
uniformly (the Pallas kernel's behaviour; the XLA twin in
``ops.attention`` averages zero-padded neighbours instead — the decoder
zeroes such rows, so valid rows never depend on it).
"""
from __future__ import annotations

import torch

from styletts_zs_torch.kernels import build, plain
from styletts_zs_torch.ops.attention import NEG_INF

launches = 0   # CUDA kernel launches; ``local_attention_cuda`` adds one each

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def local_attention_plain(q, k, v, lengths, *, chunk: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same function, fp32 softmax)."""
    plain.note("local_attention", q)
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
    kw = k[:, key].float()                                          # (B, n, W, H, D)
    vw = v[:, key]
    logits = torch.einsum("bnqhd,bnkhd->bnhqk",
                          q.reshape(B, n, chunk, H, D).float(), kw) * D ** -0.5
    logits = logits.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", probs.to(v.dtype).float(),
                       vw.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def local_attention_cuda(q, k, v, lengths, *, chunk: int) -> torch.Tensor:
    """Launch ``csrc/local_attention.cu`` on the current stream.

    q/k/v: (B, T, H, D) CUDA tensors of one dtype (fp32 or bf16), last
    dimension contiguous, any strides elsewhere; lengths (B,) int32.  The
    kernel takes D = 64, chunk % 64 == 0 and T >= 2c (a multiple of c), and
    raises on anything else.
    """
    global launches
    B, T, H, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
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
    lengths = lengths.contiguous()
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    lib = build.library().lib
    rc = lib.local_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, T, H, D, chunk,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "local_attention_fwd")
    launches += 1
    return out

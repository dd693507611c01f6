"""Full attention with a per-key mask: the CUDA kernel's wrapper and its
plain version.

Port of ``styletts_zs_tpu/kernels/attention_kernel.py::_full_attn_kernel``
(``full_attention_pallas``).  The kernel is ``csrc/full_attention.cu``.
Both functions here take (B, Tq, H, D) queries, (B, Tk, H, D) keys and
values and an optional (B, Tk) key mask, and compute the Pallas kernel's
function: fp32 logits q·kᵀ·D^-0.5, masked keys at ``NEG_INF`` (so a row
with no valid key averages all Tk keys), probabilities normalised with
max(sum, 1e-30) and rounded to v's dtype before P·V, an fp32 accumulate,
the output in q's dtype.  The mask need not be a length mask: the
denoiser's cross-attention keys are [text | padding | prompt].  The kernel
takes any Tq and Tk (its grid covers the queries, its loop walks the key
tiles), so unlike the Pallas kernel there is no shape gate.
"""
from __future__ import annotations

import torch

from styletts_zs_torch.kernels import build, plain
from styletts_zs_torch.ops import attention as attn_ops
from styletts_zs_torch.ops.attention import NEG_INF

launches = 0   # CUDA kernel launches; ``full_attention_cuda`` adds one each

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEMS_16B = {torch.float32: 4, torch.bfloat16: 8}   # elements in 16 bytes


def valid_key_tiles(mask_row, Tk: int, tile: int = 64) -> list[int]:
    """The key tiles (indices of ``tile`` keys) the kernel walks, fp32 and
    bf16 alike, for a batch row with key mask ``mask_row`` (Tk,) or None:
    the tiles that hold a valid key, whose probabilities alone are not
    exactly 0; or, when the row has no valid key, every tile, all keys at
    equal weight (the kernel then needs no scores: P.V alone)."""
    n = -(-Tk // tile)
    if mask_row is None:
        return list(range(n))
    has_key = torch.zeros(n * tile, dtype=torch.bool)
    has_key[:Tk] = mask_row.reshape(Tk).bool().cpu()
    tiles = torch.nonzero(has_key.reshape(n, tile).any(-1)).flatten()
    return tiles.tolist() or list(range(n))


def full_attention_plain(q, k, v, mask=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the Pallas kernel's steps)."""
    plain.note("full_attention", q)
    D = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    if mask is not None:
        logits = logits.masked_fill(~mask.bool()[:, None, None, :], NEG_INF)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def check_layout(name: str, t: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel's TMA can read ``t``'s rows: a
    contiguous last dimension, a 16-byte aligned pointer and (b, t, h)
    strides in multiples of 16 bytes (4 fp32 or 8 bf16 elements; the
    denoiser's fp32 views of its fused projections have row strides of
    1536 and 1024).  Reads the dtype, strides and address only, so it runs
    on any device."""
    elems = _ELEMS_16B.get(t.dtype)
    if elems is None:
        raise ValueError(f"{name}: dtype {t.dtype} not supported")
    sb, st, sh, sd = t.stride()
    if sd != 1:
        raise ValueError(f"{name}: last dimension must be contiguous")
    if t.data_ptr() % 16 or sb % elems or st % elems or sh % elems:
        raise ValueError(f"{name}: {str(t.dtype)[6:]} needs a 16-byte "
                         f"aligned pointer and strides in multiples of "
                         f"{elems}, got {t.stride()}")


def full_attention_cuda(q, k, v, mask=None) -> torch.Tensor:
    """Launch ``csrc/full_attention.cu`` on the current stream.

    q (B, Tq, H, D), k/v (B, Tk, H, D): CUDA tensors of one dtype (fp32 or
    bf16), last dimension contiguous, rows on 16 bytes (``check_layout``:
    the views of the model's fused projections are); mask (B, Tk) bool
    with a contiguous last dimension, or None.  The kernel takes D = 64 and
    raises on anything else.
    """
    global launches
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_layout(name, t)
        if not t.is_cuda or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: need a CUDA tensor like q, got "
                             f"{t.device} {t.dtype}")
    if k.shape != (B, Tk, H, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if D != 64:
        raise ValueError(f"the kernel takes D=64, got D={D}")
    m_ptr, m_sb = None, 0
    if mask is not None:
        if mask.shape != (B, Tk) or mask.dtype != torch.bool or \
                mask.device != q.device or mask.stride(-1) != 1:
            raise ValueError(f"mask must be (B, Tk) bool on q's device with "
                             f"a contiguous last dimension, got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        m_ptr, m_sb = mask.data_ptr(), mask.stride(0)
    out = torch.empty(B, Tq, H, D, dtype=q.dtype, device=q.device)
    lib = build.library().lib
    rc = lib.full_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), m_ptr,
        out.data_ptr(), B, Tq, Tk, H, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), m_sb,
        D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "full_attention_fwd")
    launches += 1
    return out


class FullAttention(torch.autograd.Function):
    """``fwd`` (the kernel's wrapper or its plain version) forward; the
    twin's gradient backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, fwd):
        ctx.save_for_backward(q, k, v, mask)
        return fwd(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = plain.twin_vjp(
            "full_attention",
            lambda q, k, v: attn_ops.cross_attention(q, k, v, kv_mask=mask),
            (q, k, v), g)
        return dq, dk, dv, None, None

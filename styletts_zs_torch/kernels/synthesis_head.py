"""Fused vocoder synthesis head: the CUDA kernel's wrapper and plain version.

Port of ``styletts_zs_tpu/kernels/vocoder_kernels.py::_synth_head_kernel``
(``synthesis_head_pallas``).  The kernel is ``csrc/synthesis_head.cu``.
Function: leaky_relu(0.1) -> K-tap SAME conv + bias, each rounded to the
compute dtype -> fp32 magnitude exp(clip(logmag, -12, 6)) and unit phase ->
centred iSTFT overlap-add (window n_fft, hop) normalised by the squared
window envelope.  x (B, T, C), w (K, C, 3*n_freq), b (3*n_freq,) ->
(B, (T-1)*hop) fp32.  ``SynthesisHead`` is the op's ``autograd.Function``:
the kernel forward, and the gradient of the twin's composition backward
(JAX has no backward kernel for it, ``dispatch.py:314-333``).
"""
from __future__ import annotations

import functools

import torch

from styletts_zs_torch.config import AudioConfig
from styletts_zs_torch.kernels import build, plain
from styletts_zs_torch.ops import conv as conv_ops
from styletts_zs_torch.ops import stft as stft_ops

launches = 0   # CUDA kernel launches; ``synthesis_head_cuda`` adds one each

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supported(*, n_fft: int, hop: int, K: int, dtype=None) -> bool:
    """The JAX package's geometry gate (``synthesis_head_supported``,
    ``vocoder_kernels.py:400``): the window spans at most P = 128//hop
    frames, K is odd, n_freq <= 64, and the dtype is fp32 or bf16.  Its
    channel rule (C % 128) is a TPU lane-layout limit and is not carried
    over."""
    if dtype is not None and dtype not in _DTYPES:
        return False
    P = max(1, 128 // hop)
    return (n_fft - 1) // hop + 1 <= P and K % 2 == 1 and n_fft // 2 + 1 <= 64


def head_composition(x, w, b, *, n_fft: int, hop: int) -> torch.Tensor:
    """The JAX twin's op composition (``dispatch._synthesis_head_xla``):
    leaky ReLU, the head conv + bias, the fp32 mag/phase epilogue and
    ``ops.stft.istft``."""
    n_freq = n_fft // 2 + 1
    h = torch.where(x >= 0, x, x * torch.tensor(0.1, dtype=x.dtype))
    head = conv_ops.conv1d(h, w.to(x.dtype)) + b.to(x.dtype)
    logmag, pc, ps = head.float().split(n_freq, dim=-1)
    mag = torch.exp(torch.clamp(logmag, -12.0, 6.0))
    norm = torch.rsqrt(pc * pc + ps * ps + 1e-7)
    cfg = AudioConfig(n_fft=n_fft, win_length=n_fft, hop_length=hop)
    return stft_ops.istft(mag * pc * norm, mag * ps * norm, cfg)


def synthesis_head_plain(x, w, b, *, n_fft: int, hop: int) -> torch.Tensor:
    """Plain PyTorch version: the twin's composition."""
    plain.note("synthesis_head", x)
    return head_composition(x, w, b, n_fft=n_fft, hop=hop)


@functools.lru_cache(maxsize=16)
def ola_constants(n_fft: int, hop: int, T: int, device: torch.device):
    """Synthesis basis and inverse envelope, built in numpy, on the card."""
    syn = stft_ops.istft_synthesis_basis(n_fft, n_fft)
    inv_env = stft_ops.istft_inverse_envelope(n_fft, hop, T)
    return (torch.as_tensor(syn, device=device),
            torch.as_tensor(inv_env, device=device))


# The bf16 kernel at the vocoder's geometry (``synth_head_sm90_kernel``):
# (C, K, n_fft, hop) and the output frames of one tile of its walk.
SM90_GEOMETRY = (128, 7, 48, 12)
SM90_TILE_FRAMES = 120


def takes_sm90(dtype, *, C: int, K: int, n_fft: int, hop: int,
               T: int) -> bool:
    """Whether the bf16 sm90 kernel computes this head (frames a multiple
    of 8, so the (B, C, T)-major view's rows are 16-byte aligned)."""
    return (dtype == torch.bfloat16 and (C, K, n_fft, hop) == SM90_GEOMETRY
            and T % 8 == 0)


def sm90_walk(B: int, T: int, n_sm: int) -> tuple[int, int, int]:
    """(tiles_per_row, n_tiles, grid) of the sm90 kernel's persistent walk:
    tiles of ``SM90_TILE_FRAMES`` output frames covering frames 0 .. T of
    each batch row (frame T still adds to the last samples), tile ``i`` on
    block ``i % grid``, one block an SM."""
    tiles_per_row = T // SM90_TILE_FRAMES + 1
    n_tiles = B * tiles_per_row
    return tiles_per_row, n_tiles, min(n_tiles, n_sm)


def synthesis_head_cuda(x, w, b, *, n_fft: int, hop: int) -> torch.Tensor:
    """Launch ``csrc/synthesis_head.cu`` on the current stream.

    x: (B, T, C) CUDA tensor, fp32 or bf16; w and b are cast to x's dtype
    (the production model already holds them in it).  At the vocoder's
    geometry in bf16 the kernel reads x with frames contiguous (the (B, C,
    T)-major view the vocoder's convs hand over) in place; another layout
    is copied into it.  Other shapes take x contiguous (B, T, C).
    """
    global launches
    B, T, C = x.shape
    K = w.shape[0]
    n_freq = n_fft // 2 + 1
    if not x.is_cuda or x.dtype not in _DTYPES:
        raise ValueError(f"x: need an fp32/bf16 CUDA tensor, got {x.device} "
                         f"{x.dtype}")
    if w.shape != (K, C, 3 * n_freq) or b.shape != (3 * n_freq,):
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not "
                         f"fit C={C}, n_fft={n_fft}")
    if not supported(n_fft=n_fft, hop=hop, K=K) or T < 2:
        raise ValueError(f"shape outside the kernel's gate: n_fft={n_fft} "
                         f"hop={hop} K={K} T={T}")
    walk = (0, 0, 0)
    if takes_sm90(x.dtype, C=C, K=K, n_fft=n_fft, hop=hop, T=T):
        sb, st, sc = x.stride()
        if st != 1 or sc % 8 or (B > 1 and sb % 8) or x.data_ptr() % 16:
            x = x.transpose(1, 2).contiguous().transpose(1, 2)
        walk = sm90_walk(B, T, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
    else:
        x = x.contiguous()
    wt = w.to(device=x.device, dtype=x.dtype).contiguous()
    bt = b.to(device=x.device, dtype=x.dtype).contiguous()
    syn, inv_env = ola_constants(n_fft, hop, T, x.device)
    out = torch.empty(B, (T - 1) * hop, dtype=torch.float32, device=x.device)
    lib = build.library().lib
    rc = lib.synthesis_head_fwd(
        _DTYPES[x.dtype], x.data_ptr(), wt.data_ptr(), bt.data_ptr(),
        syn.data_ptr(), inv_env.data_ptr(), out.data_ptr(),
        B, T, C, K, n_fft, hop, *x.stride(), *walk,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "synthesis_head_fwd")
    launches += 1
    return out


class SynthesisHead(torch.autograd.Function):
    """``fwd`` (the kernel's wrapper or its plain version) forward; the
    twin's gradient backward."""

    @staticmethod
    def forward(ctx, x, w, b, n_fft, hop, fwd):
        ctx.save_for_backward(x, w, b)
        ctx.n_fft, ctx.hop = n_fft, hop
        return fwd(x, w, b, n_fft=n_fft, hop=hop)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        dx, dw, db = plain.twin_vjp(
            "synthesis_head",
            lambda x, w, b: head_composition(x, w, b, n_fft=ctx.n_fft,
                                             hop=ctx.hop),
            (x, w, b), g)
        return dx, dw, db, None, None, None

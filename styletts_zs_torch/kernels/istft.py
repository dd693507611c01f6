"""Standalone centred iSTFT overlap-add: the CUDA kernel's wrapper and its
plain version.

Port of ``styletts_zs_tpu/kernels/vocoder_kernels.py::_istft_sf_kernel``
(``istft_pallas``).  The kernel is ``csrc/istft.cu``.  Function: real and
imag (B, F, n_freq), cast to fp32 -> the windowed inverse DFT of each frame
(periodic Hann window of n_fft), overlap-added ``hop`` apart, times the
inverse squared-window envelope, trimmed from n_fft//2: (B, (F-1)*hop)
fp32.  No model path launches it, in JAX or here: its one entry point is
``dispatch.istft_head``; the synthesis head's twin calls ``ops.stft.istft``
directly, as JAX's calls ``istft_head(use_pallas=False)``.  ``ISTFT`` is the
op's ``autograd.Function``: the kernel forward, and the twin's gradient
backward (JAX's ``dispatch._istft_ad``).  ``istft_pallas``'s fallback for
windows wider than one TPU super-frame is not carried over: the kernel
takes every n_fft and hop whose frames fit in shared memory
(``launch_geometry``) and the wrapper raises for the rest.
"""
from __future__ import annotations

import torch

from styletts_zs_torch.config import AudioConfig
from styletts_zs_torch.kernels import build, plain
from styletts_zs_torch.kernels.synthesis_head import ola_constants
from styletts_zs_torch.ops import stft as stft_ops

launches = 0   # CUDA kernel launches; ``istft_cuda`` adds one each

_SMEM_BYTES = 227 * 1024   # shared memory one block may use on the card
_FRAMES = 64               # frames of output samples per block


def launch_geometry(n_fft: int, hop: int) -> tuple[int, bool]:
    """(frames per block, basis in shared memory) of a launch.  A block
    holds the spectra of its frames and of the M - 1 frames before them
    (M = ceil(n_fft / hop)), and the (2 n_freq, n_fft) basis when that
    takes at most half the budget; ValueError when one frame cannot fit."""
    if n_fft < 2 or hop < 1:
        raise ValueError(f"n_fft {n_fft}, hop {hop}")
    row = 4 * 2 * (n_fft // 2 + 1)
    M = (n_fft - 1) // hop + 1
    syn_shared = row * n_fft <= _SMEM_BYTES // 2
    budget = _SMEM_BYTES - (row * n_fft if syn_shared else 0)
    FT = min(_FRAMES, budget // row - (M - 1))
    if FT < 1:
        raise ValueError(f"n_fft {n_fft}, hop {hop}: the {M} frames that "
                         f"overlap one sample do not fit in shared memory")
    return FT, syn_shared


def istft_twin(real, imag, *, n_fft: int, hop: int) -> torch.Tensor:
    """The twin: ``ops.stft.istft`` with the window n_fft."""
    cfg = AudioConfig(n_fft=n_fft, win_length=n_fft, hop_length=hop)
    return stft_ops.istft(real, imag, cfg)


def istft_plain(real, imag, *, n_fft: int, hop: int) -> torch.Tensor:
    """Plain PyTorch version: the twin."""
    plain.note("istft", real)
    return istft_twin(real, imag, n_fft=n_fft, hop=hop)


def istft_cuda(real, imag, *, n_fft: int, hop: int) -> torch.Tensor:
    """Launch ``csrc/istft.cu`` on the current stream.  real, imag: CUDA
    tensors (B, F, n_fft//2 + 1) of any float dtype, read as fp32."""
    global launches
    if not (real.is_cuda and imag.is_cuda):
        raise ValueError(f"need CUDA tensors, got {real.device} / "
                         f"{imag.device}")
    if real.shape != imag.shape or real.dim() != 3 or \
            real.shape[-1] != n_fft // 2 + 1 or real.shape[1] < 2:
        raise ValueError(f"real {tuple(real.shape)} / imag "
                         f"{tuple(imag.shape)}: need (B, F >= 2, "
                         f"{n_fft // 2 + 1}) each")
    FT, syn_shared = launch_geometry(n_fft, hop)
    B, F, _ = real.shape
    re = real.float().contiguous()
    im = imag.float().contiguous()
    syn, inv_env = ola_constants(n_fft, hop, F, real.device)
    out = torch.empty(B, (F - 1) * hop, dtype=torch.float32,
                      device=real.device)
    rc = build.library().lib.istft_fwd(
        re.data_ptr(), im.data_ptr(), syn.data_ptr(), inv_env.data_ptr(),
        out.data_ptr(), B, F, n_fft, hop, FT, int(syn_shared),
        torch.cuda.current_stream(real.device).cuda_stream)
    build.check(rc, "istft_fwd")
    launches += 1
    return out


class ISTFT(torch.autograd.Function):
    """``fwd`` (the kernel's wrapper or its plain version) forward; the
    twin's gradient backward."""

    @staticmethod
    def forward(ctx, real, imag, n_fft, hop, fwd):
        ctx.save_for_backward(real, imag)
        ctx.n_fft, ctx.hop = n_fft, hop
        return fwd(real, imag, n_fft=n_fft, hop=hop)

    @staticmethod
    def backward(ctx, g):
        real, imag = ctx.saved_tensors
        d_real, d_imag = plain.twin_vjp(
            "istft",
            lambda r, i: istft_twin(r, i, n_fft=ctx.n_fft, hop=ctx.hop),
            (real, imag), g)
        return d_real, d_imag, None, None, None

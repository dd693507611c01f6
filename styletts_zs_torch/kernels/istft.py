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
backward (JAX's ``dispatch._istft_ad``).  Two kernels: ``istft_sm90_kernel``
(n_fft in ``SM90_N_FFT``, any hop, spectra on 16 bytes: ``takes_sm90``) runs
the inverse DFT on the tensor cores in 3xTF32 and reads the envelope from a
table of one period and its edges (``envelope_table``); ``istft_kernel``
takes every other n_fft and hop whose frames fit in shared memory
(``launch_geometry``), and the wrapper raises for the rest.
``istft_pallas``'s fallback for windows wider than one TPU super-frame is
not carried over.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from styletts_zs_torch.config import AudioConfig
from styletts_zs_torch.kernels import build, plain
from styletts_zs_torch.kernels.synthesis_head import ola_constants
from styletts_zs_torch.ops import stft as stft_ops

launches = 0   # CUDA kernel launches; ``istft_cuda`` adds one each

_SMEM_BYTES = 227 * 1024   # shared memory one block may use on the card
_FRAMES = 64               # frames of output samples per block

# The windows the sm90 kernel is built for: wgmma.m64n{n_fft}k8 per window,
# with n_fft / 2 accumulators a thread.  The vocoder head's is 48.
SM90_N_FFT = (16, 32, 48, 64)
# Its ring of 96 frame rows holds a tile's 64 frames and the M - 1 before
# them that its first samples sum (M = ceil(n_fft / hop)).
SM90_MAX_M = 33


def takes_sm90(n_fft: int, hop: int) -> bool:
    """Whether ``istft_sm90_kernel`` computes this geometry: its windows, and
    M <= ``SM90_MAX_M`` (every hop but 1 at n_fft 48 and 64).  Its shared
    memory does not depend on hop: the envelope table holds fewer than
    2 n_fft values."""
    return (n_fft in SM90_N_FFT and hop >= 1
            and (n_fft - 1) // hop + 1 <= SM90_MAX_M)


def sm90_slots(n_fft: int, hop: int, F: int) -> tuple[int, int]:
    """(s_lo, S): the sm90 kernel's output slots of a row are frames s_lo ..
    s_lo + S - 1, slot f the hop samples that frame f starts, those of the
    trimmed output (samples n_fft//2 .. n_fft//2 + (F-1)*hop - 1)."""
    s_lo = (n_fft // 2) // hop
    return s_lo, (n_fft // 2 + (F - 1) * hop - 1) // hop - s_lo + 1


def envelope_table(n_fft: int, hop: int, F: int) -> tuple[np.ndarray, int]:
    """(table, Fc): the inverse envelope of Fc = min(F, M) frames (M =
    ceil(n_fft / hop)), which holds every value of F frames' envelope.
    ``istft_inverse_envelope`` adds to each sample the squared-window values
    of the frames that cover it, in the order of the frames' offsets, so a
    sample whose slot f (its s // hop) lies among frames M-1 .. F-1 sums the
    same M values in the same order as slot M-1: the kernel reads sample s
    = f hop + phi at ``table[j hop + phi]``, j = min(f, M-1) for f < F and
    f - F + Fc beyond (phi < n_fft; no frame reaches the others)."""
    M = (n_fft - 1) // hop + 1
    Fc = min(F, M)
    return stft_ops.istft_inverse_envelope(n_fft, hop, Fc), Fc


@functools.lru_cache(maxsize=64)
def sm90_constants(n_fft: int, hop: int, Fc: int, device: torch.device):
    """The synthesis basis and the envelope table of Fc frames, on the
    card."""
    syn = stft_ops.istft_synthesis_basis(n_fft, n_fft)
    return (torch.as_tensor(syn, device=device),
            torch.as_tensor(envelope_table(n_fft, hop, Fc)[0], device=device))


@functools.lru_cache(maxsize=None)
def sm90_grid(n_fft: int, device: torch.device) -> int:
    """The sm90 kernel's persistent blocks: as many as fit on the card."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    build.check(build.library().lib.istft_sm90_occupancy(
        n_fft, ctypes.byref(blocks), ctypes.byref(smem)),
        "istft_sm90_occupancy")
    props = torch.cuda.get_device_properties(device)
    return blocks.value * props.multi_processor_count


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
    """Launch ``csrc/istft.cu`` on the current stream: the sm90 kernel where
    it takes the geometry and the spectra start on 16 bytes, else the
    generic one.  real, imag: CUDA tensors (B, F, n_fft//2 + 1) of any
    float dtype, read as fp32."""
    global launches
    if not (real.is_cuda and imag.is_cuda):
        raise ValueError(f"need CUDA tensors, got {real.device} / "
                         f"{imag.device}")
    if real.shape != imag.shape or real.dim() != 3 or \
            real.shape[-1] != n_fft // 2 + 1 or real.shape[1] < 2:
        raise ValueError(f"real {tuple(real.shape)} / imag "
                         f"{tuple(imag.shape)}: need (B, F >= 2, "
                         f"{n_fft // 2 + 1}) each")
    B, F, _ = real.shape
    re = real.float().contiguous()
    im = imag.float().contiguous()
    out = torch.empty(B, (F - 1) * hop, dtype=torch.float32,
                      device=real.device)
    stream = torch.cuda.current_stream(real.device).cuda_stream
    lib = build.library().lib
    if takes_sm90(n_fft, hop) and re.data_ptr() % 16 == 0 and \
            im.data_ptr() % 16 == 0:
        Fc = envelope_table(n_fft, hop, F)[1]
        syn, table = sm90_constants(n_fft, hop, Fc, real.device)
        grid = min(sm90_grid(n_fft, real.device),
                   B * sm90_slots(n_fft, hop, F)[1])
        rc = lib.istft_sm90_fwd(
            re.data_ptr(), im.data_ptr(), syn.data_ptr(), table.data_ptr(),
            out.data_ptr(), B, F, n_fft, hop, Fc, grid, stream)
        build.check(rc, "istft_sm90_fwd")
    else:
        FT, syn_shared = launch_geometry(n_fft, hop)
        syn, inv_env = ola_constants(n_fft, hop, F, real.device)
        rc = lib.istft_fwd(
            re.data_ptr(), im.data_ptr(), syn.data_ptr(), inv_env.data_ptr(),
            out.data_ptr(), B, F, n_fft, hop, FT, int(syn_shared), stream)
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

"""Fused AdaIN -> SiLU -> dilated conv: the CUDA kernels' wrappers, their
plain versions and the decoder block built from two passes, with its
backward.

Port of ``styletts_zs_tpu/kernels/decoder_kernels.py::_mod_conv_kernel``
(``_mod_conv_pass``, ``adain_conv_block_pallas``; row 6, kernel
``csrc/adain_conv.cu``) and of ``_bwd_data_kernel`` (``_bwd_data_mod_pass``
in ``adain_conv_block_bwd_pallas``; row 7, kernel
``csrc/adain_conv_bwd.cu``).  One pass, for x (B, T, C), scale/shift (B, T, C)
or (B, C), the instance statistics mean/rstd (B, C) of x and a weight
(K, C, C_out) in the JAX layout:

    h = silu((x - mean) * rstd * (1 + scale) + shift)   in fp32, rounded
        once to x's dtype (the Pallas kernel's rounding);
    y = SAME conv of h with the weight, dilation d     fp32 sums, x's dtype.

The block is pass 1 with dilation d, the statistics of its output, pass 2
with dilation 1, then ``(x + h2) / sqrt(2)`` in fp32 rounded to x's dtype
(h2 is rounded to x's dtype first, as JAX's block rounds it).  The
statistics are fp32 ``torch.var_mean`` over T, as JAX takes them in XLA
outside the Pallas kernel (``_instance_stats``).

Backward of a pass (row 7 and the PyTorch steps around it, which JAX keeps
in XLA, ``decoder_kernels.py:292-313``): from the cotangent dc of its conv
output, dh = conv_bwd_data(dc, w) * silu'(u), u = (x - mean) * rstd *
(1 + scale) + shift recomputed from the saved statistics (row 7); then the
instance-norm backward gives dx, dscale, dshift (``_norm_bwd``) and the
weight gradient is K fp32 products of the SiLU output with dc
(``_conv_wgrad``).  ``AdaINConvBlock`` is the block's
``torch.autograd.Function``: row 6's two passes forward, saving
(x, scale, shift, k1, k2, h, mean_x, rstd_x, mean_h, rstd_h), and that
backward, as ``adain_conv_block_fwd_pallas``/``_bwd_pallas`` pair them.

Tensor parallelism (``model``, a ``parallel.tensor.ModelAxis``): the
kernels hold this rank's chunk of the output channels.  Each pass then
gives this rank's channels of h and of h2, gathered before what reads them
whole (pass 2's statistics, the residual).  Backward, row 7 takes this
rank's channels of dc and gives a partial dh over all input channels,
which is summed over the model ranks before the norm's backward; the
weight gradients are this rank's chunks, the input and style gradients
whole and equal on every rank.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from styletts_zs_torch.kernels import build, plain

# CUDA kernel launches, one added by each wrapper where it launches
launches = 0             # row 6, ``adain_conv_pass_cuda``
bwd_data_launches = 0    # row 7, ``adain_conv_bwd_data_cuda``

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def instance_stats(x: torch.Tensor, eps: float = 1e-5):
    """fp32 (mean, rstd) over the time axis, each (B, C)."""
    var, mean = torch.var_mean(x.float(), dim=1, unbiased=False)
    return mean, torch.rsqrt(var + eps)


def shifted(h: torch.Tensor, s: int) -> torch.Tensor:
    """g[:, t] = h[:, t + s] along the time axis, zeros outside [0, T)."""
    T = h.shape[1]
    if s == 0:
        return h
    if abs(s) >= T:
        return torch.zeros_like(h)
    if s > 0:
        return F.pad(h[:, s:], (0, 0, 0, s))
    return F.pad(h[:, :T + s], (0, 0, -s, 0))


def adain_conv_pass_plain(x, scale, shift, mean, rstd, w, *,
                          dilation: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the modulation, then the conv
    written out as K shifted products, summed in fp32."""
    plain.note("adain_conv", x)
    if scale.ndim == 2:
        scale, shift = scale[:, None], shift[:, None]
    h = ((x.float() - mean[:, None]) * rstd[:, None] * (1.0 + scale.float())
         + shift.float())
    h = F.silu(h).to(x.dtype).float()
    K = w.shape[0]
    halo = (K - 1) * dilation // 2
    wf = w.to(x.dtype).float()
    y = sum(shifted(h, k * dilation - halo) @ wf[k] for k in range(K))
    return y.to(x.dtype)


def _rows_aligned(t: torch.Tensor) -> bool:
    """16-byte aligned rows: the bf16 kernel's vector loads."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1])


def _check_pass(x, scale, shift, mean, rstd, w, dilation: int) -> None:
    """Raise on what the pass kernels (rows 6 and 7) do not take."""
    B, T, C = x.shape
    K, _, C_out = w.shape
    if not x.is_cuda or x.dtype not in _DTYPES:
        raise ValueError(f"x: need an fp32/bf16 CUDA tensor, got {x.device} "
                         f"{x.dtype}")
    for name, s in (("scale", scale), ("shift", shift)):
        if s.dtype != x.dtype or s.device != x.device or \
                s.shape not in ((B, T, C), (B, C)) or s.stride(-1) != 1:
            raise ValueError(f"{name}: need (B, T, C) or (B, C) like x with "
                             f"a contiguous channel dimension, got {s.dtype} "
                             f"{tuple(s.shape)} strides {s.stride()}")
    if x.stride(-1) != 1:
        raise ValueError("x: the channel dimension must be contiguous")
    if x.dtype == torch.bfloat16 and not (
            all(_rows_aligned(t) for t in (x, scale, shift))
            and C % 8 == 0 and C_out % 8 == 0):
        raise ValueError("bf16 needs 16-byte aligned rows and C, C_out "
                         "multiples of 8")
    if w.shape != (K, C, C_out) or K % 2 != 1 or (K - 1) * dilation % 2:
        raise ValueError(f"w {tuple(w.shape)}: need (K, C, C_out) with K odd "
                         f"and (K-1)*dilation even, dilation {dilation}")
    for name, s in (("mean", mean), ("rstd", rstd)):
        if s.shape != (B, C) or s.dtype != torch.float32 or \
                s.device != x.device:
            raise ValueError(f"{name}: need (B, C) fp32 on x's device")


# The bf16 kernel (``adain_conv_sm90_kernel``): a block owns SM90_FRAMES
# frames x SM90_CHANNELS output channels of one batch row (SM90_NARROW
# where C_out is not a multiple of SM90_CHANNELS: a tensor-parallel shard
# of 128) and walks the input channels SM90_CK at a time over a window of
# SM90_FRAMES + 2 halo frames, for the decoder's SM90_K taps and a halo of
# at most SM90_MAX_HALO frames.  Row 7's kernel owns SM90_CHANNELS input
# channels a block.
SM90_FRAMES, SM90_CHANNELS, SM90_NARROW, SM90_CK = 128, 256, 128, 16
SM90_K, SM90_MAX_HALO = 5, 18


def frame_tiles(T: int, K: int, dilation: int) -> list[tuple[int, int, int]]:
    """The bf16 kernel's frame tiles along T (its grid's x): for each, the
    first output frame, the first window frame and the window's frames."""
    halo = (K - 1) * dilation // 2
    return [(t0, t0 - halo, SM90_FRAMES + 2 * halo)
            for t0 in range(0, T, SM90_FRAMES)]


def sm90_tile(C_out: int) -> int:
    """The output channels a block of the bf16 kernel owns at C_out."""
    return SM90_CHANNELS if C_out % SM90_CHANNELS == 0 else SM90_NARROW


def _check_sm90(scale, shift, w, dilation: int) -> None:
    """Raise on a bf16 pass the kernel does not take."""
    K, C, C_out = w.shape
    if K != SM90_K or (K - 1) * dilation // 2 > SM90_MAX_HALO or \
            C % SM90_CK or C_out % SM90_NARROW or scale.ndim != shift.ndim:
        raise ValueError(
            f"bf16 needs K {SM90_K}, a halo of at most "
            f"{SM90_MAX_HALO} frames, C % {SM90_CK} == 0, C_out % "
            f"{SM90_NARROW} == 0 and scale, shift both per-frame or both "
            f"global; got w {tuple(w.shape)}, dilation {dilation}, "
            f"scale {tuple(scale.shape)}, shift {tuple(shift.shape)}")


def _check_sm90_bwd(scale, shift, w, dilation: int) -> None:
    """Raise on a bf16 pass whose backward-data row 7's kernel
    (``adain_bwd_data_sm90_kernel``) does not take: a block owns
    SM90_FRAMES frames x SM90_CHANNELS input channels c and walks the
    output channels o SM90_CK at a time, for the decoder's SM90_K taps and
    a halo of at most SM90_MAX_HALO frames."""
    K, C, C_out = w.shape
    if K != SM90_K or (K - 1) * dilation // 2 > SM90_MAX_HALO or \
            C_out % SM90_CK or C % SM90_CHANNELS or scale.ndim != shift.ndim:
        raise ValueError(
            f"bf16 backward-data needs K {SM90_K}, a halo of at most "
            f"{SM90_MAX_HALO} frames, C_out % {SM90_CK} == 0, C % "
            f"{SM90_CHANNELS} == 0 and scale, shift both per-frame or both "
            f"global; got w {tuple(w.shape)}, dilation {dilation}, "
            f"scale {tuple(scale.shape)}, shift {tuple(shift.shape)}")


def _bt_strides(s):
    """(b, t) strides of a (B, T, C) tensor or a (B, C) one (t stride 0)."""
    return s.stride(0), (s.stride(1) if s.ndim == 3 else 0)


def adain_conv_pass_cuda(x, scale, shift, mean, rstd, w, *,
                         dilation: int) -> torch.Tensor:
    """Launch ``csrc/adain_conv.cu`` on the current stream.

    x (B, T, C) and scale/shift (B, T, C) or (B, C): CUDA tensors of one
    dtype (fp32 or bf16) with a contiguous channel dimension and any other
    strides, so the scale/shift views of the decoder's style projection go
    in without a copy (bf16: 16-byte aligned rows, and ``_check_sm90``'s
    shapes); mean/rstd (B, C) fp32; w (K, C, C_out), cast to x's dtype.  K
    odd and (K-1)*dilation even.  Raises on anything else.
    """
    global launches
    B, T, C = x.shape
    K, _, C_out = w.shape
    _check_pass(x, scale, shift, mean, rstd, w, dilation)
    if x.dtype == torch.bfloat16:
        _check_sm90(scale, shift, w, dilation)
    mean, rstd = mean.contiguous(), rstd.contiguous()
    wt = w.to(x.dtype).contiguous()
    out = torch.empty(B, T, C_out, dtype=x.dtype, device=x.device)
    rc = build.library().lib.adain_conv_fwd(
        _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), wt.data_ptr(), out.data_ptr(),
        B, T, C, C_out, K, dilation, *_bt_strides(x), *_bt_strides(scale),
        *_bt_strides(shift), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "adain_conv_fwd")
    launches += 1
    return out


def _block_forward(x, scale, shift, kernel1, kernel2, *, dilation: int,
                   conv_pass, model=None):
    """(y, residuals): the block and what its backward needs; with
    ``model``, each pass's channel slices gathered."""
    C = x.shape[-1]
    whole = (lambda y: y) if model is None else model.gather
    mean_x, rstd_x = instance_stats(x)
    h = whole(conv_pass(x, scale[..., :C], shift[..., :C], mean_x, rstd_x,
                        kernel1, dilation=dilation))
    mean_h, rstd_h = instance_stats(h)
    h2 = whole(conv_pass(h, scale[..., C:], shift[..., C:], mean_h, rstd_h,
                         kernel2, dilation=1))
    y = ((x.float() + h2.float()) * np.float32(1.0 / np.sqrt(2.0))).to(x.dtype)
    return y, (x, scale, shift, kernel1, kernel2, h, mean_x, rstd_x, mean_h,
               rstd_h)


def adain_conv_block(x, scale, shift, kernel1, kernel2, *, dilation: int,
                     conv_pass, model=None) -> torch.Tensor:
    """(x + pass2(pass1(x))) / sqrt(2); ``conv_pass`` is the kernel's
    wrapper or its plain version.  scale/shift are (B, T, 2C) or (B, 2C):
    channels [0, C) for pass 1, [C, 2C) for pass 2, taken as views.
    ``model``: the kernels are this rank's output chunks."""
    return _block_forward(x, scale, shift, kernel1, kernel2,
                          dilation=dilation, conv_pass=conv_pass,
                          model=model)[0]


# ---------------------------------------------------------------------------
# backward (row 7 and the steps JAX keeps in XLA)
# ---------------------------------------------------------------------------

def _dsilu(x, scale, shift, mean, rstd):
    """silu'(u) of the pass's pre-activation u, fp32 (Pallas's steps)."""
    if scale.ndim == 2:
        scale, shift = scale[:, None], shift[:, None]
    u = ((x.float() - mean[:, None]) * rstd[:, None] * (1.0 + scale.float())
         + shift.float())
    sig = torch.sigmoid(u)
    return sig * (1.0 + u * (1.0 - sig))


def adain_conv_bwd_data_plain(dc, x, scale, shift, mean, rstd, w, *,
                              dilation: int) -> torch.Tensor:
    """Plain PyTorch version of row 7: the conv's backward-data over the
    flipped, transposed taps as K shifted products summed in fp32, times
    silu'(u), in dc's dtype."""
    plain.note("adain_conv_bwd_data", dc)
    K = w.shape[0]
    halo = (K - 1) * dilation // 2
    wb = w.to(dc.dtype).flip(0).transpose(1, 2).float()     # (K, C_out, C)
    dcf = dc.float()
    da = sum(shifted(dcf, k * dilation - halo) @ wb[k] for k in range(K))
    return (da * _dsilu(x, scale, shift, mean, rstd)).to(dc.dtype)


def adain_conv_bwd_data_cuda(dc, x, scale, shift, mean, rstd, w, *,
                             dilation: int) -> torch.Tensor:
    """Launch row 7 (``csrc/adain_conv_bwd.cu``) on the current stream.

    dc (B, T, C_out), made contiguous; x, scale, shift, mean, rstd and w as
    ``adain_conv_pass_cuda`` takes them (w (K, C, C_out) read flipped in
    place; bf16: ``_check_sm90_bwd``'s shapes).  Returns dh (B, T, C) in
    dc's dtype.  Raises on anything the kernel does not take.
    """
    global bwd_data_launches
    B, T, C = x.shape
    K, _, C_out = w.shape
    _check_pass(x, scale, shift, mean, rstd, w, dilation)
    if x.dtype == torch.bfloat16:
        _check_sm90_bwd(scale, shift, w, dilation)
    dc = dc.contiguous()
    if dc.shape != (B, T, C_out) or dc.dtype != x.dtype or \
            dc.device != x.device:
        raise ValueError(f"dc: need (B, T, C_out) like x, got {dc.dtype} "
                         f"{tuple(dc.shape)}")
    if dc.dtype == torch.bfloat16 and dc.data_ptr() % 16:
        raise ValueError("bf16 dc must be 16-byte aligned")
    mean, rstd = mean.contiguous(), rstd.contiguous()
    wt = w.to(x.dtype).contiguous()
    out = torch.empty(B, T, C, dtype=x.dtype, device=x.device)
    rc = build.library().lib.adain_conv_bwd_data(
        _DTYPES[x.dtype], dc.data_ptr(), x.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), mean.data_ptr(), rstd.data_ptr(), wt.data_ptr(),
        out.data_ptr(), B, T, C, C_out, K, dilation, *_bt_strides(x),
        *_bt_strides(scale), *_bt_strides(shift),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "adain_conv_bwd_data")
    bwd_data_launches += 1
    return out


def _norm_bwd(dh, x, s, mean, rstd):
    """Instance norm + modulation backward: (dx, dscale, dshift, n), fp32."""
    if s.ndim == 2:
        s = s[:, None]
    n = (x.float() - mean[:, None]) * rstd[:, None]
    dhf = dh.float()
    dn = dhf * (1.0 + s.float())
    m1 = dn.mean(dim=1, keepdim=True)
    m2 = (dn * n).mean(dim=1, keepdim=True)
    return rstd[:, None] * (dn - m1 - n * m2), dhf * n, dhf, n


def _silu_act(n, s, b):
    """The pass's SiLU output from the normalised input, fp32."""
    if s.ndim == 2:
        s, b = s[:, None], b[:, None]
    u = n * (1.0 + s.float()) + b.float()
    return u * torch.sigmoid(u)


def _conv_wgrad(a, dc, K: int, dilation: int) -> torch.Tensor:
    """dW[k] = sum_{b,t} a[b, t + k d - halo] (x) dc[b, t]: K fp32 products."""
    halo = (K - 1) * dilation // 2
    T = dc.shape[1]
    ap = F.pad(a, (0, 0, halo, halo))
    dcf = dc.float()
    return torch.stack([torch.einsum("btc,btd->cd",
                                     ap[:, k * dilation:k * dilation + T], dcf)
                        for k in range(K)])


def _sum_global(d, like):
    """A global (B, C) style's gradient: the per-frame one summed over T."""
    return d.sum(dim=1) if like.ndim == 2 else d


class AdaINConvBlock(torch.autograd.Function):
    """The decoder block with row 7 in its backward.  ``conv_pass`` and
    ``bwd_data`` are row 6's and row 7's wrappers, or their plain versions
    (the caller picks by device).  The weight gradients are computed only
    where a kernel requires grad (a frozen decoder, as stage 3 backpropagates
    through, wants the input and style gradients alone).  ``model``: the
    kernels are this rank's output chunks (see the module's docstring)."""

    @staticmethod
    def forward(ctx, x, scale, shift, kernel1, kernel2, dilation, conv_pass,
                bwd_data, model=None):
        y, res = _block_forward(x, scale, shift, kernel1, kernel2,
                                dilation=dilation, conv_pass=conv_pass,
                                model=model)
        ctx.save_for_backward(*res)
        ctx.dilation, ctx.bwd_data, ctx.model = dilation, bwd_data, model
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, shift, k1, k2, h, mean_x, rstd_x, mean_h, rstd_h = \
            ctx.saved_tensors
        need_x, need_s, need_b, need_w1, need_w2 = ctx.needs_input_grad[:5]
        C = x.shape[-1]
        s1, s2 = scale[..., :C], scale[..., C:]
        b1, b2 = shift[..., :C], shift[..., C:]
        inv_sqrt2 = np.float32(1.0 / np.sqrt(2.0))
        model = ctx.model
        # this rank's output channels of a whole cotangent, and the sum of
        # the ranks' partial input gradients
        mine = (lambda d: d) if model is None else model.slice
        summed = (lambda d: d) if model is None else model.sum
        dc2 = mine((g.float() * inv_sqrt2).to(g.dtype))
        # pass 2 (dilation 1): dh2 -> dc1, ds2, db2, dW2
        dh2 = summed(ctx.bwd_data(dc2, h, s2, b2, mean_h, rstd_h, k2,
                                  dilation=1))
        dc1_f, ds2, db2, n_h = _norm_bwd(dh2, h, s2, mean_h, rstd_h)
        dc1 = mine(dc1_f.to(g.dtype))
        dW2 = (_conv_wgrad(_silu_act(n_h, s2, b2), dc2, k2.shape[0], 1)
               .to(k2.dtype) if need_w2 else None)
        # pass 1 (dilated): dh1 -> dx, ds1, db1, dW1
        dh1 = summed(ctx.bwd_data(dc1, x, s1, b1, mean_x, rstd_x, k1,
                                  dilation=ctx.dilation))
        dx_n, ds1, db1, n_x = _norm_bwd(dh1, x, s1, mean_x, rstd_x)
        dW1 = (_conv_wgrad(_silu_act(n_x, s1, b1), dc1, k1.shape[0],
                           ctx.dilation).to(k1.dtype) if need_w1 else None)
        dx = (g.float() * inv_sqrt2 + dx_n).to(x.dtype) if need_x else None
        dscale = (_sum_global(torch.cat([ds1, ds2], dim=-1), scale)
                  .to(scale.dtype) if need_s else None)
        dshift = (_sum_global(torch.cat([db1, db2], dim=-1), shift)
                  .to(shift.dtype) if need_b else None)
        return dx, dscale, dshift, dW1, dW2, None, None, None, None

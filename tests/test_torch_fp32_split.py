"""Row 2's fp32 kernel and row 7's bf16 kernel, on the CPU.

Row 2's fp32 kernel (``csrc/full_attention.cu`` ``full_attn_f32_sm90_kernel``)
computes every product in 3xTF32 on the tensor cores: each operand x is
split into TF32 values hi = rna(x) and lo = rna(x - hi), and x y is taken
as hi_x hi_y + hi_x lo_y + lo_x hi_y with fp32 sums.  A torch emulation of
those steps (the kernel's: unnormalised weights P split the same way, a row
with no valid key at weight 1 on every key, the sum divided at the end)
shows at the denoiser's shapes that the split stays within the fp32
tolerance the card is held to (``chip_smoke.py``'s ``TOL``) of the plain
version and of JAX's Pallas kernel.  The kernel's layout rule (TMA reads
rows on 16 bytes) and row 7's shape rule (``_check_sm90_bwd``) are checked
against what the model hands them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from styletts_zs_torch.config import Config
from styletts_zs_torch.kernels import adain_conv as ac
from styletts_zs_torch.kernels import full_attention as fa
from styletts_zs_torch.models.decoder import MelDecoder
from styletts_zs_tpu.kernels import attention_kernel

# chip_smoke.py's TOL["full_attention"][float32]: |out - ref| <= atol +
# rtol |ref|
ATOL, RTOL = 1e-5, 1e-5
H, D = 8, 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value, ties away from zero (PTX's
    cvt.rna.tf32.f32): add half of the 13 dropped mantissa bits to the
    magnitude and clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three TF32 products summed in fp32 (a TF32
    product is exact in fp32)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def attention_3xtf32(q, k, v, mask=None) -> torch.Tensor:
    """The fp32 kernel's function in its steps, (B, Tq, H, D) fp32: scores
    by 3xTF32, masked keys at -1e30, the unnormalised weights exp(s - max)
    (1 on every key of a row with no valid key), P V by 3xTF32, divided by
    max(sum, 1e-30)."""
    qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))
    s = matmul_3xtf32(qh, kh.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        m = mask.bool()[:, None, None, :]
        s = s.masked_fill(~m, -1e30)
        none = ~mask.bool().any(-1)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if mask is not None:
        p[none] = 1.0
    out = matmul_3xtf32(p, vh) / torch.clamp(p.sum(-1, keepdim=True),
                                             min=1e-30)
    return out.transpose(1, 2)


def _denoiser_inputs(case: str):
    """q/k/v with the denoiser's shapes (H 8, D 64), numpy from a seed:
    ``cross`` 50 queries against 256 text + 16 prompt keys with the [text |
    padding | prompt] mask at batch 3 (text lengths 200 and 0, and a third
    row with no valid key at all); ``self`` 50 against 50 at batch 2, no
    mask (the denoiser's self-attention)."""
    rs = np.random.default_rng(31 if case == "cross" else 32)
    Tk = 272 if case == "cross" else 50
    B = 3 if case == "cross" else 2
    q = rs.standard_normal((B, 50, H, D)).astype(np.float32)
    k, v = (rs.standard_normal((B, Tk, H, D)).astype(np.float32)
            for _ in range(2))
    mask = None
    if case == "cross":
        text = np.arange(256)[None] < np.array([200, 0, 0])[:, None]
        mask = np.concatenate([text, np.ones((B, 16), bool)], axis=1)
        mask[2] = False
    return q, k, v, mask


@pytest.mark.parametrize("case", ["cross", "self"])
def test_3xtf32_split_stays_within_the_fp32_tolerance_of_plain(case):
    q, k, v, mask = _denoiser_inputs(case)
    tm = None if mask is None else t(mask)
    out = attention_3xtf32(t(q), t(k), t(v), tm)
    ref = fa.full_attention_plain(t(q), t(k), t(v), tm)
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=RTOL)
    # the split is not TF32 alone: one TF32 product misses the tolerance
    qh, kh, vh = (x.transpose(1, 2) for x in (t(q), t(k), t(v)))
    s1 = tf32_rna(qh) @ tf32_rna(kh).transpose(-1, -2)
    s3 = matmul_3xtf32(qh, kh.transpose(-1, -2))
    exact = (qh.double() @ kh.double().transpose(-1, -2))
    assert (s3.double() - exact).abs().max() < \
        (s1.double() - exact).abs().max() / 100


@pytest.mark.parametrize("case", ["cross", "self"])
def test_3xtf32_split_stays_within_the_fp32_tolerance_of_pallas(case):
    q, k, v, mask = _denoiser_inputs(case)
    jmask = None if mask is None else jnp.asarray(mask)
    ref = attention_kernel.full_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v)), kv_mask=jmask)
    out = attention_3xtf32(t(q), t(k), t(v), None if mask is None
                           else t(mask))
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=RTOL)
    if mask is not None:   # the row with no valid key averages all keys
        np.testing.assert_allclose(
            n(out)[2], np.broadcast_to(v[2].mean(0), (50, H, D)),
            atol=ATOL, rtol=RTOL)


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0, 3.0])
    assert torch.equal(tf32_rna(x), want)
    hi, lo = split(torch.tensor([1.0 + 2.0 ** -20]))
    assert hi.item() == 1.0 and lo.item() == 2.0 ** -20


def _fused_views(B, T, n_parts, pad=0, offset=0):
    """H x D views of one fused (B, T, n_parts H D + pad) fp32 projection,
    the first view starting ``offset`` elements in."""
    width = n_parts * H * D + pad
    base = torch.zeros(B * T * width + offset)
    return base[offset:].view(B, T, width)[..., :H * D].unflatten(-1, (H, D))


def test_fp32_wrapper_refuses_rows_off_16_bytes():
    """TMA reads fp32 rows that start on 16 bytes: strides in multiples of
    4 elements and a 16-byte aligned pointer.  The denoiser's views of its
    fused projections (row strides 1536 and 1024) pass; a view with a row
    stride of 1030, or one starting 4 bytes off, raises, in the wrapper
    too, before it looks at the device."""
    fa.check_layout("q", _fused_views(2, 50, 3))     # self-attention qkv
    fa.check_layout("k", _fused_views(2, 272, 2))    # cross-attention kv
    for bad in (_fused_views(2, 272, 2, pad=6), _fused_views(2, 50, 2,
                                                             offset=1)):
        assert bad.stride(1) % 4 or bad.data_ptr() % 16
        with pytest.raises(ValueError, match="multiples of 4"):
            fa.check_layout("k", bad)
        with pytest.raises(ValueError, match="multiples of 4"):
            fa.full_attention_cuda(bad, bad, bad)
    # bf16 rows: strides in multiples of 8 (a row stride of 1028 passes
    # in fp32, not in bf16)
    fa.check_layout("v", _fused_views(2, 50, 2, pad=4))
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.check_layout("v", torch.zeros(2 * 50 * 1028, dtype=torch.bfloat16)
                        .as_strided((2, 50, H, D), (50 * 1028, 1028, D, 1)))


def _row7_calls():
    """(x, scale, shift, w, dilation) of every row-7 call in a backward of
    the full-width decoder (``Config()``'s, as the train step builds it),
    recorded on the CPU at a few frames: what the train step hands row 7."""
    cfg = Config().model
    torch.manual_seed(0)
    dec = MelDecoder(cfg.decoder, n_mels=cfg.audio.n_mels,
                     text_dim=cfg.text_encoder.dim,
                     style_dim=cfg.style.d_style)
    for p in dec.parameters():
        torch.nn.init.normal_(p, std=0.02)
    B, T = 1, 8
    calls = []
    plain = ac.adain_conv_bwd_data_plain

    def record(dc, x, scale, shift, mean, rstd, w, *, dilation):
        calls.append((x, scale, shift, w, dilation))
        return plain(dc, x, scale, shift, mean, rstd, w, dilation=dilation)

    ac.adain_conv_bwd_data_plain = record
    try:
        mel, _ = dec(torch.randn(B, T, cfg.text_encoder.dim),
                     torch.randn(B, T), torch.randn(B, T),
                     torch.randn(B, T, cfg.style.d_style))
        mel.sum().backward()
    finally:
        ac.adain_conv_bwd_data_plain = plain
    return cfg, calls


def test_row7_shape_rule_takes_every_train_step_shape():
    cfg, calls = _row7_calls()
    assert len(calls) == 2 * cfg.decoder.n_blocks   # 12 a step
    seen = set()
    for x, scale, shift, w, d in calls:
        ac._check_sm90_bwd(scale, shift, w, d)
        # and with a global (B, C) style of the same widths
        ac._check_sm90_bwd(scale[:, 0], shift[:, 0], w, d)
        seen.add((*w.shape, d))
    assert seen == {(5, 512, 512, d) for d in (1, 3, 9)}


@pytest.mark.parametrize("w_shape,dilation,style", [
    ((3, 512, 512), 1, "frames"),      # K 3
    ((7, 512, 512), 1, "frames"),      # K 7
    ((5, 512, 512), 10, "frames"),     # halo 20 > 18
    ((5, 512, 520), 1, "frames"),      # C_out % 16
    ((5, 384, 512), 1, "frames"),      # C % 256
    ((5, 512, 512), 1, "mixed"),       # scale per frame, shift global
])
def test_row7_shape_rule_refuses_shapes_off_the_grid(w_shape, dilation,
                                                     style):
    s = torch.zeros(2, 4, w_shape[1])
    with pytest.raises(ValueError):
        ac._check_sm90_bwd(s, s[:, 0] if style == "mixed" else s,
                           torch.zeros(w_shape), dilation)

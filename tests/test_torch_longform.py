"""The long-form slice against JAX, on the CPU: the fused AdaIN conv pass
(row 6) and the transposed conv (row 10) — their plain versions, which the
CUDA kernels are held to on the card — and 60 s synthesis (acceptance
level 4) at its tiny settings, with the config it is read from.

Row 6 is held against the Pallas kernel in interpret mode
(``decoder_kernels``) and the XLA twin (``dispatch.adain_conv_block(
use_pallas=False)``), row 10 against ``conv_transpose1d_pallas`` and
``ops.conv.conv_transpose1d``; fp32 within 3e-5 (the JAX package's own
bound between the two: the same sums in another order).  bf16 against the
Pallas kernel, whose rounding points the port follows, within one bf16
step (2e-2 + 2e-2 |y|).  The whole path within 1e-4 with equal durations,
as ``test_torch_infer.py``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_tiny, n, random_tree, t, to_jax, torch_tiny
from styletts_zs_tpu.kernels import decoder_kernels, vocoder_kernels
from styletts_zs_tpu.kernels import dispatch as j_dispatch
from styletts_zs_tpu.ops import conv as j_conv
from styletts_zs_tpu.pipelines.infer import make_synthesis_fn as j_synth
from styletts_zs_tpu.utils import config as j_config
from styletts_zs_torch import config as t_config
from styletts_zs_torch.kernels import adain_conv as ac
from styletts_zs_torch.kernels import conv_transpose as ct
from styletts_zs_torch.kernels import dispatch
from styletts_zs_torch.ops import stft as stft_ops
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.infer import Synthesizer, make_synthesis_fn

REPO = Path(__file__).resolve().parent.parent
F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
PATH_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rnd(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


# --- row 6: the fused AdaIN conv pass and block ------------------------------

def _block_inputs(B, T, C, K, time_varying):
    mod_shape = (B, T, 2 * C) if time_varying else (B, 2 * C)
    return (rnd((B, T, C), 0), rnd(mod_shape, 1, 0.2), rnd(mod_shape, 2, 0.2),
            rnd((K, C, C), 3, 0.1), rnd((K, C, C), 4, 0.1))


@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("time_varying", [True, False])
@pytest.mark.parametrize("T", [100, 300])
def test_adain_conv_block_matches_pallas_and_twin(dilation, time_varying, T):
    """T 100 and 300 are no multiple of the CUDA kernel's 128-frame tile
    (nor 300 of the Pallas kernel's block)."""
    args = _block_inputs(2, T, 16, 5, time_varying)
    ja = [jnp.asarray(a) for a in args]
    before = dispatch.plain_calls["adain_conv"]
    out = n(dispatch.adain_conv_block(*map(t, args), dilation=dilation))
    assert dispatch.plain_calls["adain_conv"] == before + 2
    for ref in (decoder_kernels.adain_conv_block_pallas(*ja,
                                                        dilation=dilation),
                j_dispatch.adain_conv_block(*ja, dilation=dilation,
                                            use_pallas=False)):
        np.testing.assert_allclose(out, n(ref), **F32)


@pytest.mark.parametrize("dilation", [1, 9])
def test_adain_conv_pass_matches_pallas_pass(dilation):
    """One pass with its statistics, fp32 and bf16 (K 3 as well as 5)."""
    for K in (3, 5):
        x, sc, sh, w, _ = _block_inputs(2, 150, 16, K, True)
        sc, sh = sc[..., :16], sh[..., :16]
        ref, j_mean, j_rstd = decoder_kernels._mod_conv_pass(
            *map(jnp.asarray, (x, sc, sh, w)), dilation=dilation)
        mean, rstd = ac.instance_stats(t(x))
        np.testing.assert_allclose(n(mean), n(j_mean), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(n(rstd), n(j_rstd), atol=1e-5, rtol=1e-6)
        out = ac.adain_conv_pass_plain(t(x), t(sc), t(sh), mean, rstd, t(w),
                                       dilation=dilation)
        np.testing.assert_allclose(n(out), n(ref), **F32)
        xb, scb, shb, wb = (jnp.asarray(a).astype(jnp.bfloat16)
                            for a in (x, sc, sh, w))
        ref16, _, _ = decoder_kernels._mod_conv_pass(xb, scb, shb, wb,
                                                     dilation=dilation)
        tb = [t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
              for a in (xb, scb, shb, wb)]
        out16 = ac.adain_conv_pass_plain(tb[0], tb[1], tb[2],
                                         *ac.instance_stats(tb[0]), tb[3],
                                         dilation=dilation)
        assert out16.dtype == torch.bfloat16
        np.testing.assert_allclose(n(out16), n(ref16), **BF16)


def test_adain_conv_pass_takes_strided_views():
    """The decoder hands the pass its scale/shift as views of the style
    projection's (B, T, 4C) output; they give what copies give."""
    B, T, C, K = 2, 40, 8, 5
    x = t(rnd((B, T, C), 5))
    mod = t(rnd((B, T, 4 * C), 6, 0.2))
    scale, shift = mod.split(2 * C, dim=-1)
    w = t(rnd((K, C, C), 7, 0.1))
    mean, rstd = ac.instance_stats(x)
    for sc, sh in ((scale[..., :C], shift[..., :C]),
                   (scale[..., C:], shift[..., C:])):
        assert sc.stride() == (T * 4 * C, 4 * C, 1)
        out = ac.adain_conv_pass_plain(x, sc, sh, mean, rstd, w, dilation=3)
        ref = ac.adain_conv_pass_plain(x, sc.contiguous(), sh.contiguous(),
                                       mean, rstd, w, dilation=3)
        assert torch.equal(out, ref)


# --- row 10: the transposed conv ---------------------------------------------

@pytest.mark.parametrize("stride,K", [(5, 10), (3, 6), (5, 11), (2, 4)])
def test_conv_transpose_matches_pallas_and_twin(stride, K):
    """The cases of ``test_pallas_kernels.py``; also with the leaky ReLU
    fused and from a (B, C, T)-major view, as the vocoder hands it over."""
    B, T, Cin, Cout = 2, 40, 8, 16
    x = rnd((B, T, Cin), 0)
    w = rnd((K, Cin, Cout), 1, 0.2)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    before = dispatch.plain_calls["conv_transpose"]
    out = n(dispatch.conv_transpose1d(t(x), t(w), stride=stride))
    assert dispatch.plain_calls["conv_transpose"] == before + 1
    for ref in (vocoder_kernels.conv_transpose1d_pallas(jx, jw, stride=stride),
                j_conv.conv_transpose1d(jx, jw, stride=stride)):
        assert out.shape == ref.shape == (B, T * stride, Cout)
        np.testing.assert_allclose(out, n(ref), **F32)
    ref = j_conv.conv_transpose1d(jax.nn.leaky_relu(jx, 0.1), jw,
                                  stride=stride)
    xt = t(np.ascontiguousarray(x.transpose(0, 2, 1))).transpose(1, 2)
    assert xt.stride(1) == 1
    out = ct.conv_transpose1d_plain(xt, t(w), stride=stride,
                                    negative_slope=0.1)
    np.testing.assert_allclose(n(out), n(ref), **F32)


def test_conv_transpose_taps_cover_the_kernel_once():
    """Every tap of the kernel serves exactly one (phase, shift): K/r taps
    a phase at the vocoder's K 10, r 5, none multiplied as a zero row."""
    for K, r in ((10, 5), (11, 5), (6, 3), (4, 2)):
        plan = ct.phase_taps(K, r)
        assert sorted(tap for taps in plan for _, tap in taps) == \
            list(range(K))
    assert [len(taps) for taps in ct.phase_taps(10, 5)] == [2] * 5


def _bf16_view(B, T, C, layout, offset=0):
    """A bf16 (B, T, C) CPU tensor laid out as the card would get it."""
    if layout == "frames":      # the vocoder's (B, C, T)-major view
        return torch.zeros(B, C, T, dtype=torch.bfloat16).transpose(1, 2)
    if layout == "channels":
        return torch.zeros(B * T * C + offset, dtype=torch.bfloat16)[
            offset:].view(B, T, C)
    return torch.zeros(B, T, C, 2, dtype=torch.bfloat16)[..., 0]


@pytest.mark.parametrize("case,want", [
    ((2, 64, 32, 64, 10, 5, "frames", 0), "frames"),
    ((2, 64, 32, 128, 10, 5, "channels", 0), "channels"),
    ((1, 8, 1, 64, 10, 5, "frames", 0), "frames"),
    ((2, 64, 32, 64, 11, 5, "frames", 0), None),     # K
    ((2, 64, 32, 64, 10, 2, "frames", 0), None),     # stride
    ((2, 64, 32, 96, 10, 5, "frames", 0), None),     # Cout not a tile multiple
    ((2, 60, 32, 64, 10, 5, "frames", 0), None),     # T % 8
    ((2, 64, 32, 64, 10, 5, "neither", 0), None),    # no contiguous dim
    ((2, 64, 32, 64, 10, 5, "channels", 1), None),   # 2-byte aligned x
    ((2, 64, 12, 64, 10, 5, "channels", 0), None),   # 24-byte frame stride
])
def test_conv_transpose_bf16_layout_takes_what_the_kernel_takes(case, want):
    """The bf16 kernel's argument checks, on the CPU: it takes the
    vocoder's K 10 / stride 5 with Cout in tiles of 64 and T % 8 == 0, from
    the (B, C, T)-major view or channels last with 16-byte aligned rows
    (TMA), and the wrapper raises on anything else, with no plain
    fallback."""
    B, T, C, C_out, K, stride, layout, offset = case
    x = _bf16_view(B, T, C, layout, offset)
    w = torch.zeros(K, C, C_out, dtype=torch.bfloat16)
    if want is None:
        with pytest.raises(ValueError):
            ct.bf16_layout(x, w, stride)
    else:
        assert ct.bf16_layout(x, w, stride) == want


def test_conv_transpose_bf16_rounds_like_pallas():
    x = rnd((2, 40, 16), 8)
    w = rnd((10, 16, 16), 9, 0.2)
    xb, wb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w))
    ref = vocoder_kernels.conv_transpose1d_pallas(xb, wb, stride=5)
    out = ct.conv_transpose1d_plain(
        t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
        t(np.asarray(wb.astype(jnp.float32))).to(torch.bfloat16), stride=5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(n(out), n(ref), **BF16)


# --- the weights carry across unchanged ----------------------------------------

def test_convert_params_keeps_the_conv_layouts():
    """Every decoder block's conv1/conv2 (K, C, C) and every upsampling
    kernel (K, Cin, Cout) is the JAX array as it is."""
    jcfg = jax_tiny()
    tree = random_tree(jcfg)
    params = convert_params(tree, torch_tiny())
    dec = tree["acoustic"]["params"]["decoder"]
    for i in range(jcfg.model.decoder.n_blocks):
        for name in ("conv1", "conv2"):
            np.testing.assert_array_equal(
                params["acoustic"][f"decoder.res{i}.{name}"],
                dec[f"res{i}"][name])
    for i in range(len(jcfg.model.vocoder.upsample_rates)):
        np.testing.assert_array_equal(params["vocoder"][f"up{i}_kernel"],
                                      tree["vocoder"]["params"][f"up{i}_kernel"])


# --- the config of acceptance level 4 ------------------------------------------

LONGFORM = str(REPO / "configs" / "longform_60s.toml")


def test_longform_config_loads_as_in_jax():
    tcfg = t_config.load_config(LONGFORM)
    assert dataclasses.asdict(tcfg) == \
        dataclasses.asdict(j_config.load_config(LONGFORM))
    sv = tcfg.serve
    assert (tcfg.model.max_frames, sv.frame_buckets, sv.batch_size,
            sv.one_step, sv.with_vocoder, tcfg.runtime.compute_dtype) == \
        (4864, (1024, 2048, 4864), 4, True, True, "bfloat16")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_longform_config_and_counts():
    """The long-form phase's config is level 4 with 256 phonemes, and its
    launches per call: 3 local attention (19 chunks), 26 full attention,
    12 AdaIN conv passes, 2 transposed convs, 1 head — at 2048 frames too."""
    cs = _chip_smoke()
    cfg = cs.longform_config()
    assert (cfg.model.max_frames, cfg.model.max_text_len,
            cfg.serve.batch_size) == (4864, 256, 4)
    for frames in (4864, 2048):
        assert cs.expected_counts(cfg, frames) == {
            "local_attention": 3, "full_attention": 26, "adain_conv": 12,
            "conv_transpose": 2, "synthesis_head": 1}
    # at 256 frames (level 1; level 5's smallest bucket) the decoder's
    # attention is one chunk: full attention
    assert cs.expected_counts(cfg, 256)["full_attention"] == 26 + 3


# --- 60 s synthesis at level 4's tiny settings, against JAX --------------------

@pytest.fixture(scope="module")
def level4():
    """JAX's level 4 at tiny size (``acceptance.py``: ``tiny_test_config``
    with ``max_frames`` 128, batch 2, 1-step, with the vocoder), run at 128
    frames and at 64 (two decoder chunks) and 32 (one chunk)."""
    torch.set_num_threads(1)
    base = jax_tiny()
    jcfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, max_frames=128))
    tree = random_tree(jcfg)
    rs = np.random.default_rng(9)
    m = jcfg.model
    B, Tt = 2, 40
    inputs = (rs.integers(1, 40, (B, Tt)).astype(np.int32),
              np.array([Tt, 29], np.int32),
              (0.5 * rs.standard_normal((B, 40, m.audio.n_mels))).astype(np.float32),
              np.array([40, 33], np.int32))
    rng = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(rng, (B, m.style.n_codes,
                                               m.style.d_style)))
    refs = {}
    for frames in (128, 64, 32):
        refs[frames] = jax.jit(j_synth(jcfg, one_step=True, with_vocoder=True,
                                       n_frames=frames))(
            to_jax(tree), *map(jnp.asarray, inputs), rng)
    tcfg = dataclasses.replace(torch_tiny(), model=dataclasses.replace(
        torch_tiny().model, max_frames=128))
    return tcfg, convert_params(tree, tcfg), inputs, noise, refs


@pytest.mark.parametrize("frames", [128, 64, 32])
def test_longform_level4_tiny_matches_jax(level4, frames):
    tcfg, params, inputs, noise, refs = level4
    ref_out, ref_wav = refs[frames]
    before = dict(dispatch.plain_calls)
    out, wav = make_synthesis_fn(tcfg, params, n_frames=frames,
                                 device="cpu")(*map(t, inputs), t(noise))
    np.testing.assert_array_equal(out.durations.numpy(),
                                  np.asarray(ref_out.durations))
    assert int(out.frame_lengths.min()) > 0
    np.testing.assert_allclose(n(out.mel), n(ref_out.mel), atol=PATH_ATOL,
                               rtol=0)
    assert wav.shape == ref_wav.shape == (2, (frames * 25 - 1) * 4)
    np.testing.assert_allclose(n(wav), n(ref_wav), atol=PATH_ATOL, rtol=0)
    calls = {k: dispatch.plain_calls[k] - before[k] for k in before}
    # the decoder's one attention block: local attention above one chunk
    # (32 frames), full attention at one chunk
    assert calls["local_attention"] == int(frames > 32)
    assert (calls["adain_conv"], calls["conv_transpose"],
            calls["synthesis_head"]) == (4, 2, 1)


def test_longform_synthesizer_matches_the_program(level4):
    """``Synthesizer.synthesize(n_frames=...)`` runs the same program."""
    tcfg, params, inputs, noise, refs = level4
    syn = Synthesizer(tcfg, params, device="cpu")
    wav_ref = t(rnd((2, 4000), 12, 0.1))
    out, wav = syn.synthesize(t(inputs[0]), wav_ref,
                              text_lengths=t(inputs[1]), noise=t(noise),
                              n_frames=64)
    mel = stft_ops.mel_spectrogram(wav_ref, tcfg.model.audio)
    lens = torch.full((2,), mel.shape[1], dtype=torch.int32)
    out2, wav2 = make_synthesis_fn(tcfg, params, n_frames=64, device="cpu")(
        t(inputs[0]), t(inputs[1]), mel, lens, t(noise))
    assert out.mel.shape == (2, 64, tcfg.model.audio.n_mels)
    assert wav.shape == (2, (64 * 25 - 1) * 4) and torch.isfinite(wav).all()
    assert torch.equal(out.durations, out2.durations)
    np.testing.assert_allclose(n(wav), n(wav2), atol=PATH_ATOL, rtol=0)

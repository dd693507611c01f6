"""The port's ops (styletts_zs_torch/ops) against their JAX counterparts.

Same inputs made with numpy from a seed; fp32 on the CPU; atol 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from styletts_zs_tpu.ops import align as j_align
from styletts_zs_tpu.ops import attention as j_attn
from styletts_zs_tpu.ops import conv as j_conv
from styletts_zs_tpu.ops import fsq as j_fsq
from styletts_zs_tpu.ops import norm as j_norm
from styletts_zs_tpu.ops import stft as j_stft
from styletts_zs_tpu.utils import config as j_config
from styletts_zs_torch import config as t_config
from styletts_zs_torch.ops import align as t_align
from styletts_zs_torch.ops import attention as t_attn
from styletts_zs_torch.ops import conv as t_conv
from styletts_zs_torch.ops import fsq as t_fsq
from styletts_zs_torch.ops import norm as t_norm
from styletts_zs_torch.ops import stft as t_stft

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rnd(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(n(torch_out), n(jax_out), atol=atol, rtol=0)


# --- config ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["Config", "tiny_test_config",
                                  "cpu_ref_config"])
def test_config_copy_matches(name):
    j = getattr(j_config, name)()
    tt = getattr(t_config, name)()
    assert dataclasses.asdict(tt) == dataclasses.asdict(j)


def test_config_toml_loader_matches(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text('[model]\nmax_frames = 512\n[model.decoder]\nn_blocks = 3\n'
                 '[runtime]\ncompute_dtype = "float32"\n')
    assert dataclasses.asdict(t_config.load_config(str(p))) == \
        dataclasses.asdict(j_config.load_config(str(p)))


# --- attention ---------------------------------------------------------------

def test_length_mask():
    lengths = np.array([0, 3, 7], np.int32)
    np.testing.assert_array_equal(
        t_attn.length_mask(t(lengths), 7).numpy(),
        np.asarray(j_attn.length_mask(jnp.asarray(lengths), 7)))


@pytest.mark.parametrize("masked", [False, True])
def test_mha_and_cross_attention(masked):
    q, k, v = rnd(2, 5, 2, 8, seed=1), rnd(2, 9, 2, 8, seed=2), rnd(2, 9, 2, 8, seed=3)
    mask = np.arange(9)[None] < np.array([9, 4])[:, None] if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else t(mask)
    close(j_attn.cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 kv_mask=jm),
          t_attn.cross_attention(t(q), t(k), t(v), kv_mask=tm))


@pytest.mark.parametrize("T,masked", [(96, False), (96, True), (32, True)])
def test_local_attention_twin(T, masked):
    q, k, v = (rnd(2, T, 2, 8, seed=s) for s in (4, 5, 6))
    mask = np.arange(T)[None] < np.array([T, T // 3])[:, None]
    jm, tm = (jnp.asarray(mask), t(mask)) if masked else (None, None)
    close(j_attn.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 chunk=32, kv_mask=jm),
          t_attn.local_attention(t(q), t(k), t(v), chunk=32, kv_mask=tm))


# --- conv ------------------------------------------------------------------

@pytest.mark.parametrize("K,dilation", [(5, 1), (3, 3), (7, 9), (4, 2)])
def test_conv1d(K, dilation):
    x, w = rnd(2, 17, 6, seed=7), rnd(K, 6, 5, seed=8)
    close(j_conv.conv1d(jnp.asarray(x), jnp.asarray(w), dilation=dilation),
          t_conv.conv1d(t(x), t(w), dilation=dilation))


@pytest.mark.parametrize("K,stride", [(10, 5), (4, 2), (7, 3)])
def test_conv_transpose1d(K, stride):
    x, w = rnd(2, 13, 6, seed=9), rnd(K, 6, 5, seed=10)
    close(j_conv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), stride=stride),
          t_conv.conv_transpose1d(t(x), t(w), stride=stride))


# --- norm ------------------------------------------------------------------

def test_layer_and_instance_norm():
    x = rnd(2, 11, 8, seed=11, scale=3.0)
    close(j_norm.layer_norm(jnp.asarray(x)), t_norm.layer_norm(t(x)))
    close(j_norm.instance_norm(jnp.asarray(x)), t_norm.instance_norm(t(x)))


@pytest.mark.parametrize("fn", ["adain", "adaln"])
@pytest.mark.parametrize("time_varying", [False, True])
def test_adain_adaln(fn, time_varying):
    x = rnd(2, 11, 8, seed=14, scale=2.0)
    shape = (2, 11, 8) if time_varying else (2, 8)
    s, b = rnd(*shape, seed=15, scale=0.3), rnd(*shape, seed=16)
    close(getattr(j_norm, fn)(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)),
          getattr(t_norm, fn)(t(x), t(s), t(b)))


# --- align -----------------------------------------------------------------

def test_expand_by_duration_and_alignment():
    d = np.array([[2, 0, 3, 1], [1, 1, 5, 0]], np.int32)
    x = rnd(2, 4, 6, seed=17)
    np.testing.assert_array_equal(
        t_align.alignment_matrix(t(d), 9).numpy(),
        np.asarray(j_align.alignment_matrix(jnp.asarray(d), 9)))
    close(j_align.expand_by_duration(jnp.asarray(x), jnp.asarray(d), 9),
          t_align.expand_by_duration(t(x), t(d), 9))


def test_stretch_style_codes():
    codes, lengths = rnd(2, 5, 3, seed=18), np.array([17, 1], np.int32)
    close(j_align.interp_style_matrix(jnp.asarray(lengths), 5, 20),
          t_align.interp_style_matrix(t(lengths), 5, 20))
    close(j_align.stretch_style_codes(jnp.asarray(codes), jnp.asarray(lengths), 20),
          t_align.stretch_style_codes(t(codes), t(lengths), 20))


# --- fsq -------------------------------------------------------------------

@pytest.mark.parametrize("levels", [(8, 8, 8, 5, 5, 5), (8, 8, 5)])
def test_fsq_indices_to_codes(levels):
    idx = np.random.default_rng(19).integers(0, int(np.prod(levels)), (3, 7))
    idx = idx.astype(np.int32)
    codes_t = t_fsq.indices_to_codes(t(idx), levels)
    np.testing.assert_array_equal(
        n(codes_t), n(j_fsq.indices_to_codes(jnp.asarray(idx), levels)))
    # every index maps to a distinct lattice point
    np.testing.assert_array_equal(
        np.asarray(j_fsq.codes_to_indices(jnp.asarray(n(codes_t)), levels)), idx)


# --- stft ------------------------------------------------------------------

AUDIO = [j_config.tiny_test_config().model.audio, j_config.AudioConfig(),
         j_config.AudioConfig(n_fft=48, win_length=40, hop_length=12)]


def _t_audio(cfg):
    return t_config.AudioConfig(**dataclasses.asdict(cfg))


def test_stft_constants():
    for cfg in AUDIO:
        for a, b in zip(j_stft.stft_constants(cfg),
                        t_stft.stft_constants(_t_audio(cfg))):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_stft.hann_window(7), j_stft.hann_window(7))


@pytest.mark.parametrize("i", range(len(AUDIO)))
def test_mel_spectrogram(i):
    wav = rnd(2, 3000, seed=20)
    close(j_stft.mel_spectrogram(jnp.asarray(wav), AUDIO[i]),
          t_stft.mel_spectrogram(t(wav), _t_audio(AUDIO[i])))


@pytest.mark.parametrize("i", range(len(AUDIO)))
def test_istft(i):
    cfg = AUDIO[i]
    re, im = (rnd(2, 21, cfg.n_fft // 2 + 1, seed=s) for s in (21, 22))
    close(j_stft.istft(jnp.asarray(re), jnp.asarray(im), cfg),
          t_stft.istft(t(re), t(im), _t_audio(cfg)))


def test_inverse_envelope_matches_head_helper():
    from styletts_zs_tpu.kernels import vocoder_kernels
    env = vocoder_kernels._istft_env(48, 12, 30, 29 * 12 + 48)
    np.testing.assert_allclose(t_stft.istft_inverse_envelope(48, 12, 30),
                               1.0 / env, rtol=1e-6)

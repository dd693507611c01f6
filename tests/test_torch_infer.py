"""The whole path against JAX: zero-shot synthesis, 1-step with the vocoder
and multi-step without it.

JAX runs ``make_synthesis_fn(one_step=True, with_vocoder=True)`` and
``make_synthesis_fn(one_step=False, n_steps=4, with_vocoder=False)`` in
fp32 with the XLA twins (``use_pallas=False``); the port runs on the CPU,
where its kernels take their plain versions, with the same weights and the
same initial noise (``jax.random.normal(rng, (B, K, d))`` handed over).
Durations must be equal; mel and waveform within atol 1e-4 (fp32 sums in
another order through ~20 layers).  Also the CPU rehearsal of
``chip_smoke.py``'s main-path function.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_tiny, n, random_tree, t, to_jax, torch_tiny
from styletts_zs_tpu.pipelines.infer import make_fixed_style_fn as j_fixed
from styletts_zs_tpu.pipelines.infer import make_synthesis_fn as j_synth
from styletts_zs_tpu.ops import stft as j_stft
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.factory import init_params
from styletts_zs_torch.pipelines.infer import (Synthesizer, make_fixed_style_fn,
                                               make_synthesis_fn)

ATOL = 1e-4
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    jcfg, tcfg = jax_tiny(), torch_tiny()
    tree = random_tree(jcfg)
    rs = np.random.default_rng(3)
    m = jcfg.model
    B, Tt = 2, 24
    inputs = (rs.integers(1, 40, (B, Tt)).astype(np.int32),
              np.array([Tt, 17], np.int32),
              (0.5 * rs.standard_normal((B, 40, m.audio.n_mels))).astype(np.float32),
              np.array([40, 31], np.int32))
    rng = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(rng, (B, m.style.n_codes,
                                               m.style.d_style)))
    ref_out, ref_wav = jax.jit(j_synth(jcfg, one_step=True, with_vocoder=True))(
        to_jax(tree), *map(jnp.asarray, inputs), rng)
    return jcfg, tcfg, tree, convert_params(tree, tcfg), inputs, noise, \
        ref_out, ref_wav


def test_zero_shot_one_step_matches_jax(world):
    jcfg, tcfg, tree, params, inputs, noise, ref_out, ref_wav = world
    fn = make_synthesis_fn(tcfg, params, one_step=True, with_vocoder=True,
                           device="cpu")
    out, wav = fn(*map(t, inputs), t(noise))
    np.testing.assert_array_equal(out.durations.numpy(),
                                  np.asarray(ref_out.durations))
    assert int(out.frame_lengths.min()) > 0          # non-empty utterances
    np.testing.assert_array_equal(out.frame_mask.numpy(),
                                  np.asarray(ref_out.frame_mask))
    for name in ("mel", "f0", "energy", "log_dur"):
        np.testing.assert_allclose(n(getattr(out, name)),
                                   n(getattr(ref_out, name)), atol=ATOL,
                                   rtol=0, err_msg=name)
    assert wav.shape == ref_wav.shape
    np.testing.assert_allclose(n(wav), n(ref_wav), atol=ATOL, rtol=0)


def test_fixed_style_matches_jax(world):
    jcfg, tcfg, tree, params, inputs, noise, _, _ = world
    style = np.random.default_rng(4).standard_normal(
        (2, jcfg.model.style.n_codes, jcfg.model.style.d_style)) \
        .astype(np.float32)
    ref = j_fixed(jcfg)(to_jax(tree), jnp.asarray(inputs[0]),
                        jnp.asarray(inputs[1]), jnp.asarray(style))
    out = make_fixed_style_fn(tcfg, params, device="cpu")(
        t(inputs[0]), t(inputs[1]), t(style))
    np.testing.assert_array_equal(out.durations.numpy(),
                                  np.asarray(ref.durations))
    np.testing.assert_allclose(n(out.mel), n(ref.mel), atol=ATOL, rtol=0)
    out2 = Synthesizer(tcfg, params, device="cpu").synthesize_fixed_style(
        t(inputs[0]), t(style), text_lengths=t(inputs[1]))
    np.testing.assert_allclose(n(out2.mel), n(ref.mel), atol=ATOL, rtol=0)


def test_synthesizer_from_waveform(world):
    """``Synthesizer.synthesize`` computes the reference mel from audio
    (held against JAX's ``mel_spectrogram``) and runs the same program."""
    jcfg, tcfg, tree, params, inputs, noise, _, _ = world
    wav_ref = np.random.default_rng(6).standard_normal((2, 4000)) \
        .astype(np.float32) * 0.1
    mel = np.asarray(j_stft.mel_spectrogram(jnp.asarray(wav_ref),
                                            jcfg.model.audio))
    syn = Synthesizer(tcfg, params, device="cpu")
    out, wav = syn.synthesize(t(inputs[0]), t(wav_ref),
                              text_lengths=t(inputs[1]), noise=t(noise))
    fn = make_synthesis_fn(tcfg, params, device="cpu")
    lens = torch.full((2,), mel.shape[1], dtype=torch.int32)
    out2, wav2 = fn(t(inputs[0]), t(inputs[1]), t(mel), lens, t(noise))
    np.testing.assert_array_equal(out.durations.numpy(), out2.durations.numpy())
    np.testing.assert_allclose(n(wav), n(wav2), atol=ATOL, rtol=0)
    # default noise: a generator seeded 0, so two calls agree
    _, wav_a = syn.synthesize(t(inputs[0]), t(wav_ref))
    _, wav_b = syn.synthesize(t(inputs[0]), t(wav_ref))
    assert torch.equal(wav_a, wav_b) and torch.isfinite(wav_a).all()


N_STEPS = 4


@pytest.fixture(scope="module")
def multistep_ref(world):
    jcfg, _, tree, _, inputs, _, _, _ = world
    out, wav = jax.jit(j_synth(jcfg, one_step=False, n_steps=N_STEPS,
                               with_vocoder=False))(
        to_jax(tree), *map(jnp.asarray, inputs), jax.random.PRNGKey(5))
    assert wav is None
    return out


def test_zero_shot_multistep_matches_jax(world, multistep_ref):
    """The multi-step Heun sampler (7 CFG-doubled denoiser calls) on the
    whole path, mel without the vocoder."""
    jcfg, tcfg, tree, params, inputs, noise, _, _ = world
    fn = make_synthesis_fn(tcfg, params, one_step=False, n_steps=N_STEPS,
                           with_vocoder=False, device="cpu")
    out, wav = fn(*map(t, inputs), t(noise))
    assert wav is None
    np.testing.assert_array_equal(out.durations.numpy(),
                                  np.asarray(multistep_ref.durations))
    assert int(out.frame_lengths.min()) > 0
    for name in ("mel", "f0", "energy", "log_dur"):
        np.testing.assert_allclose(n(getattr(out, name)),
                                   n(getattr(multistep_ref, name)),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_synthesizer_multistep(world, multistep_ref):
    """``Synthesizer.synthesize(one_step=False)`` runs the same program as
    ``make_synthesis_fn(one_step=False)``, and differs from the 1-step
    path."""
    jcfg, tcfg, tree, params, inputs, noise, ref_out, _ = world
    wav_ref = np.random.default_rng(6).standard_normal((2, 4000)) \
        .astype(np.float32) * 0.1
    syn = Synthesizer(tcfg, params, device="cpu")
    out, wav = syn.synthesize(t(inputs[0]), t(wav_ref),
                              text_lengths=t(inputs[1]), noise=t(noise),
                              one_step=False, n_steps=N_STEPS,
                              with_vocoder=False)
    assert wav is None
    mel = stft_mel(jcfg, wav_ref)
    lens = torch.full((2,), mel.shape[1], dtype=torch.int32)
    out2, _ = make_synthesis_fn(tcfg, params, one_step=False, n_steps=N_STEPS,
                                with_vocoder=False, device="cpu")(
        t(inputs[0]), t(inputs[1]), t(mel), lens, t(noise))
    np.testing.assert_array_equal(out.durations.numpy(),
                                  out2.durations.numpy())
    np.testing.assert_allclose(n(out.mel), n(out2.mel), atol=ATOL, rtol=0)
    one, _ = syn.synthesize(t(inputs[0]), t(wav_ref),
                            text_lengths=t(inputs[1]), noise=t(noise),
                            with_vocoder=False)
    assert not torch.allclose(one.mel, out.mel)


def stft_mel(jcfg, wav):
    return np.asarray(j_stft.mel_spectrogram(jnp.asarray(wav),
                                             jcfg.model.audio))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_main_path_rehearsal_on_cpu():
    """The function ``chip_smoke.py`` drives the card with, at tiny size on
    the CPU: the plain versions run, and the per-call kernel counts, the
    waveform shape and finiteness are checked as on the card."""
    torch.set_num_threads(1)
    cs = _chip_smoke()
    cfg = torch_tiny()
    params = init_params(cfg, seed=0, device="cpu")
    params["acoustic"]["duration_predictor.out.bias"].fill_(cs.DURATION_BIAS)
    fn = make_synthesis_fn(cfg, params, device="cpu")
    r = cs.drive_main_path(cfg, fn, cs.synth_inputs(cfg, 2, "cpu"),
                           device="cpu", n_calls=2)
    # full attention: 1 text + 1 prosody + 1 prompt encoder block (720
    # frames: no gate), the prompt pooling and 2 denoiser blocks' self- and
    # cross-attention; 2 decoder blocks of 2 AdaIN conv passes; 2 vocoder
    # upsampling stages
    assert r["per_call"] == {"local_attention": 1, "synthesis_head": 1,
                             "full_attention": 8, "adain_conv": 4,
                             "conv_transpose": 2}
    assert r["counts"] == {"local_attention": 2, "synthesis_head": 2,
                           "full_attention": 16, "sampler_euler": 0,
                           "sampler_heun": 0, "adain_conv": 8,
                           "conv_transpose": 4,
                           # inference launches no training kernel
                           "local_attention_fwd_lse": 0,
                           "local_attention_bwd_dq": 0,
                           "local_attention_bwd_dkv": 0,
                           "adain_conv_bwd_data": 0,
                           # no model path calls the standalone iSTFT
                           "istft": 0}
    assert int(r["out"].frame_lengths.min()) > 0
    # a count off its expectation fails the run: a 32-frame path is one
    # chunk, where the decoder's attention is full attention, but the
    # program was made for 128 frames and launches local attention
    with pytest.raises(AssertionError, match="local_attention"):
        cs.drive_main_path(cfg, fn, cs.synth_inputs(cfg, 2, "cpu"),
                           device="cpu", n_calls=1, n_frames=32)
    # at 32 frames the program runs the decoder's attention as full
    # attention, and that passes
    short = make_synthesis_fn(cfg, params, device="cpu", n_frames=32)
    r = cs.drive_main_path(cfg, short, cs.synth_inputs(cfg, 2, "cpu"),
                           device="cpu", n_calls=1, n_frames=32)
    assert r["per_call"]["full_attention"] == 9 and \
        "local_attention" not in r["per_call"]

"""The whole slice against JAX: zero-shot 1-step synthesis with the vocoder.

JAX runs ``make_synthesis_fn(one_step=True, with_vocoder=True)`` in fp32
with the XLA twins (``use_pallas=False``); the port runs on the CPU, where
its two kernels take their plain versions, with the same weights and the
same initial noise (``jax.random.normal(rng, (B, K, d))`` handed over).
Durations must be equal; mel and waveform within atol 1e-4 (fp32 sums in
another order through ~20 layers).  Also the CPU rehearsal of
``chip_smoke.py``'s main-path function.
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
    assert r["per_call"] == {"local_attention": 1, "synthesis_head": 1}
    assert r["counts"] == {"local_attention": 2, "synthesis_head": 2}
    assert int(r["out"].frame_lengths.min()) > 0
    # a path whose kernel is launched no time fails the run: at 64 frames
    # the decoder's local attention is outside the gate
    bad = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             max_frames=64))
    with pytest.raises(AssertionError, match="local_attention"):
        cs.drive_main_path(bad, fn, cs.synth_inputs(cfg, 2, "cpu"),
                           device="cpu", n_calls=1)

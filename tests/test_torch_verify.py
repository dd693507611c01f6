"""The port's numerics gate (acceptance level 1) against the JAX package, on
the CPU.

The port's ``verify._run`` against JAX's (``pipelines/verify.py::_run``,
fp32 with the XLA twins) with the same weights, phonemes, style and golden
durations: mel and waveform within 1e-4 (fp32 sums in another order
through ~20 layers), durations equal.  Then the port's
``run_verification(max_frames=64, device="cpu")`` report at full width:
the fp32 variant passes and takes the golden durations.  A golden shorter
than half its frames raises, and why: at one frame the fp32 CPU path moves
~1e-3 against fp64, over 50x what it moves at full length.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_tiny, n, random_tree, t, to_jax, torch_tiny
from styletts_zs_tpu.models.tts import StyleTTSZS
from styletts_zs_tpu.ops.attention import length_mask
from styletts_zs_tpu.pipelines import verify as j_verify
from styletts_zs_tpu.pipelines.factory import build_models as j_build_models
from styletts_zs_torch.config import Config, ModelConfig, RuntimeConfig
from styletts_zs_torch.pipelines import verify
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.factory import init_params

ATOL = 1e-4
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def golden():
    torch.set_num_threads(1)
    jcfg, tcfg = jax_tiny(), torch_tiny()
    tree = random_tree(jcfg)
    m = jcfg.model
    rs = np.random.default_rng(11)
    B, Tt = 2, 24
    phonemes = rs.integers(1, 40, (B, Tt)).astype(np.int32)
    lengths = np.array([Tt, 15], np.int32)
    style = (0.3 * rs.standard_normal((B, m.style.n_codes, m.style.d_style))
             ).astype(np.float32)
    acoustic = j_build_models(jcfg)[0]
    durations = acoustic.apply(
        to_jax(tree)["acoustic"], jnp.asarray(phonemes), jnp.asarray(style),
        text_mask=length_mask(jnp.asarray(lengths), Tt),
        n_frames=m.max_frames, method=StyleTTSZS.text_to_mel).durations
    durations = np.asarray(durations)
    assert durations.sum(-1).min() > 0
    ref_out, ref_wav = j_verify._run(jcfg, to_jax(tree), jnp.asarray(phonemes),
                                     jnp.asarray(lengths), jnp.asarray(style),
                                     jnp.asarray(durations), m.max_frames)
    params = convert_params(tree, tcfg)
    inputs = (t(phonemes), t(lengths), t(style))
    out, wav = verify._run(tcfg, params, *inputs, t(durations), m.max_frames,
                           device="cpu")
    return {"out": out, "wav": wav, "ref_out": ref_out, "ref_wav": ref_wav,
            "durations": durations, "cfg": tcfg, "params": params,
            "inputs": inputs}


def test_run_matches_jax(golden):
    out, wav, ref_out = golden["out"], golden["wav"], golden["ref_out"]
    np.testing.assert_array_equal(out.durations.numpy(), golden["durations"])
    np.testing.assert_array_equal(out.frame_lengths.numpy(),
                                  np.asarray(ref_out.frame_lengths))
    np.testing.assert_allclose(n(out.mel), n(ref_out.mel), atol=ATOL, rtol=0)
    assert wav.shape == golden["ref_wav"].shape
    np.testing.assert_allclose(n(wav), n(golden["ref_wav"]), atol=ATOL, rtol=0)


def test_run_without_durations_is_the_golden_pass(golden):
    """durations=None predicts them, as JAX's golden pass does before it
    feeds them back: the same durations and outputs."""
    out, wav = verify._run(golden["cfg"], golden["params"], *golden["inputs"],
                           None, golden["cfg"].model.max_frames, device="cpu")
    np.testing.assert_array_equal(out.durations.numpy(), golden["durations"])
    np.testing.assert_array_equal(n(out.mel), n(golden["out"].mel))
    np.testing.assert_array_equal(n(wav), n(golden["wav"]))


def test_run_verification_report_on_the_cpu():
    torch.set_num_threads(1)
    rep = verify.run_verification(max_frames=64, device="cpu")
    assert rep["backend"] == "cpu" and rep["n_frames"] == 64
    assert rep["golden_frames"][0] > 0
    for name in ("fp32_kernels", "bf16_kernels", "bf16_plain"):
        assert rep[name]["dur_match"] == 1.0
        assert np.isfinite(list(rep[name].values())).all()
    assert rep["pass_fp32"] and rep["pass_bf16"]


def test_chip_smoke_verify_counts_on_cpu(golden):
    """``chip_smoke.py``'s launch expectation for one run of the gate's
    program, held against the plain-version calls of ``_run`` at tiny size:
    the encoders' and the decoder's attention, the AdaIN passes, the
    vocoder's transposed convs and head; no prompt encoder, no denoiser."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = golden["cfg"]
    cs.reset_counts()
    verify._run(cfg, golden["params"], *golden["inputs"],
                t(golden["durations"]), cfg.model.max_frames, device="cpu")
    counts = cs.kernel_counts(torch.device("cpu"))
    expect = cs.verify_expected_counts(cfg, cfg.model.max_frames)
    assert expect == {"full_attention": 2, "local_attention": 1,
                      "adain_conv": 4, "synthesis_head": 1,
                      "conv_transpose": 2}
    cs.check_counts("verify", counts, expect, 1)


def _gate_config(dtype: str) -> Config:
    """``run_verification(max_frames=64)``'s model in ``dtype``."""
    return Config(model=ModelConfig(max_text_len=64, max_frames=64),
                  runtime=RuntimeConfig(compute_dtype=dtype))


def test_run_verification_refuses_a_short_golden():
    torch.set_num_threads(1)
    params = init_params(_gate_config("float32"), seed=0, device="cpu")
    params["acoustic"]["duration_predictor.out.bias"].fill_(-3.0)
    with pytest.raises(ValueError, match="golden fills"):
        verify.run_verification(max_frames=64, device="cpu", params=params)


def test_one_frame_utterance_is_ill_conditioned():
    """The fp32 CPU path of the gate's model (seed-0 weights and inputs as
    ``run_verification`` draws them) against itself in fp64 and on four
    threads, with the durations handed in: one frame, then every phoneme
    one frame (64).  Run with ``-s`` to see the numbers."""
    cfg32 = _gate_config("float32")
    params = init_params(cfg32, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    phonemes = torch.randint(1, 40, (1, 64), generator=g)
    lengths = torch.full((1,), 64, dtype=torch.int32)
    style = torch.randn(1, cfg32.model.style.n_codes,
                        cfg32.model.style.d_style, generator=g) * 0.3
    drift = {}
    for frames in (1, 64):
        durations = torch.zeros(1, 64, dtype=torch.int32)
        durations[0, :frames] = 1
        mels = {}
        for name, dtype, threads in (("fp32", "float32", 1),
                                     ("fp64", "float64", 1),
                                     ("threads4", "float32", 4)):
            torch.set_num_threads(threads)
            out, _ = verify._run(_gate_config(dtype), params, phonemes,
                                 lengths, style, durations, 64, device="cpu")
            assert out.frame_lengths.tolist() == [frames]
            mels[name] = out.mel[0, :frames].double().numpy()
        torch.set_num_threads(1)
        drift[frames] = {k: float(np.abs(mels[k] - mels["fp32"]).mean())
                         for k in ("fp64", "threads4")}
    print(f"fp32 CPU mel MAE by frames: {drift}")
    assert drift[1]["fp64"] > 1e-4
    assert drift[1]["fp64"] > 50 * drift[64]["fp64"]
    assert drift[64]["fp64"] < 1e-4

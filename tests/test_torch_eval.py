"""The port's ``pipelines/eval.py`` and ``utils/metrics.py`` against the JAX
package, on the CPU.

One tiny ``random_tree`` goes to both sides, one synthetic batch of two
speakers, and JAX's own initial-noise draws (``jax.random.split`` and
``jax.random.normal`` of the key JAX's evaluation takes) go to the port as
its noise.  fp32.  Every float of a report within 1e-4 absolute plus 1e-4
relative of JAX's (summation order through a tiny model), plus 10^-k where
the value is rounded to k decimals; every count and rate (durations, FSQ
codes, retrievals) equal.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_tiny, load_chip_smoke, random_tree, t, to_jax,
                           torch_tiny)
from styletts_zs_tpu.pipelines import data as j_data
from styletts_zs_tpu.pipelines import eval as JE
from styletts_zs_tpu.utils import metrics as j_metrics
from styletts_zs_torch.pipelines import eval as PE
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.utils import metrics as p_metrics

ATOL = RTOL = 1e-4
# rounding of each key's value, in decimals (JAX's round(..., k))
DECIMALS = {"style_mse_ratio_pairs_over_gt": 3, "fsq_code_match_rate": 4}
EXACT = {"dur_mae_frames", "dur_exact_match", "fsq_code_match_rate",
         "style_latent_mse_seeds", "retrieval_acc", "retrieval_chance"}
N_STEPS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    jcfg, pcfg = jax_tiny(), torch_tiny()
    tree = random_tree(jcfg)
    batch = j_data.SyntheticDataset(jcfg.model, batch_size=2, seed=5,
                                    n_frames=64).next_batch()
    return {"jcfg": jcfg, "pcfg": pcfg, "tree": tree, "jp": to_jax(tree),
            "pp": convert_params(tree, pcfg), "batch": batch}


def _close(got: dict, ref: dict, exact=()) -> None:
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        g = got[k]
        if k in EXACT or k in exact:
            assert g == r, (k, g, r)
            continue
        slack = 10.0 ** -DECIMALS.get(k, 5)
        assert abs(g - r) <= ATOL + slack + RTOL * abs(r), (k, g, r)


def _jax_noise(key, n: int, world) -> list[np.ndarray]:
    """The initial noise JAX's samplers draw from the seeds of ``key``."""
    s, B = world["jcfg"].model.style, world["batch"].phonemes.shape[0]
    return [np.asarray(jax.random.normal(k, (B, s.n_codes, s.d_style),
                                         jnp.float32))
            for k in jax.random.split(key, n)]


# --- the plain metrics -------------------------------------------------------

def test_mel_mae_spectral_distance_durations_and_f0_match_jax(world):
    rs = np.random.default_rng(0)
    a, b = rs.standard_normal((2, 2, 30, 40)).astype(np.float32)
    mask = np.arange(30)[None, :] < np.array([[30], [17]])
    for m in (None, mask):
        got = PE.mel_mae(t(a), t(b), None if m is None else t(m))
        ref = JE.mel_mae(jnp.asarray(a), jnp.asarray(b),
                         None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    wa, wb = (0.3 * rs.standard_normal((2, 2, 3001))).astype(np.float32)
    np.testing.assert_allclose(
        PE.mel_spectral_distance(t(wa), t(wb[:, :2900]), world["pcfg"]),
        JE.mel_spectral_distance(jnp.asarray(wa), jnp.asarray(wb[:, :2900]),
                                 world["jcfg"]), rtol=1e-5)
    pd, td = rs.integers(0, 6, (2, 2, 12))
    tm = np.arange(12)[None, :] < np.array([[12], [5]])
    assert PE.duration_accuracy(t(pd), td, t(tm)) == \
        JE.duration_accuracy(pd, td, tm)
    f0 = np.where(rs.random((2, 30)) < 0.4, 0.0, rs.standard_normal((2, 30))
                  ).astype(np.float32)
    for fm in (mask, np.zeros_like(mask)):
        np.testing.assert_allclose(PE.f0_rmse(t(a[:, :, 0]), f0, t(fm)),
                                   JE.f0_rmse(a[:, :, 0], f0, fm),
                                   rtol=1e-6)


# --- the model-based evaluations ---------------------------------------------

def test_speaker_similarity_and_margin_match_jax(world):
    jcfg, pcfg = world["jcfg"], world["pcfg"]
    wavs = world["batch"].ref_wav[:, :8000]
    other = world["batch"].wav[:, :8000]
    np.testing.assert_allclose(
        PE.speaker_similarity(pcfg, world["pp"]["acoustic"], wavs, other,
                              device="cpu"),
        JE.speaker_similarity(jcfg, world["jp"]["acoustic"],
                              jnp.asarray(wavs), jnp.asarray(other)),
        atol=ATOL, rtol=RTOL)
    for synth in (wavs, np.repeat(wavs[:1], 2, axis=0)):
        got = PE.speaker_similarity_margin(pcfg, world["pp"]["acoustic"],
                                           synth, wavs, device="cpu")
        ref = JE.speaker_similarity_margin(jcfg, world["jp"]["acoustic"],
                                           jnp.asarray(synth),
                                           jnp.asarray(wavs))
        _close(got, ref)
    with pytest.raises(ValueError, match=">= 2"):
        PE.speaker_similarity_margin(pcfg, world["pp"]["acoustic"],
                                     wavs[:1], wavs[:1], device="cpu")


def test_fsq_usage_stats_equal_jax(world):
    got = PE.fsq_usage_stats(world["pcfg"], world["pp"]["acoustic"],
                             world["batch"], device="cpu")
    ref = JE.fsq_usage_stats(world["jcfg"], world["jp"]["acoustic"],
                             world["batch"])
    assert got == ref


def test_evaluate_acoustic_matches_jax(world):
    g = {p: world["pp"][p] for p in ("acoustic", "vocoder")}
    got = PE.evaluate_acoustic(world["pcfg"], g, world["batch"], device="cpu")
    ref = JE.evaluate_acoustic(
        world["jcfg"], {p: world["jp"][p] for p in ("acoustic", "vocoder")},
        world["batch"])
    _close(got, ref)
    assert ref["mel_mae_teacher_forced"] > 0
    # a batch dict (a corpus loader's) reads the same
    assert PE.evaluate_acoustic(world["pcfg"], g, vars(world["batch"]),
                                device="cpu") == got


@pytest.mark.parametrize("one_step,n_seeds", [(False, 1), (False, 3),
                                              (True, 2)])
def test_evaluate_diffusion_matches_jax_on_jax_draws(world, one_step,
                                                     n_seeds):
    key = jax.random.PRNGKey(3)
    kw = dict(n_steps=N_STEPS, one_step=one_step, n_seeds=n_seeds,
              guidance=1.0 if n_seeds > 1 else None)
    ref = JE.evaluate_diffusion(world["jcfg"], world["jp"]["acoustic"],
                                world["jp"]["diffusion"], world["batch"],
                                key, **kw)
    noise = [t(x) for x in _jax_noise(key, n_seeds, world)]
    got = PE.evaluate_diffusion(world["pcfg"], world["pp"]["acoustic"],
                                world["pp"]["diffusion"], world["batch"],
                                noise, device="cpu", **kw)
    _close(got, ref)
    assert (n_seeds > 1) == ("style_mse_ratio_pairs_over_gt" in got)
    with pytest.raises(ValueError, match="noise tensors"):
        PE.evaluate_diffusion(world["pcfg"], world["pp"]["acoustic"],
                              world["pp"]["diffusion"], world["batch"],
                              noise[:1] * (n_seeds + 1), device="cpu", **kw)


def test_evaluate_distill_gap_matches_jax(world):
    """The teacher (the seeded denoiser) against a student with other
    weights, from JAX's one draw."""
    key = jax.random.PRNGKey(4)
    student = random_tree(world["jcfg"], seed=1)["diffusion"]
    ref = JE.evaluate_distill_gap(world["jcfg"], world["jp"]["acoustic"],
                                  world["jp"]["diffusion"], to_jax(student),
                                  world["batch"], key,
                                  n_teacher_steps=N_STEPS)
    s = world["jcfg"].model.style
    noise = np.asarray(jax.random.normal(key, (2, s.n_codes, s.d_style),
                                         jnp.float32))   # JAX's one draw
    got = PE.evaluate_distill_gap(
        world["pcfg"], world["pp"]["acoustic"], world["pp"]["diffusion"],
        convert_params({**world["tree"], "diffusion": student},
                       world["pcfg"])["diffusion"],
        world["batch"], t(noise), n_teacher_steps=N_STEPS, device="cpu")
    _close(got, ref)
    assert ref["distill_latent_mse"] > 0


def test_evaluations_draw_from_a_generator_and_run_in_bf16(world):
    """A ``torch.Generator`` in place of the noise list gives the same
    report as its draws handed in; the bf16 config (the card's) runs every
    evaluation to finite numbers."""
    pcfg, pp, batch = world["pcfg"], world["pp"], world["batch"]
    s = pcfg.model.style
    draws = [torch.randn(2, s.n_codes, s.d_style,
                         generator=torch.Generator().manual_seed(9))]
    kw = dict(n_steps=N_STEPS, device="cpu")
    assert PE.evaluate_diffusion(
        pcfg, pp["acoustic"], pp["diffusion"], batch,
        torch.Generator().manual_seed(9), **kw) == PE.evaluate_diffusion(
        pcfg, pp["acoustic"], pp["diffusion"], batch, draws, **kw)
    bf16 = dataclasses.replace(pcfg, runtime=dataclasses.replace(
        pcfg.runtime, compute_dtype="bfloat16"))
    cs = load_chip_smoke()
    reps, ms = cs.eval_calls(bf16, pp, batch, vars(batch),
                             cs.eval_noise(bf16, 2, 0), device="cpu",
                             n_steps=N_STEPS)
    assert set(reps) == set(ms) == {
        "evaluate_acoustic", "fsq_usage_stats", "speaker_similarity_margin",
        "evaluate_diffusion", "evaluate_distill_gap"}
    assert np.isfinite(list(cs._numbers(reps))).all()


def test_chip_smoke_eval_comparison_rehearsal_on_cpu(world):
    """The corpus phase's fp32 gate at tiny size: two CPU runs on the same
    noise agree, a float moved past 1e-3 and a count moved by one fail."""
    cs = load_chip_smoke()
    pcfg, pp, batch = world["pcfg"], world["pp"], world["batch"]
    noise = cs.eval_noise(pcfg, 2, cs.PARITY_SEED)
    a, _ = cs.eval_calls(pcfg, pp, batch, vars(batch), noise, device="cpu",
                         n_steps=N_STEPS)
    b, _ = cs.eval_calls(pcfg, pp, batch, vars(batch), noise, device="cpu",
                         n_steps=N_STEPS)
    assert cs.compare_eval(b, a) == 0.0
    moved = json.loads(json.dumps(b))
    moved["evaluate_diffusion"]["style_latent_mse_vs_gt"] += 2e-3
    with pytest.raises(AssertionError, match="style_latent_mse_vs_gt"):
        cs.compare_eval(moved, a)
    moved = json.loads(json.dumps(b))
    moved["fsq_usage_stats"]["fsq_unique_codes"] += 1
    with pytest.raises(AssertionError, match="fsq_unique_codes"):
        cs.compare_eval(moved, a)


# --- utils/metrics.py --------------------------------------------------------

def test_metrics_writer_writes_jax_json_lines(capsys, tmp_path):
    values = {"loss": 1.23456789, "acc": np.float32(0.5),
              "t": torch.tensor(2.0)}
    for writer in (p_metrics.MetricsWriter(), j_metrics.MetricsWriter()):
        writer.scalars(7, {k: float(v) for k, v in values.items()},
                       prefix="train/")
        writer.close()
    port, jax_line = capsys.readouterr().out.strip().splitlines()
    assert json.loads(port) == json.loads(jax_line) == {
        "step": 7, "train/loss": 1.234568, "train/acc": 0.5, "train/t": 2.0}
    tb = p_metrics.MetricsWriter(str(tmp_path / "tb"))
    tb.scalars(1, {"x": 3.0})
    tb.close()
    assert json.loads(capsys.readouterr().out) == {"step": 1, "x": 3.0}


def test_fenced_timer_and_rtf():
    res = {}
    with p_metrics.fenced_timer(res, "s") as holder:
        holder["value"] = torch.ones(3).sum()
    assert 0.0 <= res["s"] < 5.0
    assert p_metrics.rtf(10.0, 2.0) == j_metrics.rtf(10.0, 2.0) == 5.0
    assert p_metrics.rtf(1.0, 0.0) == j_metrics.rtf(1.0, 0.0)

"""The port's ``synth``, ``accept`` and ``bench`` commands on the CPU, and
the audio I/O that ``synth --ref`` reads its speaker through, against the
JAX package.

The commands run in fresh processes at the tiny size (``configs/tiny.toml``,
fp32).  ``synth --fixed-style --ckpt`` runs JAX's own command on one
``random_tree`` saved by JAX's orbax ``save_params`` and the port's command
on the same tree saved by the port's ``save_params``: the mels must agree
within 1e-4 (fp32 sums in another order).  ``accept`` and ``bench`` print
JSON with JAX's keys.  The numpy audio functions of
``pipelines/{corpus,preprocess}.py`` and ``utils/audio.py`` are copies: equal
to JAX's bit for bit, and within 2e-6 of JAX's native resampler
(``tests/test_audio_native.py``'s tolerance).
"""
import dataclasses
import json
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import (_toml_lines, jax_synth_report, jax_tiny,
                           load_chip_smoke, random_tree, run_cli, run_module,
                           torch_tiny)
from styletts_zs_tpu.pipelines import corpus as j_corpus
from styletts_zs_tpu.pipelines import preprocess as j_pre
from styletts_zs_tpu.pipelines.checkpoint import save_params as j_save_params
from styletts_zs_tpu.utils import audio as j_audio
from styletts_zs_torch.pipelines import corpus, preprocess
from styletts_zs_torch.pipelines.checkpoint import load_params, save_params
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.utils import audio

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs" / "tiny.toml")
TEXT = "hello world"
ATOL = 1e-4
# bench.py's line (the note on its untrained gate is not carried over)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "rtf_batch1",
              "mel_mae_vs_fp32_golden"}
RATES = [(22050, 24000), (16000, 24000), (48000, 24000), (24000, 24000),
         (44100, 24000), (16000, 8000)]


def _ok(r):
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return r.stdout


def _synth(tmp_path, *args, module="styletts_zs_torch.cli", name="mel"):
    out = tmp_path / f"{name}.npy"
    extra = ["--device", "cpu"] if module == "styletts_zs_torch.cli" else []
    _ok(run_module(module, ["synth", "--config", TINY, "--text", TEXT,
                            "--out", str(out), *args, *extra]))
    return np.load(out)


def _read_int16(path):
    with wave.open(str(path), "rb") as w:
        assert w.getsampwidth() == 2 and w.getnchannels() == 1
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()),
                                               np.int16)


def test_synth_fixed_style_matches_jax_cli(tmp_path):
    tree = random_tree(jax_tiny(), seed=2)
    j_save_params(str(tmp_path / "jax_ckpt"), tree)
    save_params(str(tmp_path / "port.pt"), convert_params(tree, torch_tiny()))
    ref = _synth(tmp_path, "--fixed-style", "--ckpt",
                 str(tmp_path / "jax_ckpt"), module="styletts_zs_tpu.cli",
                 name="jax")
    got = _synth(tmp_path, "--fixed-style", "--ckpt",
                 str(tmp_path / "port.pt"))
    assert got.shape == ref.shape == (128, 40)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ref", [None, "tone"])
def test_synth_zero_shot_writes_mel_and_wav(tmp_path, ref):
    args = ["--wav-out", str(tmp_path / "out.wav")]
    if ref:   # a 1 s 16 kHz tone, which synth resamples to 24 kHz
        t = np.arange(16000) / 16000
        corpus.write_wav(str(tmp_path / "ref.wav"),
                         0.5 * np.sin(2 * np.pi * 220 * t), 16000)
        args += ["--ref", str(tmp_path / "ref.wav")]
    mel = _synth(tmp_path, *args)
    assert mel.shape == (128, 40) and np.isfinite(mel).all()
    sr, pcm = _read_int16(tmp_path / "out.wav")
    assert sr == 24000 and len(pcm) > 0 and pcm.dtype == np.int16


def test_accept_level_2_prints_jax_keys(monkeypatch):
    ref, _ = jax_synth_report(2, monkeypatch)
    rep = json.loads(_ok(run_module("styletts_zs_torch.cli",
                                    ["accept", "--level", "2", "--device",
                                     "cpu"])))
    assert set(rep) == set(ref) | {"device"}
    assert rep["config"] == "zs_batch8" and rep["device"] == "cpu"
    load_chip_smoke().check_accept_report(2, rep)


def test_bench_prints_one_line():
    out = _ok(run_module("styletts_zs_torch.cli",
                         ["bench", "--device", "cpu"])).strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    cs = load_chip_smoke()
    assert set(rec) == BENCH_KEYS | {"device"} == cs.BENCH_KEYS
    cs.check_bench_line(rec)
    assert rec["device"] == "cpu"
    # the tiny config is fp32: the CPU path is its own golden
    assert rec["mel_mae_vs_fp32_golden"] == 0.0


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_resample_matches_jax(sr_in, sr_out):
    wav = np.random.default_rng(0).standard_normal(
        int(sr_in * 0.37)).astype(np.float32)
    got = corpus.resample(wav, sr_in, sr_out)
    np.testing.assert_array_equal(got, j_audio.resample_poly_np(
        wav, sr_in, sr_out))
    np.testing.assert_array_equal(audio.resample_poly_np(wav, sr_in, sr_out),
                                  got)
    ref = j_corpus.resample(wav, sr_in, sr_out)     # native where built
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)


def test_wav_io_matches_jax(tmp_path):
    rs = np.random.default_rng(1)
    wav = np.clip(0.4 * rs.standard_normal(3001), -1.2, 1.2)
    corpus.write_wav(str(tmp_path / "port.wav"), wav, 22050)
    j_corpus.write_wav(str(tmp_path / "jax.wav"), wav, 22050)
    assert (tmp_path / "port.wav").read_bytes() == \
        (tmp_path / "jax.wav").read_bytes()
    # 16-bit mono, and 32-bit stereo written with the standard library
    with wave.open(str(tmp_path / "st32.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(4)
        w.setframerate(16000)
        w.writeframes(rs.integers(-2**31, 2**31, 2 * 500, dtype=np.int64)
                      .astype(np.int32).tobytes())
    for name in ("port.wav", "st32.wav"):
        got, sr = corpus.read_wav(str(tmp_path / name))
        ref, sr_ref = j_corpus.read_wav(str(tmp_path / name))
        assert sr == sr_ref and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [0, 1000, 48000, 90000])
def test_ref_window_matches_jax(n):
    wav = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = preprocess.ref_window(wav, 16000)
    assert got.shape == (48000,)
    np.testing.assert_array_equal(got, j_pre.ref_window(wav, 16000))


@pytest.mark.parametrize("stage,mas,out", [(1, True, "stage1_final"),
                                           (2, False, "stage2_final")])
def test_train_corpus_writes_a_checkpoint_that_loads(tmp_path, stage, mas,
                                                     out):
    """``train --corpus`` at the tiny size on the CPU: stage 1 from a
    corpus without durations with ``use_mas_durations`` set in the
    config's ``[train]`` table, stage 2 from the annotated one; the
    stage's output loads back, every tensor finite."""
    root = tmp_path / "corpus"
    corpus.export_synthetic_corpus(str(root), torch_tiny().model, n_utts=6,
                                   n_speakers=2, n_frames=128, text_len=40,
                                   seed=1)
    if mas:
        meta = root / "metadata.jsonl"
        recs = [json.loads(x) for x in meta.read_text().splitlines() if x]
        meta.write_text("".join(json.dumps({k: v for k, v in r.items()
                                            if k != "durations"}) + "\n"
                                for r in recs))
    cfg = torch_tiny()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, use_mas_durations=mas))
    toml = tmp_path / "tiny_mas.toml"
    toml.write_text("\n".join(_toml_lines(dataclasses.asdict(cfg))) + "\n")
    r = run_cli(["--stage", str(stage), "--corpus", str(root), "--steps",
                 "2", "--device", "cpu"], toml, tmp_path / "work")
    assert "training done" in _ok(r)
    tree = load_params(str(tmp_path / "work" / out))
    if stage == 1:
        assert set(tree) == {"g", "d"}
        assert set(tree["g"]) == {"acoustic", "vocoder"}

    def leaves(x):
        return ([v for y in x.values() for v in leaves(y)]
                if isinstance(x, dict) else [x])
    assert len(leaves(tree)) > 10
    assert all(torch.isfinite(v).all() for v in leaves(tree))

"""The port's corpus path against the JAX package, on the CPU: the native
frontend, F0 and energy features, ``featurize``/``collate``, the on-disk
corpus and its export, the synthetic data source, and the loader contract.

Features must EQUAL JAX's (the same numpy or C++ arithmetic on the same
bytes).  The F0 route (native C++ or the numpy twin, which agree only to
97 % voicing and 5e-3 relative) decides the features, so each comparison
forces one route on both sides; the native case skips where g++ is absent.
grain's permutation is not reproduced, so the loader is held to its
contract: deterministic for a seed, every index of a shard once an epoch,
shards disjoint, the remainder dropped, a batch equal to ``collate`` of its
items.
"""
import filecmp
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import jax_tiny, torch_tiny
from styletts_zs_tpu.native import frontend as j_native
from styletts_zs_tpu.pipelines import corpus as j_corpus
from styletts_zs_tpu.pipelines import data as j_data
from styletts_zs_tpu.pipelines import preprocess as j_pre
from styletts_zs_tpu.utils import audio as j_audio
from styletts_zs_torch.native import frontend as p_native
from styletts_zs_torch.pipelines import corpus as p_corpus
from styletts_zs_torch.pipelines import data as p_data
from styletts_zs_torch.pipelines import preprocess as p_pre
from styletts_zs_torch.utils import audio as p_audio

REPO = Path(__file__).resolve().parent.parent
N_FRAMES, TEXT_LEN = 64, 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(params=["numpy", "native"])
def route(request, monkeypatch):
    """The F0 route, forced on both sides."""
    if request.param == "numpy":
        monkeypatch.setattr(j_audio, "_NATIVE", None)
        monkeypatch.setattr(j_audio, "_NATIVE_CHECKED", True)
        monkeypatch.setattr(p_audio, "_native", lambda: None)
    else:
        if shutil.which("g++") is None:
            pytest.skip("g++ absent: the native frontend cannot be built")
        assert p_native.available() and p_audio._native() is p_native
        if not j_native.available():
            pytest.skip("JAX's native frontend is not built")
        monkeypatch.setattr(j_audio, "_NATIVE", j_native)
        monkeypatch.setattr(j_audio, "_NATIVE_CHECKED", True)
    return request.param


def _equal_dicts(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _tone(f0=220.0, sr=24000, secs=0.5, noise=0.01, seed=0):
    t = np.arange(int(sr * secs)) / sr
    x = 0.5 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(4 * np.pi * f0 * t)
    x += noise * np.random.default_rng(seed).standard_normal(len(t))
    return x.astype(np.float32)


# --- the native frontend and the features ------------------------------------

def test_frontend_source_is_a_verbatim_copy():
    assert (REPO / "styletts_zs_torch/native/frontend.cc").read_bytes() == \
        (REPO / "styletts_zs_tpu/native/frontend.cc").read_bytes()


def test_native_frontend_builds_into_build_and_matches_the_numpy_twin(
        monkeypatch):
    """The port's library (never JAX's), its F0 against the port's numpy
    twin with ``tests/test_audio_native.py``'s tolerances (voicing 97 %,
    F0 5e-3 relative, energy 1e-4), its resampler within 2e-6."""
    if shutil.which("g++") is None:
        pytest.skip("g++ absent: the native frontend cannot be built")
    assert p_native.available()
    path = p_native.library_path()
    assert path.parent == REPO / "build" and path.exists()
    wav = _tone()
    f0_cc, v_cc = p_native.estimate_f0(wav, 24000)
    monkeypatch.setattr(p_audio, "_native", lambda: None)
    f0_np, v_np = p_audio.estimate_f0(wav, 24000)
    assert (v_np == v_cc).mean() > 0.97
    both = v_np & v_cc
    np.testing.assert_allclose(f0_cc[both], f0_np[both], rtol=5e-3)
    np.testing.assert_allclose(p_native.frame_energy(wav),
                               p_audio.frame_energy(wav), atol=1e-4)
    np.testing.assert_allclose(p_native.resample_poly(wav, 24000, 16000),
                               p_audio.resample_poly_np(wav, 24000, 16000),
                               atol=2e-6)


def test_without_gxx_f0_takes_the_numpy_twin_with_one_stderr_line(
        monkeypatch, tmp_path, capsys):
    """No library and a build that cannot start (no g++): ``available()``
    is False, one line on stderr, and ``estimate_f0`` gives JAX's numpy
    F0."""
    def no_compiler(path):
        raise FileNotFoundError("g++")
    monkeypatch.setattr(p_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(p_native, "_build", no_compiler)
    monkeypatch.setattr(j_audio, "_NATIVE", None)
    monkeypatch.setattr(j_audio, "_NATIVE_CHECKED", True)
    p_native._load.cache_clear()
    p_audio._native.cache_clear()
    try:
        assert not p_native.available() and p_audio._native() is None
        got = p_audio.estimate_f0(_tone(), 24000)
        _equal_dicts(dict(zip("fv", got)),
                     dict(zip("fv", j_audio.estimate_f0(_tone(), 24000))))
        err = capsys.readouterr().err
        assert err.count("\n") == 1 and "numpy twins in use" in err
    finally:
        p_native._load.cache_clear()
        p_audio._native.cache_clear()


@pytest.mark.parametrize("kind", ["tone", "silence", "noise_burst"])
def test_f0_energy_and_framing_equal_jax(kind, route):
    wav = {"tone": _tone(),
           "silence": np.zeros(12000, np.float32),
           "noise_burst": np.concatenate([np.zeros(3000, np.float32),
                                          _tone(130.0, secs=0.3, noise=0.3)])
           }[kind]
    for kw in ({}, dict(hop=100, frame_length=400)):
        f0, v = p_audio.estimate_f0(wav, 24000, **kw)
        jf0, jv = j_audio.estimate_f0(wav, 24000, **kw)
        _equal_dicts({"f0": f0, "v": v}, {"f0": jf0, "v": jv})
        _equal_dicts({"lf0": p_audio.normalized_log_f0(f0, v),
                      "e": p_audio.frame_energy(wav, **kw)},
                     {"lf0": j_audio.normalized_log_f0(jf0, jv),
                      "e": j_audio.frame_energy(wav, **kw)})
    np.testing.assert_array_equal(p_audio.frame_audio(wav, 400, 100),
                                  j_audio.frame_audio(wav, 400, 100))
    if kind == "silence":
        assert not v.any()


@pytest.mark.parametrize("case", ["clipped", "short", "no_durations"])
def test_featurize_and_collate_equal_jax(case, route):
    """The frame budget (cumulative durations clipped into it, at least 8
    frame lengths, energy padded with log 1e-5), the phoneme padding and
    the reference window, one utterance at a time and collated."""
    m_j, m_p = jax_tiny().model, torch_tiny().model
    hop = m_p.audio.hop_length
    rs = np.random.default_rng(4)
    n_samples = {"clipped": 80 * hop + 37, "short": 5 * hop,
                 "no_durations": 40 * hop}[case]
    wav = _tone(secs=n_samples / 24000, noise=0.05)
    ph = rs.integers(5, 40, 20).astype(np.int32)
    dur = None if case == "no_durations" else rs.integers(1, 9, 20)
    ref = _tone(150.0, secs=4.0, seed=1) if case != "short" else None
    outs = []
    for pre, m in ((p_pre, m_p), (j_pre, m_j)):
        utt = pre.Utterance(phonemes=ph, wav=wav, durations=dur)
        outs.append([pre.featurize(utt, m, n_frames=N_FRAMES,
                                   text_len=TEXT_LEN, ref_wav=ref)
                     for _ in range(2)])
    got, ref_ex = outs
    _equal_dicts(got[0], ref_ex[0])
    _equal_dicts(p_pre.collate(got), j_pre.collate(ref_ex))
    assert got[0]["frame_lengths"] >= 8
    assert got[0]["durations"].sum() <= min(n_samples // hop, N_FRAMES)


# --- the on-disk corpus ------------------------------------------------------

@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same synthetic corpus exported by both sides."""
    roots = {}
    for side, corpus, m in (("port", p_corpus, torch_tiny().model),
                            ("jax", j_corpus, jax_tiny().model)):
        roots[side] = str(tmp_path_factory.mktemp(side))
        corpus.export_synthetic_corpus(roots[side], m, n_utts=7, n_speakers=3,
                                       n_frames=N_FRAMES, text_len=TEXT_LEN,
                                       seed=3)
    return roots


def test_export_synthetic_corpus_writes_jax_bytes(corpora):
    names = ["metadata.jsonl"] + [
        f"wavs/{f}" for f in sorted(os.listdir(Path(corpora["jax"]) / "wavs"))]
    assert len(names) == 8
    match, mismatch, errors = filecmp.cmpfiles(
        corpora["jax"], corpora["port"], names, shallow=False)
    assert mismatch == errors == [] and len(match) == 8
    lines = (Path(corpora["port"]) / "metadata.jsonl").read_text().split("\n")
    assert {json.loads(x)["speaker"] for x in lines if x} == \
        {"spk0", "spk1", "spk2"}


def test_disk_corpus_items_equal_jax(corpora, route):
    """Every item, its same-speaker reference (the speaker's next
    utterance, cyclic) and the entries."""
    p = p_corpus.DiskCorpus(corpora["port"], torch_tiny().model,
                            n_frames=N_FRAMES, text_len=TEXT_LEN)
    j = j_corpus.DiskCorpus(corpora["jax"], jax_tiny().model,
                            n_frames=N_FRAMES, text_len=TEXT_LEN)
    assert len(p) == len(j) == 7
    np.testing.assert_array_equal(p._ref_idx, j._ref_idx)
    assert [e.speaker for e in p.entries] == [e.speaker for e in j.entries]
    for i in range(len(p)):
        _equal_dicts(p[i], j[i])


@pytest.mark.parametrize("meta", ["text", "unannotated", "single_speaker"])
def test_text_fallback_and_unannotated_corpus_equal_jax(tmp_path, meta):
    """A line with ``"text"`` (ids from the port's ``utils/text.py``), a
    corpus without durations (the case MAS exists for: zero durations), and
    a speaker with one clip (its own reference); wavs at another rate."""
    m = torch_tiny().model
    root = tmp_path / meta
    (root / "wavs").mkdir(parents=True)
    rs = np.random.default_rng(7)
    lines = []
    for i in range(3):
        wav = _tone(120.0 + 40 * i, sr=16000, secs=0.3 + 0.1 * i, seed=i)
        p_corpus.write_wav(str(root / "wavs" / f"u{i}.wav"), wav, 16000)
        rec = {"id": f"u{i}", "speaker": "a" if meta == "single_speaker"
               and i == 0 else f"s{i % 2}"}
        if meta == "text":
            rec["text"] = ["hello world", "the quick fox", "ok"][i]
        else:
            rec["phonemes"] = rs.integers(5, 40, 9 + i).tolist()
            if meta == "single_speaker":
                rec["durations"] = rs.integers(1, 6, 9 + i).tolist()
        lines.append(json.dumps(rec))
    (root / "metadata.jsonl").write_text("\n".join(lines) + "\n\n")
    p = p_corpus.DiskCorpus(str(root), m, n_frames=32, text_len=24)
    j = j_corpus.DiskCorpus(str(root), jax_tiny().model, n_frames=32,
                            text_len=24)
    for i in range(3):
        ex = p[i]
        _equal_dicts(ex, j[i])
        if meta != "single_speaker":
            assert ex["durations"].sum() == 0
    if meta == "text":
        assert int(p[0]["text_lengths"]) > 2
    if meta == "single_speaker":
        assert p._ref_idx[0] == 0


def test_empty_corpus_raises(tmp_path):
    (tmp_path / "metadata.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="empty corpus"):
        p_corpus.DiskCorpus(str(tmp_path), torch_tiny().model, n_frames=8,
                            text_len=8)


# --- the data source and the loader contract ---------------------------------

def test_synthetic_data_source_equals_jax():
    kw = dict(n_items=50, n_frames=N_FRAMES, text_len=TEXT_LEN, seed=2)
    p = p_data.SyntheticDataSource(torch_tiny().model, **kw)
    j = j_data.SyntheticDataSource(jax_tiny().model, **kw)
    assert len(p) == len(j) == 50
    for i in (0, 7, 49):
        _equal_dicts(p[i], j[i])


class _Indexed:
    """A map-style source whose item i is recognisable."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.full((3,), i, np.float32)}


def _take(loader, n_batches):
    it = iter(loader)
    return [next(it) for _ in range(n_batches)]


def test_sampler_is_deterministic_and_covers_each_epoch():
    a = p_data.ShardedSampler(10, seed=5)
    b = p_data.ShardedSampler(10, seed=5)
    assert a.epoch(0) == b.epoch(0) and a.epoch(1) == b.epoch(1)
    assert a.epoch(0) != a.epoch(1)                 # reshuffled each epoch
    assert p_data.ShardedSampler(10, seed=6).epoch(0) != a.epoch(0)
    for e in range(3):
        assert sorted(a.epoch(e)) == list(range(10))
    it = iter(a)
    assert [next(it) for _ in range(20)] == a.epoch(0) + a.epoch(1)


def test_shards_are_disjoint_and_drop_the_remainder():
    shards = [p_data.ShardedSampler(11, seed=1, shard_index=i, shard_count=3)
              for i in range(3)]
    seen = [set(s.epoch(0)) for s in shards]
    assert all(len(s) == 3 for s in seen)          # 11 // 3, remainder 2
    assert set().union(*seen) == set(range(9))
    assert all(not (seen[i] & seen[k]) for i in range(3) for k in range(i))
    for s, first in zip(shards, seen):
        assert set(s.epoch(4)) == first
    with pytest.raises(ValueError):
        p_data.ShardedSampler(2, shard_count=3)
    with pytest.raises(ValueError):
        p_data.ShardedSampler(9, shard_index=3, shard_count=3)


@pytest.mark.parametrize("workers", [0, 1])
def test_loader_batches_are_collated_items_in_sampler_order(workers):
    src = _Indexed(10)
    loader = p_data.make_loader(src, batch_size=4, seed=3,
                                worker_count=workers)
    batches = _take(loader, 5)                     # 20 indices: 2 epochs
    order = p_data.ShardedSampler(10, seed=3)
    flat = order.epoch(0) + order.epoch(1)
    for k, b in enumerate(batches):
        assert set(b) == {"i", "x"} and isinstance(b["x"], np.ndarray)
        _equal_dicts(b, p_pre.collate([src[i] for i in flat[4 * k:
                                                            4 * k + 4]]))
    _equal_dicts(batches[0], _take(p_data.make_loader(
        src, batch_size=4, seed=3), 1)[0])


def test_corpus_and_synthetic_loaders_yield_collated_batches(corpora, route):
    loader = p_corpus.make_corpus_loader(
        corpora["port"], torch_tiny().model, batch_size=3, n_frames=N_FRAMES,
        text_len=TEXT_LEN, seed=0, shard_index=1, shard_count=2)
    (b,) = _take(loader, 1)
    src = p_corpus.DiskCorpus(corpora["port"], torch_tiny().model,
                              n_frames=N_FRAMES, text_len=TEXT_LEN)
    idx = p_data.ShardedSampler(7, seed=0, shard_index=1,
                                shard_count=2).epoch(0)
    assert set(idx) == {3, 4, 5}
    _equal_dicts(b, p_pre.collate([src[i] for i in idx]))
    (s,) = _take(p_data.make_synthetic_loader(
        torch_tiny().model, batch_size=2, n_frames=N_FRAMES,
        text_len=TEXT_LEN, n_items=6), 1)
    assert s["wav"].shape == (2, N_FRAMES * torch_tiny().model.audio
                              .hop_length)

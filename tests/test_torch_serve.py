"""The port's serving path against the JAX package, on the CPU.

The port's copies of ``utils/text.py`` and ``parallel/bucketing.py`` give
what the JAX modules give on seeded inputs.  The port's ``Server`` at
acceptance level 5's tiny settings (batch 2, buckets 64 and 128, 8
requests, mel only, fp32) against JAX's ``Server`` with the same weights
and the same initial noise (``jax.random.normal(PRNGKey(0), (B, K, d))``,
the draw JAX makes from the key it hands every batch): per uid, frames
equal and mel within 1e-4 (fp32 sums in another order through ~20 layers);
the style table within 1e-4, the cluster ids, the dispatch order and the
plan equal.  Then the requeue, which takes a batch that raises a
``RuntimeError`` and lets a ``ValueError`` or a kernel fault through, and
the host exchanges, identities on one process.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_tiny, random_tree, t, to_jax, torch_tiny
from styletts_zs_tpu.parallel import bucketing as j_bucketing
from styletts_zs_tpu.pipelines import serve as j_serve
from styletts_zs_tpu.utils import text as j_text
from styletts_zs_tpu.utils.config import ServeConfig as JServeConfig
from styletts_zs_torch.config import ServeConfig
from styletts_zs_torch.kernels.build import KernelError
from styletts_zs_torch.parallel import bucketing, collectives
from styletts_zs_torch.pipelines import serve
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.factory import init_params
from styletts_zs_torch.utils import text

ATOL = 1e-4
N_REQUESTS = 8
REPO = Path(__file__).resolve().parent.parent


# --- the copies --------------------------------------------------------------

def test_text_tables_equal():
    assert text.SYMBOLS == j_text.SYMBOLS
    assert text.SYMBOL_TO_ID == j_text.SYMBOL_TO_ID
    assert text.VOCAB_SIZE == j_text.VOCAB_SIZE
    for name in ("PAD_ID", "BOS_ID", "EOS_ID", "UNK_ID", "SIL_ID"):
        assert getattr(text, name) == getattr(j_text, name)


@pytest.mark.parametrize("bos_eos", [True, False])
def test_text_functions_match_jax(bos_eos):
    rng = np.random.default_rng(0)
    phones = [str(p) for p in rng.choice(j_text.SYMBOLS[5:], 30)] + \
        ["aa", "zh", "xyz", "."]
    assert text.phonemes_to_ids(phones, add_bos_eos=bos_eos) == \
        j_text.phonemes_to_ids(phones, add_bos_eos=bos_eos)
    for s in ("some request text", "Hello, World!?", "", "çé 123"):
        assert text.text_to_ids(s, add_bos_eos=bos_eos) == \
            j_text.text_to_ids(s, add_bos_eos=bos_eos)
    ids = text.text_to_ids("some request text", add_bos_eos=bos_eos)
    for length in (0, 5, len(ids), 64):
        assert text.pad_ids(ids, length) == j_text.pad_ids(ids, length)


BUCKETS = [(64, 128), (256, 512, 1024), bucketing.DEFAULT_FRAME_BUCKETS]


@pytest.mark.parametrize("buckets", BUCKETS)
@pytest.mark.parametrize("n", [0, 1, 37])
def test_bucketing_matches_jax(buckets, n):
    assert bucketing.DEFAULT_FRAME_BUCKETS == j_bucketing.DEFAULT_FRAME_BUCKETS
    assert bucketing.DEFAULT_TEXT_BUCKETS == j_bucketing.DEFAULT_TEXT_BUCKETS
    rng = np.random.default_rng(n)
    lengths = rng.integers(1, 2 * buckets[-1], n)
    for L in list(lengths) + [buckets[0], buckets[-1], buckets[-1] + 1]:
        assert bucketing.bucket_for(int(L), buckets) == \
            j_bucketing.bucket_for(int(L), buckets)
    hist = bucketing.bucket_histogram(lengths, buckets)
    np.testing.assert_array_equal(
        hist, j_bucketing.bucket_histogram(lengths, buckets))
    for batch in (1, 2, 32):
        got = bucketing.plan_buckets(hist, batch, buckets)
        ref = j_bucketing.plan_buckets(hist, batch, buckets)
        assert (got.buckets, got.batches_per_bucket, got.total_batches) == \
            (ref.buckets, ref.batches_per_bucket, ref.total_batches)
    got = bucketing.assign_to_buckets(lengths, buckets)
    ref = j_bucketing.assign_to_buckets(lengths, buckets)
    assert got.keys() == ref.keys()
    styles = rng.standard_normal((n, 6, 5)).astype(np.float32)
    cids = bucketing.style_cluster_ids(styles)
    np.testing.assert_array_equal(cids, j_bucketing.style_cluster_ids(styles))
    for b in got:
        np.testing.assert_array_equal(got[b], ref[b])
        np.testing.assert_array_equal(
            bucketing.mixed_speaker_order(got[b], cids),
            j_bucketing.mixed_speaker_order(ref[b], cids))
    arrays = [rng.standard_normal((int(L) % 7 + 1, 3)) for L in lengths]
    if arrays:
        np.testing.assert_array_equal(
            bucketing.pad_batch(arrays, 5, pad_value=-1),
            j_bucketing.pad_batch(arrays, 5, pad_value=-1))


# --- the server against JAX's --------------------------------------------------

def _level5_tiny(cfg, serve_cls):
    """Level 5's tiny settings (batch 2, buckets 64/128, mel only)."""
    return dataclasses.replace(cfg, serve=serve_cls(
        batch_size=2, one_step=True, with_vocoder=False,
        frame_buckets=(64, 128)))


def _requests(cls, cfg, n=N_REQUESTS):
    """Level 5's requests: the fixed text, 3 s of noise, a frame estimate."""
    rng = np.random.default_rng(0)
    sr = cfg.model.audio.sample_rate
    return [cls(uid=i,
                phonemes=np.asarray(text.text_to_ids("some request text"),
                                    np.int32),
                ref_wav=rng.standard_normal(3 * sr).astype(np.float32) * 0.1,
                est_frames=int(rng.integers(32, cfg.model.max_frames)))
            for i in range(n)]


@pytest.fixture(scope="module")
def served():
    torch.set_num_threads(1)
    jcfg = _level5_tiny(jax_tiny(), JServeConfig)
    tcfg = _level5_tiny(torch_tiny(), ServeConfig)
    tree = random_tree(jcfg)
    s, st = jcfg.serve, jcfg.model.style
    noise = np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (s.batch_size, st.n_codes, st.d_style)))
    j_server = j_serve.Server(jcfg, to_jax(tree))
    j_reqs = _requests(j_serve.Request, jcfg)
    ref = j_server.serve_batch(j_reqs)
    server = serve.Server(tcfg, convert_params(tree, tcfg), device="cpu",
                          noise=t(noise))
    reqs = _requests(serve.Request, tcfg)
    plan = server.plan(reqs)
    got = server.serve_batch(reqs)
    return {"ref": ref, "got": got, "reqs": reqs, "plan": plan,
            "j_plan": j_server.plan(j_reqs), "server": server,
            "j_server": j_server, "cfg": tcfg}


def test_server_matches_jax_per_uid(served):
    ref = {r.uid: r for r in served["ref"]}
    assert sorted(ref) == list(range(N_REQUESTS))
    assert not served["server"].requeued and not served["j_server"].requeued
    for r in served["got"]:
        assert r.wav is None and ref[r.uid].wav is None
        assert r.frames == ref[r.uid].frames > 0
        np.testing.assert_allclose(r.mel, np.asarray(ref[r.uid].mel, np.float32),
                                   atol=ATOL, rtol=0, err_msg=f"uid {r.uid}")


def test_server_style_table_and_order_match_jax(served):
    table = served["server"].last_style_table
    j_table = np.asarray(served["j_server"].last_style_table, np.float32)
    assert table.shape == j_table.shape == (N_REQUESTS, table.shape[1])
    np.testing.assert_allclose(table, j_table, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(bucketing.style_cluster_ids(table),
                                  j_bucketing.style_cluster_ids(j_table))
    assert [r.uid for r in served["got"]] == [r.uid for r in served["ref"]]


def test_server_plan_matches_jax_and_the_batches_served(served):
    plan, cfg = served["plan"], served["cfg"]
    assert plan.buckets == served["j_plan"].buckets
    assert plan.batches_per_bucket == served["j_plan"].batches_per_bucket
    est = {r.uid: r.est_frames for r in served["reqs"]}
    per_bucket = {}
    for r in served["got"]:
        b = bucketing.bucket_for(est[r.uid], cfg.serve.frame_buckets)
        per_bucket[b] = per_bucket.get(b, 0) + 1
    assert {b: -(-n // cfg.serve.batch_size) for b, n in per_bucket.items()} \
        == plan.batches_per_bucket
    assert len(served["got"]) == N_REQUESTS


def test_server_with_the_vocoder_in_bf16(served):
    """``configs/pod_v5e16.toml``'s setting, bf16 with the vocoder: every
    result holds a finite fp32 waveform of frames x hop samples (cut to the
    vocoder's (bucket x 25 - 1) x 4 where a request fills its bucket)."""
    cfg = served["cfg"]
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, compute_dtype="bfloat16"),
        serve=dataclasses.replace(cfg.serve, with_vocoder=True))
    server = serve.Server(cfg, convert_params(random_tree(jax_tiny()), cfg),
                          device="cpu")
    reqs = served["reqs"]
    results = server.serve_batch(reqs)
    assert sorted(r.uid for r in results) == list(range(N_REQUESTS))
    hop = cfg.model.audio.hop_length
    for r in results:
        bucket = bucketing.bucket_for(reqs[r.uid].est_frames,
                                      cfg.serve.frame_buckets)
        assert r.mel.dtype == r.wav.dtype == np.float32
        assert r.wav.shape == (min(r.frames * hop, (bucket * 25 - 1) * 4),)
        assert np.isfinite(r.wav).all() and np.isfinite(r.mel).all()


# --- the requeue and the exchanges ----------------------------------------------

@pytest.fixture(scope="module")
def tiny_server():
    torch.set_num_threads(1)
    cfg = _level5_tiny(torch_tiny(), ServeConfig)
    params = convert_params(random_tree(jax_tiny()), cfg)
    return serve.Server(cfg, params, device="cpu"), _requests(serve.Request,
                                                              cfg)


def _failing_first_batch(server, monkeypatch, exc):
    calls = []
    dispatch = server._dispatch

    def flaky(bucket, phon, tlen, refs, group):
        calls.append([r.uid for r in group])
        if len(calls) == 1:
            raise exc
        return dispatch(bucket, phon, tlen, refs, group)
    monkeypatch.setattr(server, "_dispatch", flaky)
    server.requeued = []
    return calls


def test_server_requeues_a_batch_that_raises_a_runtime_error(tiny_server,
                                                             monkeypatch):
    server, reqs = tiny_server
    calls = _failing_first_batch(
        server, monkeypatch, torch.cuda.OutOfMemoryError("out of memory"))
    results = server.serve_batch(reqs)
    assert [r.uid for r in server.requeued] == calls[0]
    assert sorted([r.uid for r in results] + calls[0]) == \
        list(range(N_REQUESTS))
    assert len(calls) == server.plan(reqs).total_batches


@pytest.mark.parametrize("exc", [ValueError("shape"), TypeError("type"),
                                 KernelError("istft_fwd: CUDA error 700")])
def test_server_lets_shape_errors_and_kernel_faults_through(tiny_server,
                                                            monkeypatch, exc):
    assert not isinstance(exc, RuntimeError)
    server, reqs = tiny_server
    _failing_first_batch(server, monkeypatch, exc)
    with pytest.raises(type(exc)):
        server.serve_batch(reqs)
    assert not server.requeued


def test_build_errors_are_not_runtime_errors():
    assert not issubclass(KernelError, RuntimeError)


def test_collectives_are_identities_on_one_process(monkeypatch):
    table = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    hist = np.array([3, 0, 2], np.int32)
    np.testing.assert_array_equal(collectives.process_concat_styles(table),
                                  table)
    np.testing.assert_array_equal(collectives.process_sum_histogram(hist),
                                  hist)
    # across processes they are not ported yet: no silently local table
    monkeypatch.setattr(collectives.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(collectives.dist, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError):
        collectives.process_concat_styles(table)
    with pytest.raises(NotImplementedError):
        collectives.process_sum_histogram(hist)


# --- chip_smoke.py's serve phase, rehearsed on the CPU ---------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_serve_rehearsal_on_cpu():
    """The function ``chip_smoke.py`` drives the serving path with, at tiny
    size on the CPU: the plain versions run, and the launches per call are
    those the bucket plan predicts — the 32-frame bucket's decoder attention
    is one chunk (full attention), the longer ones chunk-local — with the
    prompt encoder once per 64 references for the style table."""
    torch.set_num_threads(1)
    cs = _chip_smoke()
    cfg = dataclasses.replace(torch_tiny(), serve=ServeConfig(
        batch_size=2, one_step=True, with_vocoder=False,
        frame_buckets=(32, 64, 128)))
    params = init_params(cfg, seed=0, device="cpu")
    params["acoustic"]["duration_predictor.out.bias"].fill_(cs.DURATION_BIAS)
    server = serve.Server(cfg, params, device="cpu")
    reqs = cs.serve_requests(cfg, 8, est_frames=(20, 30, 40, 60, 70, 100,
                                                 120, 127))
    r = cs.drive_serve(server, reqs, n_calls=2, label="serve", card="cpu")
    # batches: 1 at 32, 1 at 64, 2 at 128; per batch 1 text + 1 prosody +
    # 1 prompt block, the pooling, 2 denoiser blocks' self- and
    # cross-attention (8), the decoder's attention block (full at 32,
    # local above); 2 blocks of 2 AdaIN passes; the style table: 1 chunk
    assert r["counts"]["full_attention"] == 2 * (4 * 8 + 1 + 2)
    assert r["counts"]["local_attention"] == 2 * 3
    assert r["counts"]["adain_conv"] == 2 * 4 * 4
    assert len(r["results"]) == 8 and not server.requeued
    # a plan off by one batch fails the run
    wrong = serve.Server(dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, batch_size=4)), params, device="cpu")
    wrong.plan = lambda reqs: server.plan(reqs)
    with pytest.raises(AssertionError):
        cs.drive_serve(wrong, reqs, n_calls=1, label="serve", card="cpu")


def test_chip_smoke_serve_requests_fill_their_buckets():
    """Level 5's full-size requests: estimates in [32, 1024), as many
    phonemes (BOS and EOS included) as should fill each estimate, within
    the 256-phoneme limit."""
    cs = _chip_smoke()
    cfg = cs.serve_config()
    assert (cfg.serve.batch_size, cfg.serve.frame_buckets) == \
        (32, (256, 512, 1024))
    reqs = cs.serve_requests(cfg, 64)
    for r in reqs:
        assert 32 <= r.est_frames < 1024 and r.ref_wav.shape == (72000,)
        assert r.phonemes[0] == text.BOS_ID and r.phonemes[-1] == text.EOS_ID
        assert len(r.phonemes) == np.clip(
            round(r.est_frames / cs.SERVE_FRAMES_PER_PHONEME), 3, 256)

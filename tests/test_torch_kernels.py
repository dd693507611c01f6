"""The port's kernel modules against the JAX package, on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against these plain versions there).  Here each plain version is held
against the Pallas kernel in interpret mode — on every row — and against the
XLA twin; chunk-local attention takes every length the JAX twin takes
(JAX's Pallas gate included), the synthesis head's gate is compared with
JAX's; and the routing and the wrappers' refusals are checked.
"""
import importlib.util
import shutil
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from styletts_zs_tpu.kernels import attention_kernel
from styletts_zs_tpu.kernels import dispatch as j_dispatch
from styletts_zs_tpu.kernels import vocoder_kernels
from styletts_zs_tpu.ops import attention as j_attn
from styletts_zs_torch.kernels import adain_conv as ac
from styletts_zs_torch.kernels import build, dispatch, plain
from styletts_zs_torch.kernels import conv_transpose as ct
from styletts_zs_torch.kernels import full_attention as fa
from styletts_zs_torch.kernels import istft as istft_k
from styletts_zs_torch.kernels import local_attention as la
from styletts_zs_torch.kernels import synthesis_head as head
from styletts_zs_torch.ops import attention as attn_ops
from styletts_zs_torch.ops.attention import NEG_INF

# fp32: the same sums in another order.  bf16: conv/probabilities rounded
# to bf16 at the same places, but a sum in another order can round one bf16
# step apart before exp() and the overlap-add (the bound chip_smoke.py uses).
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
# full attention: the output is rounded to bf16 at the same place (one bf16
# step is under 1e-2 + 1e-2 |x| at any |x|), as chip_smoke.py holds row 2
FULL_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rnd(*shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


# --- row 1: chunk-local attention -------------------------------------------

B, T, H, D, CHUNK = 3, 96, 2, 16, 32


def _attn_inputs(masked):
    q, k, v = (rnd(B, T, H, D, seed=s) for s in (1, 2, 3))
    lengths = np.array([T, 50, 0] if masked else [T] * B, np.int32)
    return q, k, v, lengths, np.arange(T)[None] < lengths[:, None]


@pytest.mark.parametrize("masked", [False, True])
def test_local_attention_plain_matches_pallas_on_all_rows(masked):
    q, k, v, lengths, mask = _attn_inputs(masked)
    ref = attention_kernel.local_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=CHUNK,
        kv_mask=jnp.asarray(mask) if masked else None)
    out = la.local_attention_plain(t(q), t(k), t(v), t(lengths), chunk=CHUNK)
    np.testing.assert_allclose(n(out), n(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_local_attention_plain_matches_twin_on_rows_with_a_key(masked):
    q, k, v, lengths, mask = _attn_inputs(masked)
    ref = n(j_attn.local_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), chunk=CHUNK,
                                   kv_mask=jnp.asarray(mask)))
    out = n(la.local_attention_plain(t(q), t(k), t(v), t(lengths),
                                     chunk=CHUNK))
    ci = np.arange(T) // CHUNK
    lo = np.maximum((ci - 1) * CHUNK, 0)
    has_key = lo[None, :] < lengths[:, None]            # (B, T) query rows
    assert has_key.any() and (masked == (not has_key.all()))
    np.testing.assert_allclose(out[has_key], ref[has_key], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("T_,chunk", [(96, 32), (1024, 256), (768, 256),
                                      (512, 256), (100, 25), (120, 12),
                                      (64, 32), (48, 16)])
def test_local_attention_gate_matches_jax(monkeypatch, T_, chunk):
    """JAX's gate is the test in ``local_attention_pallas`` (recorded by
    whether it reaches the Pallas call); the port has no such gate: every
    one of these lengths, inside JAX's gate or not (512 and 64 are two
    chunks, 100 and 120 chunks that are no multiple of 8), takes the
    local-attention kernel's route, its plain version here."""
    reached = []

    def impl(q, k, v, lengths, *, chunk):
        reached.append(True)
        return q

    monkeypatch.setattr(attention_kernel, "_local_attention_impl", impl)
    x = jnp.zeros((1, T_, 1, 8), jnp.float32)
    attention_kernel.local_attention_pallas(x, x, x, chunk=chunk)
    assert bool(reached) == (T_ >= 3 * chunk and chunk % 8 == 0)
    q = torch.zeros(1, T_, 1, 8)
    before = dict(dispatch.plain_calls)
    dispatch.local_attention(q, q, q, chunk=chunk)
    assert dispatch.plain_calls["local_attention"] == \
        before["local_attention"] + 1
    assert dispatch.plain_calls["full_attention"] == before["full_attention"]


@pytest.mark.parametrize("T_", [CHUNK // 2, CHUNK, 2 * CHUNK])
@pytest.mark.parametrize("masked", [False, True])
def test_local_attention_below_three_chunks_matches_twin(T_, masked):
    """T = c/2 and c (one chunk: full attention over the length, through
    the full-attention op) and 2c (the window is the whole sequence):
    the plain version and the dispatcher's route agree with the XLA twin on
    every row with a valid key, and with each other on all rows."""
    q, k, v = (rnd(B, T_, H, D, seed=s) for s in (21, 22, 23))
    lengths = np.array([T_, T_ // 2 + 1, 0] if masked else [T_] * B, np.int32)
    mask = np.arange(T_)[None] < lengths[:, None]
    ref = n(j_attn.local_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), chunk=CHUNK,
                                   kv_mask=jnp.asarray(mask)))
    out = n(la.local_attention_plain(t(q), t(k), t(v), t(lengths),
                                     chunk=CHUNK))
    has_key = np.broadcast_to((lengths > 0)[:, None], (B, T_))
    np.testing.assert_allclose(out[has_key], ref[has_key], atol=1e-5,
                               rtol=1e-5)
    before = dict(dispatch.plain_calls)
    routed = n(dispatch.local_attention(t(q), t(k), t(v), chunk=CHUNK,
                                        kv_mask=t(mask) if masked else None))
    np.testing.assert_allclose(routed, out, atol=1e-6, rtol=1e-6)
    one_chunk = T_ <= CHUNK
    assert dispatch.plain_calls["full_attention"] - \
        before["full_attention"] == int(one_chunk)
    assert dispatch.plain_calls["local_attention"] - \
        before["local_attention"] == int(not one_chunk)


def test_local_attention_raises_off_the_chunk_grid():
    """T > c that is no multiple of c: the XLA twin raises (an assert), so
    do the plain version and the CUDA wrapper."""
    q = t(rnd(1, CHUNK + 8, 1, 8, seed=24))
    lengths = t(np.array([CHUNK + 8], np.int32))
    with pytest.raises(ValueError):
        la.local_attention_plain(q, q, q, lengths, chunk=CHUNK)
    with pytest.raises(ValueError):
        dispatch.local_attention(q, q, q, chunk=CHUNK)
    with pytest.raises(ValueError):
        la.local_attention_cuda(q, q, q, lengths, chunk=CHUNK)


# --- row 2: full attention with a per-key mask --------------------------------

FB, FH, FD, TT, NP = 4, 2, 16, 40, 8      # keys: 40 text + 8 prompt


def _full_inputs(Tq, dtype):
    """q (4, Tq, 2, 16), k/v (4, 48, 2, 16); the denoiser's cross mask
    [text | padding | prompt] with text lengths 40, 9 and 0, and a row with
    no valid key at all."""
    q = rnd(FB, Tq, FH, FD, seed=11)
    k, v = (rnd(FB, TT + NP, FH, FD, seed=s) for s in (12, 13))
    text = np.arange(TT)[None] < np.array([TT, 9, 0, 0])[:, None]
    mask = np.concatenate([text, np.ones((FB, NP), bool)], axis=1)
    mask[3] = False
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    tx = [t(a).to(dtype) for a in (q, k, v)]
    return jx, tx, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq", [50, 128])
def test_full_attention_plain_matches_pallas_on_all_rows(dtype, Tq):
    jx, tx, mask = _full_inputs(Tq, dtype)
    ref = attention_kernel.full_attention_pallas(*jx,
                                                 kv_mask=jnp.asarray(mask))
    out = fa.full_attention_plain(*tx, t(mask))
    assert out.dtype == dtype and out.shape == (FB, Tq, FH, FD)
    atol, rtol = FULL_TOL[dtype]
    np.testing.assert_allclose(n(out), n(ref), atol=atol, rtol=rtol)
    # the row with no valid key averages all 48 keys, as Pallas does
    np.testing.assert_allclose(n(out)[3], np.broadcast_to(
        n(tx[2])[3].mean(0), (Tq, FH, FD)), atol=atol, rtol=rtol)
    # no mask: every key counts
    ref = attention_kernel.full_attention_pallas(*jx)
    np.testing.assert_allclose(n(fa.full_attention_plain(*tx)), n(ref),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_attention_plain_matches_twin_on_rows_with_a_key(dtype):
    jx, tx, mask = _full_inputs(50, dtype)
    ref = n(j_attn.cross_attention(*jx, kv_mask=jnp.asarray(mask)))
    out = n(fa.full_attention_plain(*tx, t(mask)))
    has_key = mask.any(-1)
    assert has_key.any() and not has_key.all()
    atol, rtol = FULL_TOL[dtype]
    np.testing.assert_allclose(out[has_key], ref[has_key], atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("Tq,Tk", [(50, 272), (256, 256), (240, 240),
                                   (16, 240), (512, 64), (600, 64),
                                   (640, 64), (64, 2048), (64, 2049)])
def test_full_attention_has_no_shape_gate(Tq, Tk):
    """Every shape, inside the Pallas kernel's gate or outside it (600 and
    640 queries, 2049 keys), takes the kernel's plain version on the CPU
    (the kernel on the card), and agrees with the XLA twin on rows with a
    key."""
    q = t(rnd(2, Tq, FH, FD, seed=15))
    k, v = (t(rnd(2, Tk, FH, FD, seed=s)) for s in (16, 17))
    mask = np.arange(Tk)[None] < np.array([Tk, 0])[:, None]
    before = dispatch.plain_calls["full_attention"]
    out = dispatch.full_attention(q, k, v, kv_mask=t(mask))
    assert dispatch.plain_calls["full_attention"] == before + 1
    assert torch.equal(out, fa.full_attention_plain(q, k, v, t(mask)))
    np.testing.assert_allclose(
        n(out)[0], n(attn_ops.cross_attention(q, k, v, kv_mask=t(mask)))[0],
        atol=FULL_TOL[torch.float32][0], rtol=FULL_TOL[torch.float32][1])


def test_full_attention_cpu_routing_and_cuda_refusal():
    _, tx, mask = _full_inputs(50, torch.float32)
    before = dict(dispatch.plain_calls)
    launches = fa.launches
    out = dispatch.full_attention(*tx, kv_mask=t(mask))
    assert torch.equal(out, fa.full_attention_plain(*tx, t(mask)))
    # 600 queries, outside the Pallas kernel's gate: the plain version too
    q = t(rnd(FB, 600, FH, FD, seed=14))
    assert torch.equal(dispatch.full_attention(q, *tx[1:], kv_mask=t(mask)),
                       fa.full_attention_plain(q, *tx[1:], t(mask)))
    assert dispatch.plain_calls["full_attention"] == \
        before["full_attention"] + 2
    assert fa.launches == launches
    with pytest.raises(ValueError):
        fa.full_attention_cuda(*tx, t(mask))


# --- row 12: fused synthesis head --------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_fft,hop,C", [(8, 4, 16), (48, 12, 16)])
def test_synthesis_head_plain_matches_pallas_and_twin(dtype, n_fft, hop, C):
    K, Tn, n_freq = 7, 40, n_fft // 2 + 1
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = rnd(2, Tn, C, seed=4, scale=0.5)
    w = rnd(K, C, 3 * n_freq, seed=5, scale=(K * C) ** -0.5)
    b = rnd(3 * n_freq, seed=6, scale=0.1)
    xj = jnp.asarray(x).astype(jdt)
    xt = t(x).to(dtype)
    assert torch.equal(xt.float(), t(np.asarray(xj.astype(jnp.float32))))
    out = n(head.synthesis_head_plain(xt, t(w), t(b), n_fft=n_fft, hop=hop))
    atol, rtol = TOL[dtype]
    for ref in (vocoder_kernels.synthesis_head_pallas(
                    xj, jnp.asarray(w), jnp.asarray(b), n_fft=n_fft, hop=hop),
                j_dispatch._synthesis_head_xla(
                    xj, jnp.asarray(w), jnp.asarray(b), n_fft=n_fft, hop=hop)):
        assert out.shape == ref.shape == (2, (Tn - 1) * hop)
        np.testing.assert_allclose(out, n(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("n_fft,hop,K", [(48, 12, 7), (8, 4, 7), (48, 12, 6),
                                         (256, 64, 7), (130, 64, 7),
                                         (16, 4, 3), (126, 2, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_synthesis_head_gate_matches_jax(n_fft, hop, K, dtype):
    jax_ok = vocoder_kernels.synthesis_head_supported(
        n_fft=n_fft, hop=hop, K=K, channels=128, dtype=getattr(jnp, dtype))
    assert head.supported(n_fft=n_fft, hop=hop, K=K,
                          dtype=getattr(torch, dtype)) == jax_ok


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [16, 128])
def test_synthesis_head_dispatch_takes_the_vocoders_view(dtype, C):
    """``dispatch.synthesis_head`` on the (B, C, T)-major view the vocoder
    hands over (a transpose of (B, C, T) memory, passed without a copy) on
    CPU tensors: the plain version, counted, equal to its result on the
    contiguous input, and both within the row's bound of
    ``synthesis_head_pallas`` in interpret mode (C 128: the bf16 kernel's
    geometry, K 7, n_fft 48, hop 12)."""
    n_fft, hop, K, Tn = 48, 12, 7, 40
    n_freq = n_fft // 2 + 1
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = rnd(2, C, Tn, seed=61, scale=0.5)
    w = rnd(K, C, 3 * n_freq, seed=62, scale=(K * C) ** -0.5)
    b = rnd(3 * n_freq, seed=63, scale=0.1)
    view = t(x).to(dtype).transpose(1, 2)
    assert view.stride(1) == 1 and not view.is_contiguous()
    before = dispatch.plain_calls["synthesis_head"]
    out = dispatch.synthesis_head(view, t(w), t(b), n_fft=n_fft, hop=hop)
    assert dispatch.plain_calls["synthesis_head"] == before + 1
    assert not plain.cuda_calls
    assert torch.equal(out, head.synthesis_head_plain(
        view.contiguous(), t(w), t(b), n_fft=n_fft, hop=hop))
    ref = vocoder_kernels.synthesis_head_pallas(
        jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1))).astype(jdt),
        jnp.asarray(w), jnp.asarray(b), n_fft=n_fft, hop=hop)
    atol, rtol = TOL[dtype]
    assert out.shape == ref.shape == (2, (Tn - 1) * hop)
    np.testing.assert_allclose(n(out), n(ref), atol=atol, rtol=rtol)


# --- routing and the wrappers ------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    q, k, v, lengths, mask = _attn_inputs(True)
    before = dict(dispatch.plain_calls)
    launches = (la.launches, head.launches)
    out = dispatch.local_attention(t(q), t(k), t(v), chunk=CHUNK,
                                   kv_mask=t(mask))
    np.testing.assert_array_equal(
        n(out), n(la.local_attention_plain(t(q), t(k), t(v), t(lengths),
                                           chunk=CHUNK)))
    x, w, b = rnd(1, 20, 8, seed=7), rnd(7, 8, 15, seed=8), rnd(15, seed=9)
    dispatch.synthesis_head(t(x), t(w), t(b), n_fft=8, hop=4)
    # two chunks, outside JAX's Pallas gate: the local kernel's plain
    # version all the same (there is no gate), counted
    dispatch.local_attention(t(q)[:, :64], t(k)[:, :64], t(v)[:, :64],
                             chunk=CHUNK)
    assert dispatch.plain_calls["local_attention"] == \
        before["local_attention"] + 2
    assert dispatch.plain_calls["synthesis_head"] == \
        before["synthesis_head"] + 1
    assert (la.launches, head.launches) == launches
    # none of them saw a CUDA tensor
    assert not plain.cuda_calls


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v, lengths, _ = _attn_inputs(False)
    with pytest.raises(ValueError):
        la.local_attention_cuda(t(q), t(k), t(v), t(lengths), chunk=CHUNK)
    x, w, b = rnd(1, 20, 8, seed=7), rnd(7, 8, 15, seed=8), rnd(15, seed=9)
    with pytest.raises(ValueError):
        head.synthesis_head_cuda(t(x), t(w), t(b), n_fft=8, hop=4)
    x, s = t(rnd(1, 20, 8, seed=7)), t(rnd(1, 20, 8, seed=10))
    mean, rstd = ac.instance_stats(x)
    with pytest.raises(ValueError):
        ac.adain_conv_pass_cuda(x, s, s, mean, rstd, t(rnd(5, 8, 8, seed=11)),
                                dilation=1)
    with pytest.raises(ValueError):
        ct.conv_transpose1d_cuda(x, t(rnd(10, 8, 8, seed=12)), stride=5)


def test_build_lists_every_source_and_names_the_target():
    names = [p.name for p in build.sources()]
    assert names == ["adain_conv.cu", "adain_conv_bwd.cu",
                     "conv_transpose.cu", "full_attention.cu", "istft.cu",
                     "local_attention.cu", "local_attention_bwd.cu",
                     "sampler.cu", "synthesis_head.cu"]
    assert [p.name for p in build.headers()] == ["attention_fwd_sm90.cuh",
                                                 "sm90.cuh"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for p in build.sources():
        src = p.read_text()
        assert "#include <torch" not in src and 'extern "C"' in src
    for p in build.headers():
        assert "#include <torch" not in p.read_text()


@pytest.mark.parametrize("edited", ["attention_fwd_sm90.cuh", "sm90.cuh",
                                    "local_attention.cu"])
def test_build_digest_covers_sources_and_headers(tmp_path, monkeypatch,
                                                 edited):
    """An edit to a header names a new library as an edit to a source does,
    so a stale build is never loaded; nvcc still compiles only the sources."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert all(p.suffix == ".cu" for p in build.sources())
    before = build.digest()
    assert build.digest() == before
    f = csrc / edited
    f.write_text(f.read_text() + "\n// edited\n")
    assert build.digest() != before


def test_build_loads_an_existing_library_with_its_log(tmp_path, monkeypatch):
    """A library built earlier is loaded with the nvcc log kept beside it,
    so a later process (``chip_smoke.py --against``) still prints its
    registers and spills; without the log it says so."""
    class FakeLib:
        def __getattr__(self, name):
            return types.SimpleNamespace()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    path = tmp_path / f"libstyletts_zs_kernels-{build.digest()}.so"
    path.write_bytes(b"")
    build.library.cache_clear()
    try:
        assert build.library().log == "loaded an existing build"
        build.library.cache_clear()
        path.with_suffix(".log").write_text("ptxas info : Used 209 registers")
        lib = build.library()
        assert "Used 209 registers" in lib.log and lib.build_seconds == 0.0
    finally:
        build.library.cache_clear()


# --- rows 1 and 2: the key tiles the bf16 kernels walk -----------------------

SKIP_CHUNK, SKIP_H, SKIP_D = 256, 2, 16
# attention over the walked tiles alone against the plain version over every
# key, fp32: the same nonzero terms summed over a shorter key axis
SKIP_ATOL = 1e-6


def _probs(logits):
    """The plain versions' probabilities from their masked logits."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


@pytest.mark.parametrize("T_", [2 * SKIP_CHUNK, 4 * SKIP_CHUNK])
@pytest.mark.parametrize("length", [0, 1, SKIP_CHUNK, 700, None])
def test_local_attention_skips_only_tiles_without_a_valid_key(T_, length):
    """Row 1: for each query chunk with a valid key, every key outside the
    tiles ``valid_key_tiles`` names has probability exactly 0.0 in the plain
    version, and attention over those tiles alone matches it; a chunk with
    none walks its whole clipped window."""
    length = T_ if length is None else length
    q, k, v = (t(rnd(1, T_, SKIP_H, SKIP_D, seed=s)) for s in (31, 32, 33))
    lengths = torch.tensor([length], dtype=torch.int32)
    logits, key = la._window(q, k, lengths, SKIP_CHUNK)   # (1, n, H, c, W)
    probs = _probs(logits)
    ref = la.local_attention_plain(q, k, v, lengths, chunk=SKIP_CHUNK)
    W = key.shape[1]
    n_valid = n_none = 0
    for ci in range(T_ // SKIP_CHUNK):
        first, n_tiles, has_key = la.valid_key_tiles(ci, T_, SKIP_CHUNK,
                                                     length)
        walked = (key[ci] >= first) & (key[ci] < first + 64 * n_tiles)
        band = (key[ci] >= (ci - 1) * SKIP_CHUNK) & \
            (key[ci] < (ci + 2) * SKIP_CHUNK)
        assert has_key == bool((band & (key[ci] < length)).any())
        assert int(walked.sum()) == 64 * n_tiles
        if has_key:
            n_valid += 1
            assert torch.all(probs[0, ci][..., ~walked] == 0.0)
            valid = (band & (key[ci] < length))[walked].reshape(n_tiles, 64)
            assert bool(valid.any(-1).all())     # no tile walked in vain
        else:
            n_none += 1
            assert n_tiles * 64 == W and bool(walked.all())
        p = _probs(logits[0, ci][..., walked])              # (H, c, walked)
        out = torch.einsum("hqk,khd->qhd", p, v[0, key[ci][walked]])
        rows = slice(ci * SKIP_CHUNK, (ci + 1) * SKIP_CHUNK)
        np.testing.assert_allclose(n(out), n(ref[0, rows]), atol=SKIP_ATOL,
                                   rtol=0)
    assert n_valid + n_none == T_ // SKIP_CHUNK
    assert n_valid == 0 if length == 0 else n_valid > 0


def _skip_masks(Tk, kind):
    """(3, Tk) key masks: lengths (0, 1, c, 700, Tk clipped) or the
    denoiser's [text | padding | prompt] with a row of no valid key."""
    if kind == "lengths":
        lens = np.array([0, 1, SKIP_CHUNK, min(700, Tk), Tk])
        return np.arange(Tk)[None] < lens[:, None]
    n_prompt = 16
    text = np.arange(Tk - n_prompt)[None] < np.array([0, 9, 200, 0])[:, None]
    mask = np.concatenate([text, np.ones((4, n_prompt), bool)], axis=1)
    mask[3] = False
    return mask


@pytest.mark.parametrize("Tk,kind", [(2 * SKIP_CHUNK, "lengths"),
                                     (4 * SKIP_CHUNK, "lengths"),
                                     (272, "text_prompt"), (240, None)])
def test_full_attention_skips_only_tiles_without_a_valid_key(Tk, kind):
    """Row 2: per batch row, the keys outside the tiles ``valid_key_tiles``
    names have probability exactly 0.0 in the plain version where the row
    has a valid key, and attention over those tiles alone matches it; a row
    with none (or no mask) walks every tile of the Tk keys."""
    mask = None if kind is None else t(_skip_masks(Tk, kind))
    B = 2 if mask is None else mask.shape[0]
    Tq = 50
    q = t(rnd(B, Tq, SKIP_H, SKIP_D, seed=34))
    k, v = (t(rnd(B, Tk, SKIP_H, SKIP_D, seed=s)) for s in (35, 36))
    ref = fa.full_attention_plain(q, k, v, mask)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * SKIP_D ** -0.5
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = _probs(logits)
    n_tiles = -(-Tk // 64)
    for b in range(B):
        row = None if mask is None else mask[b]
        tiles = fa.valid_key_tiles(row, Tk)
        walked = torch.zeros(n_tiles * 64, dtype=torch.bool)
        for tile in tiles:
            walked[64 * tile:64 * (tile + 1)] = True
        walked = walked[:Tk]
        if row is None or not bool(row.any()):
            assert tiles == list(range(n_tiles))
        else:
            assert all(bool(row[64 * i:64 * (i + 1)].any()) for i in tiles)
            assert torch.all(probs[b][..., ~walked] == 0.0)
        p = _probs(logits[b][..., walked])
        out = torch.einsum("hqk,khd->qhd", p, v[b, walked])
        np.testing.assert_allclose(n(out), n(ref[b]), atol=SKIP_ATOL, rtol=0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("T_", [64, 128, 256])
def test_local_attention_bound_counts_what_the_function_needs(T_):
    """chip_smoke's bound for rows 1 and 2 (through the local kernel's
    function): its bytes and FLOPs equal what the plain version's masked
    logits and probabilities show the function needs.  K where some query
    has a valid score; V where some query has a nonzero probability; Q for
    the queries with a valid key; every output; one int32 length a row;
    QK^T and PV over the valid pairs."""
    chunk, H, D = 64, 2, 16
    lens = [0, 1, 64, 100, T_]
    q, k = (t(rnd(len(lens), T_, H, D, seed=s)) for s in (41, 42))
    lengths = torch.tensor(lens, dtype=torch.int32)
    logits, key = la._window(q, k, lengths, chunk)     # (B, n, H, c, W)
    valid = logits[:, :, 0] != NEG_INF                  # (B, n, c, W)
    nonzero = (_probs(logits[:, :, 0]) > 0)
    rows = pairs = 0
    for b in range(len(lens)):
        k_keys = torch.zeros(T_, dtype=torch.bool)
        v_keys = torch.zeros(T_, dtype=torch.bool)
        for ci in range(key.shape[0]):
            k_keys[key[ci][valid[b, ci].any(0)]] = True
            v_keys[key[ci][nonzero[b, ci].any(0)]] = True
        n_q = int(valid[b].any(-1).sum())
        rows += n_q + int(k_keys.sum()) + int(v_keys.sum()) + T_
        pairs += int(valid[b].sum())
    want = (rows * H * D * 2 + 4 * len(lens), 4 * pairs * H * D)
    assert _chip_smoke()._attention_work(lengths, T_, H, D, chunk, 2) == want


def test_full_attention_bound_counts_what_the_function_needs():
    """The same for row 2 with the denoiser's [text | padding | prompt]
    mask and a row with no valid key, which reads V alone; the bool mask is
    read once."""
    H, D, Tq, Tk = 2, 16, 50, 272
    mask = t(_skip_masks(Tk, "text_prompt"))
    B = mask.shape[0]
    q = t(rnd(B, Tq, H, D, seed=43))
    k = t(rnd(B, Tk, H, D, seed=44))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).masked_fill(
        ~mask[:, None, None, :], NEG_INF)
    valid = logits[:, 0] != NEG_INF                     # (B, Tq, Tk)
    nonzero = _probs(logits[:, 0]) > 0
    rows = (int(valid.any(-1).sum()) + int(valid.any(1).sum())
            + int(nonzero.any(1).sum()) + B * Tq)
    want = (rows * H * D * 4 + B * Tk, 4 * int(valid.sum()) * H * D)
    assert _chip_smoke()._full_attention_work(q, k, mask) == want


def test_valid_key_tiles_refuse_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        la.valid_key_tiles(0, 96, 32, 96)        # chunk not a multiple of 64
    with pytest.raises(ValueError):
        la.valid_key_tiles(0, 256, 256, 256)     # one chunk: full attention


# --- rows 3-5: the local-attention forward with lse and its backward --------

TRAIN_CHUNK = 128


def _train_attn_inputs(T, *, zero_masked_rows):
    """(B 2, T, H 2, D 64) inputs; lengths T and 200, so at T 512 the last
    chunk's queries have no valid key; the cotangent zeroed on the query
    rows past the length (as the decoder zeroes them) or not."""
    B, H, D = 2, 2, 64
    q, k, v, g = (rnd(B, T, H, D, seed=s) for s in (21, 22, 23, 24))
    lengths = np.array([T, 200], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    if zero_masked_rows:
        g = g * mask[..., None, None]
    return q, k, v, g, lengths, mask


def _port_fwd_bwd(q, k, v, g, lengths, chunk):
    tq, tk, tv, tg, tl = (t(a) for a in (q, k, v, g, lengths))
    out, lse = la.local_attention_fwd_lse_plain(tq, tk, tv, tl, chunk=chunk)
    delta = (tg * out).sum(-1).transpose(1, 2).contiguous()
    dq = la.local_attention_bwd_dq_plain(tq, tk, tv, tg, lse, delta, tl,
                                         chunk=chunk)
    dk, dv = la.local_attention_bwd_dkv_plain(tq, tk, tv, tg, lse, delta, tl,
                                              chunk=chunk)
    return out, lse, dq, dk, dv


@pytest.mark.parametrize("T", [384, 512])
@pytest.mark.parametrize("zero_masked_rows", [False, True])
def test_local_attention_train_plain_matches_pallas(T, zero_masked_rows):
    """Rows 3, 4 and 5's plain versions against ``local_attention_fwd_pallas``
    and ``local_attention_bwd_pallas`` in interpret mode, on every row: the
    queries with no valid key included (p = 1 on their masked keys in both).
    fp32 sums of up to 3c products in another order: 1e-4."""
    q, k, v, g, lengths, mask = _train_attn_inputs(
        T, zero_masked_rows=zero_masked_rows)
    out_j, res = attention_kernel.local_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=TRAIN_CHUNK,
        kv_mask=jnp.asarray(mask))
    dq_j, dk_j, dv_j = attention_kernel.local_attention_bwd_pallas(
        res, jnp.asarray(g), chunk=TRAIN_CHUNK)
    out, lse, dq, dk, dv = _port_fwd_bwd(q, k, v, g, lengths, TRAIN_CHUNK)
    lse_j = np.asarray(res[4])[:, :, 0, :]
    assert (lse_j[1, :, 3 * TRAIN_CHUNK:] < -1e29).all()   # no valid key
    for got, ref in ((out, out_j), (lse, lse_j), (dq, dq_j), (dk, dk_j),
                     (dv, dv_j)):
        np.testing.assert_allclose(n(got), n(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("T", [384, 512])
def test_local_attention_fwd_lse_plain_on_rows_with_no_valid_key(T):
    """Row 3's plain version against ``local_attention_fwd_pallas`` in
    interpret mode on a length-0 row (every chunk without a valid key) and
    a length T - 2c (the last chunk without one): lse exactly -1e30 there,
    as the Pallas kernel gives it and rows 4-5 read it, and out the
    window's mean.  fp32: 1e-4."""
    B, H, D = 2, 2, 64
    q, k, v = (rnd(B, T, H, D, seed=s) for s in (31, 32, 33))
    lengths = np.array([0, T - 2 * TRAIN_CHUNK], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    out_j, res = attention_kernel.local_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=TRAIN_CHUNK,
        kv_mask=jnp.asarray(mask))
    lse_j = np.asarray(res[4])[:, :, 0, :]
    out, lse = la.local_attention_fwd_lse_plain(t(q), t(k), t(v), t(lengths),
                                                chunk=TRAIN_CHUNK)
    last = slice(T - TRAIN_CHUNK, T)
    for got in (n(lse), lse_j):
        assert (got[0] == np.float32(-1e30)).all()
        assert (got[1, :, last] == np.float32(-1e30)).all()
        assert (got[1, :, :T - TRAIN_CHUNK] > -1e29).all()
    np.testing.assert_allclose(n(out), n(out_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(n(lse), lse_j, atol=1e-4, rtol=1e-4)
    W = min(3 * TRAIN_CHUNK, T)
    np.testing.assert_allclose(n(out)[1, last], np.broadcast_to(
        v[1, T - W:].mean(0), (TRAIN_CHUNK, H, D)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T_", [128, 256])
def test_local_attention_train_bound_counts_what_the_function_needs(T_):
    """chip_smoke's bound for rows 3-5: the rows of q, k, v and g each
    plain version reads are those its output depends on (nonzero gradients
    on random inputs), plus the outputs, lse, delta and the lengths; the
    products are those of the nonzero probabilities p = exp(s - lse): 4D
    (row 3), 6D (row 4) or 8D (row 5) a valid pair, 4D a pair of a chunk
    with no valid key, where p = 1 whatever the scores (g V^T and dS K or
    dS^T Q; its P^T g is a sum)."""
    chunk, H, D = 64, 2, 16
    lens = [0, 1, chunk, 100, T_]
    B = len(lens)
    q, k, v, g = (t(rnd(B, T_, H, D, seed=s)) for s in (45, 46, 47, 48))
    lengths = torch.tensor(lens, dtype=torch.int32)
    out, lse = la.local_attention_fwd_lse_plain(q, k, v, lengths, chunk=chunk)
    delta = t(rnd(B, H, T_, seed=49))
    work = _chip_smoke()._attention_train_work(lengths, T_, H, D, chunk, 2)
    stat, lens_bytes = B * H * T_ * 4, 4 * B

    def rows_read(fn):
        xs = [a.clone().requires_grad_() for a in (q, k, v, g)]
        grads = torch.autograd.grad(
            sum((o * torch.linspace(1, 2, o.numel()).reshape(o.shape)).sum()
                for o in fn(*xs)), xs, allow_unused=True)
        return sum(0 if gr is None else int((gr != 0).any(-1).any(-1).sum())
                   for gr in grads)

    key_t = torch.arange(T_)
    band = ((key_t[:, None] // chunk) - (key_t[None, :] // chunk)).abs() <= 1
    key_ok = (key_t[None] < lengths[:, None])[:, None, None, :]  # (B,1,1,T)

    # row 4: dq over each query chunk's clipped window
    logits, _ = la._window(q, k, lengths, chunk)
    p = torch.exp(logits - la._per_chunk(lse, logits.shape[1]))
    valid = logits != NEG_INF
    rows = rows_read(lambda q_, k_, v_, g_: (la.local_attention_bwd_dq_plain(
        q_, k_, v_, g_, lse, delta, lengths, chunk=chunk),)) + B * T_
    flops = D * (6 * int(valid.sum()) + 4 * int(((p > 0) & ~valid).sum()))
    assert work["local_attention_bwd_dq"] == (
        rows * H * D * 2 + 2 * stat + lens_bytes, flops)

    # row 5: key chunk j against query chunks j-1..j+1, masked by length
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    s = s.masked_fill(~key_ok, NEG_INF)
    p = torch.exp(s - lse[..., None]) * band
    rows = rows_read(lambda q_, k_, v_, g_: la.local_attention_bwd_dkv_plain(
        q_, k_, v_, g_, lse, delta, lengths, chunk=chunk)) + 2 * B * T_
    flops = D * (8 * int(((p > 0) & key_ok).sum())
                 + 4 * int(((p > 0) & ~key_ok).sum()))
    assert work["local_attention_bwd_dkv"] == (
        rows * H * D * 2 + 2 * stat + lens_bytes, flops)

    # row 3: row 1's work and the lse written
    fwd = _chip_smoke()._attention_work(lengths, T_, H, D, chunk, 2)
    assert work["local_attention_fwd_lse"] == (fwd[0] + stat, fwd[1])


def test_local_attention_train_plain_matches_twin_vjp_at_two_chunks():
    """At T = 2c (outside the Pallas backward's gate) the plain versions
    against ``jax.vjp`` of the XLA twin, the cotangent zeroed on the query
    rows past the length (the twin averages zero-padded neighbours on rows
    with no valid key; the decoder zeroes those rows).  fp32: 1e-4."""
    T = 2 * TRAIN_CHUNK
    q, k, v, g, lengths, mask = _train_attn_inputs(T, zero_masked_rows=True)
    out_j, vjp = jax.vjp(
        lambda q, k, v: j_attn.local_attention(
            q, k, v, chunk=TRAIN_CHUNK, kv_mask=jnp.asarray(mask)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(g))
    out, _, *grads = _port_fwd_bwd(q, k, v, g, lengths, TRAIN_CHUNK)
    rows = mask[..., None, None] & np.ones_like(q, bool)
    np.testing.assert_allclose(n(out)[rows], n(out_j)[rows], atol=1e-4,
                               rtol=1e-4)
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(n(got), n(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("T", [256, 512])
def test_local_attention_function_routes_and_matches_twin_grads(T):
    """Through ``dispatch.local_attention`` with grad: rows 3-5's plain
    versions (counted) at T >= 2c, the full-attention Function with the
    twin's backward at T <= c; gradients equal to the twin's where the
    cotangent is live; under no_grad the inference route, unchanged."""
    chunk = TRAIN_CHUNK if T > TRAIN_CHUNK else T
    q, k, v, g, lengths, mask = _train_attn_inputs(T, zero_masked_rows=True)
    before = dict(dispatch.plain_calls)
    twins = dict(plain.twin_vjp_calls)
    xs = [t(a).requires_grad_() for a in (q, k, v)]
    out = dispatch.local_attention(*xs, chunk=chunk, kv_mask=t(mask))
    grads = torch.autograd.grad(out, xs, t(g))
    calls = {k_: dispatch.plain_calls[k_] - before[k_] for k_ in before}
    if T > chunk:
        assert calls["local_attention_fwd_lse"] == 1 and \
            calls["local_attention_bwd_dq"] == 1 and \
            calls["local_attention_bwd_dkv"] == 1
        assert calls["local_attention"] == 0
    else:
        assert calls["full_attention"] == 1
        assert plain.twin_vjp_calls.get("full_attention", 0) == \
            twins.get("full_attention", 0) + 1
    _, vjp = jax.vjp(
        lambda q, k, v: j_attn.local_attention(
            q, k, v, chunk=chunk, kv_mask=jnp.asarray(mask)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, ref in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(n(got), n(ref), atol=1e-4, rtol=1e-4)
    before = dict(dispatch.plain_calls)
    with torch.no_grad():
        dispatch.local_attention(*xs, chunk=chunk, kv_mask=t(mask))
    name = "local_attention" if T > chunk else "full_attention"
    assert {k_: dispatch.plain_calls[k_] - before[k_] for k_ in before} == \
        {k_: int(k_ == name) for k_ in before}


# --- rows 4 and 5: the tiles the bf16 backward kernels walk -----------------

# fp32: the walked tiles' sums against the plain version's over every key,
# the same nonzero terms in another order: within 1e-5 of the largest value
# (|dq| up to ~40 where p = 1 and g is live, sums of up to 3c terms that
# cancel)
BWD_SKIP_TOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(
        n(got), n(want), rtol=0,
        atol=BWD_SKIP_TOL * max(1.0, float(want.abs().max())))


def _bwd_skip_inputs(T_, length, zero_masked_rows):
    """(1, T, H 2, D 16) inputs with row 3's lse (-1e30 on the chunks with no
    valid key) and delta = sum_d g * out; g zeroed past the length or not."""
    q, k, v, g = (t(rnd(1, T_, SKIP_H, SKIP_D, seed=s))
                  for s in (51, 52, 53, 54))
    lengths = torch.tensor([length], dtype=torch.int32)
    if zero_masked_rows:
        g = g * (torch.arange(T_) < length)[None, :, None, None]
    out, lse = la.local_attention_fwd_lse_plain(q, k, v, lengths,
                                                chunk=SKIP_CHUNK)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, g, lse, delta, lengths


def _tile_terms(q_rows, k_rows, g_rows, v_rows, lse_q, delta_q, valid, ones):
    """p and dS (H, queries, keys) of one tile pair, as the kernels form
    them: scores masked to -1e30 before the exponent, or (``ones``) every
    key at -1e30 with no scores."""
    if ones:
        s = torch.full((SKIP_H, len(q_rows), len(k_rows)), NEG_INF)
    else:
        s = torch.einsum("qhd,khd->hqk", q_rows, k_rows) * SKIP_D ** -0.5
        s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - lse_q[..., None])
    dp = torch.einsum("qhd,khd->hqk", g_rows, v_rows)
    return p, p * (dp - delta_q[..., None])


@pytest.mark.parametrize("zero_masked_rows", [True, False])
@pytest.mark.parametrize("T_", [2 * SKIP_CHUNK, 4 * SKIP_CHUNK])
@pytest.mark.parametrize("length", [0, 1, SKIP_CHUNK, 700, None])
def test_local_attention_bwd_dq_walks_only_tiles_that_count(
        T_, length, zero_masked_rows):
    """Row 4: for each query chunk, the key tiles ``valid_key_tiles`` names.
    With a valid key, p and dS are exactly 0.0 in the plain version on every
    key of the window outside them; without one, every tile of the window
    is walked and p is exactly 1.0 on every key.  dq over the plan's tiles
    alone, with p taken without scores where there is no valid key, matches
    the plain version."""
    length = T_ if length is None else length
    q, k, v, g, lse, delta, lengths = _bwd_skip_inputs(T_, length,
                                                       zero_masked_rows)
    p, ds, key = la._bwd_dq_terms(q, k, v, g, lse, delta, lengths,
                                  SKIP_CHUNK)               # (1, n, H, c, W)
    ref = la.local_attention_bwd_dq_plain(q, k, v, g, lse, delta, lengths,
                                          chunk=SKIP_CHUNK)
    modes = set()
    for ci in range(T_ // SKIP_CHUNK):
        first, n_tiles, has_key = la.valid_key_tiles(ci, T_, SKIP_CHUNK,
                                                     length)
        walked = (key[ci] >= first) & (key[ci] < first + 64 * n_tiles)
        if has_key:
            modes.add("full")
            assert torch.all(p[0, ci][..., ~walked] == 0.0)
            assert torch.all(ds[0, ci][..., ~walked] == 0.0)
        else:
            modes.add("ones")
            assert bool(walked.all()) and torch.all(p[0, ci] == 1.0)
        rows = slice(ci * SKIP_CHUNK, (ci + 1) * SKIP_CHUNK)
        keys = key[ci][walked]
        band = (keys >= (ci - 1) * SKIP_CHUNK) & \
            (keys < (ci + 2) * SKIP_CHUNK)
        p_w, ds_w = _tile_terms(q[0, rows], k[0, keys], g[0, rows],
                                v[0, keys], lse[0, :, rows], delta[0, :, rows],
                                band & (keys < length), not has_key)
        dq = torch.einsum("hqk,khd->qhd", ds_w, k[0, keys]) * SKIP_D ** -0.5
        _close(dq, ref[0, rows])
    assert modes == ({"ones"} if length == 0 else
                     {"full", "ones"} if length <= T_ - 2 * SKIP_CHUNK
                     else {"full"})


@pytest.mark.parametrize("zero_masked_rows", [True, False])
@pytest.mark.parametrize("T_", [2 * SKIP_CHUNK, 4 * SKIP_CHUNK])
@pytest.mark.parametrize("length", [0, 1, SKIP_CHUNK, 700, None])
def test_local_attention_bwd_dkv_walks_only_tiles_that_count(
        T_, length, zero_masked_rows):
    """Row 5: for each key tile, the query tiles ``bwd_dkv_query_tiles``
    names, "full" or "ones".  Every (key tile, query tile) pair of chunks
    j-1..j+1 that the plan skips has p and dS exactly 0.0 in the plain
    version, every "ones" pair p exactly 1.0; a key tile's pairs are all of
    one mode (the kernel's walk); dk and dv over the plan alone match the
    plain version (exactly 0 where it walks nothing)."""
    length = T_ if length is None else length
    c, n_chunks = SKIP_CHUNK, T_ // SKIP_CHUNK
    q, k, v, g, lse, delta, lengths = _bwd_skip_inputs(T_, length,
                                                       zero_masked_rows)
    p, ds, _ = la._bwd_dkv_terms(q, k, v, g, lse, delta, lengths,
                                 c)                      # (1, n, H, 3c, c)
    ref_dk, ref_dv = la.local_attention_bwd_dkv_plain(
        q, k, v, g, lse, delta, lengths, chunk=c)
    counts = {"full": 0, "ones": 0, "skipped": 0}
    for k0 in range(0, T_, 64):
        j = k0 // c
        plan = dict(la.bwd_dkv_query_tiles(k0, T_, c, length))
        assert len(set(plan.values())) <= 1
        kk = slice(k0 - j * c, k0 - j * c + 64)
        for slot in range(3):
            i = j - 1 + slot
            for t0 in range(0, c, 64):
                pair_p = p[0, j, :, slot * c + t0:slot * c + t0 + 64, kk]
                pair_ds = ds[0, j, :, slot * c + t0:slot * c + t0 + 64, kk]
                mode = plan.get(i * c + t0) if 0 <= i < n_chunks else None
                if mode is None:
                    counts["skipped"] += 0 <= i < n_chunks
                    assert torch.all(pair_p == 0.0)
                    assert torch.all(pair_ds == 0.0)
                    continue
                counts[mode] += 1
                if mode == "ones":
                    assert torch.all(pair_p == 1.0)
        keys = torch.arange(k0, k0 + 64)
        dk = torch.zeros(64, SKIP_H, SKIP_D)
        dv = torch.zeros(64, SKIP_H, SKIP_D)
        for q0, mode in plan.items():
            rows = slice(q0, q0 + 64)
            p_w, ds_w = _tile_terms(q[0, rows], k[0, keys], g[0, rows],
                                    v[0, keys], lse[0, :, rows],
                                    delta[0, :, rows], keys < length,
                                    mode == "ones")
            dk += torch.einsum("hqk,qhd->khd", ds_w, q[0, rows]) \
                * SKIP_D ** -0.5
            dv += torch.einsum("hqk,qhd->khd", p_w, g[0, rows])
        for got, want in ((dk, ref_dk), (dv, ref_dv)):
            if not plan:
                assert torch.all(want[0, keys] == 0.0)
            _close(got, want[0, keys])
    assert counts["full"] == 0 if length == 0 else counts["full"] > 0
    assert counts["ones"] > 0 if length <= T_ - 2 * c else \
        counts["ones"] == 0


def test_bwd_dkv_query_tiles_refuse_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        la.bwd_dkv_query_tiles(0, 96, 32, 96)      # chunk not a multiple of 64
    with pytest.raises(ValueError):
        la.bwd_dkv_query_tiles(0, 256, 256, 256)   # one chunk
    with pytest.raises(ValueError):
        la.bwd_dkv_query_tiles(0, 640, 256, 640)   # T not a multiple of c
    with pytest.raises(ValueError):
        la.bwd_dkv_query_tiles(32, 512, 256, 512)  # not a tile's first key
    with pytest.raises(ValueError):
        la.bwd_dkv_query_tiles(512, 512, 256, 512)  # past T


# --- row 7: the AdaIN conv backward-data pass --------------------------------

def _bwd_data_inputs(B=2, T=300, C=16, C_out=24, K=5, seed=30):
    dc = rnd(B, T, C_out, seed=seed)
    x = rnd(B, T, C, seed=seed + 1)
    s = rnd(B, T, C, seed=seed + 2, scale=0.3)
    b = rnd(B, T, C, seed=seed + 3, scale=0.3)
    w = rnd(K, C, C_out, seed=seed + 4, scale=(K * C) ** -0.5)
    return dc, x, s, b, w


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_adain_bwd_data_plain_matches_pallas(dilation):
    """Row 7's plain version against ``_bwd_data_mod_pass`` in interpret
    mode (C 16 -> 24, so the transposed taps are not square).  fp32 sums
    of K * C_out products in another order: 1e-5."""
    from styletts_zs_tpu.kernels import decoder_kernels as dk
    dc, x, s, b, w = _bwd_data_inputs()
    mean, rstd = dk._instance_stats(jnp.asarray(x))
    ref = dk._bwd_data_mod_pass(jnp.asarray(dc), jnp.asarray(x),
                                jnp.asarray(s), jnp.asarray(b), mean, rstd,
                                jnp.asarray(w), dilation=dilation)
    out = ac.adain_conv_bwd_data_plain(t(dc), t(x), t(s), t(b), t(mean),
                                       t(rstd), t(w), dilation=dilation)
    np.testing.assert_allclose(n(out), n(ref), atol=1e-5, rtol=1e-5)
    # a global (B, C) style is the same function as its broadcast
    g_s, g_b = s[:, 0], b[:, 0]
    out_g = ac.adain_conv_bwd_data_plain(t(dc), t(x), t(g_s), t(g_b),
                                         t(mean), t(rstd), t(w),
                                         dilation=dilation)
    ref_g = dk._bwd_data_mod_pass(
        jnp.asarray(dc), jnp.asarray(x),
        jnp.broadcast_to(jnp.asarray(g_s)[:, None], x.shape),
        jnp.broadcast_to(jnp.asarray(g_b)[:, None], x.shape), mean, rstd,
        jnp.asarray(w), dilation=dilation)
    np.testing.assert_allclose(n(out_g), n(ref_g), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("tv_style", [False, True])
def test_adain_block_function_matches_jax_grad(dilation, tv_style):
    """The block's ``autograd.Function`` (row 6 forward, row 7 and the
    PyTorch steps backward; plain versions on the CPU) against ``jax.grad``
    of ``dispatch.adain_conv_block(use_pallas=True)`` (the XLA forward and
    the Pallas backward, interpret mode), for all five inputs.  fp32: the
    JAX package's own bound for these gradients, 2e-4."""
    B, T, C, K = 2, 96, 16, 5
    x = rnd(B, T, C, seed=40)
    shp = (B, T, 2 * C) if tv_style else (B, 2 * C)
    sc, sh = rnd(*shp, seed=41, scale=0.2), rnd(*shp, seed=42, scale=0.2)
    k1 = rnd(K, C, C, seed=43, scale=0.1)
    k2 = rnd(K, C, C, seed=44, scale=0.1)

    def f(x, sc, sh, k1, k2):
        y = j_dispatch.adain_conv_block(x, sc, sh, k1, k2, dilation=dilation,
                                        use_pallas=True)
        return jnp.sum(jnp.sin(y))

    refs = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, sc, sh, k1, k2)))
    xs = [t(a).requires_grad_() for a in (x, sc, sh, k1, k2)]
    before = dict(dispatch.plain_calls)
    y = dispatch.adain_conv_block(*xs, dilation=dilation)
    grads = torch.autograd.grad(torch.sin(y).sum(), xs)
    assert dispatch.plain_calls["adain_conv_bwd_data"] == \
        before["adain_conv_bwd_data"] + 2
    assert dispatch.plain_calls["adain_conv"] == before["adain_conv"] + 2
    for got, ref, name in zip(grads, refs, ["x", "scale", "shift", "k1",
                                            "k2"]):
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(n(got), n(ref), atol=2e-4, rtol=2e-4,
                                   err_msg=f"d{name}")


# --- rows 2, 10 and 12: kernel forward, the twin's gradient backward ---------

def test_full_attention_function_matches_jax_custom_vjp():
    """``FullAttention`` against JAX's custom VJP of the Pallas kernel
    (``_full_attention_ad``, backward through the XLA twin), a row with no
    valid key included.  fp32: 1e-5."""
    q, k, v = rnd(2, 50, 2, 16, seed=50), rnd(2, 70, 2, 16, seed=51), \
        rnd(2, 70, 2, 16, seed=52)
    mask = np.arange(70)[None] < np.array([[70], [0]])
    g = rnd(2, 50, 2, 16, seed=53)
    out_j, vjp = jax.vjp(
        lambda q, k, v: j_dispatch._full_attention_ad(True)(
            q, k, v, jnp.asarray(mask)),
        *(jnp.asarray(a) for a in (q, k, v)))
    xs = [t(a).requires_grad_() for a in (q, k, v)]
    out = dispatch.full_attention(*xs, kv_mask=t(mask))
    np.testing.assert_allclose(n(out), n(out_j), atol=1e-5, rtol=1e-5)
    for got, ref in zip(torch.autograd.grad(out, xs, t(g)),
                        vjp(jnp.asarray(g))):
        np.testing.assert_allclose(n(got), n(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("K,r", [(10, 5), (4, 2)])
def test_conv_transpose_function_matches_jax_custom_vjp(K, r):
    """``ConvTranspose`` with the fused leaky ReLU against JAX's custom VJP
    of the Pallas kernel (``_conv_transpose_ad``) after ``leaky_relu``, as
    the JAX vocoder calls it.  fp32: 1e-5."""
    x = rnd(2, 13, 8, seed=54)
    w = rnd(K, 8, 6, seed=55, scale=0.3)
    g = rnd(2, 13 * r, 6, seed=56)
    _, vjp = jax.vjp(
        lambda x, w: j_dispatch._conv_transpose_ad(r)(
            jax.nn.leaky_relu(x, 0.1), w), jnp.asarray(x), jnp.asarray(w))
    xs = [t(x).requires_grad_(), t(w).requires_grad_()]
    twins = plain.twin_vjp_calls.get("conv_transpose", 0)
    out = dispatch.conv_transpose1d(*xs, stride=r, negative_slope=0.1)
    grads = torch.autograd.grad(out, xs, t(g))
    assert plain.twin_vjp_calls["conv_transpose"] == twins + 1
    for got, ref in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(n(got), n(ref), atol=1e-5, rtol=1e-5)


def test_synthesis_head_function_matches_jax_custom_vjp():
    """``SynthesisHead`` against JAX's custom VJP of the fused head
    (``_synthesis_head_ad``, backward through the XLA composition).
    fp32: 1e-4 (the exp and rsqrt of the epilogue)."""
    n_fft, hop = 8, 4
    x = rnd(2, 20, 8, seed=57, scale=0.7)
    w = rnd(7, 8, 15, seed=58, scale=0.05)
    b = rnd(15, seed=59, scale=0.1)
    g = rnd(2, 19 * hop, seed=60)
    _, vjp = jax.vjp(j_dispatch._synthesis_head_ad(n_fft, hop),
                     *(jnp.asarray(a) for a in (x, w, b)))
    xs = [t(a).requires_grad_() for a in (x, w, b)]
    out = dispatch.synthesis_head(*xs, n_fft=n_fft, hop=hop)
    for got, ref in zip(torch.autograd.grad(out, xs, t(g)),
                        vjp(jnp.asarray(g))):
        np.testing.assert_allclose(n(got), n(ref), atol=1e-4, rtol=1e-4)


def test_training_wrappers_refuse_cpu_tensors():
    """Rows 3-5 and 7's CUDA wrappers raise on CPU tensors (no fallback)."""
    q, k, v, g, lengths, _ = _train_attn_inputs(256, zero_masked_rows=True)
    tq, tk, tv, tg, tl = (t(a) for a in (q, k, v, g, lengths))
    lse = torch.zeros(2, 2, 256)
    with pytest.raises(ValueError):
        la.local_attention_fwd_lse_cuda(tq, tk, tv, tl, chunk=TRAIN_CHUNK)
    with pytest.raises(ValueError):
        la.local_attention_bwd_dq_cuda(tq, tk, tv, tg, lse, lse, tl,
                                       chunk=TRAIN_CHUNK)
    with pytest.raises(ValueError):
        la.local_attention_bwd_dkv_cuda(tq, tk, tv, tg, lse, lse, tl,
                                        chunk=TRAIN_CHUNK)
    dc, x, s, b, w = (t(a) for a in _bwd_data_inputs())
    mean, rstd = ac.instance_stats(x)
    with pytest.raises(ValueError):
        ac.adain_conv_bwd_data_cuda(dc, x, s, b, mean, rstd, w, dilation=1)


# --- row 11: the standalone iSTFT overlap-add --------------------------------


def _spectra(n_fft, B=2, F=100, seed=70):
    n_freq = n_fft // 2 + 1
    return rnd(B, F, n_freq, seed=seed), rnd(B, F, n_freq, seed=seed + 1)


@pytest.mark.parametrize("n_fft,hop", [(16, 4), (48, 12)])
def test_istft_plain_and_dispatch_match_pallas(n_fft, hop):
    """Row 11's plain version and ``dispatch.istft_head`` on CPU tensors
    against ``istft_pallas`` in interpret mode (the super-frame kernel),
    within 2e-5 as the JAX package holds the kernel against its twin."""
    real, imag = _spectra(n_fft)
    ref = vocoder_kernels.istft_pallas(jnp.asarray(real), jnp.asarray(imag),
                                       n_fft=n_fft, hop=hop)
    before = dispatch.plain_calls["istft"]
    launches = istft_k.launches
    out = dispatch.istft_head(t(real), t(imag), n_fft=n_fft, hop=hop)
    assert dispatch.plain_calls["istft"] == before + 1
    assert istft_k.launches == launches and not plain.cuda_calls
    assert out.shape == ref.shape == (2, 99 * hop) and out.dtype == torch.float32
    np.testing.assert_allclose(n(out), n(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        n(istft_k.istft_plain(t(real), t(imag), n_fft=n_fft, hop=hop)),
        n(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n_fft,hop", [(16, 4), (48, 12)])
def test_istft_function_matches_jax_custom_vjp(n_fft, hop):
    """``ISTFT`` (through ``dispatch.istft_head`` with grad on) against
    ``jax.vjp`` of JAX's ``istft_head(use_pallas=True)``: the Pallas
    forward, the twin's gradient backward; one twin backward counted."""
    real, imag = _spectra(n_fft, F=40, seed=72)
    g = rnd(2, 39 * hop, seed=74)
    out_j, vjp = jax.vjp(
        lambda r, i: j_dispatch.istft_head(r, i, n_fft=n_fft, hop=hop,
                                           use_pallas=True),
        jnp.asarray(real), jnp.asarray(imag))
    xs = [t(a).requires_grad_() for a in (real, imag)]
    twins = plain.twin_vjp_calls.get("istft", 0)
    out = dispatch.istft_head(*xs, n_fft=n_fft, hop=hop)
    np.testing.assert_allclose(n(out), n(out_j), atol=2e-5, rtol=2e-5)
    grads = torch.autograd.grad(out, xs, t(g))
    assert plain.twin_vjp_calls["istft"] == twins + 1
    for got, ref in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(n(got), n(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n_fft,hop,FT,syn_shared", [
    (48, 12, 64, True), (16, 4, 64, True), (2048, 300, 22, False),
    (512, 100, 64, False), (48, 1, 64, True), (8, 16, 64, True)])
def test_istft_launch_geometry(n_fft, hop, FT, syn_shared):
    """Frames per block and where the basis lies: the spectra of FT + M - 1
    frames (and the basis, when it takes at most half) fit in 227 KB."""
    assert istft_k.launch_geometry(n_fft, hop) == (FT, syn_shared)
    row, M = 8 * (n_fft // 2 + 1), (n_fft - 1) // hop + 1
    assert (FT + M - 1) * row + syn_shared * row * n_fft <= 227 * 1024


def test_istft_wrapper_refuses_what_it_cannot_take():
    real, imag = _spectra(48, F=10)
    with pytest.raises(ValueError):            # CPU tensors
        istft_k.istft_cuda(t(real), t(imag), n_fft=48, hop=12)
    with pytest.raises(ValueError):            # one sample's frames too wide
        istft_k.launch_geometry(2048, 1)


# --- rows 6 and 12: the bf16 kernels' tile walks and bounds -----------------

_WALK_T = [2, 100, 1024, 4864, 25600, 121600]


@pytest.mark.parametrize("T_", _WALK_T)
@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_adain_conv_frame_tiles_write_every_frame_once(T_, dilation):
    """Row 6's bf16 kernel's frame tiles (its grid's x): every output frame
    lies in exactly one tile, each tile's window holds every row its
    frames' K 5 taps read (frame t reads t - halo .. t + halo), and the
    window fits the kernel's rows (at most 18 halo frames a side)."""
    K = 5
    halo = (K - 1) * dilation // 2
    seen = np.zeros(T_, np.int64)
    for t0, w0, rows in ac.frame_tiles(T_, K, dilation):
        frames = np.arange(t0, min(t0 + ac.SM90_FRAMES, T_))
        seen[frames] += 1
        assert w0 <= frames[0] - halo and frames[-1] + halo < w0 + rows
        assert rows <= ac.SM90_FRAMES + 2 * ac.SM90_MAX_HALO
    assert (seen == 1).all()


@pytest.mark.parametrize("T_", _WALK_T)
@pytest.mark.parametrize("B,n_sm", [(1, 132), (4, 132), (32, 132), (3, 7)])
def test_synthesis_head_walk_writes_every_sample_once(T_, B, n_sm):
    """Row 12's bf16 kernel's persistent walk (``sm90_walk``): block g takes
    tiles g, g + grid, ...; tile i writes the samples of output frames
    (i % tiles_per_row) * 120 .. + 119 of batch row i // tiles_per_row that
    land in the trimmed output (frame f's samples are f * 12 + phase - 24),
    so every sample of every row is written exactly once, and no block is
    left without a tile."""
    hop, start, FT = 12, 24, head.SM90_TILE_FRAMES
    out_len = (T_ - 1) * hop
    tiles_per_row, n_tiles, grid = head.sm90_walk(B, T_, n_sm)
    assert n_tiles == B * tiles_per_row and 1 <= grid <= min(n_tiles, n_sm)
    seen = np.zeros((B, out_len), np.int64)
    phases = np.arange(hop)
    for g in range(grid):
        tiles = np.arange(g, n_tiles, grid)
        assert tiles.size
        for tile in tiles:
            f0 = (tile % tiles_per_row) * FT
            s_out = ((np.arange(f0, f0 + FT)[:, None] * hop + phases)
                     .ravel() - start)
            s_out = s_out[(s_out >= 0) & (s_out < out_len)]
            seen[tile // tiles_per_row, s_out] += 1
    assert (seen == 1).all()


def test_synthesis_head_takes_sm90_only_at_the_vocoders_geometry():
    kw = dict(C=128, K=7, n_fft=48, hop=12, T=25600)
    assert head.takes_sm90(torch.bfloat16, **kw)
    assert not head.takes_sm90(torch.float32, **kw)
    for change in (dict(C=64), dict(K=5), dict(n_fft=8, hop=4), dict(T=100)):
        assert not head.takes_sm90(torch.bfloat16, **{**kw, **change})


@pytest.mark.parametrize("T_", [2, 7, 40, 300])
@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("tv", [True, False])
def test_adain_conv_bound_counts_what_the_function_needs(T_, dilation, tv):
    """chip_smoke's bound for row 6 (``_adain_work``): the bytes of x, of
    the scale and shift as given (a global style is one (C) row a batch
    row), of the fp32 statistics and the weight, read once, and of y,
    written once; the FLOPs of the products whose input row the plain
    version's shifts take from inside [0, T) (``shifted`` of ones)."""
    B, C, C_out, K = 2, 16, 32, 5
    x = torch.zeros(B, T_, C, dtype=torch.bfloat16)
    style = torch.zeros(*((B, T_, 4 * C) if tv else (B, 4 * C)),
                        dtype=torch.bfloat16)
    sc, sh = style[..., :C], style[..., 2 * C:3 * C]
    w = torch.zeros(K, C, C_out, dtype=torch.bfloat16)
    halo = (K - 1) * dilation // 2
    ones = torch.ones(1, T_, 1)
    pairs = sum(int(ac.shifted(ones, k * dilation - halo).sum())
                for k in range(K))
    style_elems = B * (T_ if tv else 1) * C
    want_bytes = ((B * T_ * C + 2 * style_elems + K * C * C_out
                   + B * T_ * C_out) * 2 + 2 * B * C * 4)
    assert _chip_smoke()._adain_work(x, sc, sh, w, dilation) == \
        (want_bytes, 2 * B * pairs * C * C_out)


@pytest.mark.parametrize("T_", [2, 5, 40, 301])
def test_synthesis_head_bound_counts_what_the_function_needs(T_):
    """chip_smoke's bound for row 12 (``_synthesis_head_work``): the bytes
    of x, the weight and bias (in x's dtype), the fp32 synthesis basis and
    inverse envelope, read once, and of the fp32 waveform, written once;
    the FLOPs of the head conv's (frame, tap) pairs with the input row
    inside [0, T) and of the overlap-add's (frame, basis sample) pairs
    whose sample lands in the trimmed output, counted one by one."""
    B, C, K, n_fft, hop = 3, 16, 7, 48, 12
    n_freq, out_len = n_fft // 2 + 1, (T_ - 1) * hop
    conv = sum(0 <= t_ + k - (K - 1) // 2 < T_
               for t_ in range(T_) for k in range(K))
    ola = sum(0 <= f * hop + m - n_fft // 2 < out_len
              for f in range(T_) for m in range(n_fft))
    want_bytes = ((B * T_ * C + K * C * 3 * n_freq + 3 * n_freq) * 2
                  + (2 * n_freq * n_fft + out_len + n_fft) * 4
                  + B * out_len * 4)
    want_flops = 2 * B * conv * C * 3 * n_freq + 2 * B * ola * 2 * n_freq
    assert _chip_smoke()._synthesis_head_work(B, T_, C, K, n_fft, hop, 2) \
        == (want_bytes, want_flops)
    assert len(head.ola_constants(n_fft, hop, T_, torch.device("cpu"))[1]) \
        == out_len + n_fft


def test_adain_conv_bf16_wrapper_refuses_what_the_kernel_cannot_take():
    """Row 6's bf16 shape rule (``_check_sm90``): K 5, halo <= 18, C % 16,
    C_out % 128 (a block of 256 channels where C_out % 256 == 0, else of
    128: a tensor-parallel chunk), scale and shift of one kind."""
    sc = torch.zeros(2, 4, 512)
    ok = torch.zeros(5, 512, 512)
    ac._check_sm90(sc, sc, ok, 9)
    ac._check_sm90(sc[:, 0], sc[:, 0], ok, 1)
    ac._check_sm90(sc, sc, torch.zeros(5, 512, 128), 1)
    assert [ac.sm90_tile(c) for c in (512, 256, 384, 128)] == \
        [256, 256, 128, 128]
    for s1, s2, w, d in ((sc, sc, ok, 11), (sc, sc, torch.zeros(7, 512, 512), 1),
                         (sc, sc, torch.zeros(3, 512, 512), 1),
                         (sc, sc, torch.zeros(5, 8, 512), 1),
                         (sc, sc, torch.zeros(5, 512, 64), 1),
                         (sc, sc[:, 0], ok, 1)):
        with pytest.raises(ValueError):
            ac._check_sm90(s1, s2, w, d)

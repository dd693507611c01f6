"""The port's kernel modules against the JAX package, on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against these plain versions there).  Here each plain version is held
against the Pallas kernel in interpret mode — on every row — and against the
XLA twin; chunk-local attention takes every length the JAX twin takes
(JAX's Pallas gate included), the synthesis head's gate is compared with
JAX's; and the routing and the wrappers' refusals are checked.
"""
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
from styletts_zs_torch.kernels import local_attention as la
from styletts_zs_torch.kernels import synthesis_head as head
from styletts_zs_torch.ops import attention as attn_ops

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
    assert names == ["adain_conv.cu", "conv_transpose.cu",
                     "full_attention.cu", "local_attention.cu", "sampler.cu",
                     "synthesis_head.cu"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for p in build.sources():
        src = p.read_text()
        assert "#include <torch" not in src and 'extern "C"' in src

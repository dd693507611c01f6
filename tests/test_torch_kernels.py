"""The port's two kernel modules against the JAX package, on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against these plain versions there).  Here each plain version is held
against the Pallas kernel in interpret mode — on every row — and against the
XLA twin; the gates are compared with the JAX gates; and the routing and the
wrappers' refusals are checked.
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
from styletts_zs_torch.kernels import build, dispatch
from styletts_zs_torch.kernels import local_attention as la
from styletts_zs_torch.kernels import synthesis_head as head

# fp32: the same sums in another order.  bf16: conv/probabilities rounded
# to bf16 at the same places, but a sum in another order can round one bf16
# step apart before exp() and the overlap-add (the bound chip_smoke.py uses).
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}


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
    """The JAX gate is the test in ``local_attention_pallas``: record
    whether it reaches the Pallas call."""
    reached = []

    def impl(q, k, v, lengths, *, chunk):
        reached.append(True)
        return q

    monkeypatch.setattr(attention_kernel, "_local_attention_impl", impl)
    x = jnp.zeros((1, T_, 1, 8), jnp.float32)
    attention_kernel.local_attention_pallas(x, x, x, chunk=chunk)
    assert la.supported(T_, chunk) == bool(reached)


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
    # outside the gate: the twin / plain op, not counted as a kernel call
    dispatch.local_attention(t(q)[:, :64], t(k)[:, :64], t(v)[:, :64],
                             chunk=CHUNK)
    assert dispatch.plain_calls["local_attention"] == \
        before["local_attention"] + 1
    assert dispatch.plain_calls["synthesis_head"] == \
        before["synthesis_head"] + 1
    assert (la.launches, head.launches) == launches


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v, lengths, _ = _attn_inputs(False)
    with pytest.raises(ValueError):
        la.local_attention_cuda(t(q), t(k), t(v), t(lengths), chunk=CHUNK)
    x, w, b = rnd(1, 20, 8, seed=7), rnd(7, 8, 15, seed=8), rnd(15, seed=9)
    with pytest.raises(ValueError):
        head.synthesis_head_cuda(t(x), t(w), t(b), n_fft=8, hop=4)


def test_build_lists_every_source_and_names_the_target():
    names = [p.name for p in build.sources()]
    assert names == ["local_attention.cu", "synthesis_head.cu"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for p in build.sources():
        src = p.read_text()
        assert "#include <torch" not in src and 'extern "C"' in src

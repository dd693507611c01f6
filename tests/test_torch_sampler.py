"""The port's multi-step sampler against the JAX package, on the CPU.

The Karras schedule array for array; the sampler kernels' plain versions
against the Pallas kernels in interpret mode; ``StyleDiffusion.sample``
against JAX's with the same weights and the same initial noise
(``jax.random.normal(rng, (B, K, d))`` handed over); the routing of the
step tail; and the CPU rehearsal of ``chip_smoke.py``'s multi-step phase.
The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against these plain versions there).
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
from styletts_zs_tpu.kernels import sampler_kernel
from styletts_zs_tpu.models import diffusion as j_diffusion
from styletts_zs_torch.kernels import dispatch
from styletts_zs_torch.kernels import sampler
from styletts_zs_torch.models.diffusion import karras_sigmas
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.factory import build_models, init_params
from styletts_zs_torch.pipelines.infer import make_synthesis_fn

REPO = Path(__file__).resolve().parent.parent
# the step tail: the same fp32 operations in the same order, with FMAs where
# XLA fuses them; the room is for a rare double rounding of the plain
# version's fp64 FMA
STEP_TOL = dict(atol=1e-6, rtol=1e-6)
# the sampler through 2 n_steps - 1 denoiser calls: fp32 sums in another
# order through a few layers per call
SAMPLE_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("n_steps", [1, 4, 16])
def test_karras_sigmas_equal_jax(n_steps):
    for cfg in (jax_tiny().model.diffusion,
                dataclasses.replace(jax_tiny().model.diffusion, rho=5.0,
                                    sigma_min=0.01)):
        ref = j_diffusion.karras_sigmas(cfg, n_steps)
        out = karras_sigmas(cfg, n_steps)
        assert out.dtype == ref.dtype == np.float32
        assert out.shape == (n_steps + 1,) and out[-1] == 0
        np.testing.assert_array_equal(out, ref)


# --- rows 8 and 9: the Euler and Heun kernels --------------------------------

SHAPE = (3, 10, 32)


def _step_inputs(seed, s_cur):
    rs = np.random.default_rng(seed)
    x = (rs.standard_normal(SHAPE) * s_cur).astype(np.float32)
    den2 = rs.standard_normal((2 * SHAPE[0], *SHAPE[1:])).astype(np.float32)
    xe = (x + rs.standard_normal(SHAPE)).astype(np.float32)
    d1 = rs.standard_normal(SHAPE).astype(np.float32)
    return x, den2, xe, d1


SIGMAS = karras_sigmas(jax_tiny().model.diffusion, 4)


@pytest.mark.parametrize("i", [0, 2, 3])
def test_euler_step_plain_matches_pallas(i):
    s_cur, s_next = SIGMAS[i], SIGMAS[i + 1]
    x, den2, _, _ = _step_inputs(i, s_cur)
    B = SHAPE[0]
    ref_x, ref_d = sampler_kernel.fused_euler_step(
        jnp.asarray(x), jnp.asarray(den2[:B]), jnp.asarray(den2[B:]),
        jnp.float32(s_cur), jnp.float32(s_next), guidance=3.0)
    d2 = t(den2)
    out_x, out_d = sampler.euler_step_plain(t(x), d2[:B], d2[B:], s_cur,
                                            s_next, guidance=3.0)
    assert out_x.dtype == out_d.dtype == torch.float32
    np.testing.assert_allclose(n(out_x), n(ref_x), **STEP_TOL)
    np.testing.assert_allclose(n(out_d), n(ref_d), **STEP_TOL)


@pytest.mark.parametrize("i", [0, 2])
def test_heun_correction_plain_matches_pallas(i):
    s_cur, s_next = SIGMAS[i], SIGMAS[i + 1]
    x, den2, xe, d1 = _step_inputs(10 + i, s_cur)
    B = SHAPE[0]
    ref = sampler_kernel.fused_heun_correction(
        jnp.asarray(x), jnp.asarray(xe), jnp.asarray(den2[:B]),
        jnp.asarray(den2[B:]), jnp.asarray(d1), jnp.float32(s_cur),
        jnp.float32(s_next), guidance=2.5)
    d2 = t(den2)
    out = sampler.heun_correction_plain(t(x), t(xe), d2[:B], d2[B:], t(d1),
                                        s_cur, s_next, guidance=2.5)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(n(out), n(ref), **STEP_TOL)


def test_sampler_gate_takes_fp32_alike_tensors_and_raises_otherwise():
    x = torch.zeros(SHAPE)
    sampler.check_operands(x, torch.zeros(SHAPE), torch.ones(SHAPE))
    den2 = torch.zeros(2 * SHAPE[0], *SHAPE[1:])
    sampler.check_operands(x, den2[:SHAPE[0]], den2[SHAPE[0]:])
    for bad in (x.to(torch.bfloat16), torch.zeros(SHAPE[0], 9, SHAPE[2]),
                torch.zeros(SHAPE[2], SHAPE[1], SHAPE[0]).permute(2, 1, 0)):
        with pytest.raises(ValueError):
            sampler.check_operands(x, bad)
        with pytest.raises(ValueError):
            dispatch.fused_euler_step(x, bad, x, 1.0, 0.5, guidance=3.0)
    with pytest.raises(ValueError):
        sampler.euler_step_cuda(x, x, x, 1.0, 0.5, guidance=3.0)
    with pytest.raises(ValueError):
        sampler.heun_correction_cuda(x, x, x, x, x, 1.0, 0.5, guidance=3.0)


def test_cpu_step_tail_takes_the_plain_versions():
    x, den2, xe, d1 = _step_inputs(5, SIGMAS[0])
    d2 = t(den2)
    B = SHAPE[0]
    before = dict(dispatch.plain_calls)
    launches = dict(sampler.launches)
    xo, d = dispatch.fused_euler_step(t(x), d2[:B], d2[B:], SIGMAS[0],
                                      SIGMAS[1], guidance=3.0)
    ref = sampler.euler_step_plain(t(x), d2[:B], d2[B:], SIGMAS[0],
                                   SIGMAS[1], guidance=3.0)
    assert torch.equal(xo, ref[0]) and torch.equal(d, ref[1])
    out = dispatch.fused_heun_correction(t(x), t(xe), d2[:B], d2[B:], t(d1),
                                         SIGMAS[0], SIGMAS[1], guidance=3.0)
    assert torch.equal(out, sampler.heun_correction_plain(
        t(x), t(xe), d2[:B], d2[B:], t(d1), SIGMAS[0], SIGMAS[1],
        guidance=3.0))
    assert dispatch.plain_calls["sampler_euler"] == \
        before["sampler_euler"] + 1
    assert dispatch.plain_calls["sampler_heun"] == before["sampler_heun"] + 1
    assert sampler.launches == launches


# --- the sampler against JAX's ------------------------------------------------

@pytest.fixture(scope="module")
def diffusion_world():
    torch.set_num_threads(1)
    jcfg, tcfg = jax_tiny(), torch_tiny()
    tree = random_tree(jcfg)
    port = build_models(tcfg, convert_params(tree, tcfg), device="cpu")
    m = jcfg.model
    rs = np.random.default_rng(2)
    B, Tt, P = 2, 16, 4
    data = {"text_enc": rs.standard_normal((B, Tt, 64)).astype(np.float32),
            "tokens": rs.standard_normal((B, P, 64)).astype(np.float32),
            "summary": rs.standard_normal((B, 64)).astype(np.float32),
            "text_mask": np.arange(Tt)[None] < np.array([Tt, 9])[:, None]}
    return m, to_jax(tree), port.diffusion, data


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sample_matches_jax(diffusion_world, use_pallas):
    """Heun over 4 steps: 7 CFG-doubled denoiser calls; JAX with its XLA
    twins, and with its Pallas sampler kernels in interpret mode."""
    m, p, port, d = diffusion_world
    rng = jax.random.PRNGKey(11)
    J = {k: jnp.asarray(v) for k, v in d.items()}
    ref = j_diffusion.StyleDiffusion(
        m.diffusion, m.style, ctx_dim=m.text_encoder.dim,
        use_pallas=use_pallas).apply(
        p["diffusion"], rng, J["text_enc"], J["tokens"], J["summary"],
        text_mask=J["text_mask"], n_steps=4,
        method=j_diffusion.StyleDiffusion.sample)
    noise = jax.random.normal(rng, (2, m.style.n_codes, m.style.d_style))
    before = dict(dispatch.plain_calls)
    with torch.inference_mode():
        out = port.sample(t(noise), t(d["text_enc"]), t(d["tokens"]),
                          t(d["summary"]), text_mask=t(d["text_mask"]),
                          n_steps=4)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(n(out), n(ref), **SAMPLE_TOL)
    calls = {k: dispatch.plain_calls[k] - before[k] for k in before}
    # 4 Euler steps, 3 corrections, 7 denoiser calls of 2 blocks with a
    # self- and a cross-attention each
    assert calls == {"local_attention": 0, "synthesis_head": 0,
                     "full_attention": 7 * 2 * 2, "sampler_euler": 4,
                     "sampler_heun": 3, "adain_conv": 0,
                     "conv_transpose": 0, "local_attention_fwd_lse": 0,
                     "local_attention_bwd_dq": 0,
                     "local_attention_bwd_dkv": 0,
                     "adain_conv_bwd_data": 0, "istft": 0}


def test_sample_one_step_schedule_and_generator_noise(diffusion_world):
    """n_steps = 1: one Euler step to sigma 0, no correction; a generator
    draws the noise reproducibly."""
    _, _, port, d = diffusion_world
    args = (t(d["text_enc"]), t(d["tokens"]), t(d["summary"]))
    before = dict(dispatch.plain_calls)
    with torch.inference_mode():
        a = port.sample(torch.Generator().manual_seed(1), *args,
                        text_mask=t(d["text_mask"]), n_steps=1)
        b = port.sample(torch.Generator().manual_seed(1), *args,
                        text_mask=t(d["text_mask"]), n_steps=1)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert dispatch.plain_calls["sampler_euler"] - \
        before["sampler_euler"] == 2
    assert dispatch.plain_calls["sampler_heun"] == before["sampler_heun"]


# --- chip_smoke.py's multi-step phase, rehearsed on the CPU -------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# inference launches none of the training kernels (rows 3-5 and 7)
TRAIN_KERNELS_UNUSED = {"local_attention_fwd_lse": 0,
                        "local_attention_bwd_dq": 0,
                        "local_attention_bwd_dkv": 0,
                        "adain_conv_bwd_data": 0}


def test_chip_smoke_multistep_rehearsal_on_cpu():
    """The multi-step phase's drive at tiny size on the CPU: the plain versions
    run, the per-call counts (derived from the config and the local
    attention gate) are
    checked, and a path whose kernel is launched no time fails the run."""
    cs = _chip_smoke()
    cfg = torch_tiny()
    params = cs.with_denoiser_gates(init_params(cfg, seed=0, device="cpu"))
    params["acoustic"]["duration_predictor.out.bias"].fill_(cs.DURATION_BIAS)
    kw = dict(one_step=False, n_steps=3, with_vocoder=False)
    fn = make_synthesis_fn(cfg, params, device="cpu", **kw)
    inputs = cs.synth_inputs(cfg, 2, "cpu")
    r = cs.drive_main_path(cfg, fn, inputs, device="cpu", n_calls=1, **kw)
    # tiny: 1 text + 1 prosody block at 64 phonemes, 1 prompt encoder block
    # at 720 frames (outside the Pallas kernel's gate; full attention has
    # none here), its 4-query pooling, and 5 denoiser calls x 2 blocks x
    # (self + cross)
    assert r["per_call"] == {"local_attention": 1, "full_attention": 24,
                             "sampler_euler": 3, "sampler_heun": 2,
                             "adain_conv": 4}
    assert r["counts"] == {**r["per_call"], "synthesis_head": 0,
                           "conv_transpose": 0, "istft": 0,
                           **TRAIN_KERNELS_UNUSED}
    assert r["wav"] is None and int(r["out"].frame_lengths.min()) > 0
    # the 1-step program driven as the multi-step path: the sampler
    # kernels are launched no time, so the run fails
    one = make_synthesis_fn(cfg, params, device="cpu", with_vocoder=False)
    with pytest.raises(AssertionError, match="sampler_euler: 0 calls"):
        cs.drive_main_path(cfg, one, inputs, device="cpu", n_calls=1, **kw)
    # and a count that is off by one step fails it too
    with pytest.raises(AssertionError, match="sampler_euler: 3 calls"):
        cs.drive_main_path(cfg, fn, inputs, device="cpu", n_calls=1,
                           one_step=False, n_steps=4, with_vocoder=False)


def test_chip_smoke_multistep_config_is_acceptance_config_3():
    cs = _chip_smoke()
    cfg = cs.multistep_config()
    sv = cfg.serve
    assert (sv.batch_size, sv.one_step, sv.n_steps, sv.guidance,
            sv.with_vocoder) == (32, False, 16, 3.0, False)
    assert (cfg.model.max_text_len, cfg.model.max_frames,
            cfg.runtime.compute_dtype) == (256, 1024, "bfloat16")
    expect = cs.expected_counts(cfg, 1024, one_step=False, n_steps=16,
                                with_vocoder=False)
    # 2 text + 3 prosody + 4 prompt blocks + pooling, and 31 denoiser calls
    # x 8 blocks x (self + cross); 6 decoder blocks of 2 AdaIN conv passes
    assert expect == {"local_attention": 3, "full_attention": 10 + 31 * 16,
                      "sampler_euler": 16, "sampler_heun": 15,
                      "adain_conv": 12}

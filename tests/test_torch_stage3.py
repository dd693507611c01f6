"""The port's stage-3 training (1-step distillation with the perceptual
loss) against the JAX package, on the CPU; the ``train`` command for stage
3 and its ``--ckpt``.

One tiny parameter tree made with numpy from a seed
(``_torch_parity.random_tree``: the duration head's bias gives a few frames
a phoneme, so the perceptual term has frames to compare) goes to both
sides; the batch comes from the synthetic generator.  The draw both
samplers start from is made here as JAX's ``sample`` and ``sample_onestep``
make it, ``jax.random.normal(key, (B, K, d))``, and handed to the port.
fp32; each tolerance is stated where it is used.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_tiny, n, random_tree, run_cli, t, to_jax,
                           torch_tiny, write_tiny_config)
from styletts_zs_tpu.models.diffusion import StyleDiffusion as JStyleDiffusion
from styletts_zs_tpu.models.style import StyleQuantizer as JStyleQuantizer
from styletts_zs_tpu.models.tts import StyleTTSZS
from styletts_zs_tpu.ops import stft as j_stft
from styletts_zs_tpu.pipelines import data as j_data
from styletts_zs_tpu.pipelines import train as JT
from styletts_zs_torch.kernels import adain_conv as ac_kernel
from styletts_zs_torch.kernels import dispatch, plain
from styletts_zs_torch.pipelines import train as PT
from styletts_zs_torch.pipelines.checkpoint import load_params, save_params
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.factory import (build_frozen_modules,
                                                 init_params)

REPO = Path(__file__).resolve().parent.parent
# the loss terms: fp32 through the teacher's sampler, the student's call
# and two decodes, summed in another order
LOSS_RTOL = 1e-5
# gradients: each tensor within GRAD_RTOL of its own largest value, plus
# GRAD_FLOOR of the largest gradient of the student
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-6
N_FRAMES, TEXT_LEN = 128, 16   # 4 decoder chunks of 32: the local backward


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    jcfg, pcfg = jax_tiny(), torch_tiny()
    tree = random_tree(jcfg)
    params = convert_params(tree, pcfg)
    nb = j_data.SyntheticDataset(jcfg.model, batch_size=2, seed=0,
                                 n_frames=N_FRAMES, text_len=TEXT_LEN) \
        .next_batch()
    return {"jcfg": jcfg, "pcfg": pcfg, "tree": tree, "params": params,
            "jb": JT.batch_to_device(nb), "pb": PT.batch_to_device(nb, "cpu")}


def jax_noise(key, cfg, B: int) -> torch.Tensor:
    s = cfg.model.style
    return t(jax.random.normal(key, (B, s.n_codes, s.d_style), jnp.float32))


def _diffusion_np(dtree, world) -> dict:
    """A JAX diffusion tree in the port's names, as numpy."""
    conv = convert_params({**world["tree"], "diffusion": dtree},
                          world["pcfg"])
    return {k: n(v) for k, v in conv["diffusion"].items()}


def _jax_durations(jtr, student, teacher, acoustic, batch, key):
    """The predicted durations of JAX's two decodes in ``Stage3Trainer.
    loss`` (its own steps, to the styles and through ``text_to_mel``)."""
    m = jtr.cfg.model
    text_mask = JT.length_mask(batch["text_lengths"],
                               batch["phonemes"].shape[1])
    ref_mel = j_stft.mel_spectrogram(batch["ref_wav"], m.audio)
    tokens, summary = jtr.acoustic.apply(acoustic, ref_mel,
                                         method=StyleTTSZS.encode_prompt)
    text_enc, _ = jtr.acoustic.apply(acoustic, batch["phonemes"], text_mask,
                                     method=StyleTTSZS.encode_text)
    s_t = jtr.diffusion.apply(teacher, key, text_enc, tokens, summary,
                              text_mask=text_mask,
                              n_steps=jtr.n_teacher_steps,
                              method=JStyleDiffusion.sample)
    s_s = jtr.diffusion.apply(student, key, text_enc, tokens, summary,
                              text_mask=text_mask,
                              method=JStyleDiffusion.sample_onestep)

    def durations(style):
        styled = jtr.acoustic.apply(acoustic, style,
                                    method=StyleTTSZS.quantize_style)
        return jtr.acoustic.apply(
            acoustic, batch["phonemes"], styled, text_mask=text_mask,
            n_frames=batch["f0"].shape[1],
            method=StyleTTSZS.text_to_mel).durations
    return durations(s_t), durations(s_s)


# --- the repairs the frozen decoder needed ------------------------------------

def test_project_style_gradient_is_straight_through_as_jax(world):
    """The projection onto the FSQ lattice passes the gradient through its
    rounding, as JAX's ``stop_gradient`` form does (stage 3's perceptual
    term reaches the student only through it); the forward is unchanged
    (lattice points, bit for bit JAX's).  fp32: 1e-5."""
    jcfg, pcfg = world["jcfg"], world["pcfg"]
    s = jcfg.model.style
    rs = np.random.default_rng(4)
    style = (2.0 * rs.standard_normal((2, s.n_codes, s.d_style))) \
        .astype(np.float32)
    w = rs.standard_normal(style.shape).astype(np.float32)
    ac = to_jax(world["tree"]["acoustic"])
    jq = JStyleQuantizer(s)
    qp = {"params": ac["params"]["quantizer"]}
    jout, jvjp = jax.vjp(lambda x: jq.apply(
        qp, x, method=JStyleQuantizer.project_style), jnp.asarray(style))
    port = build_frozen_modules(pcfg, world["params"], ("acoustic",),
                                device="cpu")["acoustic"]
    x = t(style).requires_grad_()
    out = port.quantize_style(x)
    (grad,) = torch.autograd.grad(out, x, t(w))
    np.testing.assert_allclose(n(out), n(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(n(grad), n(jvjp(jnp.asarray(w))[0]),
                               atol=1e-5, rtol=1e-5)
    assert np.abs(n(grad)).max() > 0


def test_adain_block_backward_skips_frozen_weight_gradients(monkeypatch):
    """With the conv kernels frozen (``requires_grad`` off, as in stage 3's
    decoder) the block's backward returns the input and style gradients it
    returns with them live, bit for bit, runs row 7 twice all the same, and
    computes no weight gradient."""
    rs = np.random.default_rng(5)
    B, T, C, K = 2, 24, 16, 5
    x = rs.standard_normal((B, T, C)).astype(np.float32)
    sc = (0.3 * rs.standard_normal((B, T, 2 * C))).astype(np.float32)
    sh = (0.3 * rs.standard_normal((B, T, 2 * C))).astype(np.float32)
    k1, k2 = ((rs.standard_normal((K, C, C)) / np.sqrt(K * C))
              .astype(np.float32) for _ in range(2))
    g = rs.standard_normal((B, T, C)).astype(np.float32)
    calls = []
    wgrad = ac_kernel._conv_wgrad
    monkeypatch.setattr(ac_kernel, "_conv_wgrad",
                        lambda *a: calls.append(1) or wgrad(*a))

    def run(live_weights: bool):
        ins = [t(a).requires_grad_() for a in (x, sc, sh)]
        ks = [t(a).requires_grad_(live_weights) for a in (k1, k2)]
        before = dispatch.plain_calls["adain_conv_bwd_data"]
        y = dispatch.adain_conv_block(*ins, *ks, dilation=3)
        grads = torch.autograd.grad(y, ins + [k for k in ks
                                              if k.requires_grad], t(g))
        return grads, dispatch.plain_calls["adain_conv_bwd_data"] - before

    live, n_live = run(True)
    assert len(calls) == 2
    frozen, n_frozen = run(False)
    assert len(calls) == 2 and n_live == n_frozen == 2
    for a, b in zip(frozen, live[:3]):
        assert torch.equal(a, b)


# --- the loss terms and the student's gradients -------------------------------

@pytest.fixture(scope="module")
def stage3_loss(world):
    """JAX's stage-3 loss with the student's gradients and both decodes'
    durations, and the port's on JAX's draw, once, with 3 teacher steps
    (the two steps below run 2)."""
    steps = 3
    jcfg, pcfg, tree = world["jcfg"], world["pcfg"], world["tree"]
    jtr = JT.Stage3Trainer(jcfg, n_teacher_steps=steps)
    key = jax.random.PRNGKey(steps)
    p = {k: to_jax(tree[k]) for k in ("diffusion", "acoustic")}

    def f(student, teacher, acoustic, batch, key):
        out = jax.value_and_grad(jtr.loss, has_aux=True)(
            student, teacher, acoustic, batch, key)
        return out, _jax_durations(jtr, student, teacher, acoustic, batch,
                                   key)
    ((_, jaux), jg), jdur = jax.jit(f)(p["diffusion"], p["diffusion"],
                                       p["acoustic"], world["jb"], key)
    ptr = PT.Stage3Trainer(pcfg, world["params"], device="cpu",
                           n_teacher_steps=steps)
    state = ptr.init_state(world["params"]["diffusion"])
    ptr.load(state.params)
    before = dict(dispatch.plain_calls)
    twins = dict(plain.twin_vjp_calls)
    _, paux, pg = ptr.grads(world["pb"], noise=jax_noise(key, jcfg, 2))
    return {"j_aux": jaux, "p_aux": paux, "j_dur": jdur,
            "j_g": _diffusion_np(jg, world),
            "p_g": {k: n(v) for k, v in pg.items()},
            "calls": {k: v - before[k] for k, v in
                      dispatch.plain_calls.items()},
            "twins": {k: v - twins.get(k, 0)
                      for k, v in plain.twin_vjp_calls.items()},
            "steps": steps}


def test_stage3_durations_equal_jax(stage3_loss):
    """Both decodes predict JAX's durations, and utterances are not empty,
    so the perceptual term compares frames."""
    jt, js = stage3_loss["j_dur"]
    aux = stage3_loss["p_aux"]
    np.testing.assert_array_equal(n(aux["durations_teacher"]), n(jt))
    np.testing.assert_array_equal(n(aux["durations_student"]), n(js))
    assert n(jt).sum(-1).min() > 0


def test_stage3_latent_and_perceptual_terms_match_jax(stage3_loss):
    j, p = stage3_loss["j_aux"], stage3_loss["p_aux"]
    assert set(j) == set(PT.STAGE3_METRICS) < set(p)
    for k in j:
        np.testing.assert_allclose(p[k].item(), float(j[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    assert float(j["perceptual"]) > 0 and float(j["latent"]) > 0


def test_stage3_student_gradients_match_jax_on_every_leaf(stage3_loss, world):
    """Every leaf of the student; the teacher's steps run rows 8-9's plain
    versions, the decoder's backward rows 3-5 and 7's."""
    jg, pg = stage3_loss["j_g"], stage3_loss["p_g"]
    assert pg.keys() == jg.keys()
    _grad_check(pg, jg)
    steps, m = stage3_loss["steps"], world["pcfg"].model
    calls = stage3_loss["calls"]
    assert calls["sampler_euler"] == steps
    assert calls["sampler_heun"] == steps - 1
    assert calls["local_attention_bwd_dq"] == 1
    assert calls["local_attention_bwd_dkv"] == 1
    assert calls["adain_conv_bwd_data"] == 2 * m.decoder.n_blocks
    assert stage3_loss["twins"]["full_attention"] == 2 * m.diffusion.n_layers


def _grad_check(got: dict, ref: dict) -> None:
    scale = max(np.abs(r).max() for r in ref.values())
    for k, r in ref.items():
        err = np.abs(got[k] - r).max()
        assert err <= GRAD_RTOL * np.abs(r).max() + GRAD_FLOOR * scale, \
            (k, err, np.abs(r).max())


def test_two_stage3_steps_match_jax(world):
    """Two ``train_step``s (warm-up 1, lr 1e-3, so the second moves the
    student), each on its key's draw: every metric of both steps.  1e-4
    relative: the second step's weights carry the first's fp32 rounding
    through Adam's normalised update."""
    cfg_j, cfg_p = (dataclasses.replace(c, train=dataclasses.replace(
        c.train, warmup_steps=1, lr=1e-3)) for c in (world["jcfg"],
                                                   world["pcfg"]))
    tree = world["tree"]
    jtr = JT.Stage3Trainer(cfg_j, n_teacher_steps=2)
    jstate = jtr.init_state(to_jax(tree["diffusion"]))
    ptr = PT.Stage3Trainer(cfg_p, world["params"], device="cpu",
                           n_teacher_steps=2)
    pstate = ptr.init_state(world["params"]["diffusion"])
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        jstate, jm = jtr.train_step(jstate, to_jax(tree["diffusion"]),
                                    to_jax(tree["acoustic"]), world["jb"],
                                    key)
        pstate, pm = ptr.train_step(pstate, world["pb"],
                                    noise=jax_noise(key, cfg_j, 2))
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert pstate.step == 2 and pstate.ema is None
    moved = max((pstate.params[k] - v).abs().max().item()
                for k, v in world["params"]["diffusion"].items())
    assert moved > 1e-4


# --- chip_smoke.py's stage-3 phase, rehearsed on the CPU ----------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_stage3_rehearsal_on_cpu(world):
    """The stage-3 phase's drive at tiny size, its counts as
    ``stage3_expected_counts`` predicts them: the teacher's 4 Euler steps
    and 3 corrections (tiny: 4 steps), (2 + 1 + 1 + 4 x 7 + 4) full
    attentions, the decoders' rows; a wrong depth fails the run."""
    cs = _chip_smoke()
    cfg = torch_tiny()
    params = init_params(cfg, seed=0, device="cpu")
    tr = PT.Stage3Trainer(cfg, params, device="cpu")
    state = tr.init_state(params["diffusion"])
    expect = cs.stage3_expected_counts(cfg, N_FRAMES, tr.n_teacher_steps)
    r = cs.drive_train(cfg, tr, state, world["pb"], device="cpu", n_steps=2,
                       expect=expect, label="stage-3 step")
    assert r["per_step"] == {"full_attention": 36, "sampler_euler": 4,
                             "sampler_heun": 3, "adain_conv": 8,
                             "adain_conv_bwd_data": 4, "local_attention": 1,
                             "local_attention_fwd_lse": 1,
                             "local_attention_bwd_dq": 1,
                             "local_attention_bwd_dkv": 1}
    assert r["twins"] == {"full_attention": 8}
    assert set(r["losses"]) == set(PT.STAGE3_METRICS)
    with pytest.raises(AssertionError, match="sampler_euler"):
        cs.drive_train(cfg, tr, state, world["pb"], device="cpu", n_steps=1,
                       expect=cs.stage3_expected_counts(cfg, N_FRAMES, 3))


# --- the train command --------------------------------------------------------

def test_cli_train_stage3_reads_ckpt_and_refuses_without_a_card(tmp_path):
    """``python -m styletts_zs_torch.cli train --stage 3`` at tiny size on
    the CPU, twice: from the seeded weights, then from a tree written by
    ``save_params`` (``--ckpt``).  With one step (lr 0 at the first
    update) the student is its teacher: the checkpoint's denoiser, bit for
    bit, not the seeded one.  Without ``--device`` and without a card it
    raises."""
    config = write_tiny_config(tmp_path)
    cfg = torch_tiny()
    mine = init_params(cfg, seed=7, device="cpu")
    save_params(str(tmp_path / "mine.pt"), mine)
    seeded = init_params(cfg, seed=cfg.train.seed, device="cpu")
    for ckpt, want in ((None, seeded), (tmp_path / "mine.pt", mine)):
        work = tmp_path / ("ckpt" if ckpt else "seed")
        args = ["--stage", "3", "--steps", "1" if ckpt else "2",
                "--device", "cpu"]
        r = run_cli(args + ([f"--ckpt={ckpt}"] if ckpt else []), config, work)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "latent=" in r.stdout and "training done" in r.stdout
        student = load_params(str(work / "stage3_student"))
        assert student.keys() == want["diffusion"].keys()
        if ckpt:
            for k, v in want["diffusion"].items():
                assert torch.equal(student[k], v), k
            assert not torch.equal(student["denoiser.in_proj.weight"],
                                   seeded["diffusion"]
                                   ["denoiser.in_proj.weight"])
    r = run_cli(["--stage", "3", "--steps", "1"], config, tmp_path / "card")
    assert r.returncode != 0 and "CUDA" in r.stderr
    assert not (tmp_path / "card" / "stage3_student").exists()

"""The port's stage-1 training against the JAX package, on the CPU.

One tiny parameter tree with the discriminator, made with numpy from a seed
(``_torch_parity.random_tree``), goes to both sides; the batch comes from
the synthetic generator, which the port copies bit for bit.  The three
dropout rates are 0 on both sides (the JAX PRNG cannot be reproduced in
torch; Flax's ``Dropout(0)`` is the identity).  fp32; each tolerance is
stated where it is used.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import jax_tiny, n, random_tree, t, to_jax, torch_tiny
from styletts_zs_tpu.models import discriminators as j_disc
from styletts_zs_tpu.models.tts import StyleTTSZS
from styletts_zs_tpu.ops import align as j_align
from styletts_zs_tpu.ops import fsq as j_fsq
from styletts_zs_tpu.ops import stft as j_stft
from styletts_zs_tpu.pipelines import data as j_data
from styletts_zs_tpu.pipelines import train as JT
from styletts_zs_tpu.utils.config import AudioConfig as JAudioConfig
from styletts_zs_torch.config import AudioConfig
from styletts_zs_torch.kernels import dispatch
from styletts_zs_torch.models import discriminators as p_disc
from styletts_zs_torch.models.layers import dropout
from styletts_zs_torch.ops import align as p_align
from styletts_zs_torch.ops import fsq as p_fsq
from styletts_zs_torch.ops import stft as p_stft
from styletts_zs_torch.pipelines import data as p_data
from styletts_zs_torch.pipelines import train as PT
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.factory import build_models, init_params

REPO = Path(__file__).resolve().parent.parent
# losses: fp32 through ~30 layers, summed in another order
LOSS_RTOL = 1e-5
# gradients: each tensor within GRAD_RTOL of its own largest value, plus
# GRAD_FLOOR of the largest gradient of its model (a tensor whose gradient
# is zero by construction holds only rounding)
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-6
N_FRAMES, TEXT_LEN = 128, 16   # 4 decoder chunks of 32: the local backward


@pytest.fixture(autouse=True)
def _one_thread():
    """Every test on one torch thread, as the other files' fixtures set it,
    also those that run before ``world`` in a fresh worker: run first in its
    worker at the default eight threads, with the host's cores shared among
    six workers, the spectrogram test once put about 13 whole frames 3e-4
    (relative) off JAX's, far beyond summation order (the two agree to the
    bit at power 2 on one thread or eight)."""
    torch.set_num_threads(1)


def _no_dropout(cfg):
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, text_encoder=dataclasses.replace(m.text_encoder, dropout=0.0),
        prosody_encoder=dataclasses.replace(m.prosody_encoder, dropout=0.0),
        predictor=dataclasses.replace(m.predictor, dropout=0.0)))


def _fast_schedule(cfg):
    """Warm-up 2 and lr 1e-3, so three steps move the weights."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, warmup_steps=2, lr=1e-3, lr_disc=2e-3))


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    jcfg, pcfg = _no_dropout(jax_tiny()), _no_dropout(torch_tiny())
    tree = random_tree(jcfg, with_discriminator=True)
    params = convert_params(tree, pcfg)
    nb = j_data.SyntheticDataset(jcfg.model, batch_size=2, seed=0,
                                 n_frames=N_FRAMES, text_len=TEXT_LEN) \
        .next_batch()
    return {"jcfg": jcfg, "pcfg": pcfg, "tree": tree, "params": params,
            "jb": JT.batch_to_device(nb), "pb": PT.batch_to_device(nb, "cpu"),
            "nb": nb}


def _grad_check(got: dict, ref: dict) -> None:
    scale = max(np.abs(r).max() for r in ref.values())
    for k, r in ref.items():
        err = np.abs(got[k] - r).max()
        assert err <= GRAD_RTOL * np.abs(r).max() + GRAD_FLOOR * scale, \
            (k, err, np.abs(r).max())


# --- data ---------------------------------------------------------------------

@pytest.mark.parametrize("seed,kw", [(0, {}), (3, dict(n_frames=128,
                                                        text_len=16))])
def test_synthetic_dataset_equals_jax_bit_for_bit(seed, kw):
    jcfg, pcfg = jax_tiny(), torch_tiny()
    jd = j_data.SyntheticDataset(jcfg.model, batch_size=3, seed=seed, **kw)
    pd = p_data.SyntheticDataset(pcfg.model, batch_size=3, seed=seed, **kw)
    for _ in range(2):
        a, b = vars(jd.next_batch()), vars(pd.next_batch())
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# --- ops ----------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,win,hop", [(256, 256, 64), (512, 400, 100)])
def test_spectrogram_and_frame_signal_match_jax(n_fft, win, hop):
    wav = np.random.default_rng(1).standard_normal((2, 3001)) \
        .astype(np.float32)
    jc = JAudioConfig(n_fft=n_fft, win_length=win, hop_length=hop)
    pc = AudioConfig(n_fft=n_fft, win_length=win, hop_length=hop)
    for power in (1.0, 2.0):
        np.testing.assert_allclose(
            n(p_stft.spectrogram(t(wav), pc, power=power)),
            n(j_stft.spectrogram(jnp.asarray(wav), jc, power=power)),
            atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(
        n(p_stft.frame_signal(t(wav), win, hop)),
        n(j_stft.frame_signal(jnp.asarray(wav), win, hop)))


LEVELS = (8, 8, 5)


def test_fsq_quantize_indices_and_straight_through_gradient_match_jax():
    """Codes and indices equal; the straight-through gradient within 1e-6."""
    z = 2.0 * np.random.default_rng(2).standard_normal((2, 7, 3)) \
        .astype(np.float32)
    w = np.random.default_rng(3).standard_normal((2, 7, 3)).astype(np.float32)
    jcodes, jvjp = jax.vjp(lambda z: j_fsq.quantize(z, LEVELS),
                           jnp.asarray(z))
    tz = t(z).requires_grad_()
    codes = p_fsq.quantize(tz, LEVELS)
    np.testing.assert_array_equal(n(codes), n(jcodes))
    np.testing.assert_array_equal(
        n(p_fsq.codes_to_indices(codes, LEVELS)),
        n(j_fsq.codes_to_indices(jcodes, LEVELS)))
    (grad,) = torch.autograd.grad(codes, tz, t(w))
    np.testing.assert_allclose(n(grad), n(jvjp(jnp.asarray(w))[0]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(n(p_fsq.bound(t(z), LEVELS)),
                               n(j_fsq.bound(jnp.asarray(z), LEVELS)),
                               atol=1e-6, rtol=1e-6)


def test_fsq_entropy_losses_and_gradient_match_jax():
    z = np.random.default_rng(4).standard_normal((2, 7, 3)).astype(np.float32)

    def f(z):
        s, c = j_fsq.entropy_losses(z, LEVELS)
        return s - 2.0 * c, (s, c)

    (_, (js, jc)), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(z))
    tz = t(z).requires_grad_()
    s, c = p_fsq.entropy_losses(tz, LEVELS)
    (grad,) = torch.autograd.grad(s - 2.0 * c, tz)
    np.testing.assert_allclose([s.item(), c.item()], [float(js), float(jc)],
                               rtol=1e-6)
    np.testing.assert_allclose(n(grad), n(jg), atol=1e-6, rtol=1e-5)


def test_forward_sum_loss_and_gradient_match_jax():
    """The log-space DP over frames (a Python loop here, ``lax.scan`` in
    JAX), utterances shorter than the lattice on both axes.  1e-5."""
    rs = np.random.default_rng(5)
    lp = np.log(rs.dirichlet(np.ones(12), size=(2, 40))).astype(np.float32)
    tl, fl = np.array([12, 7], np.int32), np.array([40, 25], np.int32)
    jl, jg = jax.value_and_grad(j_align.forward_sum_loss)(
        jnp.asarray(lp), jnp.asarray(tl), jnp.asarray(fl))
    tlp = t(lp).requires_grad_()
    loss = p_align.forward_sum_loss(tlp, t(tl), t(fl))
    (grad,) = torch.autograd.grad(loss, tlp)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(n(grad), n(jg), atol=1e-6, rtol=1e-5)


def test_dropout_draws_from_its_generator():
    x = torch.ones(4, 1000)
    a = dropout(x, 0.25, torch.Generator().manual_seed(7))
    b = dropout(x, 0.25, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.all(a[kept] == 1.0 / 0.75)
    assert 0.7 < kept.float().mean() < 0.8
    assert dropout(x, 0.25, None) is x and dropout(x, 0.0, None) is x


# --- models -------------------------------------------------------------------

def test_discriminators_logits_features_and_losses_match_jax(world):
    """MPD (reflect-padded, phase folded), MRD (band folded) and the mel
    patch critic with strided SAME convs on odd lengths; the three LSGAN
    losses.  fp32: 1e-4."""
    jcfg, pcfg = world["jcfg"], world["pcfg"]
    m = jcfg.model
    rs = np.random.default_rng(6)
    wav = (0.3 * rs.standard_normal((2, 12797))).astype(np.float32)
    mel = rs.standard_normal((2, 127, m.audio.n_mels)).astype(np.float32)
    jd = j_disc.MultiModalDiscriminator(m.discriminator)
    jlg, jft = jd.apply(to_jax(world["tree"]["discriminator"]),
                        jnp.asarray(wav), jnp.asarray(mel))
    pd = p_disc.MultiModalDiscriminator(pcfg.model.discriminator,
                                        n_mels=m.audio.n_mels)
    pd.load_state_dict(world["params"]["discriminator"])
    with torch.no_grad():
        plg, pft = pd(t(wav), t(mel))
    assert len(plg) == len(jlg) == 4
    for a, b in zip(plg, jlg):
        np.testing.assert_allclose(n(a), n(b), atol=1e-4, rtol=1e-4)
    for fa, fb in zip(pft, jft):
        assert len(fa) == len(fb)
        for a, b in zip(fa, fb):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(n(a), n(b), atol=1e-4, rtol=1e-4)
    fake = [x * 0.5 for x in plg]
    jfake = [x * 0.5 for x in jlg]
    for p_fn, j_fn, args, jargs in (
            (p_disc.discriminator_loss, j_disc.discriminator_loss,
             (plg, fake), (jlg, jfake)),
            (p_disc.generator_adv_loss, j_disc.generator_adv_loss,
             (fake,), (jfake,)),
            (p_disc.feature_matching_loss, j_disc.feature_matching_loss,
             (pft, [[x * 0.9 for x in f] for f in pft]),
             (jft, [[x * 0.9 for x in f] for f in jft]))):
        np.testing.assert_allclose(float(p_fn(*args)), float(j_fn(*jargs)),
                                   rtol=1e-5)


def test_reconstruct_and_align_energies_match_jax(world):
    """The stage-1 forward (style from the ground-truth mel, durations and
    F0/energy targets given) and the aligner's energies.  fp32: 1e-4."""
    jcfg, pcfg, jb = world["jcfg"], world["pcfg"], world["jb"]
    m = jcfg.model
    mel = n(j_stft.mel_spectrogram(jb["wav"], m.audio))[:, :N_FRAMES]
    tmask = np.asarray(JT.length_mask(jb["text_lengths"], TEXT_LEN))
    fmask = np.asarray(JT.length_mask(jb["frame_lengths"], N_FRAMES))
    acoustic = StyleTTSZS(m)
    p_ac = to_jax(world["tree"]["acoustic"])
    jout, jcodes, jstyled = acoustic.apply(
        p_ac, jb["phonemes"], jnp.asarray(mel), jb["durations"],
        text_mask=jnp.asarray(tmask), frame_mask=jnp.asarray(fmask),
        f0_target=jb["f0"], energy_target=jb["energy"],
        method=StyleTTSZS.reconstruct)

    def _energies(mdl, ph, mel, mask):
        te, _ = mdl.encode_text(ph, mask)
        return mdl.align_energies(te, mel, text_mask=mask)
    jen = acoustic.apply(p_ac, jb["phonemes"], jnp.asarray(mel),
                         jnp.asarray(tmask), method=_energies)
    port = build_models(pcfg, world["params"], device="cpu").acoustic
    pb = world["pb"]
    with torch.no_grad():
        out, codes, styled = port.reconstruct(
            pb["phonemes"], t(mel), pb["durations"], text_mask=t(tmask),
            frame_mask=t(fmask), f0_target=pb["f0"],
            energy_target=pb["energy"])
        te, _ = port.encode_text(pb["phonemes"], t(tmask))
        en = port.align_energies(te, t(mel), text_mask=t(tmask))
    np.testing.assert_array_equal(n(codes), n(jcodes))
    np.testing.assert_array_equal(n(port.quantizer.decode_codes(codes)),
                                  n(styled))
    for a, b in ((styled, jstyled), (out.mel, jout.mel),
                 (out.hidden, jout.hidden), (out.log_dur, jout.log_dur),
                 (out.f0, jout.f0), (out.energy, jout.energy), (en, jen)):
        np.testing.assert_allclose(n(a), n(b), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(n(out.durations), n(jout.durations))
    assert float(n(en).min()) == -1e9


# --- the loss functions and their gradients -----------------------------------

@pytest.fixture(scope="module")
def losses(world):
    """JAX's and the port's g_loss/d_loss with their gradients, once."""
    jcfg, pcfg, tree = world["jcfg"], world["pcfg"], world["tree"]
    jtr = JT.Stage1Trainer(jcfg)
    g_params = to_jax({"acoustic": tree["acoustic"],
                       "vocoder": tree["vocoder"]})
    d_params = to_jax(tree["discriminator"])
    (_, jg_aux), jgg = jax.jit(jax.value_and_grad(jtr.g_loss, has_aux=True))(
        g_params, d_params, world["jb"], jax.random.PRNGKey(0))
    (_, jd_aux), jdg = jax.jit(jax.value_and_grad(jtr.d_loss, has_aux=True))(
        d_params, g_params, world["jb"], jax.random.PRNGKey(1))
    ptr = PT.Stage1Trainer(pcfg, world["params"], device="cpu")
    state = ptr.init_state(world["params"])
    ptr.load(state.g_params, state.d_params)
    before = dict(dispatch.plain_calls)
    _, pg_aux, pgg = ptr.g_grads(world["pb"])
    calls = {k: dispatch.plain_calls[k] - before[k] for k in before}
    _, pd_aux, pdg = ptr.d_grads(world["pb"])
    conv = convert_params({**tree, "acoustic": jgg["acoustic"],
                           "vocoder": jgg["vocoder"], "discriminator": jdg},
                          pcfg)
    return {"j_aux": {**jg_aux, **jd_aux}, "p_aux": {**pg_aux, **pd_aux},
            "j_g": {f"{p}.{k}": n(v) for p in ("acoustic", "vocoder")
                    for k, v in conv[p].items()},
            "p_g": {f"{p}.{k}": n(v) for p in ("acoustic", "vocoder")
                    for k, v in pgg[p].items()},
            "j_d": {k: n(v) for k, v in conv["discriminator"].items()},
            "p_d": {k: n(v) for k, v in pdg.items()}, "g_calls": calls}


def test_g_loss_every_term_matches_jax(losses):
    j, p = losses["j_aux"], losses["p_aux"]
    assert set(p) == set(j) >= {"mel", "adv_g", "fm", "dur", "f0", "energy",
                                "align", "spk_nce", "spk_acc", "spk_nce_rec",
                                "spk_nce_voc", "fsq_sample_ent",
                                "fsq_code_ent", "total_g", "total_d"}
    for k in j:
        np.testing.assert_allclose(float(p[k]), float(j[k]), rtol=LOSS_RTOL,
                                   err_msg=k)


def test_g_loss_gradients_match_jax_on_every_leaf(losses):
    """Every acoustic and vocoder leaf (the prompt encoder through the
    speaker terms, the aligner's projections through the forward-sum
    loss); the decoder's backward runs rows 4, 5 and 7's plain versions."""
    assert losses["p_g"].keys() == losses["j_g"].keys()
    assert len(losses["p_g"]) > 150
    _grad_check(losses["p_g"], losses["j_g"])
    calls = losses["g_calls"]
    assert calls["local_attention_bwd_dq"] == 1 and \
        calls["local_attention_bwd_dkv"] == 1
    assert calls["adain_conv_bwd_data"] == 4 and calls["adain_conv"] == 4


def test_d_loss_and_gradients_match_jax(losses):
    np.testing.assert_allclose(float(losses["p_aux"]["total_d"]),
                               float(losses["j_aux"]["total_d"]),
                               rtol=LOSS_RTOL)
    assert losses["p_d"].keys() == losses["j_d"].keys()
    _grad_check(losses["p_d"], losses["j_d"])


# --- the optimiser and the step -----------------------------------------------

@pytest.mark.parametrize("warmup,scale", [(1000, 3.0), (2, 0.01)])
def test_optimizer_matches_optax(warmup, scale):
    """Identical gradients through the port's AdamW and optax's chain: the
    first update (lr 0 at count 0) leaves every weight as it is, decay
    included; the clip engages (norm > 1) or not (norm < 1).  1e-6."""
    cfg = torch_tiny()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, warmup_steps=warmup, lr=1e-2))
    jcfg = dataclasses.replace(jax_tiny(), train=dataclasses.replace(
        jax_tiny().train, warmup_steps=warmup, lr=1e-2))
    rs = np.random.default_rng(8)
    params = [rs.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2, 2))]
    tx = JT.make_optimizer(jcfg)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    opt = PT.make_optimizer(cfg)
    pp = [t(p) for p in params]
    pstate = opt.init(pp)
    for i in range(4):
        grads = [(scale * rs.standard_normal(p.shape)).astype(np.float32)
                 for p in params]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        pp, pstate = opt.update([t(g) for g in grads], pstate, pp)
        for a, b in zip(pp, jp):
            np.testing.assert_allclose(n(a), n(b), atol=1e-6, rtol=1e-6)
        if i == 0:
            for a, p in zip(pp, params):
                assert np.array_equal(n(a), p)


def test_three_train_steps_match_jax(world):
    """Three ``train_step``s on both sides (warm-up 2, lr 1e-3, so steps 2
    and 3 move the weights): every loss of every step.  The weights' fp32
    rounding differences grow through Adam's normalised updates:
    1e-4 relative."""
    jcfg, pcfg = _fast_schedule(world["jcfg"]), _fast_schedule(world["pcfg"])
    tree = world["tree"]
    jtr = JT.Stage1Trainer(jcfg)
    jstate = jtr.init_state(to_jax(tree))
    ptr = PT.Stage1Trainer(pcfg, world["params"], device="cpu")
    pstate = ptr.init_state(world["params"])
    for i in range(3):
        jstate, jm = jtr.train_step(jstate, world["jb"],
                                    jax.random.PRNGKey(i))
        pstate, pm = ptr.train_step(pstate, world["pb"])
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    assert pstate.step == 3 and int(jstate.step) == 3


# --- chip_smoke.py's train phase, rehearsed on the CPU ------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_train_rehearsal_on_cpu(world):
    """The train phase's drive at tiny size: the plain versions run, the
    per-step counts (rows 3-5 once per decoder attention block, row 7
    twice per AdaIN block, the twin backwards) are checked, and a count
    off its expectation fails the run."""
    cs = _chip_smoke()
    cfg = torch_tiny()
    params = init_params(cfg, seed=0, device="cpu", with_discriminator=True)
    tr = PT.Stage1Trainer(cfg, params, device="cpu")
    state = tr.init_state(params)
    r = cs.drive_train(cfg, tr, state, world["pb"], device="cpu", n_steps=2)
    # tiny: 1 text block (aligner) + 2 (text, prosody) + 3 extractor (1
    # block, 2 pools) twice + 4 speaker views x 2 prompt blocks = 17 in
    # the generator step, each with a twin backward; 2 + 3 in the
    # discriminator step's forward
    assert r["per_step"] == {"full_attention": 22, "adain_conv": 8,
                             "adain_conv_bwd_data": 4, "conv_transpose": 4,
                             "synthesis_head": 2, "local_attention": 1,
                             "local_attention_fwd_lse": 1,
                             "local_attention_bwd_dq": 1,
                             "local_attention_bwd_dkv": 1}
    assert r["twins"] == {"full_attention": 34, "conv_transpose": 4,
                          "synthesis_head": 2}
    assert all(np.isfinite(v) for v in r["losses"].values())
    wrong = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, decoder=dataclasses.replace(cfg.model.decoder,
                                               attn_every=1)))
    with pytest.raises(AssertionError, match="local_attention"):
        cs.drive_train(wrong, tr, state, world["pb"], device="cpu",
                       n_steps=1)



def test_trainer_refuses_mas_durations(world):
    """Monotonic alignment search is ported (``tests/test_torch_mas.py``
    holds it against JAX), so the trainer no longer refuses it: asked for
    it with ``w_align`` 0, as JAX it still runs the aligner and MAS, takes
    the durations from MAS (summing to the frame lengths) and adds no
    forward-sum term."""
    cfg = world["pcfg"]
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, use_mas_durations=True, w_align=0.0))
    tr = PT.Stage1Trainer(cfg, world["params"], device="cpu")
    tr.load(*(lambda s: (s.g_params, s.d_params))(
        tr.init_state(world["params"])))
    with torch.no_grad():
        out = tr._forward_g(world["pb"], None)
        _, aux = tr.g_loss(world["pb"])
    energies, durations = out[5], out[6]
    assert energies is not None and "align" not in aux
    np.testing.assert_array_equal(
        n(durations), n(p_align.monotonic_alignment_search(
            energies, world["pb"]["text_lengths"],
            world["pb"]["frame_lengths"])))
    np.testing.assert_array_equal(n(durations).sum(1),
                                  world["nb"].frame_lengths)

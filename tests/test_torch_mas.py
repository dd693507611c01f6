"""Monotonic alignment search and stage-1 training with MAS durations, the
port against the JAX package, on the CPU.

MAS is adds and compares only, so its durations must EQUAL JAX's, on fp32
and bf16 lattices, ragged text and frame lengths, a planted alignment and
fewer frames than phonemes.  ``Stage1Trainer(use_mas_durations=True)``
(the durations of a corpus without annotations: zeroed in the batch here,
so only MAS can supply them) against JAX's on one ``random_tree``, dropout
off on both sides: every loss term within 1e-5 relative, every gradient as
``tests/test_torch_train.py`` holds them, and three ``train_step``s within
its 1e-4, which also holds the discriminator step's recomputed MAS.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_tiny, load_chip_smoke, n, random_tree, t,
                           to_jax, torch_tiny)
from styletts_zs_tpu.ops import align as j_align
from styletts_zs_tpu.pipelines import data as j_data
from styletts_zs_tpu.pipelines import train as JT
from styletts_zs_torch.ops import align as p_align
from styletts_zs_torch.pipelines import train as PT
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.factory import init_params

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-6
N_FRAMES, TEXT_LEN = 128, 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _lattice(B, T, N, seed, *, frames_lo=1):
    rs = np.random.default_rng(seed)
    e = rs.standard_normal((B, T, N)).astype(np.float32)
    tl = rs.integers(1, N + 1, B).astype(np.int32)
    fl = rs.integers(frames_lo, T + 1, B).astype(np.int32)
    tl[0], fl[0] = N, T
    return e, tl, fl


def _planted():
    """JAX's own planted case (``tests/test_align.py``), a second utterance
    of another length beside it, and text masked at -1e9 past its length
    as the aligner masks it."""
    e = np.full((2, 12, 5), -5.0, np.float32)
    pos = 0
    for i, d in enumerate([3, 4, 2, 3]):
        e[0, pos: pos + d, i] = 5.0
        pos += d
    pos = 0
    for i, d in enumerate([1, 2, 2, 4]):
        e[1, pos: pos + d, i] = 5.0
        pos += d
    e[:, :, 4] = -1e9
    return e, np.array([4, 4], np.int32), np.array([12, 9], np.int32)


CASES = {
    "random": lambda: _lattice(3, 40, 12, 0),
    "one_frame_one_phoneme": lambda: _lattice(2, 1, 1, 1),
    "fewer_frames_than_phonemes": lambda: _lattice(3, 9, 16, 2),
    "short_frames": lambda: _lattice(4, 50, 7, 3, frames_lo=2),
    "planted": _planted,
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mas_durations_equal_jax(case, dtype):
    e, tl, fl = CASES[case]()
    je = jnp.asarray(e).astype(dtype)
    ref = np.asarray(j_align.monotonic_alignment_search(
        je, jnp.asarray(tl), jnp.asarray(fl)))
    got = p_align.monotonic_alignment_search(
        t(e).to(getattr(torch, dtype)), t(tl), t(fl))
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy().sum(1), fl)
    if case == "planted":
        np.testing.assert_array_equal(got.numpy()[:, :4],
                                      [[3, 4, 2, 3], [1, 2, 2, 4]])


# --- Stage1Trainer with MAS durations ----------------------------------------

def _mas(cfg):
    m = cfg.model
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, use_mas_durations=True),
        model=dataclasses.replace(
            m, text_encoder=dataclasses.replace(m.text_encoder, dropout=0.0),
            prosody_encoder=dataclasses.replace(m.prosody_encoder,
                                                dropout=0.0),
            predictor=dataclasses.replace(m.predictor, dropout=0.0)))


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    jcfg, pcfg = _mas(jax_tiny()), _mas(torch_tiny())
    tree = random_tree(jcfg, with_discriminator=True)
    nb = j_data.SyntheticDataset(jcfg.model, batch_size=2, seed=0,
                                 n_frames=N_FRAMES, text_len=TEXT_LEN) \
        .next_batch()
    nb.durations[:] = 0       # unannotated: MAS gives every duration
    return {"jcfg": jcfg, "pcfg": pcfg, "tree": tree,
            "params": convert_params(tree, pcfg), "nb": nb,
            "jb": JT.batch_to_device(nb), "pb": PT.batch_to_device(nb, "cpu")}


@pytest.fixture(scope="module")
def losses(world):
    jcfg, pcfg, tree = world["jcfg"], world["pcfg"], world["tree"]
    jtr = JT.Stage1Trainer(jcfg)
    g = to_jax({"acoustic": tree["acoustic"], "vocoder": tree["vocoder"]})
    d = to_jax(tree["discriminator"])
    (_, jg_aux), jgg = jax.jit(jax.value_and_grad(jtr.g_loss, has_aux=True))(
        g, d, world["jb"], jax.random.PRNGKey(0))
    (_, jd_aux), jdg = jax.jit(jax.value_and_grad(jtr.d_loss, has_aux=True))(
        d, g, world["jb"], jax.random.PRNGKey(1))
    jdur = jax.jit(lambda g, b: jtr._forward_g(
        g, b, jax.random.PRNGKey(0))[6])(g, world["jb"])
    ptr = PT.Stage1Trainer(pcfg, world["params"], device="cpu")
    state = ptr.init_state(world["params"])
    ptr.load(state.g_params, state.d_params)
    _, pg_aux, pgg = ptr.g_grads(world["pb"])
    _, pd_aux, pdg = ptr.d_grads(world["pb"])
    with torch.no_grad():
        pdur = ptr._forward_g(world["pb"], None, with_align=False)[6]
    conv = convert_params({**tree, "acoustic": jgg["acoustic"],
                           "vocoder": jgg["vocoder"], "discriminator": jdg},
                          pcfg)
    return {"j_aux": {**jg_aux, **jd_aux}, "p_aux": {**pg_aux, **pd_aux},
            "j_g": {f"{p}.{k}": n(v)
                    for p in ("acoustic", "vocoder", "discriminator")
                    for k, v in conv[p].items()},
            "p_g": {**{f"{p}.{k}": n(v) for p in ("acoustic", "vocoder")
                       for k, v in pgg[p].items()},
                    **{f"discriminator.{k}": n(v) for k, v in pdg.items()}},
            "j_dur": np.asarray(jdur), "p_dur": pdur.numpy()}


def test_mas_durations_of_the_step_equal_jax(losses, world):
    """The durations the step decodes with (in the discriminator step's
    forward, too): JAX's, summing to the frame lengths, none from the
    zeroed batch."""
    np.testing.assert_array_equal(losses["p_dur"], losses["j_dur"])
    np.testing.assert_array_equal(losses["p_dur"].sum(1),
                                  world["nb"].frame_lengths)


def test_mas_loss_terms_match_jax(losses):
    j, p = losses["j_aux"], losses["p_aux"]
    assert set(p) == set(j) >= {"dur", "align", "total_g", "total_d"}
    for k in j:
        np.testing.assert_allclose(float(n(p[k])), float(j[k]), rtol=LOSS_RTOL,
                                   err_msg=k)


def test_mas_gradients_match_jax(losses):
    ref, got = losses["j_g"], losses["p_g"]
    assert got.keys() == ref.keys()
    for part in ("acoustic", "vocoder", "discriminator"):
        keys = [k for k in ref if k.startswith(part + ".")]
        scale = max(np.abs(ref[k]).max() for k in keys)
        for k in keys:
            err = np.abs(got[k] - ref[k]).max()
            assert err <= GRAD_RTOL * np.abs(ref[k]).max() \
                + GRAD_FLOOR * scale, (k, err)


def test_three_mas_train_steps_match_jax(world):
    """Three steps (warm-up 2, lr 1e-3: steps 2 and 3 move the weights), so
    the discriminator steps decode with MAS durations of the updated
    generator: every loss of every step within 1e-4 relative."""
    def fast(cfg):
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, warmup_steps=2, lr=1e-3, lr_disc=2e-3))
    jtr = JT.Stage1Trainer(fast(world["jcfg"]))
    jstate = jtr.init_state(to_jax(world["tree"]))
    ptr = PT.Stage1Trainer(fast(world["pcfg"]), world["params"], device="cpu")
    pstate = ptr.init_state(world["params"])
    for i in range(3):
        jstate, jm = jtr.train_step(jstate, world["jb"],
                                    jax.random.PRNGKey(i))
        pstate, pm = ptr.train_step(pstate, world["pb"])
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i} {k}")


def test_chip_smoke_mas_step_counts_rehearsal_on_cpu(world):
    """The corpus phase's expected launches at tiny size: the stage-1
    step's, plus the discriminator step's aligner text encoder (one more
    full attention a step, no twin backward); the drive checks them."""
    cs = load_chip_smoke()
    cfg = _mas(torch_tiny())
    params = init_params(cfg, seed=0, device="cpu", with_discriminator=True)
    tr = PT.Stage1Trainer(cfg, params, device="cpu")
    expect = cs.train_expected_counts(cfg, N_FRAMES)
    plain = cs.train_expected_counts(torch_tiny(), N_FRAMES)
    aligner = cfg.model.text_encoder.n_attn_layers
    assert expect["kernels"]["full_attention"] == \
        plain["kernels"]["full_attention"] + aligner
    assert expect["twins"] == plain["twins"]
    r = cs.drive_train(cfg, tr, tr.init_state(params), world["pb"],
                       device="cpu", n_steps=1, expect=expect)
    assert r["per_step"]["full_attention"] == 23

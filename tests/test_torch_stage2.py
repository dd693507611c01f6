"""The port's stage-2 training (the EDM style-diffusion step) against the
JAX package, on the CPU; the torch checkpoints; the ``train`` command for
stages 1 and 2.

One tiny parameter tree made with numpy from a seed
(``_torch_parity.random_tree``: the AdaLN gates are not zero, so every
denoiser block reaches the loss) goes to both sides.  The draws (the CFG
drop, the log-normal sigma's normal, the noise) are made here with JAX's
own ``jax.random.split`` sequence from the step's key and handed to the
port.  ``cond_dropout`` is 0.5 so that the key below drops one prompt of
two.  fp32; each tolerance is stated where it is used.
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
from styletts_zs_tpu.pipelines import data as j_data
from styletts_zs_tpu.pipelines import train as JT
from styletts_zs_torch.kernels import plain
from styletts_zs_torch.pipelines import checkpoint as ckpt
from styletts_zs_torch.pipelines import train as PT
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.factory import (build_frozen_modules,
                                                 init_params)

REPO = Path(__file__).resolve().parent.parent
# the loss: fp32 through the frozen encoders and the denoiser, summed in
# another order
LOSS_RTOL = 1e-5
# gradients: each tensor within GRAD_RTOL of its own largest value, plus
# GRAD_FLOOR of the largest gradient of the denoiser
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-6
N_FRAMES, TEXT_LEN = 128, 16
KEY = 0          # its draws keep the first prompt and drop the second


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _with(cfg, **diffusion):
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, diffusion=dataclasses.replace(m.diffusion, **diffusion)))


def _fast_schedule(cfg):
    """Warm-up 2 and lr 1e-3, so three steps move the weights; an EMA
    decay of 0.5, so the EMA moves with them."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, warmup_steps=2, lr=1e-3, ema_decay=0.5))


def jax_draws(key, cfg, B: int) -> dict:
    """The draws of JAX's ``Stage2Trainer.loss`` for ``key``, in its order."""
    m = cfg.model
    rng_drop, rng_diff = jax.random.split(key)
    drop = jax.random.bernoulli(rng_drop, m.diffusion.cond_dropout, (B,))
    rng_t, rng_n = jax.random.split(rng_diff)
    return {"drop": t(drop),
            "n": t(jax.random.normal(rng_t, (B,))),
            "noise": t(jax.random.normal(
                rng_n, (B, m.style.n_codes, m.style.d_style), jnp.float32))}


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    jcfg, pcfg = _with(jax_tiny(), cond_dropout=0.5), \
        _with(torch_tiny(), cond_dropout=0.5)
    tree = random_tree(jcfg)
    params = convert_params(tree, pcfg)
    nb = j_data.SyntheticDataset(jcfg.model, batch_size=2, seed=0,
                                 n_frames=N_FRAMES, text_len=TEXT_LEN) \
        .next_batch()
    return {"jcfg": jcfg, "pcfg": pcfg, "tree": tree, "params": params,
            "jb": JT.batch_to_device(nb), "pb": PT.batch_to_device(nb, "cpu")}


def _grad_check(got: dict, ref: dict) -> None:
    scale = max(np.abs(r).max() for r in ref.values())
    for k, r in ref.items():
        err = np.abs(got[k] - r).max()
        assert err <= GRAD_RTOL * np.abs(r).max() + GRAD_FLOOR * scale, \
            (k, err, np.abs(r).max())


def _diffusion_np(dtree, world) -> dict:
    """A JAX diffusion tree in the port's names, as numpy."""
    conv = convert_params({**world["tree"], "diffusion": dtree},
                          world["pcfg"])
    return {k: n(v) for k, v in conv["diffusion"].items()}


# --- the conditioning and the sampling paths ----------------------------------

def _cond_inputs(cfg, B: int = 3, seed: int = 1):
    m = cfg.model
    rs = np.random.default_rng(seed)
    D, P, Tt = m.text_encoder.dim, m.prompt_encoder.n_prompt_tokens, 7
    text_enc = rs.standard_normal((B, Tt, D)).astype(np.float32)
    tokens = rs.standard_normal((B, P, D)).astype(np.float32)
    summary = rs.standard_normal((B, D)).astype(np.float32)
    mask = np.arange(Tt)[None] < np.array([7, 4, 1])[:B, None]
    return text_enc, tokens, summary, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_context_and_summary_with_mixed_drop_equal_jax(world, dtype):
    """``_context``/``_summary`` with drop (True, False, True), with a mask
    and without: exactly JAX's, the nulls cast to the prompt's dtype."""
    jcfg, pcfg = world["jcfg"], world["pcfg"]
    m = jcfg.model
    jd = JStyleDiffusion(m.diffusion, m.style, ctx_dim=m.text_encoder.dim)
    jp = to_jax({"params": world["tree"]["diffusion"]["params"]})
    pd = build_frozen_modules(pcfg, world["params"], ("diffusion",),
                              device="cpu")["diffusion"]
    text_enc, tokens, summary, mask = _cond_inputs(jcfg)
    drop = np.array([True, False, True])
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for msk in (mask, None):
        jctx, jmask = jd.apply(
            jp, jnp.asarray(text_enc, jdt), jnp.asarray(tokens, jdt),
            None if msk is None else jnp.asarray(msk), jnp.asarray(drop),
            method=JStyleDiffusion._context)
        ctx, cmask = pd._context(t(text_enc).to(dtype), t(tokens).to(dtype),
                                 None if msk is None else t(msk), t(drop))
        assert ctx.dtype == dtype
        np.testing.assert_array_equal(n(ctx), n(jctx))
        if msk is None:
            assert cmask is None and jmask is None
        else:
            np.testing.assert_array_equal(n(cmask), n(jmask))
    jsum = jd.apply(jp, jnp.asarray(summary, jdt), jnp.asarray(drop),
                    method=JStyleDiffusion._summary)
    got = pd._summary(t(summary).to(dtype), t(drop))
    np.testing.assert_array_equal(n(got), n(jsum))
    assert pd._summary(t(summary), None) is not None
    np.testing.assert_array_equal(n(pd._summary(t(summary), None)), summary)


def _old_cfg_context(self, text_enc, prompt_tokens, prompt_summary,
                     text_mask):
    """The doubled-batch context as the sampling paths built it before
    ``_context`` and ``_summary`` existed."""
    B, P, C = prompt_tokens.shape
    null_tok = self.null_prompt_tokens.to(prompt_tokens.dtype)[None] \
        .expand(B, P, C)
    ctx2 = torch.cat([torch.cat([text_enc, prompt_tokens], dim=1),
                      torch.cat([text_enc, null_tok], dim=1)], dim=0)
    mask2 = None
    if text_mask is not None:
        pm = torch.ones(B, P, dtype=torch.bool, device=text_mask.device)
        m = torch.cat([text_mask, pm], dim=1)
        mask2 = torch.cat([m, m], dim=0)
    null_sum = self.null_prompt_summary.to(prompt_summary.dtype)[None] \
        .expand_as(prompt_summary)
    return ctx2, mask2, torch.cat([prompt_summary, null_sum], dim=0)


def test_sampling_paths_unchanged_bit_for_bit(world, monkeypatch):
    """``_cfg_context`` rebuilt on ``_context``/``_summary`` gives the
    tensors it gave before, bit for bit (fp32 and bf16 prompts, with and
    without a mask), and ``sample`` and ``sample_onestep`` return what
    they returned with the old context."""
    pcfg = world["pcfg"]
    pd = build_frozen_modules(pcfg, world["params"], ("diffusion",),
                              device="cpu")["diffusion"]
    text_enc, tokens, summary, mask = _cond_inputs(world["jcfg"])
    for dt in (torch.float32, torch.bfloat16):
        for msk in (t(mask), None):
            args = (t(text_enc).to(dt), t(tokens).to(dt), t(summary).to(dt),
                    msk)
            for a, b in zip(pd._cfg_context(*args),
                            _old_cfg_context(pd, *args)):
                assert (a is None and b is None) or torch.equal(a, b)
    noise = torch.randn(3, pcfg.model.style.n_codes, pcfg.model.style.d_style,
                        generator=torch.Generator().manual_seed(2))
    args = (t(text_enc), t(tokens), t(summary))
    with torch.no_grad():
        new = (pd.sample(noise, *args, text_mask=t(mask), n_steps=3),
               pd.sample_onestep(noise, *args, text_mask=t(mask)))
        monkeypatch.setattr(type(pd), "_cfg_context", _old_cfg_context)
        old = (pd.sample(noise, *args, text_mask=t(mask), n_steps=3),
               pd.sample_onestep(noise, *args, text_mask=t(mask)))
    for a, b in zip(new, old):
        assert torch.equal(a, b)


# --- the loss, its gradients, init_all ----------------------------------------

@pytest.fixture(scope="module")
def stage2_loss(world):
    """JAX's stage-2 loss with its gradients, and the port's with JAX's
    draws, once."""
    jcfg, pcfg, tree = world["jcfg"], world["pcfg"], world["tree"]
    jtr = JT.Stage2Trainer(jcfg)
    key = jax.random.PRNGKey(KEY)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jtr.loss, has_aux=True))(
        to_jax(tree["diffusion"]), to_jax(tree["acoustic"]), world["jb"], key)
    draws = jax_draws(key, jcfg, 2)
    ptr = PT.Stage2Trainer(pcfg, world["params"], device="cpu")
    state = ptr.init_state(world["params"]["diffusion"])
    ptr.load(state.params)
    before = dict(plain.twin_vjp_calls)
    pl, paux, pg = ptr.grads(world["pb"], **draws)
    twins = {k: v - before.get(k, 0) for k, v in plain.twin_vjp_calls.items()}
    return {"j": (float(jl), float(jaux["diff"]), _diffusion_np(jg, world)),
            "p": (pl.item(), paux["diff"].item(),
                  {k: n(v) for k, v in pg.items()}),
            "draws": draws, "twins": twins}


def test_stage2_draws_drop_one_prompt_of_two(stage2_loss):
    """The key's Bernoulli draw is mixed, so the loss below runs the
    learned nulls and the prompt in one batch."""
    assert stage2_loss["draws"]["drop"].tolist() == [False, True]


def test_stage2_loss_matches_jax(stage2_loss):
    (jl, jdiff, _), (pl, pdiff, _) = stage2_loss["j"], stage2_loss["p"]
    assert pl == pdiff and jl == jdiff
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


def test_stage2_gradients_match_jax_on_every_denoiser_leaf(stage2_loss, world):
    """Every leaf of the denoiser and the two nulls (the dropped prompt
    reaches them through ``torch.where``); the attention's backward is its
    twin's (two per block: self and cross)."""
    jg, pg = stage2_loss["j"][2], stage2_loss["p"][2]
    assert pg.keys() == jg.keys()
    assert {"null_prompt_summary", "null_prompt_tokens"} <= pg.keys()
    assert np.abs(pg["null_prompt_tokens"]).max() > 0
    _grad_check(pg, jg)
    assert stage2_loss["twins"].get("full_attention") == \
        2 * world["pcfg"].model.diffusion.n_layers


def test_init_all_matches_jax(world):
    """``init_all``: the loss with no prompt dropped, on JAX's draws."""
    jcfg, pcfg = world["jcfg"], world["pcfg"]
    m = jcfg.model
    rs = np.random.default_rng(3)
    B, K, d = 2, m.style.n_codes, m.style.d_style
    target = rs.standard_normal((B, K, d)).astype(np.float32)
    text_enc, tokens, summary, _ = _cond_inputs(jcfg, B=B)
    key = jax.random.PRNGKey(5)
    jd = JStyleDiffusion(m.diffusion, m.style, ctx_dim=m.text_encoder.dim)
    jl = jax.jit(lambda *a: jd.apply(*a, method=JStyleDiffusion.init_all))(
        to_jax(world["tree"]["diffusion"]), jnp.asarray(target),
        jnp.asarray(text_enc), jnp.asarray(tokens), jnp.asarray(summary), key)
    rng_t, rng_n = jax.random.split(key)
    pd = build_frozen_modules(pcfg, world["params"], ("diffusion",),
                              device="cpu")["diffusion"]
    pl = pd.init_all(t(target), t(text_enc), t(tokens), t(summary),
                     n=t(jax.random.normal(rng_t, (B,))),
                     noise=t(jax.random.normal(rng_n, (B, K, d))))
    np.testing.assert_allclose(float(pl), float(jl), rtol=LOSS_RTOL)


def test_three_stage2_steps_match_jax(world):
    """Three ``train_step``s on both sides (warm-up 2, lr 1e-3, EMA decay
    0.5), each on its key's draws: the loss of every step, then the loss at
    the final masters and at the final EMA.  The weights are compared
    through the loss they give, not leaf by leaf: a leaf whose gradient is
    zero by construction (an attention key's bias, under the softmax's
    shift invariance) holds only rounding, which Adam's normalised update
    turns into steps of up to lr.  fp32 rounding grows through the
    updates: 1e-4 relative."""
    jcfg, pcfg = _fast_schedule(world["jcfg"]), _fast_schedule(world["pcfg"])
    tree = world["tree"]
    jtr = JT.Stage2Trainer(jcfg)
    jstate = jtr.init_state(to_jax(tree["diffusion"]))
    ac = to_jax(tree["acoustic"])
    ptr = PT.Stage2Trainer(pcfg, world["params"], device="cpu")
    pstate = ptr.init_state(world["params"]["diffusion"])
    losses = []
    for i in range(3):
        key = jax.random.PRNGKey(i)
        jstate, jm = jtr.train_step(jstate, ac, world["jb"], key)
        pstate, pm = ptr.train_step(pstate, world["pb"],
                                    **jax_draws(key, jcfg, 2))
        assert set(pm) == set(jm) == {"diff"}
        np.testing.assert_allclose(float(pm["diff"]), float(jm["diff"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        losses.append(float(jm["diff"]))
    assert pstate.step == 3 and int(jstate["step"]) == 3
    key = jax.random.PRNGKey(3)
    draws = jax_draws(key, jcfg, 2)
    jloss = jax.jit(jtr.loss)
    for name, got, ref in (("masters", pstate.params, jstate["params"]),
                           ("EMA", pstate.ema, jstate["ema"])):
        jl, _ = jloss(ref, ac, world["jb"], key)
        ptr.load(got)
        with torch.no_grad():
            pl, _ = ptr.loss(world["pb"], **draws)
        np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-4,
                                   err_msg=name)
    # the EMA moved: its weights give another loss than the start's
    jl0, _ = jloss(to_jax(tree["diffusion"]), ac, world["jb"], key)
    assert abs(float(jl) - float(jl0)) > 1e-3 * abs(float(jl0))


# --- checkpoints --------------------------------------------------------------

def test_checkpoint_manager_saves_restores_and_keeps(tmp_path):
    """Numbered saves, the newest ``keep`` kept; ``restore`` of the latest
    or a given step, bit for bit, on the CPU or placed and checked as
    ``like``; a tree of another shape is refused; ``save_params`` /
    ``load_params`` round-trip a parameter tree."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"), keep=2)
    assert mgr.latest_step() is None and mgr.restore() is None
    tree = {"g": {"a": torch.arange(6.0).reshape(2, 3)},
            "d": {"b": torch.ones(4, dtype=torch.float32)}}
    for step in (10, 20, 30):
        mgr.save(step, {"g": {"a": tree["g"]["a"] + step}, "d": tree["d"]})
    mgr.wait()
    assert mgr.steps() == [20, 30] and mgr.latest_step() == 30
    assert not (tmp_path / "run" / "10").exists()
    got = mgr.restore()
    assert torch.equal(got["g"]["a"], tree["g"]["a"] + 30)
    like = {"g": {"a": torch.zeros(2, 3, dtype=torch.float64)},
            "d": {"b": torch.zeros(4)}}
    got = mgr.restore(20, like=like)
    assert got["g"]["a"].dtype == torch.float64
    assert torch.equal(got["g"]["a"], (tree["g"]["a"] + 20).double())
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(20, like={"g": {"a": torch.zeros(3, 2)}, "d": like["d"]})
    with pytest.raises(KeyError):
        mgr.restore(20, like={"g": like["g"]})
    mgr.close()
    # a new manager on the same directory finds what is there
    assert ckpt.CheckpointManager(str(tmp_path / "run")).latest_step() == 30
    params = init_params(torch_tiny(), seed=3, device="cpu")
    ckpt.save_params(str(tmp_path / "p.pt"), params)
    back = ckpt.load_params(str(tmp_path / "p.pt"), like=params)
    assert back.keys() == params.keys()
    for part in params:
        for k, v in params[part].items():
            assert torch.equal(back[part][k], v), (part, k)


# --- the train command --------------------------------------------------------

@pytest.mark.parametrize("stage,out", [(1, "stage1_final"),
                                       (2, "stage2_final")])
def test_cli_train_writes_the_stage_output(tmp_path, stage, out):
    """``python -m styletts_zs_torch.cli train --stage N --steps 2 --device
    cpu`` at tiny size: it logs the first step and writes the stage's
    output, JAX's tree (stage 1: the generator's EMA and the
    discriminator; stage 2: the denoiser's EMA), finite."""
    config = write_tiny_config(tmp_path)
    r = run_cli(["--stage", str(stage), "--steps", "2", "--device", "cpu"],
                config, tmp_path / "work")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "step 0:" in r.stdout and "training done" in r.stdout
    tree = ckpt.load_params(str(tmp_path / "work" / out))
    params = init_params(torch_tiny(), device="cpu",
                         with_discriminator=stage == 1)
    want = ({"g": {p: params[p] for p in ("acoustic", "vocoder")},
             "d": params["discriminator"]} if stage == 1
            else params["diffusion"])
    ckpt.load_params(str(tmp_path / "work" / out), like=want)  # same tree
    leaves = [v for part in tree.values()
              for v in (part.values() if isinstance(part, dict) else [part])]
    leaves = [x for v in leaves
              for x in (v.values() if isinstance(v, dict) else [v])]
    assert leaves and all(torch.isfinite(v).all() for v in leaves)


def test_cli_train_stage2_trains_the_ckpt_weights(tmp_path):
    """``--ckpt`` reads a whole tree written by ``save_params``; with two
    steps (lr 0, then 1e-7 in the warm-up) the EMA stays within 1e-6 of the
    checkpoint's denoiser, far from the seeded one."""
    config = write_tiny_config(tmp_path)
    mine = init_params(torch_tiny(), seed=7, device="cpu")
    ckpt.save_params(str(tmp_path / "mine.pt"), mine)
    r = run_cli(["--stage", "2", "--steps", "2", "--device", "cpu",
                 "--ckpt", str(tmp_path / "mine.pt")], config,
                tmp_path / "work")
    assert r.returncode == 0, r.stderr[-2000:]
    ema = ckpt.load_params(str(tmp_path / "work" / "stage2_final"))
    seeded = init_params(torch_tiny(), device="cpu")["diffusion"]
    for k, v in mine["diffusion"].items():
        np.testing.assert_allclose(n(ema[k]), n(v), rtol=0, atol=1e-6,
                                   err_msg=k)
    k = "denoiser.in_proj.weight"
    assert (ema[k] - seeded[k]).abs().max() > 1e-2


# --- chip_smoke.py's stage-2 phase, rehearsed on the CPU ----------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_stage2_rehearsal_on_cpu(world):
    """The stage-2 phase's drive at tiny size, its counts as
    ``stage2_expected_counts`` predicts them: the frozen extractor (1
    block, 2 pools), prompt encoder (1 block and the pooling) and text
    encoder (1 block), forward only, and the denoiser's 2 blocks x (self,
    cross) with their twin backwards; a count off its expectation fails
    the run."""
    cs = _chip_smoke()
    cfg = torch_tiny()
    params = init_params(cfg, seed=0, device="cpu")
    tr = PT.Stage2Trainer(cfg, params, device="cpu")
    state = tr.init_state(params["diffusion"])
    r = cs.drive_train(cfg, tr, state, world["pb"], device="cpu", n_steps=2,
                       expect=cs.stage2_expected_counts(cfg),
                       label="stage-2 step")
    assert r["per_step"] == {"full_attention": 10}
    assert r["twins"] == {"full_attention": 8}
    assert set(r["losses"]) == {"diff"}
    assert r["state"].step == 2
    wrong = {"kernels": {"full_attention": 9},
             "twins": {"full_attention": 4}}
    with pytest.raises(AssertionError, match="full_attention"):
        cs.drive_train(cfg, tr, state, world["pb"], device="cpu", n_steps=1,
                       expect=wrong)

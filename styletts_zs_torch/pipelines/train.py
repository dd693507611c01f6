"""The three training stages on the card: stage 1 (the acoustic GAN step),
stage 2 (the style-diffusion EDM step), stage 3 (1-step distillation with
the perceptual loss).

Counterpart of ``styletts_zs_tpu/pipelines/train.py``, term for term.
Stage 1 (``make_optimizer``, ``Stage1Trainer``): the generator loss
is the mel L1, the LSGAN adversarial and feature-matching terms, the
duration, F0 and energy L1s, the forward-sum aligner, the speaker InfoNCE
with its reconstructed-mel and vocoded-mel views against the stop-gradient
reference embedding, and the FSQ usage-entropy bonus; the discriminator step
re-runs the generator forward with the updated generator weights (under
``no_grad``); then an EMA of the generator weights.

State: fp32 master weights and optimiser moments (``TrainState``, dicts of
tensors keyed like the parameter dicts of ``pipelines.factory``); the
forward runs on working copies in the compute dtype (``build_train_modules``),
refreshed from the masters before each loss, whose gradients are upcast to
fp32: Flax's cast of fp32 parameters at each use gives the same gradient.
The optimiser is optax's ``clip_by_global_norm`` then ``adamw`` on a
warm-up cosine schedule, written out: the schedule is read at the update
count before its increment, so the first update has lr 0 and changes
nothing, weight decay included; the clip scales by max/||g|| only when
||g|| >= max (no epsilon).  Dropout draws from the trainer's
``torch.Generator`` (the JAX PRNG cannot be reproduced; parity runs set the
rates to 0).  With ``use_mas_durations`` (a corpus without duration
annotations), monotonic alignment search over the aligner's energies gives
the durations that ``reconstruct`` expands by and the duration loss's
target, without a gradient; the discriminator step recomputes them with the
updated generator weights, as JAX's ``d_loss`` re-runs the whole generator
forward.

Stages 2 and 3 (``Stage2Trainer``, ``Stage3Trainer``) train the style
denoiser in fp32 (the diffusion net's dtype) on fp32 masters, against the
acoustic model frozen in its compute-dtype copy (gradients off, eval mode).
Stage 2: the frozen extractor's style of the ground-truth mel is the
target, the prompt and text encodings the conditioning, a Bernoulli
``cond_dropout`` nulls the prompt, and the EDM loss
(``StyleDiffusion.forward``) trains the denoiser; then the EMA.  Stage 3:
the student starts as a copy of the teacher; one standard-normal draw goes
to the teacher's multi-step sampler (no grad) and the student's 1-step
path; the loss is the latent MSE plus the masked L1 between the two mels
that the frozen acoustic model decodes from the quantised styles (the
teacher's without grad, its frame mask used).  The draws (JAX's PRNG
cannot be reproduced) are inputs of ``loss``; when not given they come
from the trainer's ``torch.Generator``.

Data parallelism (``mesh=``, JAX's batch sharded over the ``data`` axis):
each rank holds its rows of the global batch, and its loss is the global
loss in mean form (``_DataAxis``), so that ``pmean_grads`` of the ranks'
gradients is the global batch's gradient; the clip then sees the reduced
gradient and every rank applies the same update.  ``state_tree`` and
``state_from_tree`` turn a train state into a tree ``save_params`` writes
and back.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from styletts_zs_torch.config import Config
from styletts_zs_torch.models.discriminators import (discriminator_loss,
                                                     feature_matching_loss,
                                                     generator_adv_loss)
from styletts_zs_torch.ops import align as align_ops
from styletts_zs_torch.ops import fsq as fsq_ops
from styletts_zs_torch.ops import stft as stft_ops
from styletts_zs_torch.ops.attention import length_mask
from styletts_zs_torch.parallel import collectives
from styletts_zs_torch.parallel import mesh as mesh_lib
from styletts_zs_torch.pipelines.factory import (build_frozen_modules,
                                                 build_train_modules,
                                                 resolve_device)

G_PARTS = ("acoustic", "vocoder")
BATCH_KEYS = ("phonemes", "text_lengths", "durations", "wav", "f0", "energy",
              "frame_lengths", "ref_wav")


def batch_to_device(batch, device, sharding=None) -> dict[str, torch.Tensor]:
    """A numpy ``Batch`` (or dict) -> a dict of tensors on ``device``;
    with ``sharding`` (``parallel.mesh.batch_sharding``), this rank's
    rows."""
    src = batch if isinstance(batch, dict) else vars(batch)
    take = sharding.take if sharding is not None else (lambda x: x)
    return {k: torch.as_tensor(take(src[k])).to(device) for k in BATCH_KEYS}


# ---------------------------------------------------------------------------
# the global batch: one process, or the data ranks of a mesh
# ---------------------------------------------------------------------------

class _OneProcess:
    """The batch a process holds is the global batch."""
    n = 1

    def total(self, x):
        return x

    def gather(self, x, grad: bool = True):
        return x

    # ``fsq.entropy_losses`` takes its own batch mean
    batch_mean = None

    def rows(self, x):
        return x

    def mean(self, tree):
        return tree


class _DataAxis:
    """The data ranks of ``mesh`` hold the global batch between them, each
    its rows.  A rank's loss is the global loss in mean form: the mean over
    the ranks of their losses is the loss of the global batch, so the mean
    of their gradients (``pmean_grads``) is its gradient.  Per-utterance
    means over equal row counts average as they are; masked means divide
    the rank's sum by the global mask count (``total``) times n; the
    speaker InfoNCE's logits span the gathered embeddings and the codebook
    entropy the gathered probabilities, both with their gradients."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sharding = mesh_lib.batch_sharding(mesh)
        self.n = self.sharding.count

    def total(self, x):
        return collectives.all_sum(self.mesh, x)

    def gather(self, x, grad: bool = True):
        return collectives.gather_rows(self.mesh, x, grad=grad)

    def batch_mean(self, x):
        return collectives.all_sum(self.mesh, x.sum(dim=0), grad=True) \
            / (x.shape[0] * self.n)

    def rows(self, x):
        return self.sharding.take(x)

    def mean(self, tree):
        return collectives.pmean_grads(tree, self.mesh)


def _data_group(mesh):
    return _OneProcess() if mesh is None else _DataAxis(mesh)


# ---------------------------------------------------------------------------
# optimiser: optax's clip_by_global_norm + adamw(warmup_cosine_decay)
# ---------------------------------------------------------------------------

def warmup_cosine_lr(count: int, peak: float, warmup: int,
                     decay_steps: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)``
    at ``count``: linear from 0 over the warm-up, then cosine to 0."""
    if count < warmup:
        return peak * count / warmup
    t = min(count - warmup, decay_steps - warmup)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup)))


@dataclass
class AdamState:
    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


class AdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(schedule, b1, b2,
    eps=1e-8, weight_decay))`` over a list of fp32 tensors."""

    def __init__(self, cfg: Config, lr: float | None = None):
        t = cfg.train
        self.peak = lr or t.lr
        self.warmup = t.warmup_steps
        self.decay_steps = max(t.n_steps, t.warmup_steps + 1)
        self.b1, self.b2, self.eps = t.adam_b1, t.adam_b2, 1e-8
        self.wd, self.clip = t.weight_decay, t.grad_clip

    def lr(self, count: int) -> float:
        return warmup_cosine_lr(count, self.peak, self.warmup,
                                self.decay_steps)

    def init(self, params: list[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(self, grads, state: AdamState, params):
        """(new params, new state); grads fp32, params updated out of place."""
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm)
        g = torch._foreach_mul(grads, scale)
        count = state.count + 1
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - self.b1),
                                torch._foreach_mul(state.mu, self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2),
            torch._foreach_mul(state.nu, self.b2))
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        nu_hat = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        upd = torch._foreach_div(mu_hat, torch._foreach_add(
            torch._foreach_sqrt(nu_hat), self.eps))
        upd = torch._foreach_add(upd, torch._foreach_mul(params, self.wd))
        new = torch._foreach_add(params, torch._foreach_mul(
            upd, -self.lr(state.count)))
        return new, AdamState(count, mu, nu)


def make_optimizer(cfg: Config, lr: float | None = None) -> AdamW:
    return AdamW(cfg, lr)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _masked_l1(a, b, mask, dp=_OneProcess()):
    """JAX's ``_masked_l1``, its denominator as it is: the mask is widened
    to a's rank first, so the channel factor never applies.  ``dp``: the
    global batch the denominator counts."""
    m = mask.float()
    while m.ndim < a.ndim:
        m = m[..., None]
    diff = torch.abs(a.float() - b.float()) * m
    return diff.sum() * dp.n / torch.clamp(dp.total(
        m.sum() * (a.shape[-1] if a.ndim > m.ndim else 1.0)), min=1.0)


def _masked_l1_feat(a, b, mask, dp=_OneProcess()):
    """L1 over (B, T, C) with a (B, T) mask."""
    m = mask.float()[..., None]
    diff = torch.abs(a.float() - b.float()) * m
    return diff.sum() * dp.n / torch.clamp(dp.total(m.sum() * a.shape[-1]),
                                           min=1.0)


def _l2normalize(e):
    e = e.float()
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                           min=1e-8)


@dataclass
class TrainState:
    step: int
    g_params: dict[str, dict[str, torch.Tensor]]   # fp32 masters
    d_params: dict[str, torch.Tensor]
    g_opt: AdamState
    d_opt: AdamState
    ema_params: dict[str, dict[str, torch.Tensor]]


def _detached(aux: dict) -> dict:
    return {k: v.detach() for k, v in aux.items()}


def _flat(tree: dict[str, dict[str, torch.Tensor]]) -> list[torch.Tensor]:
    return [t for part in tree.values() for t in part.values()]


def _unflat(like, flat):
    it = iter(flat)
    return {part: {k: next(it) for k in sd} for part, sd in like.items()}


class Stage1Trainer:
    """The stage-1 acoustic GAN step.  ``params``: fp32 parameter dicts
    with ``"acoustic"``, ``"vocoder"`` and ``"discriminator"``; the modules
    run on ``device`` (the card unless ``device="cpu"``); ``seed`` seeds
    the dropout generator (plus the data rank under a mesh).  With
    ``mesh`` (``parallel.mesh.make_mesh``) each rank is given its rows of
    the global batch (``batch_to_device(..., sharding=)``) and a step
    computes the loss of the global batch: the aux losses and gradients
    that ``g_grads``/``d_grads`` return are the global batch's on every
    rank, so every rank applies the same update."""

    def __init__(self, cfg: Config, params, *, device=None, seed: int = 0,
                 mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dp = _data_group(mesh)
        if mesh is not None:
            seed += self.dp.sharding.index
        mods = build_train_modules(cfg, params, G_PARTS + ("discriminator",),
                                   device=self.device)
        self.acoustic, self.vocoder = mods["acoustic"], mods["vocoder"]
        self.discriminator = mods["discriminator"]
        self.g_tx = make_optimizer(cfg)
        self.d_tx = make_optimizer(cfg, cfg.train.lr_disc)
        self.rng = torch.Generator(device=self.device).manual_seed(seed)

    # -- parameters ---------------------------------------------------------

    def init_state(self, params) -> TrainState:
        """fp32 copies on the device, in the modules' parameter order:
        masters, moments and the EMA."""
        def copy(part):
            return {k: params[part][k].detach().to(self.device,
                                                   torch.float32).clone()
                    for k in self._names(part)}
        g = {p: copy(p) for p in G_PARTS}
        d = copy("discriminator")
        return TrainState(0, g, d, self.g_tx.init(_flat(g)),
                          self.d_tx.init(list(d.values())),
                          {p: {k: v.clone() for k, v in g[p].items()}
                           for p in G_PARTS})

    def _g_working(self) -> list[torch.nn.Parameter]:
        return [*self.acoustic.parameters(), *self.vocoder.parameters()]

    @torch.no_grad()
    def load(self, g_params=None, d_params=None) -> None:
        """Copy fp32 masters into the working modules (cast)."""
        if g_params is not None:
            torch._foreach_copy_(self._g_working(), _flat(g_params))
        if d_params is not None:
            torch._foreach_copy_(list(self.discriminator.parameters()),
                                 list(d_params.values()))

    # -- forwards -----------------------------------------------------------

    def _forward_g(self, batch, rng, *, with_align: bool = True):
        """The generator forward: (out, wav_hat, mel_gt, text_mask,
        frame_mask, energies, durations).  ``with_align`` False (the
        discriminator step) skips the aligner unless MAS needs its
        energies: JAX computes them there too, but only MAS reads them."""
        m, t = self.cfg.model, self.cfg.train
        ac = self.acoustic
        n_frames = batch["f0"].shape[1]
        mel_gt = stft_ops.mel_spectrogram(batch["wav"], m.audio)[:, :n_frames]
        text_mask = length_mask(batch["text_lengths"],
                                batch["phonemes"].shape[1])
        frame_mask = length_mask(batch["frame_lengths"], n_frames)
        durations = batch["durations"]
        energies = None
        if t.use_mas_durations or (with_align and t.w_align > 0):
            # the text encoder alone: JAX's aligner discards the prosody
            # encoding, which XLA then never computes
            text_enc = ac.text_encoder(batch["phonemes"], mask=text_mask)
            energies = ac.align_energies(text_enc, mel_gt, text_mask=text_mask)
            if t.use_mas_durations:
                durations = align_ops.monotonic_alignment_search(
                    energies.detach(), batch["text_lengths"],
                    batch["frame_lengths"])
        out, _, _ = ac.reconstruct(
            batch["phonemes"], mel_gt, durations,
            text_mask=text_mask, frame_mask=frame_mask,
            f0_target=batch["f0"], energy_target=batch["energy"], rng=rng)
        wav_hat = self.vocoder(out.mel, mask=frame_mask)
        return out, wav_hat, mel_gt, text_mask, frame_mask, energies, durations

    def g_loss(self, batch, rng=None):
        """(loss, aux) of the generator with the working weights (``load``
        them first); ``rng`` the dropout generator (None: no dropout)."""
        m, t = self.cfg.model, self.cfg.train
        ac, disc = self.acoustic, self.discriminator
        out, wav_hat, mel_gt, text_mask, frame_mask, energies, durations = \
            self._forward_g(batch, rng)
        L = min(wav_hat.shape[1], batch["wav"].shape[1])
        wav_gt, wav_fake = batch["wav"][:, :L], wav_hat[:, :L]
        disc.requires_grad_(False)
        try:
            fake_lg, fake_ft = disc(wav_fake, out.mel)
            with torch.no_grad():
                real_lg, real_ft = disc(wav_gt, mel_gt)
        finally:
            disc.requires_grad_(True)
        dp = self.dp
        loss_mel = _masked_l1_feat(out.mel, mel_gt, frame_mask, dp)
        loss_adv = generator_adv_loss(fake_lg)
        loss_fm = feature_matching_loss(real_ft, fake_ft)
        dur_target = torch.log1p(durations.float())
        loss_dur = _masked_l1(out.log_dur, dur_target, text_mask, dp)
        loss_f0 = _masked_l1(out.f0, batch["f0"], frame_mask, dp)
        loss_en = _masked_l1(out.energy, batch["energy"], frame_mask, dp)
        loss = (t.w_mel * loss_mel + t.w_adv * loss_adv + t.w_fm * loss_fm
                + t.w_dur * loss_dur + t.w_f0 * loss_f0
                + t.w_energy * loss_en)
        aux = {"mel": loss_mel, "adv_g": loss_adv, "fm": loss_fm,
               "dur": loss_dur, "f0": loss_f0, "energy": loss_en}
        if energies is not None and t.w_align > 0:
            loss_align = align_ops.forward_sum_loss(
                F.log_softmax(energies, dim=-1), batch["text_lengths"],
                batch["frame_lengths"])
            loss = loss + t.w_align * loss_align
            aux["align"] = loss_align
        if t.w_spk > 0:
            ref_mel = stft_ops.mel_spectrogram(batch["ref_wav"], m.audio)
            _, e_ref = ac.encode_prompt(ref_mel)
            _, e_utt = ac.encode_prompt(mel_gt, frame_mask)
            # the logits span the global batch's embeddings
            za = dp.gather(_l2normalize(e_utt))
            zb = dp.gather(_l2normalize(e_ref))
            labels = torch.arange(za.shape[0], device=za.device)

            def nce(x, y):
                lg = (x @ y.T) / t.spk_tau
                return 0.5 * (F.cross_entropy(lg, labels)
                              + F.cross_entropy(lg.T, labels)), lg

            loss_spk, logits = nce(za, zb)
            loss = loss + t.w_spk * loss_spk
            aux["spk_nce"] = loss_spk
            aux["spk_acc"] = (logits.argmax(dim=1) == labels).float().mean()
            zb_sg = zb.detach()
            if t.w_spk_rec > 0:
                _, e_rec = ac.encode_prompt(out.mel, frame_mask)
                loss_rec, _ = nce(dp.gather(_l2normalize(e_rec)), zb_sg)
                loss = loss + t.w_spk_rec * loss_rec
                aux["spk_nce_rec"] = loss_rec
            if t.w_spk_voc > 0:
                mel_voc = stft_ops.mel_spectrogram(wav_fake, m.audio)
                Tv = min(mel_voc.shape[1], frame_mask.shape[1])
                _, e_voc = ac.encode_prompt(mel_voc[:, :Tv],
                                            frame_mask[:, :Tv])
                loss_voc, _ = nce(dp.gather(_l2normalize(e_voc)), zb_sg)
                loss = loss + t.w_spk_voc * loss_voc
                aux["spk_nce_voc"] = loss_voc
        if t.w_fsq_entropy > 0:
            z = ac.quantizer.down(ac.style_extractor(mel_gt, mask=frame_mask))
            ent_s, ent_c = fsq_ops.entropy_losses(z, m.style.fsq_levels,
                                                  batch_mean=dp.batch_mean)
            loss = loss + t.w_fsq_entropy * (ent_s - ent_c)
            aux["fsq_sample_ent"] = ent_s
            aux["fsq_code_ent"] = ent_c
        aux["total_g"] = loss
        return loss, aux

    def d_loss(self, batch, rng=None):
        """(loss, aux) of the discriminator: the generator's forward with
        the working generator weights under ``no_grad`` (MAS's durations
        recomputed with them), then the critics."""
        with torch.no_grad():
            out, wav_hat, mel_gt, _, _, _, _ = self._forward_g(
                batch, rng, with_align=False)
        L = min(wav_hat.shape[1], batch["wav"].shape[1])
        fake_lg, _ = self.discriminator(wav_hat[:, :L], out.mel)
        real_lg, _ = self.discriminator(batch["wav"][:, :L], mel_gt)
        loss = discriminator_loss(real_lg, fake_lg)
        return loss, {"total_d": loss}

    def g_grads(self, batch, rng=None):
        """(loss, aux, fp32 gradients keyed like the generator masters);
        under a mesh the aux and gradients are the means over the data
        ranks: the global batch's."""
        loss, aux = self.g_loss(batch, rng)
        params = self._g_working()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p, dtype=torch.float32) if gr is None
                 else gr.float() for p, gr in zip(params, grads)]
        names = {p: self._names(p) for p in G_PARTS}
        grads, aux = self.dp.mean((grads, _detached(aux)))
        return loss, aux, _unflat(names, grads)

    def d_grads(self, batch, rng=None):
        loss, aux = self.d_loss(batch, rng)
        params = list(self.discriminator.parameters())
        grads = torch.autograd.grad(loss, params)
        names = dict(self.discriminator.named_parameters())
        grads, aux = self.dp.mean(([gr.float() for gr in grads],
                                   _detached(aux)))
        return loss, aux, dict(zip(names, grads))

    def _names(self, part: str) -> dict[str, None]:
        return dict.fromkeys(k for k, _ in getattr(self, part)
                             .named_parameters())

    # -- the step -----------------------------------------------------------

    def train_step(self, state: TrainState, batch):
        """One generator update, one discriminator update on the updated
        generator, the EMA; returns (new state, metrics as 0-d tensors)."""
        self.load(state.g_params, state.d_params)
        _, g_aux, g_grads = self.g_grads(batch, self.rng)
        g_new, g_opt = self.g_tx.update(_flat(g_grads), state.g_opt,
                                        _flat(state.g_params))
        g_params = _unflat(state.g_params, g_new)
        self.load(g_params)
        _, d_aux, d_grads = self.d_grads(batch, self.rng)
        d_new, d_opt = self.d_tx.update(list(d_grads.values()), state.d_opt,
                                        list(state.d_params.values()))
        d_params = dict(zip(state.d_params, d_new))
        decay = self.cfg.train.ema_decay
        ema = torch._foreach_add(
            torch._foreach_mul(_flat(state.ema_params), decay),
            torch._foreach_mul(g_new, 1.0 - decay))
        new_state = TrainState(state.step + 1, g_params, d_params, g_opt,
                               d_opt, _unflat(state.ema_params, ema))
        return new_state, {k: v.detach() for k, v in {**g_aux,
                                                      **d_aux}.items()}


# ---------------------------------------------------------------------------
# stages 2 and 3: the style denoiser against the frozen acoustic model
# ---------------------------------------------------------------------------

@dataclass
class DiffusionTrainState:
    step: int
    params: dict[str, torch.Tensor]        # fp32 denoiser masters
    opt: AdamState
    ema: dict[str, torch.Tensor] | None = None   # stage 2 only


class _DiffusionTrainer:
    """What stages 2 and 3 share: the acoustic model frozen in its compute
    dtype, a working fp32 ``StyleDiffusion`` with gradients on, its
    optimiser and the generator of the draws.  With ``mesh`` each rank is
    given its rows of the global batch and of any draw handed in; a draw
    not handed in is drawn at the global batch's shape (the generator is
    seeded alike on every rank) and cut to the rank's rows, so the step
    equals the one-process step on the global batch."""

    frozen_parts: tuple[str, ...] = ("acoustic",)

    def __init__(self, cfg: Config, params, *, device=None, seed: int = 0,
                 mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dp = _data_group(mesh)
        self.frozen = build_frozen_modules(cfg, params, self.frozen_parts,
                                           device=self.device)
        self.acoustic = self.frozen["acoustic"]
        self.diffusion = build_train_modules(cfg, params, ("diffusion",),
                                             device=self.device)["diffusion"]
        self.tx = make_optimizer(cfg)
        self.rng = torch.Generator(device=self.device).manual_seed(seed)

    def _masters(self, diffusion_params) -> dict[str, torch.Tensor]:
        """fp32 copies on the device, in the working module's order."""
        return {k: diffusion_params[k].detach().to(self.device,
                                                   torch.float32).clone()
                for k, _ in self.diffusion.named_parameters()}

    @torch.no_grad()
    def load(self, params: dict[str, torch.Tensor]) -> None:
        """Copy the fp32 masters into the working denoiser."""
        torch._foreach_copy_(list(self.diffusion.parameters()),
                             list(params.values()))

    @torch.no_grad()
    def _condition(self, batch, *, prosody: bool):
        """The frozen conditioning: (text mask, prompt tokens, summary,
        (text encoding, prosody encoding or None))."""
        m, ac = self.cfg.model, self.acoustic
        phonemes = batch["phonemes"]
        text_mask = length_mask(batch["text_lengths"], phonemes.shape[1])
        ref_mel = stft_ops.mel_spectrogram(batch["ref_wav"], m.audio)
        tokens, summary = ac.encode_prompt(ref_mel)
        # stage 2 discards the prosody encoding, which XLA never computes
        encoded = (ac.encode_text(phonemes, text_mask) if prosody
                   else (ac.text_encoder(phonemes, mask=text_mask), None))
        return text_mask, tokens, summary, encoded

    def grads(self, batch, **draws):
        """(loss, aux, fp32 gradients keyed like the denoiser masters) with
        the working weights (``load`` them first); under a mesh the scalar
        aux and the gradients are the means over the data ranks (the global
        batch's), per-utterance aux gathered over them."""
        loss, aux = self.loss(batch, **draws)
        named = list(self.diffusion.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g.float()
                 for (k, p), g in zip(named, grads)}
        scalars = {k: v.detach() for k, v in aux.items() if v.ndim == 0}
        grads, scalars = self.dp.mean((grads, scalars))
        return loss, {k: scalars[k] if k in scalars
                      else self.dp.gather(v.detach(), grad=False)
                      for k, v in aux.items()}, grads

    def _draw(self, shape, kind: str):
        """A draw of this rank's rows of a global (n * shape[0], ...) draw
        from the trainer's generator: ``rand`` or ``randn``."""
        full = (shape[0] * self.dp.n, *shape[1:])
        fn = torch.rand if kind == "rand" else torch.randn
        return self.dp.rows(fn(full, generator=self.rng, device=self.device))

    def _update(self, state: DiffusionTrainState, grads):
        new, opt = self.tx.update(list(grads.values()), state.opt,
                                  list(state.params.values()))
        return dict(zip(state.params, new)), opt


class Stage2Trainer(_DiffusionTrainer):
    """The stage-2 style-diffusion step.  ``params``: fp32 parameter dicts
    with ``"acoustic"`` (frozen) and ``"diffusion"``; the modules run on
    ``device`` (the card unless ``device="cpu"``); ``seed`` seeds the
    draws."""

    def init_state(self, diffusion_params) -> DiffusionTrainState:
        """fp32 masters, moments and the EMA from the denoiser's tree."""
        p = self._masters(diffusion_params)
        return DiffusionTrainState(0, p, self.tx.init(list(p.values())),
                                   {k: v.clone() for k, v in p.items()})

    def loss(self, batch, *, drop=None, n=None, noise=None):
        """(loss, {"diff"}): the EDM loss of the frozen extractor's style of
        the ground-truth mel, conditioned on the frozen text and prompt
        encodings.  ``drop`` (B,) bool nulls the prompt (drawn Bernoulli
        ``cond_dropout`` when not given); ``n`` and ``noise`` are
        ``StyleDiffusion.forward``'s draws."""
        m = self.cfg.model
        with torch.no_grad():
            n_frames = batch["f0"].shape[1]
            mel_gt = stft_ops.mel_spectrogram(batch["wav"], m.audio)[
                :, :n_frames]
            frame_mask = length_mask(batch["frame_lengths"], n_frames)
            styled, _, _ = self.acoustic.extract_style(mel_gt, frame_mask)
        text_mask, tokens, summary, (text_enc, _) = self._condition(
            batch, prosody=False)
        B = styled.shape[0]
        # in the order ``StyleDiffusion.forward`` would draw them
        if drop is None:
            drop = self._draw((B,), "rand") < m.diffusion.cond_dropout
        if n is None:
            n = self._draw((B,), "randn")
        if noise is None:
            noise = self._draw(styled.shape, "randn")
        loss, _ = self.diffusion(styled, text_enc, tokens, summary,
                                 text_mask=text_mask, drop_prompt=drop, n=n,
                                 noise=noise)
        return loss, {"diff": loss}

    def train_step(self, state: DiffusionTrainState, batch, **draws):
        """One update and the EMA; returns (new state, metrics as 0-d
        tensors)."""
        self.load(state.params)
        _, aux, grads = self.grads(batch, **draws)
        params, opt = self._update(state, grads)
        decay = self.cfg.train.ema_decay
        ema = torch._foreach_add(
            torch._foreach_mul(list(state.ema.values()), decay),
            torch._foreach_mul(list(params.values()), 1.0 - decay))
        return (DiffusionTrainState(state.step + 1, params, opt,
                                    dict(zip(state.ema, ema))),
                {k: v.detach() for k, v in aux.items()})


STAGE3_METRICS = ("latent", "perceptual", "total_distill")


class Stage3Trainer(_DiffusionTrainer):
    """The stage-3 distillation step: the teacher (``params["diffusion"]``,
    frozen) samples with ``n_teacher_steps`` (default
    ``diffusion.n_steps``) Heun steps, the student's one CFG call must
    reproduce its end point, in latent space and through the frozen
    acoustic decoder."""

    frozen_parts = ("acoustic", "diffusion")

    def __init__(self, cfg: Config, params, *, device=None, seed: int = 0,
                 n_teacher_steps: int | None = None, mesh=None):
        super().__init__(cfg, params, device=device, seed=seed, mesh=mesh)
        self.teacher = self.frozen["diffusion"]
        self.n_teacher_steps = n_teacher_steps or cfg.model.diffusion.n_steps

    def init_state(self, teacher_params) -> DiffusionTrainState:
        """The student's fp32 masters, a copy of the teacher's tree, and
        their moments."""
        p = self._masters(teacher_params)
        return DiffusionTrainState(0, p, self.tx.init(list(p.values())))

    def loss(self, batch, *, noise=None):
        """(loss, aux): aux holds JAX's ``latent``, ``perceptual`` and
        ``total_distill`` and the two decodes' predicted durations.
        ``noise`` (B, K, d_style) is the standard-normal draw both samplers
        start from (drawn when not given)."""
        m, t, ac = self.cfg.model, self.cfg.train, self.acoustic
        text_mask, tokens, summary, encoded = self._condition(
            batch, prosody=True)
        text_enc = encoded[0]
        if noise is None:
            noise = self._draw((text_enc.shape[0], m.style.n_codes,
                                m.style.d_style), "randn")
        with torch.no_grad():
            s_teacher = self.teacher.sample(
                noise, text_enc, tokens, summary, text_mask=text_mask,
                n_steps=self.n_teacher_steps)
        s_student = self.diffusion.sample_onestep(
            noise, text_enc, tokens, summary, text_mask=text_mask)
        loss_latent = torch.mean((s_student.float() - s_teacher.float()) ** 2)

        def decode(style):
            return ac.text_to_mel(batch["phonemes"], ac.quantize_style(style),
                                  text_mask=text_mask,
                                  n_frames=batch["f0"].shape[1],
                                  encoded=encoded)

        with torch.no_grad():
            out_t = decode(s_teacher)
        out_s = decode(s_student)
        loss_perc = _masked_l1_feat(out_s.mel, out_t.mel, out_t.frame_mask,
                                    self.dp)
        loss = t.w_latent * loss_latent + t.w_perceptual * loss_perc
        return loss, {"latent": loss_latent, "perceptual": loss_perc,
                      "total_distill": loss,
                      "durations_teacher": out_t.durations,
                      "durations_student": out_s.durations}

    def train_step(self, state: DiffusionTrainState, batch, **draws):
        """One update of the student; returns (new state, JAX's metrics as
        0-d tensors)."""
        self.load(state.params)
        _, aux, grads = self.grads(batch, **draws)
        params, opt = self._update(state, grads)
        return (DiffusionTrainState(state.step + 1, params, opt),
                {k: aux[k].detach() for k in STAGE3_METRICS})


# ---------------------------------------------------------------------------
# train states as trees of tensors (``checkpoint.save_params``)
# ---------------------------------------------------------------------------

def state_tree(state):
    """A ``TrainState`` or ``DiffusionTrainState`` as a nested dict of
    tensors: the step and the optimiser's count as 0-d int64 tensors, the
    moments' lists keyed by position, an absent EMA left out."""
    if isinstance(state, int):
        return torch.tensor(state, dtype=torch.int64)
    if isinstance(state, (list, tuple)):
        return {str(i): t for i, t in enumerate(state)}
    if dataclasses.is_dataclass(state):
        return {f.name: state_tree(getattr(state, f.name))
                for f in dataclasses.fields(state)
                if getattr(state, f.name) is not None}
    return state


def state_from_tree(tree, like):
    """The state ``state_tree`` made ``tree`` from, shaped as ``like`` (a
    state of the same kind; ``checkpoint.load_params(path,
    like=state_tree(like))`` reads the tree)."""
    if isinstance(like, int):
        return int(tree)
    if isinstance(like, (list, tuple)):
        return [tree[str(i)] for i in range(len(like))]
    if dataclasses.is_dataclass(like):
        return type(like)(**{
            f.name: (state_from_tree(tree[f.name], getattr(like, f.name))
                     if getattr(like, f.name) is not None else None)
            for f in dataclasses.fields(like)})
    return tree

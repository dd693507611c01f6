"""Evaluation metrics and the quality gates at the stage boundaries.

Counterpart of ``styletts_zs_tpu/pipelines/eval.py``, function for function,
with the same keys and roundings: mel MAE, the log-mel distance of two
waveforms, the speaker similarity of the prompt encoder's embeddings and its
falsifiable margin against the other speakers of a batch, FSQ codebook
usage, the stage-1 metric ladder (``evaluate_acoustic``), the sampled style
against the ground truth's (``evaluate_diffusion``) and the teacher-student
gap (``evaluate_distill_gap``), duration accuracy and the F0 RMSE.

The functions take the parameter dicts the trainers take (an acoustic
state dict, a denoiser's, ``{"acoustic", "vocoder"}``) and build the models
through ``pipelines.factory`` on ``device`` (the card unless ``"cpu"``),
in the config's dtypes, each call, as JAX does.  Batches are numpy
``Batch``es or batch dicts (a corpus loader's).  JAX's PRNG key becomes
explicit noise: a list of initial-noise tensors, one per seed, or a
``torch.Generator`` to draw them from (the JAX PRNG cannot be reproduced,
so tests hand in JAX's own draws).  The decodes run over the ground-truth
durations, as JAX's do.
"""
from __future__ import annotations

import numpy as np
import torch

from styletts_zs_torch.config import Config
from styletts_zs_torch.ops import stft as stft_ops
from styletts_zs_torch.ops.attention import length_mask
from styletts_zs_torch.pipelines.factory import (build_frozen_modules,
                                                 resolve_device)
from styletts_zs_torch.pipelines.train import batch_to_device


def _np(x) -> np.ndarray:
    """A tensor (any device or dtype; floats as float32) or array as
    numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def _acoustic(cfg: Config, acoustic_params, device):
    return build_frozen_modules(cfg, {"acoustic": acoustic_params},
                                ("acoustic",), device=device)["acoustic"]


def _denoiser(cfg: Config, diffusion_params, device):
    return build_frozen_modules(cfg, {"diffusion": diffusion_params},
                                ("diffusion",), device=device)["diffusion"]


def _inputs(cfg: Config, batch, device):
    """(batch tensors on ``device``, ground-truth mel cut to the batch's
    frames, text mask, frame mask)."""
    b = batch_to_device(batch, device)
    n_frames = b["f0"].shape[1]
    mel_gt = stft_ops.mel_spectrogram(b["wav"], cfg.model.audio)[:, :n_frames]
    text_mask = length_mask(b["text_lengths"], b["phonemes"].shape[1])
    frame_mask = length_mask(b["frame_lengths"], n_frames)
    return b, mel_gt, text_mask, frame_mask


def mel_mae(pred: torch.Tensor, target: torch.Tensor,
            mask: torch.Tensor | None = None) -> float:
    """Masked mean absolute error between mel spectrograms."""
    diff = torch.abs(pred.float() - target.float())
    if mask is not None:
        m = mask.float()[..., None]
        return float((diff * m).sum() / torch.clamp(
            m.sum() * pred.shape[-1], min=1.0))
    return float(diff.mean())


def mel_spectral_distance(pred_wav: torch.Tensor, target_wav: torch.Tensor,
                          cfg: Config) -> float:
    """Log-mel L1 between two waveforms (cropped to their common length)."""
    L = min(pred_wav.shape[-1], target_wav.shape[-1])
    a = stft_ops.mel_spectrogram(pred_wav[..., :L], cfg.model.audio)
    b = stft_ops.mel_spectrogram(target_wav[..., :L], cfg.model.audio)
    return float(torch.mean(torch.abs(a - b)))


def _embed(cfg: Config, acoustic, wav, device, *, normalize: bool):
    """The prompt encoder's summary of ``wav``'s mel, fp32."""
    mel = stft_ops.mel_spectrogram(torch.as_tensor(wav).to(device),
                                   cfg.model.audio)
    _, summary = acoustic.encode_prompt(mel)
    e = summary.float()
    if normalize:
        e = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                            min=1e-8)
    return e


@torch.no_grad()
def speaker_similarity(cfg: Config, acoustic_params, wav_a, wav_b, *,
                       device=None) -> np.ndarray:
    """Cosine similarity of prompt-encoder summaries, (B,) per pair."""
    dev = resolve_device(device)
    acoustic = _acoustic(cfg, acoustic_params, dev)
    ea = _embed(cfg, acoustic, wav_a, dev, normalize=False)
    eb = _embed(cfg, acoustic, wav_b, dev, normalize=False)
    num = torch.sum(ea * eb, dim=-1)
    den = torch.linalg.vector_norm(ea, dim=-1) * \
        torch.linalg.vector_norm(eb, dim=-1)
    return _np(num / torch.clamp(den, min=1e-8))


@torch.no_grad()
def speaker_similarity_margin(cfg: Config, acoustic_params, synth_wav,
                              ref_wav, *, device=None) -> dict:
    """Similarity that can fail: every synthesized utterance against all
    references of the batch (each item a different speaker), its own the
    positive, the others negatives.  ``sim_margin`` is the mean of
    (positive - hardest negative); ``retrieval_acc`` the share whose most
    similar reference is its own (chance 1/B).  Raises below batch 2
    (no negatives)."""
    if synth_wav.shape[0] < 2:
        raise ValueError("speaker_similarity_margin needs a batch of >= 2 "
                         "distinct speakers to form negative pairs")
    dev = resolve_device(device)
    acoustic = _acoustic(cfg, acoustic_params, dev)
    es = _embed(cfg, acoustic, synth_wav, dev, normalize=True)
    er = _embed(cfg, acoustic, ref_wav, dev, normalize=True)
    sims = _np(es @ er.T)                      # (B_synth, B_ref)
    B = sims.shape[0]
    pos = np.diag(sims)
    neg = sims.copy()
    np.fill_diagonal(neg, -np.inf)
    hardest_neg = neg.max(axis=1)
    return {
        "sim_pos_mean": float(pos.mean()),
        "sim_neg_max_mean": float(hardest_neg.mean()),
        "sim_margin": float((pos - hardest_neg).mean()),
        "retrieval_acc": float((sims.argmax(axis=1) == np.arange(B)).mean()),
        "retrieval_chance": round(1.0 / B, 4),
    }


@torch.no_grad()
def fsq_usage_stats(cfg: Config, acoustic_params, batch, *,
                    device=None) -> dict:
    """FSQ codebook usage over a batch: each dimension's level occupancy as
    a perplexity (max = its levels), the distinct codes, and the share of
    utterance-level codes distinct across utterances (code collapse shows
    as a perplexity near 1 or a share near 0)."""
    dev = resolve_device(device)
    acoustic = _acoustic(cfg, acoustic_params, dev)
    m = cfg.model
    _, mel, _, frame_mask = _inputs(cfg, batch, dev)
    _, codes, indices = acoustic.extract_style(mel, frame_mask)
    levels = m.style.fsq_levels
    codes = _np(codes).reshape(-1, len(levels))          # (B*K, d_fsq)
    digits = np.round((codes + 1.0) * (np.asarray(levels) - 1.0) / 2.0)
    perplexity = []
    for d, L in enumerate(levels):
        counts = np.bincount(digits[:, d].astype(np.int64), minlength=L)
        p = counts / max(counts.sum(), 1)
        ent = -(p[p > 0] * np.log(p[p > 0])).sum()
        perplexity.append(float(np.exp(ent)))
    idx2d = _np(indices).reshape(codes.shape[0] // m.style.n_codes,
                                 m.style.n_codes)          # (B, K)
    idx = idx2d.reshape(-1)
    # adjacent style segments of one utterance share codes by design:
    # dedupe within each utterance, then count across utterances
    per_utt = [np.unique(r) for r in idx2d]
    n_utt_codes = sum(u.size for u in per_utt)
    n_cross = np.unique(np.concatenate(per_utt)).size
    return {
        "fsq_dim_perplexity": [round(p, 2) for p in perplexity],
        "fsq_dim_levels": list(levels),
        "fsq_unique_codes": int(np.unique(idx).size),
        "fsq_unique_frac": round(float(np.unique(idx).size / idx.size), 4),
        "fsq_unique_frac_cross_utterance": round(
            float(n_cross / max(n_utt_codes, 1)), 4),
        "fsq_within_utt_repetition": round(
            1.0 - float(np.mean([u.size for u in per_utt]))
            / m.style.n_codes, 4),
        "fsq_n_codes_seen_of": int(idx.size),
    }


@torch.no_grad()
def evaluate_acoustic(cfg: Config, g_params, batch, *, device=None) -> dict:
    """The stage-1 gate on a held-out batch, from fully teacher-forced to
    free-running: ``mel_mae_teacher_forced`` (the decoder: ground-truth
    style, durations, F0 and energy); ``f0_rmse``, ``energy_rmse`` and
    ``mel_mae_pred_prosody`` (the prosody predictors over ground-truth
    durations); ``dur_mae_frames`` and ``dur_exact_match`` (the duration
    predictor, free-running)."""
    dev = resolve_device(device)
    acoustic = _acoustic(cfg, g_params["acoustic"], dev)
    b, mel_gt, text_mask, frame_mask = _inputs(cfg, batch, dev)
    n_frames = mel_gt.shape[1]
    phonemes, durations = b["phonemes"], b["durations"]
    f0_gt, energy_gt = _np(b["f0"]), _np(b["energy"])

    out_tf, _, styled = acoustic.reconstruct(
        phonemes, mel_gt, durations, text_mask=text_mask,
        frame_mask=frame_mask, f0_target=b["f0"], energy_target=b["energy"])
    res = {"mel_mae_teacher_forced": mel_mae(out_tf.mel, mel_gt, frame_mask)}

    # predicted prosody over ground-truth durations (frame-aligned targets)
    out_pp = acoustic.text_to_mel(phonemes, styled, text_mask=text_mask,
                                  durations=durations, n_frames=n_frames)
    em = _np(frame_mask)
    res["f0_rmse"] = f0_rmse(out_pp.f0, f0_gt, em)
    ed = (_np(out_pp.energy) - energy_gt)[em]
    res["energy_rmse"] = float(np.sqrt(np.mean(ed * ed))) if em.any() else 0.0
    res["mel_mae_pred_prosody"] = mel_mae(out_pp.mel, mel_gt, frame_mask)

    # free-running durations from the predictor
    out_fr = acoustic.text_to_mel(phonemes, styled, text_mask=text_mask,
                                  n_frames=n_frames)
    res.update(duration_accuracy(out_fr.durations, durations, text_mask))
    return {k: round(float(v), 5) for k, v in res.items()}


def _draws(noise, n: int) -> list:
    """``n`` initial noises: the list given, or the generator given ``n``
    times (each sampler call draws its own from it)."""
    draws = ([noise] * n if isinstance(noise, torch.Generator)
             else list(noise))
    if len(draws) != n:
        raise ValueError(f"{len(draws)} noise tensors for {n} seeds")
    return draws


def _mse(a, b) -> float:
    return float(torch.mean((a.float() - b.float()) ** 2))


def _conditioning(cfg: Config, acoustic, b, text_mask):
    """(prompt tokens, summary, text encoding) of the batch."""
    ref_mel = stft_ops.mel_spectrogram(b["ref_wav"], cfg.model.audio)
    tokens, summary = acoustic.encode_prompt(ref_mel)
    text_enc, _ = acoustic.encode_text(b["phonemes"], text_mask)
    return tokens, summary, text_enc


def _decoder(acoustic, b, text_mask, n_frames: int):
    """decode(style, quantize): the mel over the ground-truth durations
    (shared by both sides of a comparison, so the gap isolates the style
    pathway; an early predictor's free-running durations can be all
    zero, which would make a masked gap vacuously 0)."""
    def decode(s, quantize: bool):
        if quantize:
            s = acoustic.quantize_style(s)
        return acoustic.text_to_mel(b["phonemes"], s, text_mask=text_mask,
                                    durations=b["durations"],
                                    n_frames=n_frames)
    return decode


@torch.no_grad()
def evaluate_diffusion(cfg: Config, acoustic_params, diffusion_params, batch,
                       noise, *, n_steps: int | None = None,
                       one_step: bool = False, n_seeds: int = 1,
                       guidance: float | None = None, device=None) -> dict:
    """The stage-2/3 gate: the sampled style against the style extracted
    from the ground truth, in latent space and through the decoder
    (quantized and raw), and the FSQ code match.  ``noise``: a list of
    ``max(n_seeds, 1)`` initial-noise tensors or a ``torch.Generator``.
    With ``n_seeds > 1`` also the latent MSE's band over seeds and
    ``style_mse_ratio_pairs_over_gt`` (mean pairwise E|A-B|^2 between
    samples over mean E|A-GT|^2: 1 for a sampler with the data's spread,
    0 collapsed; read it at guidance 1)."""
    dev = resolve_device(device)
    acoustic = _acoustic(cfg, acoustic_params, dev)
    diffusion = _denoiser(cfg, diffusion_params, dev)
    b, mel_gt, text_mask, frame_mask = _inputs(cfg, batch, dev)
    tokens, summary, text_enc = _conditioning(cfg, acoustic, b, text_mask)
    styled_gt, _, _ = acoustic.extract_style(mel_gt, frame_mask)

    def draw(nz):
        if one_step:
            return diffusion.sample_onestep(nz, text_enc, tokens, summary,
                                            text_mask=text_mask,
                                            guidance=guidance)
        return diffusion.sample(nz, text_enc, tokens, summary,
                                text_mask=text_mask, n_steps=n_steps,
                                guidance=guidance)

    samples = [draw(nz) for nz in _draws(noise, max(n_seeds, 1))]
    style = samples[0]
    decode = _decoder(acoustic, b, text_mask, mel_gt.shape[1])
    out_s = decode(style, True)
    out_gt = decode(styled_gt, True)
    per_seed = [_mse(s, styled_gt) for s in samples]
    latent = per_seed[0]
    mask = out_gt.frame_mask & out_s.frame_mask
    # the raw (unquantized) decode and the code match tell identical codes
    # from identical styles: the FSQ lattice is coarse
    out_s_raw = decode(style, False)
    out_gt_raw = decode(styled_gt, False)
    q_s = acoustic.quantize_style(style)
    q_gt = acoustic.quantize_style(styled_gt)
    code_match = float(torch.all(torch.isclose(q_s, q_gt), dim=-1)
                       .float().mean())
    res = {"style_latent_mse_vs_gt": round(latent, 5),
           "mel_mae_sampled_vs_gt_style": round(
               mel_mae(out_s.mel, out_gt.mel, mask), 5),
           "mel_mae_sampled_vs_gt_style_raw": round(
               mel_mae(out_s_raw.mel, out_gt_raw.mel, mask), 5),
           "fsq_code_match_rate": round(code_match, 4)}
    if n_seeds > 1:
        pairs = [_mse(samples[i], samples[j])
                 for i in range(n_seeds) for j in range(i + 1, n_seeds)]
        res["style_latent_mse_mean"] = round(float(np.mean(per_seed)), 5)
        res["style_latent_mse_std"] = round(float(np.std(per_seed)), 5)
        res["style_latent_mse_seeds"] = n_seeds
        res["style_mse_ratio_pairs_over_gt"] = round(
            float(np.mean(pairs)) / max(float(np.mean(per_seed)), 1e-9), 3)
    return res


@torch.no_grad()
def evaluate_distill_gap(cfg: Config, acoustic_params, teacher_params,
                         student_params, batch, noise, *,
                         n_teacher_steps: int | None = None,
                         device=None) -> dict:
    """The distillation gate: the teacher's multi-step sample against the
    student's 1-step one from the same noise and conditioning, in latent
    space and through the decoder (quantized and raw).  ``noise``: the
    (B, K, d_style) initial noise or a ``torch.Generator`` to draw it."""
    dev = resolve_device(device)
    acoustic = _acoustic(cfg, acoustic_params, dev)
    teacher = _denoiser(cfg, teacher_params, dev)
    student = _denoiser(cfg, student_params, dev)
    b, mel_gt, text_mask, _ = _inputs(cfg, batch, dev)
    tokens, summary, text_enc = _conditioning(cfg, acoustic, b, text_mask)
    n_steps = n_teacher_steps or cfg.model.diffusion.n_steps
    nz = teacher._noise(noise, text_enc)     # one draw for both
    s_teacher = teacher.sample(nz, text_enc, tokens, summary,
                               text_mask=text_mask, n_steps=n_steps)
    s_student = student.sample_onestep(nz, text_enc, tokens, summary,
                                       text_mask=text_mask)
    latent = _mse(s_student, s_teacher)
    decode = _decoder(acoustic, b, text_mask, mel_gt.shape[1])
    out_t = decode(s_teacher, True)
    out_s = decode(s_student, True)
    out_t_raw = decode(s_teacher, False)
    out_s_raw = decode(s_student, False)
    mask = out_t.frame_mask & out_s.frame_mask
    return {"distill_latent_mse": round(latent, 5),
            "distill_perceptual_mel_l1": round(
                mel_mae(out_s.mel, out_t.mel, mask), 5),
            "distill_perceptual_mel_l1_raw": round(
                mel_mae(out_s_raw.mel, out_t_raw.mel, mask), 5)}


def duration_accuracy(pred_dur, true_dur, text_mask) -> dict:
    """Per-phoneme duration agreement over the valid phonemes."""
    m = _np(text_mask)
    p = _np(pred_dur)[m]
    t = _np(true_dur)[m]
    return {
        "dur_mae_frames": float(np.abs(p - t).mean()),
        "dur_exact_match": float((p == t).mean()),
    }


def f0_rmse(pred_f0, true_f0, frame_mask) -> float:
    """RMSE over voiced frames (true F0 != 0 in normalised-log space)."""
    m = _np(frame_mask) & (_np(true_f0) != 0)
    if not m.any():
        return 0.0
    d = (_np(pred_f0) - _np(true_f0))[m]
    return float(np.sqrt(np.mean(d * d)))

"""Numerics gate (acceptance level 1): the kernels' paths against the fp32
plain golden.

Counterpart of ``styletts_zs_tpu/pipelines/verify.py``.  The golden is the
fp32 path on the CPU, where every op takes its plain version; its pass
fixes the durations that every run takes, so frames stay aligned.  The
variants run the same text -> mel -> waveform program with the same fp32
weights, phonemes, style and durations:
  ``fp32_kernels``  fp32 on ``device`` with TF32 off for matmuls and
                    convolutions (JAX's "highest" precision);
  ``bf16_kernels``  bf16 on ``device``;
  ``bf16_plain``    bf16 on the CPU (JAX's ``bf16_xla``).
Each reports the masked mel MAE, the mel max error, the waveform MAE and
the share of durations equal to the golden's; ``pass_fp32`` holds the fp32
variant's mel MAE under 1e-3 and ``pass_bf16`` the bf16 one under 1e-1.
The weights are the port's ``init_params(seed)`` with the duration head's
bias at ``DURATION_BIAS`` (about 4 frames a phoneme, so the golden fills
most of its frames) unless ``params`` are given; the inputs come from a
generator seeded ``seed + 1``.  Seeded weights alone can give an utterance
of a frame or two, where the gate would measure the model's conditioning
and not the kernels: at one frame the fp32 CPU path itself moves by a
mel MAE of ~1e-3 against fp64 and across thread counts, against ~3e-6 at
full length (``tests/test_torch_verify.py`` shows both).  So a golden
shorter than ``MIN_GOLDEN_SHARE`` of ``max_frames`` raises.
"""
from __future__ import annotations

import math
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from styletts_zs_torch.config import Config, ModelConfig, RuntimeConfig
from styletts_zs_torch.ops.attention import length_mask
from styletts_zs_torch.pipelines.factory import (build_models, init_params,
                                                 resolve_device)

DURATION_BIAS = math.log1p(3.0)
MIN_GOLDEN_SHARE = 0.5


def _run(cfg: Config, params, phonemes, text_lengths, style, durations,
         n_frames: int, *, device=None):
    """The text -> mel -> waveform program on ``device`` (the card by
    default) with the given durations (None: the predictor's, as in the
    golden pass); returns (AcousticOutput, waveform) there."""
    dev = resolve_device(device)
    models = build_models(cfg, params, device=dev)
    with torch.inference_mode():
        phonemes, text_lengths, style = (
            x.to(dev) for x in (phonemes, text_lengths, style))
        text_mask = length_mask(text_lengths, phonemes.shape[1])
        out = models.acoustic.text_to_mel(
            phonemes, style, text_mask=text_mask,
            durations=None if durations is None else durations.to(dev),
            n_frames=n_frames)
        wav = models.vocoder(out.mel, mask=out.frame_mask)
    return out, wav


@contextmanager
def _full_fp32():
    """TF32 off for matmuls and cuDNN convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def run_verification(*, max_frames: int = 256, batch: int = 1, seed: int = 0,
                     device=None, params=None) -> dict:
    dev = resolve_device(device)
    base_model = ModelConfig(max_text_len=64, max_frames=max_frames)
    golden_cfg = Config(model=base_model,
                        runtime=RuntimeConfig(compute_dtype="float32"))
    if params is None:
        params = init_params(golden_cfg, seed=seed, device="cpu")
        params["acoustic"]["duration_predictor.out.bias"].fill_(
            DURATION_BIAS)

    g = torch.Generator().manual_seed(seed + 1)
    phonemes = torch.randint(1, 40, (batch, 64), generator=g)
    text_lengths = torch.full((batch,), 64, dtype=torch.int32)
    style = torch.randn(batch, base_model.style.n_codes,
                        base_model.style.d_style, generator=g) * 0.3

    # the golden pass also fixes the durations every other run takes
    golden_out, golden_wav = _run(golden_cfg, params, phonemes, text_lengths,
                                  style, None, max_frames, device="cpu")
    durations = golden_out.durations
    golden_frames = golden_out.frame_lengths.tolist()
    if min(golden_frames) < MIN_GOLDEN_SHARE * max_frames:
        raise ValueError(
            f"the golden fills {golden_frames} of {max_frames} frames, under "
            f"{MIN_GOLDEN_SHARE:g} of them: too short an utterance to gate "
            f"the kernels with")

    report = {"backend": dev.type,
              "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu"),
              "n_frames": int(max_frames), "batch": int(batch),
              "golden_frames": golden_frames}
    variants = {"fp32_kernels": ("float32", dev),
                "bf16_kernels": ("bfloat16", dev),
                "bf16_plain": ("bfloat16", torch.device("cpu"))}
    mel_g = golden_out.mel.float().numpy()
    wav_g = golden_wav.float().numpy()
    mask = golden_out.frame_mask.numpy()[..., None]

    for name, (dtype, vdev) in variants.items():
        cfg_v = Config(model=base_model,
                       runtime=RuntimeConfig(compute_dtype=dtype))
        with _full_fp32() if dtype == "float32" else nullcontext():
            out_v, wav_v = _run(cfg_v, params, phonemes, text_lengths, style,
                                durations, max_frames, device=vdev)
        mel_v = out_v.mel.float().cpu().numpy()
        wav_v = wav_v.float().cpu().numpy()
        mel_mae = float(np.abs((mel_v - mel_g) * mask).sum()
                        / np.maximum(mask.sum() * mel_g.shape[-1], 1))
        report[name] = {
            "mel_mae": mel_mae,
            "mel_max": float(np.abs(mel_v - mel_g).max()),
            "wav_mae": float(np.abs(wav_v - wav_g).mean()),
            "dur_match": float((out_v.durations.cpu() == durations)
                               .float().mean()),
        }
    report["pass_fp32"] = bool(report["fp32_kernels"]["mel_mae"] < 1e-3)
    report["pass_bf16"] = bool(report["bf16_kernels"]["mel_mae"] < 1e-1)
    return report

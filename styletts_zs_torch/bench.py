"""Benchmark: zero-shot synthesis throughput on one card.

Counterpart of the repository's ``bench.py``.  Prints ONE JSON line:
  - ``value``: audio-seconds synthesized per wall-second at batch 32
    (``vs_baseline`` = value / 10, the 10x real-time target), for the
    whole program: 3 s prompt encode, 1-step CFG style diffusion, mel
    decode and vocoder;
  - ``rtf_batch1``: audio-seconds per wall-second at batch 1, the same
    program;
  - ``mel_mae_vs_fp32_golden``: the masked mel MAE of this program at
    batch 1 against the fp32 plain path on the CPU, same weights and
    inputs;
  - ``device``: the card's name and power limit (``"cpu"`` off the card).

Timing: one warm-up call, then the median of 5 calls at batch 32 and of
10 at batch 1, each timed on the host clock to its end.  On the card the
model is full width (``max_text_len`` 256, 1024 frames, bf16, weights from
a seed); ``--device cpu`` runs the tiny config at batch 2.  A failure
raises, so the command exits non-zero and prints no line.

    python -m styletts_zs_torch.bench [--device cpu]
"""
from __future__ import annotations

import argparse
import json

from styletts_zs_torch.config import replace
from styletts_zs_torch.pipelines.acceptance import (base_config, device_label,
                                                    measure, synth_inputs)
from styletts_zs_torch.pipelines.factory import init_params, resolve_device
from styletts_zs_torch.pipelines.infer import make_synthesis_fn

N_CALLS, N_CALLS_BATCH1 = 5, 10


def mel_mae(out, ref_out) -> float:
    """Masked mel MAE against the reference's frame mask."""
    mask = ref_out.frame_mask.cpu()[..., None].float()
    diff = (out.mel.float().cpu() - ref_out.mel.float().cpu()).abs() * mask
    return float(diff.sum() / max(float(mask.sum()) * out.mel.shape[-1], 1.0))


def run_bench(*, device=None) -> dict:
    dev = resolve_device(device)
    cfg = base_config(dev.type == "cuda")
    batch = 32 if dev.type == "cuda" else 2
    m = cfg.model
    params = init_params(cfg, seed=0, device="cpu")
    fn = make_synthesis_fn(cfg, params, one_step=True, with_vocoder=True,
                           device=dev)
    (_, wav), dt, _ = measure(fn, synth_inputs(cfg, batch, dev), dev,
                              N_CALLS)
    audio_s = batch * wav.shape[1] / m.audio.sample_rate
    inputs1 = synth_inputs(cfg, 1, dev)
    (out1, wav1), dt1, _ = measure(fn, inputs1, dev, N_CALLS_BATCH1)
    # the fp32 plain path on the CPU, same weights and inputs
    golden_cfg = replace(cfg, runtime=replace(cfg.runtime,
                                              compute_dtype="float32"))
    ref, _ = make_synthesis_fn(golden_cfg, params, one_step=True,
                               with_vocoder=True, device="cpu")(
        *(x.cpu() for x in inputs1))
    return {"metric": "audio_s_per_s_per_chip_batch32_1step",
            "value": audio_s / dt,
            "unit": "audio-seconds/s/chip",
            "vs_baseline": audio_s / dt / 10.0,
            "rtf_batch1": (wav1.shape[1] / m.audio.sample_rate) / dt1,
            "mel_mae_vs_fp32_golden": mel_mae(out1, ref),
            "device": device_label(dev)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(run_bench(device=args.device)))


if __name__ == "__main__":
    main()

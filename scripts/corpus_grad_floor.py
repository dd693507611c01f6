"""The fp32 stage-1 gradient gate of ``chip_smoke.py`` on a corpus batch.

Runs on one card, from the repository root:

    python3 scripts/corpus_grad_floor.py

The batch is the first two utterances of the corpus phase's training batch
(``chip_smoke.export_corpora``, shard 0 of ``make_corpus_loader``: two
1024-frame utterances of ~255 phonemes, no durations), MAS on, dropout 0,
fp32, TF32 off.  It gates the card against the CPU at 8 threads, and the CPU
at 2 threads against 8, through ``chip_smoke.gate_losses_and_grads``
(printing, not raising), and prints ``acoustic.align_text_proj.bias`` in
detail: its gradient is zero by construction (a per-frame constant under
the softmax over text), so every side holds only its rounding.
"""
import dataclasses
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from styletts_zs_torch.config import RuntimeConfig  # noqa: E402
from styletts_zs_torch.pipelines import corpus  # noqa: E402
from styletts_zs_torch.pipelines.factory import init_params  # noqa: E402

ZERO_BY_CONSTRUCTION = "acoustic.align_text_proj.bias"


def main() -> None:
    card = cs.phase_device()
    base = cs.train_config()
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, use_mas_durations=True))
    cfg32 = dataclasses.replace(cs._no_dropout(cfg), runtime=RuntimeConfig(
        compute_dtype="float32"))
    params = init_params(cfg, seed=0, device="cpu", with_discriminator=True)
    params["acoustic"]["duration_predictor.out.bias"].fill_(cs.DURATION_BIAS)
    with tempfile.TemporaryDirectory() as tmp:
        _, una = cs.export_corpora(cfg, Path(tmp))
        nb = next(iter(corpus.make_corpus_loader(
            una, cfg.model, batch_size=cfg.train.batch_size,
            n_frames=cs.TRAIN_FRAMES, text_len=cs.TRAIN_TEXT, seed=0,
            shard_index=0, shard_count=cs.CORPUS_SHARDS)))
    nb = {k: v[:2] for k, v in nb.items()}
    runs = {}
    for threads in (8, 2):
        torch.set_num_threads(threads)
        t0 = time.perf_counter()
        runs[threads] = cs.train_parity_run(cfg32, params, nb, "cpu")
        print(f"CPU {threads} threads: {time.perf_counter() - t0:.1f} s")
    torch.set_num_threads(8)
    runs["card"] = cs.train_parity_run(cfg32, params, nb, "cuda")
    scale = max(g.abs().max().item() for k, g in runs[8]["grads"].items()
                if k.startswith("acoustic."))
    name = ZERO_BY_CONSTRUCTION
    for k in (8, 2, "card"):
        print(f"{name} {k}: max|g| "
              f"{runs[k]['grads'][name].abs().max().item():.3e}")
    for a, b in ((2, 8), ("card", 8), ("card", 2)):
        got, ref = runs[a]["grads"][name], runs[b]["grads"][name]
        err = (got - ref).abs().max().item()
        allowed = cs.GRAD_RTOL * ref.abs().max().item() \
            + cs.GRAD_FLOOR * scale
        print(f"{name} {a} vs {b}: err {err:.3e}, allowed {allowed:.3e} "
              f"(ratio {err / allowed:.3f}); acoustic max|g| {scale:.3e}")
        try:
            cs.gate_losses_and_grads(f"{a} vs {b}:", runs[a], runs[b], 0.0,
                                     card)
        except AssertionError as e:
            print(f"  gate: {e}")
    print("MAS durations equal, card and CPU 2 threads against CPU 8:",
          torch.equal(runs["card"]["mas"], runs[8]["mas"]),
          torch.equal(runs[2]["mas"], runs[8]["mas"]))


if __name__ == "__main__":
    main()

"""Command-line interface of the port: synth / train / verify / accept /
bench.

Counterpart of ``styletts_zs_tpu/cli.py``, with the same flags and outputs,
plus ``--device`` (default: the card; ``cpu`` for tests).  Examples:

    python -m styletts_zs_torch.cli synth --text "hello world" --out mel.npy
    python -m styletts_zs_torch.cli synth --text "hi" --ref spk.wav \
        --wav-out out.wav
    python -m styletts_zs_torch.cli train --stage 1 --steps 100
    python -m styletts_zs_torch.cli train --stage 1 --corpus corpus_dir
    python -m styletts_zs_torch.cli train --stage 3 --ckpt params.pt
    python -m styletts_zs_torch.cli verify      # card-vs-CPU-golden mel MAE
    python -m styletts_zs_torch.cli accept --level 2   # 0 = all five
    torchrun --nproc-per-node 2 -m styletts_zs_torch.cli accept --level 5 \
        --mesh                      # data-parallel serving over 2 ranks
    python -m styletts_zs_torch.cli bench       # one JSON line

``synth`` runs ``cfg.serve``'s program on ``serve.batch_size`` copies of
the text and saves the first mel as ``.npy`` (``--wav-out``: the first
waveform as 16-bit PCM); ``--ref`` is the speaker's wav, resampled and cut
to 3 s, else 3 s of seeded noise; ``--fixed-style`` decodes with a zero
style and no diffusion.  ``train`` runs one stage on the synthetic data
(``SyntheticDataset``) or, with ``--corpus DIR``, on an on-disk corpus
(``pipelines/corpus.py``: ``metadata.jsonl`` and ``wavs/``, batches from
``make_corpus_loader`` with 48 phonemes; set ``use_mas_durations`` in the
config's ``[train]`` table for a corpus without durations), clips of
``min(max_frames, 256)`` frames, saves a numbered checkpoint every
``checkpoint_every`` steps in stage 1 and writes the stage's output to
``--workdir``: ``stage1_final`` (``{"g": the generator's EMA, "d": the
discriminator}``), ``stage2_final`` (the denoiser's EMA) or
``stage3_student``.  ``--ckpt`` reads a whole parameter
tree, as ``save_params`` writes one (``scripts/convert_jax_params.py``
writes one from a JAX bundle), in place of the seeded initialisation.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from styletts_zs_torch.config import Config, load_config, replace


def _load_cfg(path) -> Config:
    return load_config(path) if path else Config()


def _get_params(cfg: Config, ckpt, *, with_discriminator: bool = False):
    """The seeded fp32 parameters (made on the CPU, so every device trains
    the same ones), or the tree at ``ckpt`` checked against them."""
    from styletts_zs_torch.pipelines.checkpoint import load_params
    from styletts_zs_torch.pipelines.factory import init_params
    params = init_params(cfg, seed=cfg.train.seed, device="cpu",
                         with_discriminator=with_discriminator)
    if ckpt:
        params = load_params(ckpt, like=params)
    return params


def cmd_synth(args) -> None:
    from styletts_zs_torch.pipelines.factory import resolve_device
    from styletts_zs_torch.pipelines.infer import Synthesizer
    from styletts_zs_torch.utils import text as text_utils

    device = resolve_device(args.device)
    cfg = _load_cfg(args.config)
    m, s = cfg.model, cfg.serve
    syn = Synthesizer(cfg, _get_params(cfg, args.ckpt), device=device)

    ids = text_utils.text_to_ids(args.text)
    phonemes = torch.tensor([text_utils.pad_ids(ids, m.max_text_len)]
                            * s.batch_size, dtype=torch.int64)
    tlen = torch.full((s.batch_size,), min(len(ids), m.max_text_len),
                      dtype=torch.int32)

    t0 = time.time()
    if args.fixed_style:
        style = torch.zeros(s.batch_size, m.style.n_codes, m.style.d_style)
        out = syn.synthesize_fixed_style(phonemes, style, text_lengths=tlen)
        wav = None
    else:
        if args.ref:
            from styletts_zs_torch.pipelines.corpus import read_wav, resample
            from styletts_zs_torch.pipelines.preprocess import ref_window
            ref, sr = read_wav(args.ref)
            ref = ref_window(resample(ref, sr, m.audio.sample_rate),
                             m.audio.sample_rate)
            ref = np.tile(ref[None], (s.batch_size, 1))
        else:
            ref = np.random.default_rng(0).standard_normal(
                (s.batch_size, 3 * m.audio.sample_rate)
            ).astype(np.float32) * 0.1
        out, wav = syn.synthesize(
            phonemes, torch.from_numpy(ref), text_lengths=tlen,
            one_step=s.one_step, n_steps=s.n_steps, guidance=s.guidance,
            with_vocoder=s.with_vocoder)
    mel = out.mel[0].float().cpu().numpy()   # waits for the device
    print(f"synthesized mel {tuple(out.mel.shape)} in {time.time() - t0:.2f}s")

    np.save(args.out, mel)
    print(f"wrote {args.out}")
    if wav is not None and args.wav_out:
        import wave
        w = np.clip(wav[0].float().cpu().numpy(), -1.0, 1.0)
        with wave.open(args.wav_out, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(m.audio.sample_rate)
            f.writeframes((w * 32767).astype(np.int16).tobytes())
        print(f"wrote {args.wav_out}")


def cmd_train(args) -> None:
    from styletts_zs_torch.pipelines import train as T
    from styletts_zs_torch.pipelines.checkpoint import (CheckpointManager,
                                                        save_params)
    from styletts_zs_torch.pipelines.data import SyntheticDataset
    from styletts_zs_torch.pipelines.factory import resolve_device

    device = resolve_device(args.device)   # before the weights are made
    cfg = _load_cfg(args.config)
    if args.steps:
        cfg = replace(cfg, train=replace(cfg.train, n_steps=args.steps))
    t = cfg.train
    params = _get_params(cfg, args.ckpt, with_discriminator=(args.stage == 1))
    if args.corpus:
        from styletts_zs_torch.pipelines.corpus import make_corpus_loader
        loader = iter(make_corpus_loader(
            args.corpus, cfg.model, batch_size=t.batch_size,
            n_frames=min(cfg.model.max_frames, 256), seed=t.seed))
        next_batch = lambda: next(loader)  # noqa: E731
    else:
        next_batch = SyntheticDataset(
            cfg.model, batch_size=t.batch_size, seed=t.seed,
            n_frames=min(cfg.model.max_frames, 256)).next_batch
    mgr = CheckpointManager(args.workdir, keep=t.keep_checkpoints)

    if args.stage == 1:
        tr = T.Stage1Trainer(cfg, params, device=device, seed=t.seed)
        state = tr.init_state(params)
        for step in range(t.n_steps):
            batch = T.batch_to_device(next_batch(), tr.device)
            state, metrics = tr.train_step(state, batch)
            if step % t.log_every == 0:
                m = {k: round(float(v), 4) for k, v in metrics.items()}
                print(f"step {step}: {json.dumps(m)}")
            if step and step % t.checkpoint_every == 0:
                mgr.save(step, {"g": state.g_params, "d": state.d_params})
        save_params(f"{args.workdir}/stage1_final",
                    {"g": state.ema_params, "d": state.d_params})
    elif args.stage == 2:
        tr = T.Stage2Trainer(cfg, params, device=device, seed=t.seed)
        state = tr.init_state(params["diffusion"])
        for step in range(t.n_steps):
            batch = T.batch_to_device(next_batch(), tr.device)
            state, metrics = tr.train_step(state, batch)
            if step % t.log_every == 0:
                print(f"step {step}: diff={float(metrics['diff']):.4f}")
        save_params(f"{args.workdir}/stage2_final", state.ema)
    else:
        tr = T.Stage3Trainer(cfg, params, device=device, seed=t.seed)
        state = tr.init_state(params["diffusion"])
        # distillation uses only distill_samples clips
        n_steps = min(t.n_steps, t.distill_samples // t.batch_size)
        for step in range(n_steps):
            batch = T.batch_to_device(next_batch(), tr.device)
            state, metrics = tr.train_step(state, batch)
            if step % t.log_every == 0:
                print(f"step {step}: latent={float(metrics['latent']):.4f} "
                      f"perc={float(metrics['perceptual']):.4f}")
        save_params(f"{args.workdir}/stage3_student", state.params)
    mgr.close()
    print("training done")


def cmd_verify(args) -> None:
    """Numerics gate: the device's fp32 and bf16 output against the fp32 CPU
    golden."""
    from styletts_zs_torch.pipelines.verify import run_verification
    report = run_verification(max_frames=args.frames, batch=args.batch,
                              device=args.device)
    print(json.dumps(report, indent=2))


def cmd_accept(args) -> None:
    """One of the five acceptance configs, or all five (``--level 0``)."""
    from styletts_zs_torch.pipelines.acceptance import run_acceptance
    if args.level == 0:
        report = {f"level_{lv}": run_acceptance(
            lv, full_size=args.full or None, device=args.device)
            for lv in (1, 2, 3, 4, 5)}
    else:
        report = run_acceptance(args.level, full_size=args.full or None,
                                n_requests=args.requests, bundle=args.bundle,
                                device=args.device, use_mesh=args.mesh)
    print(json.dumps(report, indent=2))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="styletts_zs_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("synth", help="text (+ reference audio) -> mel/wav")
    ps.add_argument("--config", default=None)
    ps.add_argument("--ckpt", default=None,
                    help="a parameter tree written by save_params")
    ps.add_argument("--text", required=True)
    ps.add_argument("--ref", default=None, help="reference speaker wav")
    ps.add_argument("--out", default="mel.npy")
    ps.add_argument("--wav-out", default=None)
    ps.add_argument("--fixed-style", action="store_true",
                    help="no diffusion: decode with a zero style")
    ps.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ps.set_defaults(fn=cmd_synth)

    pt = sub.add_parser("train", help="train one stage on synthetic data "
                                      "or an on-disk corpus")
    pt.add_argument("--config", default=None)
    pt.add_argument("--ckpt", default=None,
                    help="a parameter tree written by save_params")
    pt.add_argument("--stage", type=int, choices=(1, 2, 3), required=True)
    pt.add_argument("--steps", type=int, default=None)
    pt.add_argument("--corpus", default=None,
                    help="an on-disk corpus directory (metadata.jsonl, "
                         "wavs/) in place of the synthetic data")
    pt.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "styletts_zs_ckpt"))
    pt.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    pt.set_defaults(fn=cmd_train)

    pv = sub.add_parser("verify", help="card-vs-CPU-golden numerics gate")
    pv.add_argument("--frames", type=int, default=256)
    pv.add_argument("--batch", type=int, default=1)
    pv.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    pv.set_defaults(fn=cmd_verify)

    pa = sub.add_parser("accept", help="run an acceptance config (1-5)")
    pa.add_argument("--level", type=int, choices=(0, 1, 2, 3, 4, 5),
                    required=True, help="1-5, or 0 for all five aggregated")
    pa.add_argument("--full", action="store_true",
                    help="full-size model (default: full on the card)")
    pa.add_argument("--requests", type=int, default=None,
                    help="level 5: request count (contract scale 4096)")
    pa.add_argument("--mesh", action="store_true",
                    help="level 5: data-parallel serving over every rank "
                         "(torchrun's environment, else this process)")
    pa.add_argument("--bundle", default=None,
                    help="level 5: a trained {acoustic, vocoder, diffusion} "
                         "tree written by save_params")
    pa.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    pa.set_defaults(fn=cmd_accept)

    # bench's flags are ``styletts_zs_torch.bench.main``'s own
    sub.add_parser("bench", add_help=False,
                   help="throughput benchmark (one JSON line; flags: "
                        "python -m styletts_zs_torch.bench -h)")

    args, rest = p.parse_known_args(argv)
    if args.cmd == "bench":
        from styletts_zs_torch import bench
        bench.main(rest)
        return
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    args.fn(args)


if __name__ == "__main__":
    main()

"""Command-line interface of the port: train / verify.

Counterpart of ``styletts_zs_tpu/cli.py``'s ``train`` and ``verify``
commands, with the same flags and outputs, plus ``--device`` (default: the
card; ``cpu`` for tests).  Examples:

    python -m styletts_zs_torch.cli train --stage 1 --steps 100
    python -m styletts_zs_torch.cli train --stage 3 --ckpt params.pt
    python -m styletts_zs_torch.cli verify      # card-vs-CPU-golden mel MAE

``train`` runs one stage on the synthetic data (``SyntheticDataset``,
clips of ``min(max_frames, 256)`` frames), saves a numbered checkpoint
every ``checkpoint_every`` steps in stage 1 and writes the stage's output
to ``--workdir``: ``stage1_final`` (``{"g": the generator's EMA, "d": the
discriminator}``), ``stage2_final`` (the denoiser's EMA) or
``stage3_student``.  ``--ckpt`` reads a whole parameter tree, as
``save_params`` writes one, in place of the seeded initialisation.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

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
    ds = SyntheticDataset(cfg.model, batch_size=t.batch_size, seed=t.seed,
                          n_frames=min(cfg.model.max_frames, 256))
    mgr = CheckpointManager(args.workdir, keep=t.keep_checkpoints)

    if args.stage == 1:
        tr = T.Stage1Trainer(cfg, params, device=device, seed=t.seed)
        state = tr.init_state(params)
        for step in range(t.n_steps):
            batch = T.batch_to_device(ds.next_batch(), tr.device)
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
            batch = T.batch_to_device(ds.next_batch(), tr.device)
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
            batch = T.batch_to_device(ds.next_batch(), tr.device)
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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="styletts_zs_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train one stage on synthetic data")
    pt.add_argument("--config", default=None)
    pt.add_argument("--ckpt", default=None,
                    help="a parameter tree written by save_params")
    pt.add_argument("--stage", type=int, choices=(1, 2, 3), required=True)
    pt.add_argument("--steps", type=int, default=None)
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

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

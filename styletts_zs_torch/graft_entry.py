"""Entry points: the flagship synthesis program, and a dry run of the three
training stages on a (data, model) mesh.

Counterpart of the repository's ``__graft_entry__.py``.  ``entry()``
returns the zero-shot 1-step synthesis with the vocoder (prompt encode,
CFG-doubled diffusion, mel decode, vocoder: one call) and its example
arguments, at JAX's ``_flagship_config`` shapes.

``dryrun_multichip(n)`` runs over the default process group (torchrun's
environment, or gloo processes on the CPU), whose world size must be n:
it lays the ranks out as a (n // m, m) mesh with m = 2 where n is even and
at least 4 (else 1), splits the stage-1 generator over the model axis with
``min_shard_dim`` 32 (the discriminator, optimiser state and EMA of the
discriminator whole), runs one stage-1 step of the tiny config
(``tiny_config``: on the card with the attention heads the kernels take)
on the data-sharded batch, gathers the length histograms and style codes
over the data axis, runs one stage-2 and one stage-3 step with whole
trees, checks that every metric is finite and prints JAX's
``dryrun_multichip OK`` line.

    python -m styletts_zs_torch.graft_entry                # entry() once
    torchrun --nproc-per-node 4 -m styletts_zs_torch.graft_entry --dryrun 4
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from styletts_zs_torch.config import (Config, ModelConfig, RuntimeConfig,
                                      tiny_test_config)
from styletts_zs_torch.pipelines.factory import init_params, resolve_device


def _flagship_config() -> Config:
    """The full-size model, sequences shortened for a quick check."""
    return Config(model=ModelConfig(max_text_len=64, max_frames=256),
                  runtime=RuntimeConfig(compute_dtype="bfloat16",
                                        use_pallas=True))


def tiny_config(device_type: str = "cpu") -> Config:
    """The tiny config, JAX's dry run's.  On the card its attention heads
    are 64 wide, the width the attention kernels take (one head where a
    model is 64 wide), and the decoder's window 64 frames (a multiple of
    64, as chunk-local attention takes)."""
    cfg = tiny_test_config()
    if device_type != "cuda":
        return cfg
    m, r = cfg.model, dataclasses.replace

    def heads(c, dim):
        return r(c, n_heads=max(1, dim // 64))
    return r(cfg, model=r(
        m, text_encoder=heads(m.text_encoder, m.text_encoder.dim),
        prosody_encoder=heads(m.prosody_encoder, m.prosody_encoder.dim),
        style=heads(m.style, m.style.extractor_dim),
        prompt_encoder=heads(m.prompt_encoder, m.prompt_encoder.dim),
        decoder=r(heads(m.decoder, m.decoder.dim), attn_window=64),
        diffusion=heads(m.diffusion, m.diffusion.dim)))


def entry(device=None):
    """(fn, example_args): ``fn(*example_args)`` -> (mel, waveform), the
    1-step synthesis with the vocoder on ``device`` (the card unless
    ``device="cpu"``), at batch 2, 64 phonemes, a 3 s reference, 256
    frames."""
    from styletts_zs_torch.pipelines.infer import make_synthesis_fn
    dev = resolve_device(device)
    cfg = _flagship_config()
    m = cfg.model
    fn_raw = make_synthesis_fn(cfg, init_params(cfg, seed=0, device="cpu"),
                               one_step=True, with_vocoder=True,
                               n_frames=m.max_frames, device=dev)

    def fn(phonemes, text_lengths, ref_mel, ref_lengths, noise):
        out, wav = fn_raw(phonemes, text_lengths, ref_mel, ref_lengths,
                          noise)
        return out.mel, wav

    B, Tt = 2, m.max_text_len
    ref_frames = 240           # 3 s at 80 frames/s
    example_args = (
        torch.ones((B, Tt), dtype=torch.int64, device=dev),
        torch.full((B,), Tt, dtype=torch.int32, device=dev),
        torch.zeros((B, ref_frames, m.audio.n_mels), device=dev),
        torch.full((B,), ref_frames, dtype=torch.int32, device=dev),
        torch.Generator(device=dev).manual_seed(0))
    return fn, example_args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One tensor- and data-parallel stage-1 step, the metadata gathers,
    one stage-2 and one stage-3 step, over the n ranks of the default
    process group (made here from torchrun's environment where there is
    none); raises where a metric is not finite or a gather loses rows."""
    from styletts_zs_torch.parallel import collectives
    from styletts_zs_torch.parallel import mesh as mesh_lib
    from styletts_zs_torch.pipelines import train as train_lib
    from styletts_zs_torch.pipelines.data import SyntheticDataset

    dev = resolve_device(device)
    model_ax = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    data_ax = n_devices // model_ax
    mesh = mesh_lib.make_mesh(data=data_ax, model=model_ax,
                              devices=dev.type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    rows = mesh_lib.batch_sharding(mesh)

    cfg = tiny_config(dev.type)
    params = init_params(cfg, seed=0, device="cpu", with_discriminator=True)
    # the generator split over 'model' where its kernels are large enough
    # (the lane multiple relaxed so that the tiny kernels split too)
    trainer = train_lib.Stage1Trainer(cfg, params, device=dev, mesh=mesh,
                                      min_shard_dim=32)
    state = trainer.init_state(params)

    B = 2 * data_ax
    nb = SyntheticDataset(cfg.model, batch_size=B, seed=0, n_frames=64,
                          text_len=16).next_batch()
    batch = train_lib.batch_to_device(nb, dev, sharding=rows)
    state, metrics = trainer.train_step(state, batch)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), f"{k} not finite in dryrun"

    # the metadata collectives: per-shard length histograms and per-request
    # style codes gathered over the data axis
    hists = collectives.gather_length_histograms(
        mesh, batch["frame_lengths"], (64,))
    assert int(hists.sum()) == B, "metadata all_gather lost requests"
    g = torch.Generator().manual_seed(1)
    styles = torch.randn(B, cfg.model.style.n_codes,
                         len(cfg.model.style.fsq_levels), generator=g)
    table = collectives.gather_style_codes(mesh, rows.take(styles).to(dev))
    assert table.shape[0] == B, "style-code all_gather lost requests"
    np.testing.assert_allclose(table.cpu().numpy(), styles.numpy(),
                               rtol=1e-6)

    # stage 2 (style diffusion) and stage 3 (distillation) on the mesh,
    # whole trees
    tr2 = train_lib.Stage2Trainer(cfg, params, device=dev, mesh=mesh)
    s2, m2 = tr2.train_step(tr2.init_state(params["diffusion"]), batch)
    for k, v in m2.items():
        assert np.isfinite(float(v)), f"stage2 {k} not finite in dryrun"
    tr3 = train_lib.Stage3Trainer(cfg, params, device=dev, mesh=mesh)
    s3, m3 = tr3.train_step(tr3.init_state(params["diffusion"]), batch)
    for k, v in m3.items():
        assert np.isfinite(float(v)), f"stage3 {k} not finite in dryrun"

    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: mesh=({data_ax},{model_ax}), "
              f"stage-1/2/3 step metrics finite, metadata all_gather shape "
              f"{tuple(hists.shape)}, style-code all_gather shape "
              f"{tuple(table.shape)}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, metavar="N", default=None,
                    help="dryrun_multichip(N) over torchrun's N ranks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, device=args.device)
        dist.destroy_process_group()
        return
    fn, example_args = entry(device=args.device)
    mel, wav = fn(*example_args)
    print("entry OK", tuple(mel.shape), tuple(wav.shape))


if __name__ == "__main__":
    main()

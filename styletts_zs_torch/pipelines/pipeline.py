"""The three-stage training pipeline: the acoustic GAN, then the style
diffusion, then the 1-step distillation, with a quality gate at every
stage boundary, the serving bundle and a final synthesis.

Counterpart of ``scripts/train_pipeline.py``, step for step and with its
flags, plus ``--device``:

    python -m styletts_zs_torch.pipelines.pipeline --steps1 200 \\
        --steps2 200 --steps3 50 --workdir runs/pipeline [--tiny]
    python -m styletts_zs_torch.pipelines.pipeline --tiny --device cpu \\
        --steps1 2 --steps2 2 --steps3 2 --gate-every 1

The stage handoffs: stage 1's EMA tree ({acoustic, vocoder}, saved as
``workdir/stage1``) is frozen into stage 2; stage 2's EMA denoiser (saved
as ``workdir/stage2``) is stage 3's teacher, and the student starts as a
copy of it; the stage-1 acoustic model and vocoder with the student form
the bundle ``workdir/final`` (``checkpoint.save_params``), which
``Synthesizer`` then serves.  The gates (``pipelines.eval``) score a
held-out batch; ``workdir/quality_report.json`` holds JAX's keys and
nesting and is rewritten after every gate.  ``--gate-every N`` also gates
mid-stage and saves the whole train state (``stage1_state``,
``stage2_state``) that ``--resume-stage1/2`` restore; ``--skip-stage1/2``
load a stage's saved tree in place of training it; ``--stop-after``
exits after a stage's boundary gate.

The models run on the card unless ``--device cpu``; the tiny config is
taken with ``--tiny`` or on the CPU, as JAX's script takes it on a CPU
backend.  Every random draw comes from a ``torch.Generator`` seeded from
``cfg.train.seed``: the trainers' (dropout, the stage-2 and stage-3
draws) and the gates' (their initial noise; ``run_pipeline``'s
``gate_noise`` replaces the latter, so tests can hand in JAX's draws).
JAX's persistent compilation cache and its periodic drain and RSS log (a
workaround for its TPU runtime client's host leak) have no counterpart.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time
from typing import Callable, Optional

import torch

from styletts_zs_torch.config import Config, replace, tiny_test_config
from styletts_zs_torch.pipelines import eval as E
from styletts_zs_torch.pipelines import train as T
from styletts_zs_torch.pipelines.checkpoint import load_params, save_params
from styletts_zs_torch.pipelines.data import SyntheticDataset
from styletts_zs_torch.pipelines.factory import init_params, resolve_device
from styletts_zs_torch.pipelines.infer import Synthesizer

def stage_cfg(cfg: Config, n_steps: int) -> Config:
    """The LR schedule synced to the stage's actual length, its warm-up
    clamped to a tenth of it (at least 1) so that short stages decay."""
    t = cfg.train
    return replace(cfg, train=replace(
        t, n_steps=n_steps,
        warmup_steps=min(t.warmup_steps, max(n_steps // 10, 1))))


class _Producer:
    """A thread that fills a queue of 4 batches from ``ds``: the host's
    synthetic batches overlap the card's steps, and only this thread
    touches ``ds`` (its numpy generator is not thread-safe)."""

    def __init__(self, ds):
        self.q: queue.Queue = queue.Queue(maxsize=4)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._fill, args=(ds,),
                                       daemon=True)
        self.thread.start()

    def _fill(self, ds):
        while not self.stop.is_set():
            b = ds.next_batch()
            while not self.stop.is_set():
                try:
                    self.q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    pass

    def get(self):
        return self.q.get()

    def close(self):
        self.stop.set()
        self.thread.join()


def run_pipeline(*, steps1: int = 200, steps2: int = 200, steps3: int = 50,
                 batch: Optional[int] = None,
                 workdir: str = "runs/pipeline", tiny: bool = False,
                 eval_every: int = 50, gate_every: int = 0,
                 skip_stage1: Optional[str] = None,
                 skip_stage2: Optional[str] = None,
                 resume_stage1: Optional[str] = None,
                 resume_stage2: Optional[str] = None, stop_after: int = 0,
                 device=None,
                 gate_noise: Optional[Callable[[str, int], object]] = None
                 ) -> dict:
    """The pipeline with the command's flags as keywords; returns the
    quality report (also in ``workdir/quality_report.json``).
    ``gate_noise(label, step)`` gives the initial noise, as the
    ``pipelines.eval`` functions and ``Synthesizer.synthesize`` take it, of
    the stage-2 gate's EMA, raw and guidance-1 samples (``"stage2"``,
    ``"stage2_raw"``, ``"stage2_g1"``), the stage-3 gate (``"stage3"``)
    and the two final syntheses (``"final"``, ``"final_held_out"``) at
    ``step``; by default the gates draw from one generator seeded
    ``cfg.train.seed`` and the syntheses take ``Synthesizer``'s."""
    dev = resolve_device(device)
    cfg = tiny_test_config() if tiny or dev.type == "cpu" else Config()
    if batch:
        cfg = replace(cfg, train=replace(cfg.train, batch_size=batch))
    t = cfg.train
    n_frames = min(cfg.model.max_frames, 128 if tiny else 256)
    if gate_noise is None:
        gen = torch.Generator(device=dev).manual_seed(t.seed)
        gate_noise = lambda label, step: (  # noqa: E731
            None if label.startswith("final") else gen)

    params = init_params(cfg, seed=t.seed, device="cpu",
                         with_discriminator=True)
    producer = _Producer(SyntheticDataset(
        cfg.model, batch_size=t.batch_size, seed=t.seed, n_frames=n_frames))
    try:
        return _stages(cfg, params, producer.get, dev, gate_noise,
                       n_frames=n_frames, steps=(steps1, steps2, steps3),
                       workdir=workdir, tiny=tiny, eval_every=eval_every,
                       gate_every=gate_every, skip_stage1=skip_stage1,
                       skip_stage2=skip_stage2, resume_stage1=resume_stage1,
                       resume_stage2=resume_stage2, stop_after=stop_after)
    finally:
        producer.close()


def _stages(cfg: Config, params, next_batch, dev, gate_noise, *, n_frames,
            steps, workdir, tiny, eval_every, gate_every, skip_stage1,
            skip_stage2, resume_stage1, resume_stage2, stop_after) -> dict:
    t = cfg.train
    steps1, steps2, steps3 = steps
    # held-out utterances (a disjoint seed: other speakers and texts) for
    # the gates
    eval_batch = SyntheticDataset(
        cfg.model, batch_size=t.batch_size, seed=t.seed + 10_000,
        n_frames=n_frames).next_batch()
    quality: dict = {"config": "tiny" if tiny else "full",
                     "held_out_batch": t.batch_size,
                     "steps": [steps1, steps2, steps3]}

    def log(stage, step, metrics):
        m = {k: round(float(v), 4) for k, v in metrics.items()}
        print(json.dumps({"stage": stage, "step": step, **m}), flush=True)

    report_path = f"{workdir}/quality_report.json"
    # a resumed process extends the prior report's curves
    if (resume_stage1 or resume_stage2 or skip_stage1) \
            and os.path.exists(report_path):
        with open(report_path) as f:
            prior = json.load(f)
        for k, v in prior.items():
            quality.setdefault(k, v)

    def write_report():
        # rewritten after every gate: a run cut short keeps its curves
        os.makedirs(workdir, exist_ok=True)
        with open(report_path, "w") as f:
            json.dump(quality, f, indent=1)

    def gate(stage_name, step, fn):
        res = fn()
        quality.setdefault(f"{stage_name}_curve", []).append(
            {"step": step, **res})
        print(json.dumps({"quality_gate": stage_name, "step": step, **res}),
              flush=True)
        write_report()
        return res

    # ---- stage 1: the adversarial acoustic autoencoder --------------------
    t0 = time.time()
    if skip_stage1:
        like = init_params(cfg, seed=0, device="cpu")
        acoustic_final = load_params(skip_stage1, like={
            "acoustic": like["acoustic"], "vocoder": like["vocoder"]})
        print(f"stage 1 skipped; params from {skip_stage1}", flush=True)
    else:
        tr1 = T.Stage1Trainer(stage_cfg(cfg, steps1), params, device=dev,
                              seed=t.seed)
        s1 = tr1.init_state(params)
        start1 = 0
        if resume_stage1:
            s1 = T.state_from_tree(load_params(
                resume_stage1, like=T.state_tree(s1)), s1)
            start1 = s1.step
            print(f"stage 1 resumed at step {start1} from {resume_stage1}",
                  flush=True)
        for step in range(start1, steps1):
            batch = T.batch_to_device(next_batch(), dev)
            s1, metrics = tr1.train_step(s1, batch)
            if step % eval_every == 0:
                log("1", step, metrics)
            if gate_every and step and step % gate_every == 0:
                gate("stage1", step, lambda: E.evaluate_acoustic(
                    cfg, s1.ema_params, eval_batch, device=dev))
                save_params(f"{workdir}/stage1", s1.ema_params)
                save_params(f"{workdir}/stage1_state", T.state_tree(s1))
        acoustic_final = s1.ema_params
        save_params(f"{workdir}/stage1", acoustic_final)
    quality["stage1"] = gate(
        "stage1", steps1,
        lambda: E.evaluate_acoustic(cfg, acoustic_final, eval_batch,
                                    device=dev))
    # the embedding-side gate: on ground-truth audio the contrastively
    # trained prompt encoder must retrieve the right speaker
    Lgt = min(eval_batch.wav.shape[1], eval_batch.ref_wav.shape[1])
    quality["stage1_gt_margin"] = {
        k: round(float(v), 4) for k, v in E.speaker_similarity_margin(
            cfg, acoustic_final["acoustic"], eval_batch.wav[:, :Lgt],
            eval_batch.ref_wav[:, :Lgt], device=dev).items()}
    print(json.dumps({"stage1_gt_margin": quality["stage1_gt_margin"]}),
          flush=True)
    quality["fsq_usage"] = E.fsq_usage_stats(
        cfg, acoustic_final["acoustic"], eval_batch, device=dev)
    print(json.dumps({"fsq_usage": quality["fsq_usage"]}), flush=True)
    quality["stage1_wall_s"] = round(time.time() - t0, 1)
    write_report()
    print(f"stage 1 done in {time.time() - t0:.0f}s", flush=True)
    if stop_after == 1:
        print("stopping after stage 1 (--stop-after 1)", flush=True)
        return quality

    # ---- stage 2: style latent diffusion ---------------------------------
    t0 = time.time()
    acoustic = acoustic_final["acoustic"]
    if skip_stage2:
        like = init_params(cfg, seed=0, device="cpu")
        teacher = load_params(skip_stage2, like=like["diffusion"])
        print(f"stage 2 skipped; teacher from {skip_stage2}", flush=True)
    else:
        tr2 = T.Stage2Trainer(stage_cfg(cfg, steps2),
                              {"acoustic": acoustic,
                               "diffusion": params["diffusion"]},
                              device=dev, seed=t.seed)
        s2 = tr2.init_state(params["diffusion"])
        start2 = 0
        if resume_stage2:
            s2 = T.state_from_tree(load_params(
                resume_stage2, like=T.state_tree(s2)), s2)
            start2 = s2.step
            print(f"stage 2 resumed at step {start2} from {resume_stage2}",
                  flush=True)

        def gate2(step):
            """The EMA tree over 4 seeds (a noise band), the raw tree on
            one, and the EMA at guidance 1.0, where a sampler with the
            data's spread reads a dispersion ratio of ~1."""
            res = E.evaluate_diffusion(cfg, acoustic, s2.ema, eval_batch,
                                       gate_noise("stage2", step), n_seeds=4,
                                       device=dev)
            res["raw_style_latent_mse"] = E.evaluate_diffusion(
                cfg, acoustic, s2.params, eval_batch,
                gate_noise("stage2_raw", step),
                device=dev)["style_latent_mse_vs_gt"]
            g1 = E.evaluate_diffusion(cfg, acoustic, s2.ema, eval_batch,
                                      gate_noise("stage2_g1", step),
                                      n_seeds=4, guidance=1.0, device=dev)
            res["style_mse_ratio_pairs_over_gt_g1"] = (
                g1["style_mse_ratio_pairs_over_gt"])
            res["mel_mae_sampled_vs_gt_style_g1"] = (
                g1["mel_mae_sampled_vs_gt_style"])
            return res

        for step in range(start2, steps2):
            batch = T.batch_to_device(next_batch(), dev)
            s2, metrics = tr2.train_step(s2, batch)
            if step % eval_every == 0:
                log("2", step, metrics)
            if gate_every and step and step % gate_every == 0:
                gate("stage2", step, lambda: gate2(step))
                save_params(f"{workdir}/stage2", s2.ema)
                save_params(f"{workdir}/stage2_state", T.state_tree(s2))
        teacher = s2.ema
        save_params(f"{workdir}/stage2", teacher)
        quality["stage2"] = gate("stage2", steps2, lambda: gate2(steps2))
    quality["stage2_wall_s"] = round(time.time() - t0, 1)
    write_report()
    print(f"stage 2 done in {time.time() - t0:.0f}s", flush=True)
    if stop_after == 2:
        print("stopping after stage 2 (--stop-after 2)", flush=True)
        return quality

    # ---- stage 3: 1-step distillation ------------------------------------
    # the data is capped at distill_samples clips: steps beyond one pass
    # reuse the same pool in turn
    t0 = time.time()
    tr3 = T.Stage3Trainer(stage_cfg(cfg, steps3),
                          {"acoustic": acoustic, "diffusion": teacher},
                          device=dev, seed=t.seed)
    s3 = tr3.init_state(teacher)
    n3 = steps3
    n_pool = max(1, min(n3, t.distill_samples // t.batch_size))
    pool = [next_batch() for _ in range(n_pool)]
    for step in range(n3):
        batch = T.batch_to_device(pool[step % n_pool], dev)
        s3, metrics = tr3.train_step(s3, batch)
        if step % eval_every == 0:
            log("3", step, metrics)
        if gate_every and step and step % gate_every == 0:
            gate("stage3", step, lambda: E.evaluate_distill_gap(
                cfg, acoustic, teacher, s3.params, eval_batch,
                gate_noise("stage3", step), device=dev))
    quality["stage3"] = gate("stage3", n3, lambda: E.evaluate_distill_gap(
        cfg, acoustic, teacher, s3.params, eval_batch,
        gate_noise("stage3", n3), device=dev))
    quality["stage3_wall_s"] = round(time.time() - t0, 1)
    write_report()
    print(f"stage 3 done in {time.time() - t0:.0f}s", flush=True)

    # ---- the bundle and a synthesis from it ------------------------------
    bundle = {"acoustic": acoustic, "vocoder": acoustic_final["vocoder"],
              "diffusion": s3.params}
    save_params(f"{workdir}/final", bundle)
    syn = Synthesizer(cfg, bundle, device=dev)
    b = next_batch()
    _, wav = syn.synthesize(
        torch.as_tensor(b.phonemes[:2]), torch.as_tensor(b.ref_wav[:2]),
        text_lengths=torch.as_tensor(b.text_lengths[:2]),
        n_frames=n_frames, noise=gate_noise("final", n3))
    sim = E.speaker_similarity(cfg, acoustic, wav,
                               b.ref_wav[:2, : wav.shape[1]], device=dev)
    # similarity that can fail: every held-out synthesis against every
    # held-out reference
    _, wav_b = syn.synthesize(
        torch.as_tensor(eval_batch.phonemes),
        torch.as_tensor(eval_batch.ref_wav),
        text_lengths=torch.as_tensor(eval_batch.text_lengths),
        n_frames=n_frames, noise=gate_noise("final_held_out", n3))
    margin = E.speaker_similarity_margin(cfg, acoustic, wav_b,
                                         eval_batch.ref_wav, device=dev)
    quality["final"] = {
        "synthesis_shape": str(tuple(wav.shape)),
        "speaker_sim_proxy": [round(float(s), 3) for s in sim],
        **{k: round(v, 4) if isinstance(v, float) else v
           for k, v in margin.items()},
    }
    write_report()
    print(json.dumps({"final_synthesis": str(tuple(wav.shape)),
                      **quality["final"]}), flush=True)
    print("pipeline complete; bundle at", f"{workdir}/final; "
          f"quality report at {report_path}", flush=True)
    return quality


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m styletts_zs_torch.pipelines.pipeline",
        description=__doc__.splitlines()[0])
    ap.add_argument("--steps1", type=int, default=200)
    ap.add_argument("--steps2", type=int, default=200)
    ap.add_argument("--steps3", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--workdir", default="runs/pipeline")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--gate-every", type=int, default=0,
                    help="also run the stage's quality gate every N steps "
                         "(0: at the stage boundaries only); the curves "
                         "land in the report as stageN_curve")
    ap.add_argument("--skip-stage1", default=None, metavar="CKPT",
                    help="load the stage-1 EMA tree from this save_params "
                         "file instead of training stage 1")
    ap.add_argument("--skip-stage2", default=None, metavar="CKPT",
                    help="load the stage-2 teacher (EMA) tree from this "
                         "save_params file instead of training stage 2 "
                         "(with --skip-stage1)")
    ap.add_argument("--resume-stage1", default=None, metavar="STATE",
                    help="restore the whole stage-1 train state (masters, "
                         "moments, EMA, step; saved as workdir/stage1_state "
                         "at every gate) and continue from its step")
    ap.add_argument("--resume-stage2", default=None, metavar="STATE",
                    help="the same for stage 2 (workdir/stage2_state)")
    ap.add_argument("--stop-after", type=int, default=0, choices=(0, 1, 2),
                    help="exit after this stage's boundary gate (0: run all "
                         "three)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    run_pipeline(**vars(args))


if __name__ == "__main__":
    main()

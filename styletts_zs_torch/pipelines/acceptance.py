"""Acceptance configs 1-5 as runnable entry points, each giving a JSON-able
report.

Counterpart of ``styletts_zs_tpu/pipelines/acceptance.py``, with its levels,
shapes and report keys:

  1 cpu_ref       the numerics gate (``pipelines.verify``)
  2 zs_batch8     3 s prompt encode + 1-step CFG diffusion -> mel, batch 8
  3 multistep_b32 the multi-step sampler (CFG-doubled batch), batch 32
  4 longform_60s  decoder + vocoder, 60 s with chunked attention -> wav
  5 pod_serving   length-bucketed serving (``pipelines.serve.Server``)

Levels 2-4 time one warm-up call, then the median of ``N_TIMED`` calls,
each on the host clock to its end (``torch.cuda.synchronize()`` on the
card); JAX's slope timing exists for its TPU runtime and does not carry
over.  Every report adds ``"device"``: on the card its name and power
limit as ``nvidia-smi`` gives them, otherwise ``"cpu"``.

Run: ``python -m styletts_zs_torch.cli accept --level 2``
"""
from __future__ import annotations

import subprocess
import time
from typing import Optional

import numpy as np
import torch

from styletts_zs_torch.config import (Config, ModelConfig, RuntimeConfig,
                                      ServeConfig, replace, tiny_test_config)
from styletts_zs_torch.parallel import bucketing
from styletts_zs_torch.pipelines.checkpoint import load_params
from styletts_zs_torch.pipelines.factory import (PARTS, init_params,
                                                 resolve_device)
from styletts_zs_torch.pipelines.infer import make_synthesis_fn
from styletts_zs_torch.pipelines.serve import Request, Server
from styletts_zs_torch.pipelines.verify import run_verification
from styletts_zs_torch.utils import text as text_utils

N_TIMED = 3


def base_config(full: bool) -> Config:
    """The full-width model of levels 2-5 and ``bench`` (256 phonemes, 1024
    frames, bf16), or the tiny config."""
    if not full:
        return tiny_test_config()
    return Config(model=ModelConfig(max_text_len=256, max_frames=1024),
                  runtime=RuntimeConfig(compute_dtype="bfloat16"))


def device_label(device: torch.device) -> str:
    """"cpu", or the card's name and power limit (``nvidia-smi``)."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def measure(fn, args, device: torch.device, n_calls: int = N_TIMED):
    """One warm-up call, then ``n_calls`` calls, each timed on the host
    clock to its end: (the last output, median seconds, (min, max))."""
    fn(*args)
    times = []
    for _ in range(n_calls):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times)), (min(times), max(times))


def synth_inputs(cfg: Config, batch: int, device, seed: int = 0):
    """``bench.py``'s inputs: full-length random phonemes, a 3 s reference
    mel and the sampler's initial noise, all from one seed."""
    m = cfg.model
    g = torch.Generator().manual_seed(seed)
    Tt = m.max_text_len
    ref_frames = 3 * m.audio.sample_rate // m.audio.hop_length
    phonemes = torch.randint(1, 40, (batch, Tt), generator=g)
    ref_mel = 0.5 * torch.randn(batch, ref_frames, m.audio.n_mels, generator=g)
    noise = torch.randn(batch, m.style.n_codes, m.style.d_style, generator=g)
    return (phonemes.to(device),
            torch.full((batch,), Tt, dtype=torch.int32, device=device),
            ref_mel.to(device),
            torch.full((batch,), ref_frames, dtype=torch.int32, device=device),
            noise.to(device))


def _synth_report(cfg: Config, *, batch: int, one_step: bool,
                  n_steps: Optional[int], with_vocoder: bool, n_frames: int,
                  device: torch.device) -> dict:
    m = cfg.model
    params = init_params(cfg, seed=0, device="cpu")
    fn = make_synthesis_fn(cfg, params, one_step=one_step, n_steps=n_steps,
                           with_vocoder=with_vocoder, n_frames=n_frames,
                           device=device)
    (out, wav), dt, spread = measure(fn, synth_inputs(cfg, batch, device),
                                     device)
    audio_s = batch * (wav.shape[1] if wav is not None
                       else n_frames * m.audio.hop_length) / m.audio.sample_rate
    rep = {
        "batch": batch, "n_frames": n_frames,
        "one_step": one_step, "with_vocoder": with_vocoder,
        "wall_s_per_call": dt,
        "wall_s_per_call_spread": list(spread),
        "audio_s_per_s": audio_s / dt,
        "rtf_target_10x": audio_s / dt / 10.0,
        "mel_finite": bool(torch.isfinite(out.mel.float()).all()),
    }
    if wav is not None:
        rep["wav_finite"] = bool(torch.isfinite(wav.float()).all())
    return rep


def _serve_report(base: Config, *, full: bool, n_requests: Optional[int],
                  bundle: Optional[str], device: torch.device) -> dict:
    n_req = n_requests or (256 if full else 8)
    serve = ServeConfig(batch_size=32 if full else 2, one_step=True,
                        with_vocoder=False,
                        frame_buckets=(256, 512, 1024) if full else (64, 128))
    cfg = replace(base, serve=serve)
    params = init_params(cfg, seed=0, device="cpu")
    if bundle is not None:
        # a trained {acoustic, vocoder, diffusion} tree, so the served
        # frames (and the throughput) are real
        params = {**params, **load_params(
            bundle, like={k: params[k] for k in PARTS})}
    server = Server(cfg, params, device=device)
    rng = np.random.default_rng(0)
    sr = cfg.model.audio.sample_rate
    reqs = [Request(
        uid=i,
        phonemes=np.asarray(text_utils.text_to_ids("some request text"),
                            np.int32),
        ref_wav=rng.standard_normal(3 * sr).astype(np.float32) * 0.1,
        est_frames=int(rng.integers(32, cfg.model.max_frames)))
        for i in range(n_req)]
    # serve_batch truncates to max_global_batch: plan over the same slice
    reqs = reqs[: serve.max_global_batch]
    plan = server.plan(reqs)
    t0 = time.perf_counter()
    results = server.serve_batch(reqs)      # copied to the host: finished
    dt = time.perf_counter() - t0
    audio_s = sum(r.frames for r in results) * cfg.model.audio.hop_length / sr
    # batches served per bucket, by the request's length estimate (what
    # the plan saw)
    est_by_uid = {r.uid: r.est_frames for r in reqs}
    got = {b: 0 for b in plan.batches_per_bucket}
    for r in results:
        b = bucketing.bucket_for(est_by_uid[r.uid], serve.frame_buckets)
        got[b] = got.get(b, 0) + 1
    batches_served = {b: -(-n // serve.batch_size) for b, n in got.items()
                      if n}
    return {"config": "pod_serving", "n_requests": len(reqs),
            "completed": len(results), "requeued": len(server.requeued),
            "mesh": None, "bundle": bundle,
            "plan_batches": dict(sorted(plan.batches_per_bucket.items())),
            "served_batches": dict(sorted(batches_served.items())),
            # requeued batches are absent from `got`, so the comparison
            # means something only when nothing was requeued (None: N/A)
            "plan_matches_served":
                (batches_served == plan.batches_per_bucket)
                if not server.requeued else None,
            "style_table_shape": list(server.last_style_table.shape),
            "wall_s": dt,
            "audio_s_per_s_incl_compile": audio_s / dt}


def run_acceptance(level: int, *, full_size: Optional[bool] = None,
                   n_requests: Optional[int] = None,
                   bundle: Optional[str] = None, device=None) -> dict:
    """Run acceptance config ``level`` (1-5) on ``device`` (the card by
    default); returns a JSON-able report.

    ``full_size`` defaults to True on the card and False on the CPU (the
    tiny shapes).  ``n_requests`` and ``bundle`` apply to level 5 only: the
    request count (the contract's scale is 4096) and a trained tree
    ``{acoustic, vocoder, diffusion}`` written by
    ``pipelines.checkpoint.save_params``.
    """
    dev = resolve_device(device)
    full = dev.type == "cuda" if full_size is None else full_size

    if level == 1:
        rep = run_verification(max_frames=256 if full else 64, batch=1,
                               device=dev)
        rep["config"] = "cpu_ref"
    elif level in (2, 3, 4, 5):
        base = base_config(full)
        if level == 2:
            rep = _synth_report(base, batch=8, one_step=True, n_steps=None,
                                with_vocoder=False,
                                n_frames=base.model.max_frames, device=dev)
            rep["config"] = "zs_batch8"
        elif level == 3:
            rep = _synth_report(base, batch=32 if full else 4, one_step=False,
                                n_steps=16 if full else 4, with_vocoder=False,
                                n_frames=base.model.max_frames, device=dev)
            rep["config"] = "multistep_b32"
        elif level == 4:
            frames = 4864 if full else 128
            cfg = replace(base, model=replace(base.model, max_frames=frames))
            rep = _synth_report(cfg, batch=4 if full else 2, one_step=True,
                                n_steps=None, with_vocoder=True,
                                n_frames=frames, device=dev)
            rep["config"] = "longform_60s"
        else:
            rep = _serve_report(base, full=full, n_requests=n_requests,
                                bundle=bundle, device=dev)
    else:
        raise ValueError(f"unknown acceptance level {level}")
    rep["device"] = device_label(dev)
    return rep

"""Scaling harness: 1-step synthesis throughput against the number of ranks.

Counterpart of the repository's ``scripts/scaling_bench.py``: for each
size n of ``--mesh``, the first n ranks synthesize a global batch of
``--batch-per-dev`` x n utterances data-parallel (each rank its rows,
``model`` 1), the 1-step program with the vocoder, and rank 0 prints one
JSON line with JAX's keys: ``n_devices``, ``audio_s_per_s`` (the program's
output length, as ``bench.py`` counts it, over the time of a call) and
``efficiency_vs_linear`` (against n times the first size's number).  A
size beyond the ranks there are ends the run, as JAX's loop breaks.

Timing: one warm-up call, then the median of ``N_CALLS`` calls, each
synchronized with the card and followed by a barrier of the n ranks, on
the host clock (in place of JAX's TPU slope method).  Full width on the
card (256 phonemes, 1024 frames, bf16, weights from a seed); the tiny
config with ``--tiny`` or ``--device cpu`` (on the card with the attention
heads its kernels take, ``graft_entry.tiny_config``).  One rank a
process: under torchrun each takes its card (NCCL); without it, a group of
this process.

    torchrun --nproc-per-node 4 -m styletts_zs_torch.scaling_bench \\
        --mesh 1 2 4
    python -m styletts_zs_torch.scaling_bench --tiny --device cpu --mesh 1
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from styletts_zs_torch.graft_entry import tiny_config
from styletts_zs_torch.parallel import mesh as mesh_lib
from styletts_zs_torch.pipelines.acceptance import base_config, synth_inputs
from styletts_zs_torch.pipelines.factory import init_params, resolve_device
from styletts_zs_torch.pipelines.infer import make_synthesis_fn

N_CALLS = 5


def run_for_mesh(n: int, *, batch_per_dev: int, cfg, fn, device,
                 base=None) -> float:
    """Audio-s/s of the first ``n`` ranks (every rank of the default group
    must call; the others wait at the end).  Prints rank 0's line."""
    group = dist.new_group(list(range(n)))
    rank = dist.get_rank()
    thr = 0.0
    if rank < n:
        rows = mesh_lib.BatchSharding(rank, n).take
        inputs = [rows(x) for x in synth_inputs(cfg, batch_per_dev * n,
                                                device)]

        def call():
            out = fn(*inputs)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dist.barrier(group=group)
            return out

        _, wav = call()
        times = []
        for _ in range(N_CALLS):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
        audio_s = batch_per_dev * n * wav.shape[1] \
            / cfg.model.audio.sample_rate
        thr = audio_s / float(np.median(times))
        if rank == 0:
            eff = None if base is None else thr / max(base * n, 1e-9)
            print(json.dumps({"n_devices": n, "audio_s_per_s": thr,
                              "efficiency_vs_linear": eff}), flush=True)
    dist.barrier()
    dist.destroy_process_group(group)
    return thr


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--batch-per-dev", type=int, default=8)
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny model (mechanism check)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    created = not dist.is_initialized()
    mesh_lib.make_mesh(devices=dev.type)     # the default group
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        cfg = tiny_config(dev.type) if args.tiny or dev.type != "cuda" \
            else base_config(True)
        fn = make_synthesis_fn(cfg, init_params(cfg, seed=0, device="cpu"),
                               one_step=True, with_vocoder=True, device=dev)
        base = None
        for n in args.mesh:
            if n > dist.get_world_size():
                break
            thr = run_for_mesh(n, batch_per_dev=args.batch_per_dev, cfg=cfg,
                               fn=fn, device=dev, base=base)
            if base is None:     # rank 0's is the one printed
                base = thr
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

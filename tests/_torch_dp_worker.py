"""One rank of the port's data-parallel checks on the CPU (gloo), or, with
no mesh, the one-process reference the ranks are held against.

    python tests/_torch_dp_worker.py OUT_DIR [--hosts]

runs as one rank of the process group that torchrun's environment names
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``GROUP_RANK``
the rank's host) and writes ``OUT_DIR/rank<r>.pt``: the mesh's shape, the
collectives' outputs, the two-host plan, ``Server(mesh=)``'s results, the
synthesis on the mesh, ``Server(mesh=)`` with a failure planted on one
rank, and the three trainers' data-parallel losses,
gradients and two steps, each on the global batch that ``run`` makes from
fixed seeds; with ``--hosts``, only the exchanges between hosts, into
``OUT_DIR/hosts<r>.pt``.  Tiny config, dropout 0, one thread.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from styletts_zs_torch.config import replace, tiny_test_config  # noqa: E402
from styletts_zs_torch.parallel import bucketing, collectives  # noqa: E402
from styletts_zs_torch.parallel import mesh as mesh_lib  # noqa: E402
from styletts_zs_torch.pipelines import train as T  # noqa: E402
from styletts_zs_torch.pipelines.data import SyntheticDataset  # noqa: E402
from styletts_zs_torch.pipelines.factory import init_params  # noqa: E402
from styletts_zs_torch.pipelines.infer import make_synthesis_fn  # noqa: E402
from styletts_zs_torch.pipelines.serve import Request, Server  # noqa: E402
from styletts_zs_torch.utils import text as text_utils  # noqa: E402

GLOBAL_BATCH = 4          # splits over 1, 2 and 4 data ranks
N_FRAMES, TEXT_LEN = 64, 16
BOUNDARIES = (256, 640)
LENGTHS = np.arange(16, dtype=np.int64) * 40          # 0 .. 600
HOST_LENGTHS = ([100, 300], [120, 600, 900])          # test_multiprocess.py
PLAN_BUCKETS = (256, 512, 1024)


def config():
    """The tiny config, dropout 0, a warm-up of 2 and lr 1e-3 (so one step
    moves the weights)."""
    cfg = tiny_test_config()
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, text_encoder=dataclasses.replace(m.text_encoder, dropout=0.0),
        prosody_encoder=dataclasses.replace(m.prosody_encoder, dropout=0.0),
        predictor=dataclasses.replace(m.predictor, dropout=0.0)),
        train=dataclasses.replace(cfg.train, warmup_steps=2, lr=1e-3,
                                  lr_disc=2e-3))


def params_with_gates(cfg):
    """Seed-0 weights, the duration head's bias at a few frames a phoneme
    and the denoiser's zero-initialised gates drawn, so that the
    utterances are not empty and every block reaches the loss."""
    params = init_params(cfg, seed=0, device="cpu", with_discriminator=True)
    params["acoustic"]["duration_predictor.out.bias"].fill_(1.5)
    g = torch.Generator().manual_seed(3)
    for k, v in params["diffusion"].items():
        if not v.any():
            v.copy_(0.1 * torch.randn(v.shape, generator=g))
    return params


def requests(cfg, n: int = 8) -> list[Request]:
    rng = np.random.default_rng(0)
    sr = cfg.model.audio.sample_rate
    return [Request(uid=i, phonemes=np.asarray(text_utils.text_to_ids(
        "mesh request " + "a" * (i % 5)), np.int32),
        ref_wav=rng.standard_normal(sr).astype(np.float32) * 0.1,
        est_frames=int(rng.integers(20, 120))) for i in range(n)]


def draws(cfg):
    """Stage 2's and stage 3's draws for the global batch."""
    s = cfg.model.style
    g = torch.Generator().manual_seed(11)
    return {"drop": torch.tensor([False, True, False, True]),
            "n": torch.randn(GLOBAL_BATCH, generator=g),
            "noise": torch.randn(GLOBAL_BATCH, s.n_codes, s.d_style,
                                 generator=g)}


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def planted_failures(server, cfg, mesh) -> dict:
    """The last data rank's run of the first batch raises, the others'
    not: first a ``RuntimeError`` (every rank should requeue that batch
    and serve the rest), then a ``ValueError`` (every rank should raise).
    Per exception: the requeued uids, the results' order and (frames, mel)
    per uid, or the name of the exception this rank raised."""
    sharding = mesh_lib.batch_sharding(mesh)
    last = sharding.index == sharding.count - 1
    run = server._run
    res = {}
    for exc in (RuntimeError("planted"), ValueError("planted")):
        first = [True]

        def planted(*args):
            if first[0]:
                first[0] = False
                if last:
                    raise exc
            return run(*args)
        server._run = planted
        server.requeued = []
        try:
            got = server.serve_batch(requests(cfg))
            res[type(exc).__name__] = {
                "requeued": [r.uid for r in server.requeued],
                "order": [r.uid for r in got],
                "serve": {r.uid: (r.frames, r.mel) for r in got}}
        except Exception as e:  # noqa: BLE001 -- the test reads the kind
            res[type(exc).__name__] = {"raised": type(e).__name__}
    server._run = run
    server.requeued = []
    return res


def run(mesh) -> dict:
    """Everything the checks compare, on ``mesh``'s ranks or (``mesh``
    None) in one process.  oneDNN is off: its convolutions pick their
    algorithm by the batch, so a rank's one row would be summed in another
    order than the same row of the global batch."""
    with torch.backends.mkldnn.flags(enabled=False):
        return _run(mesh)


def _run(mesh) -> dict:
    cfg = config()
    sharding = mesh_lib.batch_sharding(mesh) if mesh is not None else \
        mesh_lib.replicated()
    rows = sharding.take
    out: dict = {}
    if mesh is not None:
        out["shape"] = mesh_lib.mesh_shape(mesh)
        out["hists"] = collectives.gather_length_histograms(
            mesh, torch.from_numpy(rows(LENGTHS)), BOUNDARIES)
        codes = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (16, 4, 6)).astype(np.float32))
        out["codes"] = collectives.gather_style_codes(mesh, rows(codes))
        summ = codes[:8, 0]
        out["summaries"] = collectives.gather_style_codes(mesh, rows(summ))
    out["local_hist"] = collectives.length_histogram(
        torch.from_numpy(LENGTHS), BOUNDARIES)

    params = params_with_gates(cfg)
    # serving: batch 4, so every rank of 1, 2 or 4 holds a row
    scfg = replace(cfg, serve=replace(cfg.serve, batch_size=GLOBAL_BATCH,
                                      frame_buckets=(64, 128),
                                      with_vocoder=False, one_step=True))
    server = Server(scfg, params, device="cpu", mesh=mesh)
    res = server.serve_batch(requests(scfg))
    out["serve"] = {r.uid: (r.frames, r.mel) for r in res}
    out["serve_order"] = [r.uid for r in res]
    out["serve_table"] = server.last_style_table
    out["serve_plan"] = server.plan(requests(scfg)).batches_per_bucket
    if mesh is not None:
        out["serve_planted"] = planted_failures(server, scfg, mesh)

    # the synthesis program with the vocoder on the mesh's rows
    m = cfg.model
    g = torch.Generator().manual_seed(5)
    ref_frames = m.audio.sample_rate // m.audio.hop_length
    args = (torch.randint(1, 40, (GLOBAL_BATCH, m.max_text_len), generator=g),
            torch.full((GLOBAL_BATCH,), m.max_text_len, dtype=torch.int32),
            0.5 * torch.randn(GLOBAL_BATCH, ref_frames, m.audio.n_mels,
                              generator=g),
            torch.full((GLOBAL_BATCH,), ref_frames, dtype=torch.int32),
            torch.randn(GLOBAL_BATCH, m.style.n_codes, m.style.d_style,
                        generator=g))
    fn = make_synthesis_fn(cfg, params, one_step=True, with_vocoder=True,
                           device="cpu")
    o, wav = fn(*[rows(a) for a in args])
    mel = o.mel
    if mesh is not None:
        mel = collectives.gather_rows(mesh, mel)
        wav = collectives.gather_rows(mesh, wav)
    out["synth"] = {"mel": mel, "wav": wav}

    nb = SyntheticDataset(m, batch_size=GLOBAL_BATCH, seed=1,
                          n_frames=N_FRAMES, text_len=TEXT_LEN).next_batch()
    batch = T.batch_to_device(nb, "cpu", sharding=sharding)

    tr1 = T.Stage1Trainer(cfg, params, device="cpu", mesh=mesh)
    s1 = tr1.init_state(params)
    tr1.load(s1.g_params, s1.d_params)
    _, g_aux, g_grads = tr1.g_grads(batch)
    _, d_aux, d_grads = tr1.d_grads(batch)
    # two steps: the first update's learning rate is 0 (the warm-up)
    s1, _ = tr1.train_step(s1, batch)
    s1, metrics = tr1.train_step(s1, batch)
    out["stage1"] = {"aux": _cpu({**g_aux, **d_aux}),
                     "grads": _cpu({**g_grads, "discriminator": d_grads}),
                     "metrics": _cpu(metrics), "g_params": _cpu(s1.g_params)}

    d = {k: rows(v) for k, v in draws(cfg).items()}
    tr2 = T.Stage2Trainer(cfg, params, device="cpu", mesh=mesh)
    s2 = tr2.init_state(params["diffusion"])
    tr2.load(s2.params)
    _, aux2, grads2 = tr2.grads(batch, **d)
    s2, m2 = tr2.train_step(s2, batch, **d)
    # a step with the trainer's own draws: the global draw, cut to the rows
    s2, m2b = tr2.train_step(s2, batch)
    out["stage2"] = {"aux": _cpu(aux2), "grads": _cpu(grads2),
                     "metrics": _cpu(m2), "params": _cpu(s2.params),
                     "ema": _cpu(s2.ema),
                     "metrics_drawn": _cpu(m2b)}

    tr3 = T.Stage3Trainer(cfg, params, device="cpu", mesh=mesh)
    s3 = tr3.init_state(params["diffusion"])
    tr3.load(s3.params)
    _, aux3, grads3 = tr3.grads(batch, noise=d["noise"])
    s3, _ = tr3.train_step(s3, batch, noise=d["noise"])
    s3, m3 = tr3.train_step(s3, batch, noise=d["noise"])
    out["stage3"] = {"aux": _cpu(aux3), "grads": _cpu(grads3),
                     "metrics": _cpu(m3), "params": _cpu(s3.params)}
    return out


def hosts() -> dict:
    """The exchanges between hosts, each host (``GROUP_RANK``) holding its
    own requests: the summed histogram, the plan from it, and the style
    tables joined in host order."""
    host = int(os.environ["GROUP_RANK"])
    local = bucketing.bucket_histogram(np.asarray(HOST_LENGTHS[host]),
                                       PLAN_BUCKETS)
    hist = collectives.process_sum_histogram(local)
    plan = bucketing.plan_buckets(hist, batch_size=2, buckets=PLAN_BUCKETS)
    table = np.full((host + 1, 3), host, np.float32)
    return {"host_hist": hist.tolist(),
            "host_plan": sorted(plan.batches_per_bucket.items()),
            "host_styles": collectives.process_concat_styles(table)}


def main() -> None:
    torch.set_num_threads(1)
    out_dir = Path(sys.argv[1])
    if sys.argv[2:] == ["--hosts"]:
        mesh_lib.multihost_init(backend="gloo")
        torch.save(hosts(), out_dir /
                   f"hosts{torch.distributed.get_rank()}.pt")
        torch.distributed.destroy_process_group()
        return
    mesh = mesh_lib.make_mesh(devices="cpu")
    out = run(mesh)
    try:
        mesh_lib.make_mesh(model=2, devices="cpu")
    except NotImplementedError:
        out["model_axis_raises"] = True
    torch.save(out, out_dir / f"rank{torch.distributed.get_rank()}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

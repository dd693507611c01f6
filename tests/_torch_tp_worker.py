"""One rank of the port's tensor-parallel checks on the CPU (gloo), or,
with no mesh, the one-process step the ranks are held against.

    python tests/_torch_tp_worker.py OUT_DIR

runs as one rank of the process group that torchrun's environment names
and writes ``OUT_DIR/rank<r>.pt``.  ``OUT_DIR/params.pt`` holds the
weights (``torch.save`` of ``{"256": params, "512": params}``, the narrow
configs' trees that the test made from JAX's), ``OUT_DIR/one_process.pt``
the width-256 tree as one process saves it (``save_params``).  Two
ranks: the stage-1 step on a (1, 2) mesh at width 256 (losses, gradients
gathered whole, the clip's norm, two steps; then two steps with a clip
that bites; a one-process checkpoint restored onto the shards; the whole
state as ``state_tree`` writes it), the shards' round trip and bytes, the (data, model) shapes ``make_mesh`` lays out,
and ``scaling_bench --mesh 1 2``.  Four ranks: the step on a (2, 2) mesh
at width 256 and on a (1, 4) mesh at width 512 (the AdaIN kernels split to
128 channels), and ``dryrun_multichip(4)``.  Dropout 0, one thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_dp_worker as DP  # noqa: E402
from styletts_zs_torch import graft_entry, scaling_bench  # noqa: E402
from styletts_zs_torch.parallel import mesh as mesh_lib  # noqa: E402
from styletts_zs_torch.parallel import sharding  # noqa: E402
from styletts_zs_torch.pipelines import train as T  # noqa: E402
from styletts_zs_torch.pipelines.checkpoint import load_params  # noqa: E402
from styletts_zs_torch.pipelines.data import SyntheticDataset  # noqa: E402

GLOBAL_BATCH = 4
N_FRAMES, TEXT_LEN = 64, 16
BITING_CLIP = 1e-3       # far below the gradient's norm: the clip scales


def narrow_config(width: int):
    """``_torch_dp_worker.config()`` (dropout 0, a fast schedule) with every
    model width ``width`` and the vocoder's first two stages at ``width``
    and 256: at width 256 and model 2 JAX's rule splits every kind of leaf
    (Dense and ``nn.Conv`` kernels, the AdaIN kernels, ``up0_kernel``, both
    embedding tables, both ``queries``, ``null_prompt_tokens``); at width
    512 and model 4 the AdaIN kernels split into 128 channels."""
    cfg = DP.config()
    m = cfg.model
    r = dataclasses.replace
    return r(cfg, model=r(
        m, text_encoder=r(m.text_encoder, dim=width),
        prosody_encoder=r(m.prosody_encoder, dim=width),
        style=r(m.style, extractor_dim=width),
        prompt_encoder=r(m.prompt_encoder, dim=width),
        predictor=r(m.predictor, dim=width),
        decoder=r(m.decoder, dim=width),
        diffusion=r(m.diffusion, dim=width),
        vocoder=r(m.vocoder, dims=(width, 256, m.vocoder.dims[-1]))))


def biting(cfg):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_clip=BITING_CLIP))


def batch(cfg):
    return SyntheticDataset(cfg.model, batch_size=GLOBAL_BATCH, seed=1,
                            n_frames=N_FRAMES,
                            text_len=TEXT_LEN).next_batch()


def stage1(cfg, params, mesh, *, min_shard_dim: int = 256,
           restore: str | None = None) -> dict:
    """The losses, whole gradients and the clip's global norm of one
    step's G and D losses, then two steps (the first at lr 0) and the
    whole masters after them; on a
    mesh also the whole state as ``state_tree`` writes it and, with
    ``restore``, the shards a one-process file restores to."""
    sh = mesh_lib.batch_sharding(mesh) if mesh is not None else None
    b = T.batch_to_device(batch(cfg), "cpu", sharding=sh)
    tr = T.Stage1Trainer(cfg, params, device="cpu", mesh=mesh,
                         min_shard_dim=min_shard_dim)
    s = tr.init_state(params)
    tr.load(s.g_params, s.d_params)
    _, g_aux, g_grads = tr.g_grads(b)
    _, d_aux, d_grads = tr.d_grads(b)
    flat = T._flat(g_grads)
    norm = tr._g_norm(flat)          # the clip's norm over the model ranks
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(flat)))
    out = {"aux": DP._cpu({**g_aux, **d_aux}),
           "grads": DP._cpu({**tr.whole(g_grads), "discriminator": d_grads}),
           "norm": float(norm)}
    if restore is not None:
        local = sharding.shard_params(load_params(restore), tr.shardings)
        out["restored_equal"] = all(
            torch.equal(local[p][k], s.g_params[p][k])
            for p in T.G_PARTS for k in s.g_params[p])
    s, _ = tr.train_step(s, b)
    s, metrics = tr.train_step(s, b)
    out["metrics"] = DP._cpu(metrics)
    out["g_params"] = DP._cpu(tr.whole(s.g_params))
    if mesh is not None:
        out["tree"] = DP._cpu(T.state_tree(s, trainer=tr))
        out["local_bytes"] = sharding.estimate_bytes(s.g_params)
    else:
        out["tree"] = DP._cpu(T.state_tree(s))
    return out


def reference(params: dict) -> dict:
    """The one-process runs the ranks are held against."""
    with torch.backends.mkldnn.flags(enabled=False):
        c256, c512 = narrow_config(256), narrow_config(512)
        return {"256": stage1(c256, params["256"], None),
                "256_clip": stage1(biting(c256), params["256"], None),
                "512": stage1(c512, params["512"], None)}


def two_ranks(params: dict, one_process: str) -> dict:
    out = {}
    cfg = narrow_config(256)
    mesh = mesh_lib.make_mesh(1, 2, devices="cpu")
    out["shape"] = mesh_lib.mesh_shape(mesh)
    out["256"] = stage1(cfg, params["256"], mesh, restore=one_process)
    out["256_clip"] = stage1(biting(cfg), params["256"], mesh)
    g = {p: params["256"][p] for p in T.G_PARTS}
    shs = sharding.param_shardings(g, mesh, cfg)
    local = sharding.shard_params(g, shs)
    back = sharding.unshard_params(local, shs, mesh.get_group("model"))
    out["round_trip"] = all(torch.equal(back[p][k], g[p][k])
                            for p in g for k in g[p])
    out["shard_bytes"] = sharding.estimate_bytes(local)
    out["fresh"] = all(local[p][k].is_contiguous()
                       and local[p][k].untyped_storage().nbytes()
                       == local[p][k].numel() * 4
                       for p in local for k in local[p]
                       if shs[p][k] is not None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        scaling_bench.main(["--tiny", "--device", "cpu", "--mesh", "1", "2",
                            "--batch-per-dev", "1"])
    out["scaling"] = buf.getvalue()
    return out


def four_ranks(params: dict) -> dict:
    out = {}
    mesh = mesh_lib.make_mesh(2, 2, devices="cpu")
    out["shape22"] = mesh_lib.mesh_shape(mesh)
    out["256"] = stage1(narrow_config(256), params["256"], mesh)
    mesh = mesh_lib.make_mesh(1, 4, devices="cpu")
    out["shape14"] = mesh_lib.mesh_shape(mesh)
    out["512"] = stage1(narrow_config(512), params["512"], mesh)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graft_entry.dryrun_multichip(4, device="cpu")
    out["dryrun"] = buf.getvalue()
    return out


def main() -> None:
    torch.set_num_threads(1)
    out_dir = Path(sys.argv[1])
    params = torch.load(out_dir / "params.pt", weights_only=True)
    mesh_lib.multihost_init(backend="gloo")
    with torch.backends.mkldnn.flags(enabled=False):
        if torch.distributed.get_world_size() == 2:
            out = two_ranks(params, str(out_dir / "one_process.pt"))
        else:
            out = four_ranks(params)
    torch.save(out, out_dir / f"rank{torch.distributed.get_rank()}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

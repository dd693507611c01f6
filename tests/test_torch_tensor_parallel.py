"""The port's tensor parallelism (the ``model`` axis: ``parallel/
sharding.py``, ``parallel/tensor.py``, the layers on weight chunks, the
stage-1 trainer on a (data, model) mesh) on the CPU over gloo, against one
process and against the JAX package; and the entry points that use the
axis, ``graft_entry.dryrun_multichip`` and ``scaling_bench``.

Groups of 2 and 4 processes run ``tests/_torch_tp_worker.py``, each under
its own timeout.  The weights are the narrow configs' trees made with numpy
from a seed for JAX (``random_tree``) and converted; the one-process step
runs in this process.  Width 256 at (1, 2) and (2, 2) splits every kind of
leaf; width 512 at (1, 4) splits the AdaIN kernels into 128 channels.
Bounds (``test_torch_parallel.py``'s): losses rtol 2e-4 / atol 1e-5, each
gradient tensor within 1e-3 of its largest value plus 1e-6 of its model's
largest; the weights after two steps within 1e-4 wherever the reference's
gradient exceeds that allowance.  Where it does not, the reference itself
does not fix the sign of Adam's normalised step (it moves those weights by
up to 6.7e-4 when only its thread count changes, at lr 1e-3), and each
weight is held to twice Adam's largest move (a flipped sign).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_worker as TW
from _torch_parity import random_tree, run_group
from styletts_zs_tpu.parallel import mesh as j_mesh
from styletts_zs_tpu.parallel import sharding as j_sharding
from styletts_zs_tpu.pipelines import data as j_data
from styletts_zs_tpu.pipelines import train as JT
from styletts_zs_tpu.utils import config as j_config
from styletts_zs_torch.config import to_dict
from styletts_zs_torch.parallel import tensor as tp
from styletts_zs_torch.pipelines import train as T
from styletts_zs_torch.pipelines.checkpoint import save_params
from styletts_zs_torch.pipelines.convert import convert_params

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-4, 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-6
PARAM_TOL = 1e-4
GROUP_TIMEOUT = 300
MESHES = {"1x2": ("group2", "256"), "2x2": ("group4", "256"),
          "1x4": ("group4", "512")}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_config(cfg):
    return j_config._from_dict(j_config.Config, to_dict(cfg))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The narrow configs' weights (JAX's trees, converted), written where
    the workers read them, and the one-process runs."""
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("tp")
    trees, params = {}, {}
    for w in ("256", "512"):
        cfg = TW.narrow_config(int(w))
        trees[w] = random_tree(jax_config(cfg), with_discriminator=True)
        params[w] = convert_params(trees[w], cfg)
    torch.save(params, out / "params.pt")
    save_params(str(out / "one_process.pt"), params["256"])
    return {"dir": out, "trees": trees, "params": params,
            "ref": TW.reference(params)}


def _group(world, n: int) -> list[dict]:
    run_group(n, hosts=1, script=[str(REPO / "tests" / "_torch_tp_worker.py"),
                                  str(world["dir"])],
              timeout=GROUP_TIMEOUT)
    return [torch.load(world["dir"] / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module")
def group2(world):
    return _group(world, 2)


@pytest.fixture(scope="module")
def group4(world, group2):
    return _group(world, 4)


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{pre}.{k}" if pre else k)
    else:
        yield pre, tree


def _allowances(grads: dict) -> dict:
    """Each gradient tensor's allowance: GRAD_RTOL of its largest value
    plus GRAD_FLOOR of its model's largest."""
    ref = dict(_flat(grads))
    scale = {}
    for k, r in ref.items():
        part = k.split(".")[0]
        scale[part] = max(scale.get(part, 0.0), r.abs().max().item())
    return {k: GRAD_RTOL * r.abs().max().item()
            + GRAD_FLOOR * scale[k.split(".")[0]] for k, r in ref.items()}


def _close_scalars(got: dict, ref: dict) -> None:
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _close_weights(got: dict, ref: dict, grads: dict, lr_sum: float) -> None:
    """Within PARAM_TOL where the reference's gradient exceeds its
    allowance; everywhere within twice Adam's largest move (a sign flip),
    with room for the weight decay."""
    allow = _allowances(grads)
    g = dict(_flat(grads))
    got = dict(_flat(got))
    n_fixed = 0
    for k, r in _flat(ref):
        err = (got[k] - r).abs()
        fixed = g[k].abs() > allow[k]
        n_fixed += int(fixed.sum())
        if fixed.any():
            assert err[fixed].max().item() <= PARAM_TOL, k
        assert err.max().item() <= 2.05 * lr_sum, k
    assert n_fixed > 1000


def _ranks(request, mesh: str):
    name, width = MESHES[mesh]
    return request.getfixturevalue(name), width


# --- the mesh ----------------------------------------------------------------

def test_make_mesh_lays_out_data_and_model(group2, group4):
    for rank in group2:
        assert rank["shape"] == {"data": 1, "model": 2}
    for rank in group4:
        assert rank["shape22"] == {"data": 2, "model": 2}
        assert rank["shape14"] == {"data": 1, "model": 4}


def test_collectives_over_one_rank_are_identities():
    y = torch.randn(2, 3, requires_grad=True)
    assert tp.gather_features(y, -1, None) is y
    assert tp.copy_to_model(y, None) is y
    assert tp.gather_param(y, 0, None) is y


# --- the stage-1 step against one process ------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_losses_equal_one_process(request, world, mesh):
    ranks, width = _ranks(request, mesh)
    ref = world["ref"][width]
    for rank in ranks:
        _close_scalars(rank[width]["aux"], ref["aux"])
        _close_scalars(rank[width]["metrics"], ref["metrics"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_whole_gradients_equal_one_process(request, world, mesh):
    ranks, width = _ranks(request, mesh)
    ref = world["ref"][width]["grads"]
    allow = _allowances(ref)
    for rank in ranks:
        got = dict(_flat(rank[width]["grads"]))
        assert got.keys() == allow.keys()
        for k, r in _flat(ref):
            assert got[k].shape == r.shape, k
            err = (got[k] - r).abs().max().item()
            assert err <= allow[k], (k, err, allow[k])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_two_steps_follow_one_process(request, world, mesh):
    """The whole masters after two steps: equal on every rank, bit for
    bit, and following the one-process trajectory."""
    ranks, width = _ranks(request, mesh)
    ref = world["ref"][width]
    first = dict(_flat(ranks[0][width]["g_params"]))
    for rank in ranks[1:]:
        for k, v in _flat(rank[width]["g_params"]):
            assert torch.equal(v, first[k]), k
    cfg = TW.narrow_config(int(width))
    lr_sum = T.make_optimizer(cfg).lr(1)      # the first step's lr is 0
    _close_weights(ranks[0][width]["g_params"], ref["g_params"],
                   {p: ref["grads"][p] for p in T.G_PARTS}, lr_sum)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_clip_norm_equals_one_process(request, world, mesh):
    """The clip's global norm: the split leaves' squares summed over the
    model ranks, each whole leaf counted once, as one process's norm, to
    the gradients' own bound (a norm that left out the other ranks' chunks
    reads a quarter to a half low)."""
    ranks, width = _ranks(request, mesh)
    for rank in ranks:
        np.testing.assert_allclose(rank[width]["norm"],
                                   world["ref"][width]["norm"],
                                   rtol=GRAD_RTOL)


def test_tp_clip_that_bites_equals_one_process(world, group2):
    """A clip far below the gradient's norm: every rank scales by the same
    global norm, so the ranks stay equal bit for bit and on the
    one-process step."""
    ref = world["ref"]["256_clip"]
    cfg = TW.biting(TW.narrow_config(256))
    lr_sum = T.make_optimizer(cfg).lr(1)
    a, b = (dict(_flat(r["256_clip"]["g_params"])) for r in group2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for rank in group2:
        _close_scalars(rank["256_clip"]["metrics"], ref["metrics"])
        _close_weights(rank["256_clip"]["g_params"], ref["g_params"],
                       {p: ref["grads"][p] for p in T.G_PARTS}, lr_sum)


def test_tp_local_bytes_fall_with_the_model_axis(world, group2, group4):
    whole = sum(v.numel() * 4 for p in T.G_PARTS
                for v in world["params"]["256"][p].values())
    for rank in group2:
        assert rank["256"]["local_bytes"] < 0.6 * whole
        assert rank["shard_bytes"] == rank["256"]["local_bytes"]
    whole512 = sum(v.numel() * 4 for p in T.G_PARTS
                   for v in world["params"]["512"][p].values())
    for rank in group4:
        assert rank["512"]["local_bytes"] < 0.5 * whole512


# --- checkpoints and the shards' round trip ----------------------------------

def test_state_tree_is_the_one_process_tree(world, group2):
    """``state_tree(state, trainer=)`` writes the whole state: the keys and
    shapes of one process's tree, the same on both ranks, the values on
    the one-process trajectory."""
    ref = dict(_flat(world["ref"]["256"]["tree"]))
    a, b = (dict(_flat(r["256"]["tree"])) for r in group2)
    assert a.keys() == ref.keys() == b.keys()
    for k, r in ref.items():
        assert a[k].shape == r.shape and a[k].dtype == r.dtype, k
        assert torch.equal(a[k], b[k]), k
    assert int(a["step"]) == 2 and int(a["g_opt.count"]) == 2
    lr_sum = T.make_optimizer(TW.narrow_config(256)).lr(1)
    _close_weights({k: a[f"g_params.{k}"] for k in
                    dict(_flat(world["ref"]["256"]["g_params"]))},
                   dict(_flat(world["ref"]["256"]["g_params"])),
                   {p: world["ref"]["256"]["grads"][p] for p in T.G_PARTS},
                   lr_sum)


def test_one_process_checkpoint_restores_onto_the_shards(group2):
    """``shard_params(load_params(path), trainer.shardings)`` of a file
    one process saved gives each rank's initial masters bit for bit."""
    assert all(r["256"]["restored_equal"] for r in group2)


def test_shards_round_trip_over_the_model_group(group2):
    for rank in group2:
        assert rank["round_trip"] and rank["fresh"]


# --- JAX's sharded loss ------------------------------------------------------

def test_jax_sharded_g_loss_equals_two_ranks(world, group2):
    """JAX's stage-1 ``g_loss`` with the generator split by its own rule
    on a (1, 2) mesh of its virtual devices and the batch over ``data``,
    against the port's two ranks at (1, 2): every term."""
    cfg = jax_config(TW.narrow_config(256))
    tree = world["trees"]["256"]
    mesh = j_mesh.make_mesh(data=1, model=2, devices=jax.devices()[:2])
    g = {p: tree[p] for p in T.G_PARTS}
    shards = j_sharding.param_shardings(g, mesh)
    g = jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s), g,
                     shards)
    assert any(len(s.spec) and s.spec[-1] == "model"
               for s in jax.tree.leaves(shards))
    d = jax.device_put(jax.tree.map(jnp.asarray, tree["discriminator"]),
                       j_mesh.replicated(mesh))
    nb = j_data.SyntheticDataset(cfg.model, batch_size=TW.GLOBAL_BATCH,
                                 seed=1, n_frames=TW.N_FRAMES,
                                 text_len=TW.TEXT_LEN).next_batch()
    batch = JT.batch_to_device(nb, j_mesh.batch_sharding(mesh))
    _, aux = jax.jit(JT.Stage1Trainer(cfg).g_loss)(
        g, d, batch, jax.random.PRNGKey(0))
    for rank in group2:
        got = rank["256"]["aux"]
        for k, v in aux.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


# --- the entry points --------------------------------------------------------

def test_dryrun_multichip_on_four_ranks(group4):
    line = group4[0]["dryrun"].strip()
    assert line.startswith("dryrun_multichip OK: mesh=(2,2), stage-1/2/3 "
                           "step metrics finite"), line
    assert "metadata all_gather shape (2, 1)" in line
    assert "style-code all_gather shape (4, 8, 3)" in line
    assert all(r["dryrun"] == "" for r in group4[1:])


def test_scaling_bench_prints_jax_keys_per_mesh_size(group2):
    lines = [__import__("json").loads(x) for x in
             group2[0]["scaling"].strip().splitlines()]
    assert [x["n_devices"] for x in lines] == [1, 2]
    for x in lines:
        assert set(x) == {"n_devices", "audio_s_per_s",
                          "efficiency_vs_linear"}
        assert x["audio_s_per_s"] > 0
    assert lines[0]["efficiency_vs_linear"] is None
    assert lines[1]["efficiency_vs_linear"] > 0
    assert group2[1]["scaling"] == ""

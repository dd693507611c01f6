"""The port's data parallelism (``parallel/mesh.py``, ``collectives.py``,
``Server(mesh=)``, the trainers' ``mesh=``) on the CPU over gloo, in groups
of 2 and 4 processes, against one process and against the JAX package.

Each group runs ``tests/_torch_dp_worker.py`` once per rank, with
torchrun's environment, under its own timeout: a hang fails that group's
tests, not the suite.  The ranks share one host, as ``Server(mesh=)``
expects (every rank holds the same requests); the exchanges between hosts
run in a second group whose ranks ``GROUP_RANK`` puts on two hosts (one or
two ranks each).  The one-process reference is the same worker's ``run(None)``
in this process.  Tiny config, dropout 0, one thread.  Bounds: the
collectives, the plan, the order and the frames equal; mel and waveform
within 2e-5 (JAX's ``test_parallel.py:125-155``); the trainers' losses
within rtol 2e-4 / atol 1e-5 (JAX's ``:118-121``), each gradient tensor
within 1e-3 of its largest value plus 1e-6 of its model's largest, the
weights after two steps within 1e-4.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_worker as W
from _torch_parity import load_chip_smoke, run_group
from styletts_zs_tpu.parallel import bucketing as j_bucketing
from styletts_zs_tpu.parallel import collectives as j_coll
from styletts_zs_tpu.parallel import mesh as j_mesh
from styletts_zs_torch.parallel import collectives, mesh as mesh_lib

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-4, 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-6
SYNTH_TOL = 2e-5
# weights after two steps: Adam normalises each element's step, so an
# element whose gradient is near 0 moves by up to the learning rate either
# way; test_torch_train.py holds the JAX trajectories to the same bound
PARAM_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    torch.set_num_threads(1)
    return W.run(None)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def group(request, tmp_path_factory):
    n = request.param
    out = tmp_path_factory.mktemp(f"dp{n}")
    worker = str(REPO / "tests" / "_torch_dp_worker.py")
    run_group(n, hosts=1, script=[worker, str(out)])
    run_group(n, hosts=2, script=[worker, str(out), "--hosts"])
    ranks = [{**torch.load(out / f"rank{r}.pt", weights_only=False),
              **torch.load(out / f"hosts{r}.pt", weights_only=False)}
             for r in range(n)]
    return {"n": n, "ranks": ranks}


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{pre}.{k}" if pre else k)
    else:
        yield pre, tree


def _close_scalars(got: dict, ref: dict) -> None:
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _close_grads(got: dict, ref: dict) -> None:
    ref, got = dict(_flat(ref)), dict(_flat(got))
    assert got.keys() == ref.keys()
    scale = {}
    for k, r in ref.items():
        part = k.split(".")[0]
        scale[part] = max(scale.get(part, 0.0), r.abs().max().item())
    for k, r in ref.items():
        err = (got[k] - r).abs().max().item()
        assert err <= GRAD_RTOL * r.abs().max().item() \
            + GRAD_FLOOR * scale[k.split(".")[0]], (k, err)


# --- the mesh -----------------------------------------------------------------

def test_make_mesh_shape_and_model_axis(group):
    for r, rank in enumerate(group["ranks"]):
        assert rank["shape"] == {"data": group["n"], "model": 1}
        assert rank["model_axis_raises"]


def test_batch_sharding_takes_contiguous_rows():
    sh = mesh_lib.BatchSharding(index=1, count=4)
    x = np.arange(8)
    assert sh.take(x).tolist() == [2, 3]
    assert mesh_lib.Replicated().take(x) is x
    assert mesh_lib.replicated().take(x) is x
    with pytest.raises(ValueError):
        sh.take(np.arange(6))


def test_pmean_grads_over_one_rank_returns_the_tree():
    mesh = mesh_lib.make_mesh(devices="cpu")
    try:
        tree = {"a": torch.ones(3), "b": [torch.zeros(2, 2)]}
        assert collectives.pmean_grads(tree, mesh) is tree
    finally:
        torch.distributed.destroy_process_group()


def test_multihost_init_without_an_address_is_false(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_lib.multihost_init() is False
    assert not torch.distributed.is_initialized()


def test_chip_smoke_ranks_agree_only_bit_for_bit():
    """``chip_smoke.py``'s comparison of its two card ranks, rehearsed on
    CPU results: equal results agree; one gradient one ulp off, a mel, a
    frame count or a loss changed do not."""
    cs = load_chip_smoke()
    g = torch.randn(3, 2, generator=torch.Generator().manual_seed(0))

    def result():
        return {"order": [1, 0], "requeued": 0,
                "serve": {0: (5, np.ones((5, 2), np.float32)),
                          1: (4, np.zeros((4, 2), np.float32))},
                "train": {"losses": {"mel": 0.5}, "grads": {"w": g.clone()},
                          "indices": torch.arange(4),
                          "durations": torch.ones(2, 3)}}
    a = result()
    assert cs.ranks_agree(a, result())
    b = result()
    b["train"]["grads"]["w"][0, 0] = torch.nextafter(g[0, 0],
                                                     torch.tensor(1e9))
    assert not cs.ranks_agree(a, b)
    b = result()
    b["serve"][0][1][0, 0] = 2.0
    assert not cs.ranks_agree(a, b)
    b = result()
    b["serve"][1] = (3, b["serve"][1][1])
    assert not cs.ranks_agree(a, b)
    b = result()
    b["train"]["losses"]["mel"] = 0.25
    assert not cs.ranks_agree(a, b)


# --- collectives against JAX ---------------------------------------------------

def test_length_histogram_matches_jax(reference):
    lengths = W.LENGTHS
    for b in (W.BOUNDARIES, (256, 512)):
        got = collectives.length_histogram(torch.from_numpy(lengths), b)
        ref = np.asarray(j_coll.length_histogram(jnp.asarray(lengths), b))
        assert got.tolist() == ref.tolist()
        assert got.tolist() == j_bucketing.bucket_histogram(lengths,
                                                            b).tolist()
    assert reference["local_hist"].tolist() == np.asarray(
        j_coll.length_histogram(jnp.asarray(lengths), W.BOUNDARIES)).tolist()


def test_gather_length_histograms_match_jax(group):
    n = group["n"]
    lengths = jnp.asarray(W.LENGTHS, jnp.int32)
    jm = j_mesh.make_mesh(data=n, model=1, devices=jax.devices()[:n])
    ref = np.asarray(j_coll.gather_length_histograms(
        jm, jax.device_put(lengths, j_mesh.batch_sharding(jm)), W.BOUNDARIES))
    # JAX's 8-device virtual mesh: the same global counts
    jm8 = j_mesh.make_mesh(data=8, model=1)
    ref8 = np.asarray(j_coll.gather_length_histograms(
        jm8, jax.device_put(lengths, j_mesh.batch_sharding(jm8)),
        W.BOUNDARIES))
    for rank in group["ranks"]:
        got = rank["hists"].numpy()
        assert got.shape == (n, len(W.BOUNDARIES))
        assert got.tolist() == ref.tolist()
        assert got.sum(0).tolist() == ref8.sum(0).tolist()


def test_gather_style_codes_equal_the_table(group):
    codes = np.random.default_rng(0).standard_normal((16, 4, 6)) \
        .astype(np.float32)
    n = group["n"]
    jm = j_mesh.make_mesh(data=n, model=1, devices=jax.devices()[:n])
    ref = np.asarray(j_coll.gather_style_codes(
        jm, jax.device_put(jnp.asarray(codes), j_mesh.batch_sharding(jm))))
    for rank in group["ranks"]:
        np.testing.assert_array_equal(rank["codes"].numpy(), codes)
        np.testing.assert_array_equal(rank["codes"].numpy(), ref)
        np.testing.assert_array_equal(rank["summaries"].numpy(),
                                      codes[:8, 0])


def test_two_host_exchange_gives_jax_plan(group):
    """``tests/test_multiprocess.py``'s two hosts: the summed histogram and
    the plan JAX derives from it, on every rank; the style tables joined in
    host order."""
    lengths = np.concatenate([np.asarray(x) for x in W.HOST_LENGTHS])
    hist = j_bucketing.bucket_histogram(lengths, W.PLAN_BUCKETS)
    plan = sorted(j_bucketing.plan_buckets(
        hist, batch_size=2, buckets=W.PLAN_BUCKETS)
        .batches_per_bucket.items())
    for rank in group["ranks"]:
        assert rank["host_hist"] == [2, 1, 2] == hist.tolist()
        assert rank["host_plan"] == plan
        np.testing.assert_array_equal(rank["host_styles"], np.asarray(
            [[0, 0, 0], [1, 1, 1], [1, 1, 1]], np.float32))


def test_host_exchanges_are_identities_on_one_process():
    a = np.arange(6.0).reshape(3, 2)
    assert collectives.process_concat_styles(a) is not None
    np.testing.assert_array_equal(collectives.process_concat_styles(a), a)
    np.testing.assert_array_equal(
        collectives.process_sum_histogram(np.asarray([1, 2])), [1, 2])


# --- serving and synthesis ----------------------------------------------------

def test_server_with_mesh_equals_one_process(group, reference):
    """Per uid: the same frames and mel as one process (as JAX's
    ``tests/test_serve_config.py:64-85`` serves on a data mesh), the same
    order, style table and plan, on every rank."""
    for rank in group["ranks"]:
        assert rank["serve_order"] == reference["serve_order"]
        assert rank["serve_plan"] == reference["serve_plan"]
        np.testing.assert_array_equal(rank["serve_table"],
                                      reference["serve_table"])
        for uid, (frames, mel) in reference["serve"].items():
            assert rank["serve"][uid][0] == frames
            np.testing.assert_allclose(rank["serve"][uid][1], mel,
                                       atol=SYNTH_TOL, rtol=SYNTH_TOL)


def test_server_ranks_agree_on_a_failure_of_one_rank(group, reference):
    """The last rank's run of the first batch raises, the others' not.  A
    ``RuntimeError``: every rank requeues that batch (the first of the
    one-process dispatch order) and serves the rest as one process does.
    A ``ValueError``: it propagates on that rank and every other rank
    raises ``DataRankError``; no rank gathers another batch's rows, and
    none hangs (the group's timeout)."""
    ref_order = reference["serve_order"]
    n = group["n"]
    for r, rank in enumerate(group["ranks"]):
        got = rank["serve_planted"]["RuntimeError"]
        k = len(got["requeued"])
        assert 0 < k <= W.GLOBAL_BATCH
        assert got["requeued"] == ref_order[:k]
        assert got["order"] == ref_order[k:]
        for uid in got["order"]:
            frames, mel = reference["serve"][uid]
            assert got["serve"][uid][0] == frames
            np.testing.assert_allclose(got["serve"][uid][1], mel,
                                       atol=SYNTH_TOL, rtol=SYNTH_TOL)
        assert rank["serve_planted"]["ValueError"] == {
            "raised": "ValueError" if r == n - 1 else "DataRankError"}


def test_synthesis_on_a_data_mesh_equals_one_process(group, reference):
    for rank in group["ranks"]:
        for k in ("mel", "wav"):
            np.testing.assert_allclose(
                rank["synth"][k].numpy(), reference["synth"][k].numpy(),
                atol=SYNTH_TOL, rtol=SYNTH_TOL, err_msg=k)


# --- the three trainers -------------------------------------------------------

@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_dp_losses_equal_the_global_batch(group, reference, stage):
    ref = reference[stage]
    for rank in group["ranks"]:
        aux = {k: v for k, v in rank[stage]["aux"].items() if v.ndim == 0}
        _close_scalars(aux, {k: v for k, v in ref["aux"].items()
                             if v.ndim == 0})
        _close_scalars(rank[stage]["metrics"], ref["metrics"])
        for k, v in ref["aux"].items():
            if v.ndim:                       # stage 3's durations
                assert torch.equal(rank[stage]["aux"][k], v), k


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_dp_gradients_equal_the_global_batch(group, reference, stage):
    for rank in group["ranks"]:
        _close_grads(rank[stage]["grads"], reference[stage]["grads"])


@pytest.mark.parametrize("stage,key", [("stage1", "g_params"),
                                       ("stage2", "params"),
                                       ("stage2", "ema"),
                                       ("stage3", "params")])
def test_dp_steps_keep_the_ranks_equal_to_one_process(group, reference,
                                                      stage, key):
    """Two steps: the weights on every rank equal one another and follow
    the one-process trajectory."""
    first = dict(_flat(group["ranks"][0][stage][key]))
    for rank in group["ranks"][1:]:
        for k, v in _flat(rank[stage][key]):
            assert torch.equal(v, first[k]), k
    for k, r in _flat(reference[stage][key]):
        np.testing.assert_allclose(first[k].numpy(), r.numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=k)


def test_stage2_own_draws_are_the_global_draw(group, reference):
    """Without draws handed in, each rank cuts its rows of the global draw
    of the same generator: the step is the one-process step."""
    for rank in group["ranks"]:
        _close_scalars(rank["stage2"]["metrics_drawn"],
                       reference["stage2"]["metrics_drawn"])

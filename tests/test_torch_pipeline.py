"""The port's three-stage pipeline (``pipelines/pipeline.py``) against
``scripts/train_pipeline.py`` on the CPU, at ``tiny_test_config()``.

JAX's trained weights cannot be reproduced (its PRNG cannot be), so the
JAX script runs with 0 steps a stage on one ``random_tree`` (its
``init_params`` replaced), and the port on the same tree converted: every
gate then scores the same trees.  The report's keys and nesting equal the
script's; the deterministic gates (``stage1``, ``stage1_gt_margin``,
``fsq_usage``) and, with JAX's own draws handed in through
``gate_noise``, the stochastic ones (``stage2``, ``stage3``, ``final``)
equal JAX's within 1e-4 absolute plus 1e-4 relative plus the value's
rounding (10^-k for k decimals); counts and rates equal.  The wiring is
held on the port's own runs of 2-3 steps: which tree goes to which stage,
gate and bundle, the schedule and the stage-3 pool as the script derives
them, ``--stop-after``, ``--skip-stage1/2`` and ``--resume-stage1/2``.
One thread; the JAX script runs in a process of its own
(``tests/_jax_pipeline_run.py``), started with the file's first test, and
the cases that compare with it come last.
"""
import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_tiny, random_tree, run_module, torch_tiny
from styletts_zs_torch.config import replace
from styletts_zs_torch.pipelines import pipeline as P
from styletts_zs_torch.pipelines import train as PT
from styletts_zs_torch.pipelines.checkpoint import load_params
from styletts_zs_torch.pipelines.convert import convert_params

REPO = Path(__file__).resolve().parent.parent
ATOL = RTOL = 1e-4
JAX_TIMEOUT = 600      # seconds the JAX script's process may take
EXACT = {"dur_mae_frames", "dur_exact_match", "style_latent_mse_seeds",
         "retrieval_acc", "retrieval_chance", "synthesis_shape"}
# decimals JAX rounds each key to (default 5; the margins 4, the proxy 3)
DECIMALS = {"style_mse_ratio_pairs_over_gt": 3,
            "style_mse_ratio_pairs_over_gt_g1": 3, "fsq_code_match_rate": 4}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    jcfg = jax_tiny()
    tree = random_tree(jcfg, with_discriminator=True)
    return {"jcfg": jcfg, "tree": tree,
            "pp": convert_params(tree, torch_tiny())}


@pytest.fixture(scope="module", autouse=True)
def jax_child(tmp_path_factory):
    """The JAX script at 0 steps a stage on the random tree
    (``tests/_jax_pipeline_run.py``), started in a process of its own
    before the first test of this file, so that it runs beside the port's
    own runs; killed at the end of the file if it is still running."""
    work = tmp_path_factory.mktemp("jax_pipeline")
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               JAX_DEFAULT_MATMUL_PRECISION="highest")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_jax_pipeline_run.py"),
         str(work)], cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    yield {"proc": proc, "work": work}
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_run(jax_child):
    """The JAX script's report, and the schedule of the configs its three
    trainers were made with."""
    proc, work = jax_child["proc"], jax_child["work"]
    _, err = proc.communicate(timeout=JAX_TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    with open(work / "quality_report.json") as f:
        report = json.load(f)
    with open(work / "trainers.json") as f:
        made = {k: SimpleNamespace(**v) for k, v in json.load(f).items()}
    return {"report": report, "trainers": made}


def jax_draws(jcfg):
    """``gate_noise`` with the draws the JAX script's gates take at 0
    steps: its key ``PRNGKey(seed)`` split for the stage-2 gate (4 seeds,
    1 raw, 4 at guidance 1) and then the stage-3 gate, and the syntheses'
    ``PRNGKey(0)``."""
    s, B = jcfg.model.style, jcfg.train.batch_size

    def normal(key, b=B):
        return torch.from_numpy(np.array(jax.random.normal(
            key, (b, s.n_codes, s.d_style), jnp.float32)))

    rng = jax.random.PRNGKey(jcfg.train.seed)
    rng, g_sub, r_sub, d_sub = jax.random.split(rng, 4)
    rng, sub = jax.random.split(rng)
    draws = {"stage2": [normal(k) for k in jax.random.split(g_sub, 4)],
             "stage2_raw": [normal(k) for k in jax.random.split(r_sub, 1)],
             "stage2_g1": [normal(k) for k in jax.random.split(d_sub, 4)],
             "stage3": normal(sub),
             "final": normal(jax.random.PRNGKey(0), 2),
             "final_held_out": normal(jax.random.PRNGKey(0))}
    asked = []

    def gate_noise(label, step):
        asked.append((label, step))
        return draws[label]
    gate_noise.asked = asked
    return gate_noise


def _params_as(world, monkeypatch):
    """The port's ``init_params`` gives the converted random tree."""
    monkeypatch.setattr(P, "init_params",
                        lambda *a, **k: copy.deepcopy(world["pp"]))


@pytest.fixture(scope="module")
def port_run(world, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    work = tmp_path_factory.mktemp("port_pipeline")
    made = {}

    def spy(name, cls):
        class Spy(cls):
            def __init__(self, cfg, *a, **k):
                made[name] = cfg.train
                super().__init__(cfg, *a, **k)
        mp.setattr(PT, name, Spy)

    for name in ("Stage1Trainer", "Stage2Trainer", "Stage3Trainer"):
        spy(name, getattr(PT, name))
    _params_as(world, mp)
    noise = jax_draws(world["jcfg"])
    try:
        report = P.run_pipeline(steps1=0, steps2=0, steps3=0, tiny=True,
                                workdir=str(work), device="cpu",
                                gate_noise=noise)
    finally:
        mp.undo()
    with open(work / "quality_report.json") as f:
        assert json.load(f) == report
    return {"report": report, "trainers": made, "asked": noise.asked,
            "work": work}


def _structure(x):
    if isinstance(x, dict):
        return {k: _structure(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_structure(v) for v in x]
    return type(x).__name__ if not isinstance(x, (int, float)) or \
        isinstance(x, bool) else "number"


def _close(got, ref, key="", decimals=5):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), key
        for k in ref:
            _close(got[k], ref[k], k, DECIMALS.get(k, decimals))
    elif isinstance(ref, list):
        assert len(got) == len(ref), key
        for g, r in zip(got, ref):
            _close(g, r, key, decimals)
    elif key in EXACT or not isinstance(ref, float):
        assert got == ref, (key, got, ref)
    else:
        assert abs(got - ref) <= ATOL + RTOL * abs(ref) + 10.0 ** -decimals, \
            (key, got, ref)


def test_gate_draws_are_asked_in_jax_order(port_run):
    assert port_run["asked"] == [("stage2", 0), ("stage2_raw", 0),
                                 ("stage2_g1", 0), ("stage3", 0),
                                 ("final", 0), ("final_held_out", 0)]


@pytest.mark.parametrize("n", [0, 1, 9, 10, 55, 100000])
def test_stage_cfg_clamps_the_warmup(n):
    cfg = P.stage_cfg(torch_tiny(), n)
    assert cfg.train.n_steps == n
    assert cfg.train.warmup_steps == min(torch_tiny().train.warmup_steps,
                                         max(n // 10, 1))


# --- the port's own runs: the handoffs and the flags ------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """3 / 2 / 3 steps with a gate every step and a stage-3 pool of 2
    batches (``distill_samples`` 4 at batch 2): what each trainer was
    given, the batches each step took and the trees written."""
    mp = pytest.MonkeyPatch()
    work = tmp_path_factory.mktemp("trained")
    seen = {"batches": [], "steps3": [], "init3": None}
    small = replace(torch_tiny(), train=replace(torch_tiny().train,
                                                distill_samples=4))
    mp.setattr(P, "tiny_test_config", lambda: small)

    class Producer(P._Producer):
        def get(self):
            b = super().get()
            seen["batches"].append(b)
            return b
    mp.setattr(P, "_Producer", Producer)

    class S2(PT.Stage2Trainer):
        def __init__(self, cfg, params, **k):
            seen["frozen2"] = copy.deepcopy(params["acoustic"])
            super().__init__(cfg, params, **k)

    class S3(PT.Stage3Trainer):
        def __init__(self, cfg, params, **k):
            seen["frozen3"] = copy.deepcopy(params)
            super().__init__(cfg, params, **k)

        def init_state(self, teacher):
            st = super().init_state(teacher)
            seen["init3"] = (copy.deepcopy(teacher), copy.deepcopy(st.params))
            return st

        def train_step(self, state, batch, **draws):
            seen["steps3"].append(batch["phonemes"].clone())
            st, m = super().train_step(state, batch, **draws)
            seen["student"] = copy.deepcopy(st.params)
            return st, m
    mp.setattr(PT, "Stage2Trainer", S2)
    mp.setattr(PT, "Stage3Trainer", S3)
    try:
        report = P.run_pipeline(steps1=3, steps2=2, steps3=3, tiny=True,
                                gate_every=1, workdir=str(work),
                                device="cpu")
    finally:
        mp.undo()
    return {"report": report, "seen": seen, "work": work}


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        assert torch.equal(a, b)


def test_stage2_freezes_the_stage1_ema(trained):
    stage1 = load_params(str(trained["work"] / "stage1"))
    _equal(trained["seen"]["frozen2"], stage1["acoustic"])
    # the EMA tree, not the masters it follows
    state = load_params(str(trained["work"] / "stage1_state"))
    _equal(state["ema_params"]["acoustic"], stage1["acoustic"])
    raw = state["g_params"]["acoustic"]
    assert any(not torch.equal(v, stage1["acoustic"][k])
               for k, v in raw.items())


def test_teacher_is_the_stage2_ema_and_the_student_starts_as_it(trained):
    seen, work = trained["seen"], trained["work"]
    teacher = load_params(str(work / "stage2"))
    state2 = load_params(str(work / "stage2_state"))
    _equal(teacher, state2["ema"])
    _equal(seen["frozen3"]["diffusion"], teacher)
    _equal(seen["frozen3"]["acoustic"],
           load_params(str(work / "stage1"))["acoustic"])
    given, student0 = seen["init3"]
    _equal(given, teacher)
    _equal(student0, teacher)


def test_bundle_is_stage1_acoustic_vocoder_and_the_student(trained):
    work = trained["work"]
    final = load_params(str(work / "final"))
    stage1 = load_params(str(work / "stage1"))
    assert set(final) == {"acoustic", "vocoder", "diffusion"}
    _equal(final["acoustic"], stage1["acoustic"])
    _equal(final["vocoder"], stage1["vocoder"])
    _equal(final["diffusion"], {k: v.cpu() for k, v in
                                trained["seen"]["student"].items()})


def test_stage3_pool_is_drawn_once_and_reused(trained):
    """``max(1, min(steps3, distill_samples // batch))`` = 2 batches,
    drawn after stage 2's, taken in turn; then one for the synthesis."""
    seen = trained["seen"]
    b = seen["batches"]
    assert len(b) == 3 + 2 + 2 + 1
    pool = [torch.as_tensor(x.phonemes) for x in b[5:7]]
    assert [torch.equal(s, pool[i % 2]) for i, s in
            enumerate(seen["steps3"])] == [True, True, True]


def test_curves_hold_every_gate(trained):
    r = trained["report"]
    assert [c["step"] for c in r["stage1_curve"]] == [1, 2, 3]
    assert [c["step"] for c in r["stage2_curve"]] == [1, 2]
    assert [c["step"] for c in r["stage3_curve"]] == [1, 2, 3]
    assert r["steps"] == [3, 2, 3] and r["config"] == "tiny"


def test_skip_stages_load_the_saved_trees(trained, tmp_path, monkeypatch):
    work = tmp_path / "w"
    shutil.copytree(trained["work"], work)
    seen = {}

    class S3(PT.Stage3Trainer):
        def __init__(self, cfg, params, **k):
            seen.update(copy.deepcopy(params))
            super().__init__(cfg, params, **k)
    monkeypatch.setattr(PT, "Stage3Trainer", S3)
    report = P.run_pipeline(steps1=3, steps2=2, steps3=1, tiny=True,
                            workdir=str(work),
                            skip_stage1=str(work / "stage1"),
                            skip_stage2=str(work / "stage2"), device="cpu")
    _equal(seen["acoustic"], load_params(str(work / "stage1"))["acoustic"])
    _equal(seen["diffusion"], load_params(str(work / "stage2")))
    # the prior report is extended: one more stage-1 boundary gate
    assert [c["step"] for c in report["stage1_curve"]] == [1, 2, 3, 3]
    assert report["stage1"] == trained["report"]["stage1"]


@pytest.mark.parametrize("stage", [1, 2])
def test_resume_restores_the_state_and_stop_after(trained, tmp_path,
                                                  monkeypatch, stage):
    """A fresh workdir, the saved state of stage ``stage``: the first step
    of the resumed run starts from that state bit for bit (its step
    included), and ``--stop-after`` ends the run at that stage's gate."""
    src = trained["work"]
    saved = load_params(str(src / f"stage{stage}_state"))
    cls = PT.Stage1Trainer if stage == 1 else PT.Stage2Trainer
    first = []

    class Spy(cls):
        def train_step(self, state, batch, **k):
            if not first:
                first.append(PT.state_tree(state))
            return super().train_step(state, batch, **k)
    monkeypatch.setattr(PT, cls.__name__, Spy)
    kw = {"resume_stage1": str(src / "stage1_state")} if stage == 1 else {
        "skip_stage1": str(src / "stage1"),
        "resume_stage2": str(src / "stage2_state")}
    report = P.run_pipeline(steps1=4, steps2=3, steps3=1, tiny=True,
                            workdir=str(tmp_path), stop_after=stage,
                            device="cpu", **kw)
    assert int(first[0]["step"]) == int(saved["step"]) == (3 if stage == 1
                                                           else 2)
    _equal({k: v for k, v in first[0].items()}, saved)
    assert f"stage{stage}_wall_s" in report
    assert f"stage{stage + 1}" not in report and "final" not in report
    assert not (tmp_path / f"stage{stage + 1}").exists()
    assert not (tmp_path / "final").exists()


def test_command_line_runs_and_writes_a_loadable_bundle(tmp_path):
    r = run_module("styletts_zs_torch.pipelines.pipeline", [
        "--tiny", "--device", "cpu", "--steps1", "1", "--steps2", "1",
        "--steps3", "1", "--workdir", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp_path / "quality_report.json") as f:
        rep = json.load(f)
    assert "final" in rep and rep["steps"] == [1, 1, 1]
    bundle = load_params(str(tmp_path / "final"))
    assert set(bundle) == {"acoustic", "vocoder", "diffusion"}
    assert '"quality_gate": "stage3"' in r.stdout


def test_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        P.run_pipeline(steps1=0, steps2=0, steps3=0)


# --- against the JAX script (last: its process runs beside the tests above) --

def test_report_keys_and_nesting_equal_jax(port_run, jax_run):
    assert list(port_run["report"]) == list(jax_run["report"])
    assert _structure(port_run["report"]) == _structure(jax_run["report"])


@pytest.mark.parametrize("key", ["stage1", "stage1_curve",
                                 "stage1_gt_margin", "fsq_usage"])
def test_deterministic_gates_equal_jax(port_run, jax_run, key):
    got, ref = port_run["report"][key], jax_run["report"][key]
    if key == "fsq_usage":
        assert got == ref
    else:
        _close(got, ref, decimals=4 if key == "stage1_gt_margin" else 5)


@pytest.mark.parametrize("key", ["stage2", "stage2_curve", "stage3",
                                 "stage3_curve", "final"])
def test_stochastic_gates_equal_jax_on_its_draws(port_run, jax_run, key):
    got, ref = port_run["report"][key], jax_run["report"][key]
    if key == "final":
        _close(got["speaker_sim_proxy"], ref["speaker_sim_proxy"],
               decimals=3)
        got = {k: v for k, v in got.items() if k != "speaker_sim_proxy"}
        ref = {k: v for k, v in ref.items() if k != "speaker_sim_proxy"}
        _close(got, ref, decimals=4)
    else:
        _close(got, ref)


@pytest.mark.parametrize("stage", ["Stage1Trainer", "Stage2Trainer",
                                   "Stage3Trainer"])
def test_stage_schedule_equals_jax(port_run, jax_run, stage):
    """``stage_cfg`` at 0 steps, as the script made each trainer's."""
    got, ref = port_run["trainers"][stage], jax_run["trainers"][stage]
    assert (got.n_steps, got.warmup_steps, got.lr) == \
        (ref.n_steps, ref.warmup_steps, ref.lr)

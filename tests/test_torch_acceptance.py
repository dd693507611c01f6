"""The port's acceptance levels 1-5 (``pipelines/acceptance.py``) on the
CPU at the tiny shapes, against the JAX package's ``run_acceptance``.

Level 5 serves the same requests on both sides: the plan, the batches
served and the style table's shape must be equal.  For levels 2-4 JAX's
``_synth_report`` runs with its measurement and its weights stubbed out, so
that its own code gives the report's keys and the shapes it asks for
(batch, frames, steps, vocoder) without compiling; the port's levels run
for real.  Level 5 also serves a tiny trained tree written by the port's
``save_params`` (``--bundle``).
"""
import numpy as np
import pytest
import torch

from _torch_parity import (jax_synth_report, jax_tiny, load_chip_smoke,
                           random_tree, torch_tiny)
from styletts_zs_tpu.pipelines import acceptance as j_acc
from styletts_zs_torch.pipelines import acceptance as acc
from styletts_zs_torch.pipelines import serve
from styletts_zs_torch.pipelines.checkpoint import save_params
from styletts_zs_torch.pipelines.convert import convert_params

CS = load_chip_smoke()
SERVE_KEYS = ("n_requests", "completed", "requeued", "plan_batches",
              "served_batches", "style_table_shape")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("level", [2, 3, 4])
def test_synthesis_levels_match_jax_shapes_and_keys(level, monkeypatch):
    ref, made = jax_synth_report(level, monkeypatch)
    real, port_made = acc.make_synthesis_fn, {}

    def recording(cfg, params, **kw):
        port_made.update(kw)
        return real(cfg, params, **kw)

    monkeypatch.setattr(acc, "make_synthesis_fn", recording)
    rep = acc.run_acceptance(level, device="cpu")
    assert port_made.pop("device") == torch.device("cpu")
    assert port_made == {k: v for k, v in made.items() if k != "n_mels"}
    assert set(rep) == set(ref) | {"device"} == CS.ACCEPT_KEYS[level]
    CS.check_accept_report(level, rep)
    for k in ("config", "batch", "n_frames", "one_step", "with_vocoder"):
        assert rep[k] == ref[k], k
    assert rep["device"] == "cpu"
    assert rep["mel_finite"] and rep.get("wav_finite", True)
    assert np.isfinite([rep["wall_s_per_call"], rep["audio_s_per_s"],
                        *rep["wall_s_per_call_spread"]]).all()
    lo, hi = rep["wall_s_per_call_spread"]
    assert 0 < lo <= rep["wall_s_per_call"] <= hi


def test_level_1_gate():
    rep = acc.run_acceptance(1, device="cpu")
    assert rep["config"] == "cpu_ref" and rep["n_frames"] == 64
    assert rep["pass_fp32"] and rep["pass_bf16"]
    assert rep["device"] == "cpu"
    CS.check_accept_report(1, rep)


def test_level_5_matches_jax():
    ref = j_acc.run_acceptance(5, full_size=False)
    rep = acc.run_acceptance(5, device="cpu")
    for k in SERVE_KEYS:
        assert rep[k] == ref[k], (k, rep[k], ref[k])
    assert rep["completed"] == rep["n_requests"] == 8
    assert rep["plan_matches_served"] is True
    assert set(rep) == set(ref) | {"device"} == CS.ACCEPT_KEYS[5]
    CS.check_accept_report(5, rep)


def test_level_5_serves_a_bundle(tmp_path, monkeypatch):
    tree = convert_params(random_tree(jax_tiny(), seed=7), torch_tiny())
    path = tmp_path / "bundle.pt"
    save_params(str(path), tree)
    served = []

    class Recording(serve.Server):
        def __init__(self, cfg, params, **kw):
            super().__init__(cfg, params, **kw)
            served.append(self)

    monkeypatch.setattr(acc, "Server", Recording)
    rep = acc.run_acceptance(5, bundle=str(path), device="cpu")
    assert rep["bundle"] == str(path)
    assert rep["completed"] == rep["n_requests"] and rep["requeued"] == 0
    (server,) = served
    for part, key in (("acoustic", "duration_predictor.out.bias"),
                      ("vocoder", "istft_head.kernel"),
                      ("diffusion", "null_prompt_summary")):
        got = dict(getattr(server.models, part).state_dict())[key]
        torch.testing.assert_close(got.float(), tree[part][key], rtol=0,
                                   atol=0)


def test_unknown_level_raises():
    with pytest.raises(ValueError):
        acc.run_acceptance(6, device="cpu")


def test_chip_smoke_report_checks_fail_on_a_bad_report():
    """The card's checks of a level's report catch a failed level."""
    good = {k: 1.0 for k in CS.ACCEPT_KEYS[2]}
    good.update(mel_finite=True, wall_s_per_call_spread=[1.0, 1.0])
    CS.check_accept_report(2, good)
    for bad in ({"mel_finite": False}, {"audio_s_per_s": float("nan")},
                {"wall_s_per_call_spread": [1.0, float("inf")]}):
        with pytest.raises(AssertionError):
            CS.check_accept_report(2, {**good, **bad})
    with pytest.raises(AssertionError):
        CS.check_accept_report(4, good)          # wav_finite missing

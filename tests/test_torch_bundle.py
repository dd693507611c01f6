"""Weights carried across: the trained bundle ``checkpoints/r5/final``
(orbax, ``{acoustic, vocoder, diffusion}``) through
``scripts/convert_jax_params.py``, and the port on it against JAX.

Both sides run the 1-step path with the vocoder in fp32 (JAX with the XLA
twins), at full width: batch 1, 64 phonemes, 256 frames, JAX's own initial
noise handed to the port.  Durations must be equal, the mel and the
waveform within 1e-4 (fp32 sums in another order through the whole
model).  The converter also round-trips a tiny tree.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_tiny, n, random_tree, t, torch_tiny,
                           write_tiny_config)
from styletts_zs_tpu.pipelines.checkpoint import save_params as j_save_params
from styletts_zs_tpu.pipelines.infer import make_synthesis_fn as j_synth
from styletts_zs_tpu.utils import config as jc
from styletts_zs_torch import config as tc
from styletts_zs_torch.pipelines.checkpoint import load_params
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.infer import make_synthesis_fn

REPO = Path(__file__).resolve().parent.parent
BUNDLE = REPO / "checkpoints" / "r5" / "final"
ATOL = 1e-4
TEXT_LEN, N_FRAMES = 64, 256


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_params", REPO / "scripts" / "convert_jax_params.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_trained_bundle_matches_jax():
    if not BUNDLE.is_dir():
        pytest.skip(f"{BUNDLE} is not in this checkout")
    tree = _converter().load_jax_bundle(str(BUNDLE))
    model = dict(max_text_len=TEXT_LEN, max_frames=N_FRAMES)
    jcfg = jc.Config(model=jc.ModelConfig(**model),
                     runtime=jc.RuntimeConfig(compute_dtype="float32",
                                              use_pallas=False))
    tcfg = tc.Config(model=tc.ModelConfig(**model),
                     runtime=tc.RuntimeConfig(compute_dtype="float32"))
    m = jcfg.model
    rs = np.random.default_rng(0)
    ref_frames = 3 * m.audio.sample_rate // m.audio.hop_length
    inputs = (rs.integers(1, 40, (1, TEXT_LEN)).astype(np.int32),
              np.array([TEXT_LEN], np.int32),
              (0.5 * rs.standard_normal((1, ref_frames, m.audio.n_mels)))
              .astype(np.float32),
              np.array([ref_frames], np.int32))
    rng = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(rng, (1, m.style.n_codes,
                                               m.style.d_style)))
    ref_out, ref_wav = jax.jit(j_synth(jcfg, one_step=True,
                                       with_vocoder=True))(
        jax.tree.map(jnp.asarray, tree), *map(jnp.asarray, inputs), rng)

    params = convert_params(tree, tcfg)
    del tree
    out, wav = make_synthesis_fn(tcfg, params, one_step=True,
                                 with_vocoder=True, device="cpu")(
        *map(t, inputs), t(noise))
    np.testing.assert_array_equal(out.durations.numpy(),
                                  np.asarray(ref_out.durations))
    assert int(out.frame_lengths[0]) > N_FRAMES // 2   # a real utterance
    np.testing.assert_allclose(n(out.mel), n(ref_out.mel), atol=ATOL, rtol=0)
    assert wav.shape == ref_wav.shape
    np.testing.assert_allclose(n(wav), n(ref_wav), atol=ATOL, rtol=0)


def test_converter_round_trips_a_tiny_tree(tmp_path):
    tree = random_tree(jax_tiny(), seed=5)
    j_save_params(str(tmp_path / "jax_tree"), tree)
    conv = _converter()
    back = conv.load_jax_bundle(str(tmp_path / "jax_tree"), jax_tiny())
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    config = write_tiny_config(tmp_path)
    conv.main([str(tmp_path / "jax_tree"), str(tmp_path / "port.pt"),
               "--config", str(config)])
    want = convert_params(tree, torch_tiny())
    got = load_params(str(tmp_path / "port.pt"))
    assert got.keys() == want.keys()
    for part in want:
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)

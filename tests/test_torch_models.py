"""Each model module of the port against its Flax module, on the CPU.

The weights are one tiny parameter tree made with numpy from a seed
(``_torch_parity.random_tree``), applied to the Flax modules as it is and
to the port through ``convert_params``.  fp32; the tolerance allows for
sums taken in another order through a few layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_tiny, n, random_tree, t, to_jax, torch_tiny
from styletts_zs_tpu.models import layers as j_layers
from styletts_zs_tpu.models.decoder import MelDecoder
from styletts_zs_tpu.models.diffusion import StyleDiffusion
from styletts_zs_tpu.models.predictors import (DurationPredictor,
                                               ProsodyPredictor)
from styletts_zs_tpu.models.style import (PromptEncoder, StyleExtractor,
                                          StyleQuantizer)
from styletts_zs_tpu.models.text_encoder import ProsodyTextEncoder, TextEncoder
from styletts_zs_tpu.models.vocoder import Vocoder
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.factory import build_models

ATOL = RTOL = 1e-4
B, TT, TF = 2, 16, 128     # batch, phonemes, frames (the tiny max_frames)


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    jcfg, tcfg = jax_tiny(), torch_tiny()
    tree = random_tree(jcfg)
    port = build_models(tcfg, convert_params(tree, tcfg), device="cpu")
    rs = np.random.default_rng(1)
    m = jcfg.model
    data = {
        "ids": rs.integers(1, 40, (B, TT)).astype(np.int32),
        "text_mask": np.arange(TT)[None] < np.array([TT, 11])[:, None],
        "frame_mask": np.arange(TF)[None] < np.array([TF, 20])[:, None],
        "ref_mask": np.arange(40)[None] < np.array([40, 27])[:, None],
        "mel": rs.standard_normal((B, 40, m.audio.n_mels)).astype(np.float32),
        "x_text": rs.standard_normal((B, TT, 64)).astype(np.float32),
        "x_frames": rs.standard_normal((B, TF, 64)).astype(np.float32),
        "style_frames": rs.standard_normal((B, TF, 32)).astype(np.float32),
        "style": rs.standard_normal((B, m.style.n_codes, 32)).astype(np.float32),
        "curves": rs.standard_normal((2, B, TF)).astype(np.float32),
        "dec_mel": rs.standard_normal((B, 24, m.audio.n_mels)).astype(np.float32),
    }
    return jcfg.model, to_jax(tree), port, data


def ap(module, params, *args, **kw):
    return module.apply({"params": params}, *args, **kw)


def close(ref, out):
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=RTOL)


def J(x):
    return jnp.asarray(x)


def test_text_encoder(world):
    m, p, port, d = world
    ref = ap(TextEncoder(m.text_encoder), p["acoustic"]["params"]["text_encoder"],
             J(d["ids"]), mask=J(d["text_mask"]))
    close(ref, port.acoustic.text_encoder(t(d["ids"]), mask=t(d["text_mask"])))


def test_prosody_encoder(world):
    m, p, port, d = world
    ref = ap(ProsodyTextEncoder(m.prosody_encoder, vocab_size=m.text_encoder.vocab_size),
             p["acoustic"]["params"]["prosody_encoder"], J(d["ids"]),
             J(d["x_text"]), mask=J(d["text_mask"]))
    close(ref, port.acoustic.prosody_encoder(t(d["ids"]), t(d["x_text"]),
                                             mask=t(d["text_mask"])))


def test_prompt_encoder(world):
    m, p, port, d = world
    tok, summ = ap(PromptEncoder(m.prompt_encoder, n_mels=m.audio.n_mels),
                   p["acoustic"]["params"]["prompt_encoder"], J(d["mel"]),
                   mask=J(d["ref_mask"]))
    ttok, tsumm = port.acoustic.prompt_encoder(t(d["mel"]), mask=t(d["ref_mask"]))
    close(tok, ttok)
    close(summ, tsumm)


def test_style_extractor(world):
    m, p, port, d = world
    ref = ap(StyleExtractor(m.style, n_mels=m.audio.n_mels),
             p["acoustic"]["params"]["style_extractor"], J(d["mel"]),
             mask=J(d["ref_mask"]))
    close(ref, port.acoustic.style_extractor(t(d["mel"]), mask=t(d["ref_mask"])))


def test_quantizer_project_style_and_decode(world):
    m, p, port, d = world
    q = StyleQuantizer(m.style)
    qp = p["acoustic"]["params"]["quantizer"]
    close(ap(q, qp, J(d["style"]), method=StyleQuantizer.project_style),
          port.acoustic.quantizer.project_style(t(d["style"])))
    idx = np.random.default_rng(2).integers(0, 8 * 8 * 5, (B, m.style.n_codes))
    close(ap(q, qp, J(idx.astype(np.int32)), method=StyleQuantizer.decode_indices),
          port.acoustic.quantizer.decode_indices(t(idx.astype(np.int32))))


def test_duration_predictor_and_frames(world):
    m, p, port, d = world
    dp = DurationPredictor(m.predictor)
    dpp = p["acoustic"]["params"]["duration_predictor"]
    style = d["style"].mean(1)
    ref = ap(dp, dpp, J(d["x_text"]), J(style), mask=J(d["text_mask"]))
    out = port.acoustic.duration_predictor(t(d["x_text"]), t(style),
                                           mask=t(d["text_mask"]))
    close(ref, out)
    frames = ap(dp, dpp, ref, J(d["text_mask"]), method=DurationPredictor.to_frames)
    np.testing.assert_array_equal(
        port.acoustic.duration_predictor.to_frames(t(np.asarray(ref)),
                                                   t(d["text_mask"])).numpy(),
        np.asarray(frames))
    half = np.array([[0.0, np.log1p(0.5), np.log1p(1.5), np.log1p(2.5)]],
                    np.float32)       # expm1 lands on x.5: round half to even
    np.testing.assert_array_equal(
        port.acoustic.duration_predictor.to_frames(t(half)).numpy(),
        np.asarray(ap(dp, dpp, J(half), method=DurationPredictor.to_frames)))


def test_prosody_predictor(world):
    m, p, port, d = world
    ref = ap(ProsodyPredictor(m.predictor), p["acoustic"]["params"]["prosody_predictor"],
             J(d["x_frames"]), J(d["style_frames"]), mask=J(d["frame_mask"]))
    out = port.acoustic.prosody_predictor(t(d["x_frames"]), t(d["style_frames"]),
                                          mask=t(d["frame_mask"]))
    close(ref[0], out[0])
    close(ref[1], out[1])


def test_mel_decoder(world):
    """Frame 20 on of row 1 is masked: its last chunk's queries have no
    valid key, where the kernel's plain version and JAX's twin average
    different windows — the decoder's mask hides that."""
    m, p, port, d = world
    f0, en = d["curves"]
    ref_mel, ref_h = ap(MelDecoder(m.decoder, n_mels=m.audio.n_mels),
                        p["acoustic"]["params"]["decoder"], J(d["x_frames"]),
                        J(f0), J(en), J(d["style_frames"]),
                        mask=J(d["frame_mask"]), return_hidden=True)
    mel, h = port.acoustic.decoder(t(d["x_frames"]), t(f0), t(en),
                                   t(d["style_frames"]), mask=t(d["frame_mask"]))
    close(ref_mel, mel)
    close(ref_h, h)


def test_onestep_diffusion(world):
    m, p, port, d = world
    rng = jax.random.PRNGKey(7)
    tokens = d["x_text"][:, :4]
    summary = d["x_text"][:, 0]
    ref = StyleDiffusion(m.diffusion, m.style, ctx_dim=m.text_encoder.dim).apply(
        p["diffusion"], rng, J(d["x_text"]), J(tokens), J(summary),
        text_mask=J(d["text_mask"]), method=StyleDiffusion.sample_onestep)
    noise = jax.random.normal(rng, (B, m.style.n_codes, m.style.d_style))
    out = port.diffusion.sample_onestep(t(noise), t(d["x_text"]), t(tokens),
                                        t(summary), text_mask=t(d["text_mask"]))
    close(ref, out)


def test_vocoder(world):
    m, p, port, d = world
    mask = np.arange(24)[None] < np.array([24, 15])[:, None]
    ref = Vocoder(m.vocoder, n_mels=m.audio.n_mels).apply(
        p["vocoder"], J(d["dec_mel"]), mask=J(mask))
    out = port.vocoder(t(d["dec_mel"]), mask=t(mask))
    assert out.shape == ref.shape
    close(ref, out)


# --- layers, each through a parameter subtree of the models ------------------

def test_transformer_block_with_local_attention(world):
    m, p, port, d = world
    blk = j_layers.TransformerBlock(64, 4, chunk=m.decoder.attn_window)
    ref = ap(blk, p["acoustic"]["params"]["decoder"]["attn1"], J(d["x_frames"]),
             mask=J(d["frame_mask"]))
    out = port.acoustic.decoder.attn1(t(d["x_frames"]), mask=t(d["frame_mask"]))
    valid = d["frame_mask"]       # rows past the length differ by design
    np.testing.assert_allclose(n(out)[valid], n(ref)[valid], atol=ATOL,
                               rtol=RTOL)


def test_adaln_block(world):
    m, p, port, d = world
    cond = d["x_text"][:, 0]
    ref = ap(j_layers.AdaLNTransformerBlock(64, 4, cross=True),
             p["diffusion"]["params"]["denoiser"]["block0"], J(d["x_text"]),
             J(cond), ctx=J(d["x_text"]), ctx_mask=J(d["text_mask"]))
    out = port.diffusion.denoiser.block0(t(d["x_text"]), t(cond),
                                         ctx=t(d["x_text"]),
                                         ctx_mask=t(d["text_mask"]))
    close(ref, out)


def test_conv_block_and_adain_res_block(world):
    m, p, port, d = world
    close(ap(j_layers.ConvBlock(64, kernel=m.text_encoder.conv_kernel),
             p["acoustic"]["params"]["text_encoder"]["conv0"], J(d["x_text"])),
          port.acoustic.text_encoder.conv0(t(d["x_text"])))
    for i, dil in ((0, 1), (1, 3)):
        ref = ap(j_layers.AdaINResBlock(64, kernel=m.decoder.conv_kernel,
                                        dilation=dil),
                 p["acoustic"]["params"]["decoder"][f"res{i}"],
                 J(d["x_frames"]), J(d["style_frames"]))
        out = getattr(port.acoustic.decoder, f"res{i}")(t(d["x_frames"]),
                                                        t(d["style_frames"]))
        close(ref, out)


def test_cross_attention(world):
    m, p, port, d = world
    q = d["x_text"][:, :4]
    ref = ap(j_layers.CrossAttention(64, 4),
             p["acoustic"]["params"]["prompt_encoder"]["pool"], J(q),
             J(d["x_text"]), ctx_mask=J(d["text_mask"]))
    close(ref, port.acoustic.prompt_encoder.pool(t(q), t(d["x_text"]),
                                                 ctx_mask=t(d["text_mask"])))

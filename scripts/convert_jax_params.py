"""Carry a JAX parameter bundle (orbax) across to the PyTorch port.

Reads a tree that ``styletts_zs_tpu.pipelines.checkpoint.save_params``
wrote (a serving bundle ``{acoustic, vocoder, diffusion}`` such as
``checkpoints/r5/final``, or a whole ``init_params`` tree), maps it with the
port's ``pipelines.convert.convert_params`` and writes it with the port's
``pipelines.checkpoint.save_params``, which ``styletts_zs_torch.cli synth
--ckpt`` and ``accept --level 5 --bundle`` read.  Runs where JAX and orbax
are installed; the port never imports this file.

    python scripts/convert_jax_params.py checkpoints/r5/final bundle.pt
    python scripts/convert_jax_params.py tree_dir tree.pt --config configs/tiny.toml
    python scripts/convert_jax_params.py checkpoints/r5/final --drift 256 512 1024

``--drift`` writes nothing: it measures, on the CPU, how far bf16 moves
each side from its own fp32 path on the bundle (the 1-step path with the
vocoder, batch 1, 256 phonemes, the frame counts given; the same inputs
and initial noise on both sides): the masked mel MAE, the waveform MAE, the
share of FSQ codes and of durations that flip, and the port against JAX in
each dtype.  One JSON line per frame count.

The orbax restore needs a like-tree: it is made with ``jax.eval_shape`` of
``init_params`` (shapes only, no weights computed) and placed on the CPU
device, so a tree saved on another backend restores here.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import numpy as np
import orbax.checkpoint as ocp
from jax.sharding import SingleDeviceSharding

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from styletts_zs_tpu.pipelines.checkpoint import load_params  # noqa: E402
from styletts_zs_tpu.pipelines.factory import init_params  # noqa: E402
from styletts_zs_tpu.utils.config import Config as JaxConfig  # noqa: E402
from styletts_zs_tpu.utils.config import load_config as jax_load_config  # noqa: E402
from styletts_zs_torch.config import Config  # noqa: E402
from styletts_zs_torch.config import load_config  # noqa: E402
from styletts_zs_torch.pipelines.checkpoint import save_params  # noqa: E402
from styletts_zs_torch.pipelines.convert import convert_params  # noqa: E402


def like_tree(cfg: JaxConfig, parts, *, with_discriminator: bool = False):
    """``init_params(cfg)``'s shapes and dtypes for ``parts``, on the CPU."""
    cpu = SingleDeviceSharding(jax.devices("cpu")[0])
    shapes = jax.eval_shape(lambda: init_params(
        cfg, jax.random.PRNGKey(0), with_discriminator=with_discriminator))
    return jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=cpu),
        {k: shapes[k] for k in parts})


def _saved_parts(path: str) -> tuple[str, ...]:
    """The top-level keys of the orbax tree at ``path``."""
    meta = ocp.StandardCheckpointer().metadata(os.path.abspath(path))
    return tuple(meta.item_metadata.tree)


def load_jax_bundle(path: str, cfg: JaxConfig | None = None):
    """The orbax tree at ``path`` as numpy arrays, restored against
    ``cfg``'s (default ``Config()``) like-tree."""
    cfg = cfg or JaxConfig()
    parts = _saved_parts(path)
    like = like_tree(cfg, parts, with_discriminator="discriminator" in parts)
    return jax.tree.map(np.asarray, load_params(path, like=like))


def convert_bundle(path: str, out: str, config: str | None = None) -> dict:
    """Restore ``path`` (JAX), convert it and write it to ``out`` (port);
    returns the port's tree."""
    jcfg = jax_load_config(config) if config else JaxConfig()
    tcfg = load_config(config) if config else Config()
    params = convert_params(load_jax_bundle(path, jcfg), tcfg)
    save_params(out, params)
    return params


def _fsq_digits(style: np.ndarray, up_w: np.ndarray, up_b: np.ndarray,
                levels) -> np.ndarray:
    """The unrounded lattice digits that ``project_style`` rounds ``style``
    (B, K, d_style) to, from the fp32 ``up`` kernel (d, d_style) and bias."""
    W = up_w.astype(np.float64)
    z = ((style - up_b) @ W.T) @ np.linalg.inv(W @ W.T)
    lv = np.asarray(levels, np.float64)
    return np.clip((z + 1.0) * (lv - 1.0) / 2.0, 0.0, lv - 1.0)


def _code_flips(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(share of codes whose rounded digits differ between the unrounded
    digits ``a`` and ``b``, the largest distance of a flipped digit of
    ``a`` from its rounding boundary; 0 when none flipped)."""
    flip = np.round(a) != np.round(b)
    dist = np.abs(a - np.floor(a) - 0.5)
    return float(flip.any(-1).mean()), float(dist[flip].max(initial=0.0))


def _jax_side(tree, cfg, inputs, noise_key):
    """JAX's 1-step path with the vocoder: (sampled style, out, wav)."""
    import jax.numpy as jnp
    from styletts_zs_tpu.models.diffusion import StyleDiffusion
    from styletts_zs_tpu.models.tts import StyleTTSZS
    from styletts_zs_tpu.ops.attention import length_mask
    from styletts_zs_tpu.pipelines.factory import build_models
    from styletts_zs_tpu.pipelines.infer import make_synthesis_fn

    acoustic, diffusion, _, _ = build_models(cfg)

    def sample(params, phonemes, text_lengths, ref_mel, ref_lengths, rng):
        text_mask = length_mask(text_lengths, phonemes.shape[1])
        p_ac = params["acoustic"]
        tokens, summary = acoustic.apply(
            p_ac, ref_mel, length_mask(ref_lengths, ref_mel.shape[1]),
            method=StyleTTSZS.encode_prompt)
        text_enc, _ = acoustic.apply(p_ac, phonemes, text_mask,
                                     method=StyleTTSZS.encode_text)
        return diffusion.apply(params["diffusion"], rng, text_enc, tokens,
                               summary, text_mask=text_mask,
                               method=StyleDiffusion.sample_onestep)

    params = jax.tree.map(jnp.asarray, tree)
    args = (params, *map(jnp.asarray, inputs), noise_key)
    style = jax.jit(sample)(*args)
    out, wav = jax.jit(make_synthesis_fn(cfg, one_step=True,
                                         with_vocoder=True))(*args)
    return np.asarray(style, np.float64), out, wav


def _port_side(params, cfg, inputs, noise):
    """The port's 1-step path with the vocoder on the CPU: (sampled style,
    out, wav)."""
    import torch
    from styletts_zs_torch.ops.attention import length_mask
    from styletts_zs_torch.pipelines.factory import build_models
    from styletts_zs_torch.pipelines.infer import make_synthesis_fn

    x = [torch.from_numpy(np.array(a)) for a in (*inputs, noise)]
    models = build_models(cfg, params, device="cpu")
    with torch.inference_mode():
        text_mask = length_mask(x[1], x[0].shape[1])
        tokens, summary = models.acoustic.encode_prompt(
            x[2], length_mask(x[3], x[2].shape[1]))
        text_enc = models.acoustic.encode_text(x[0], text_mask)[0]
        style = models.diffusion.sample_onestep(x[4], text_enc, tokens,
                                                summary, text_mask=text_mask)
    out, wav = make_synthesis_fn(cfg, params, device="cpu")(*x)
    return style.double().numpy(), out, wav


def drift(path: str, frames, text_len: int = 256) -> list[dict]:
    """bf16 against fp32 on each side at each of ``frames`` (see the module
    docstring); the bundle is read once."""
    from styletts_zs_tpu.utils import config as jc
    from styletts_zs_torch import config as tc

    tree = load_jax_bundle(path)
    params = convert_params(tree, tc.Config())
    rows = []
    for n_frames in frames:
        model = dict(max_text_len=text_len, max_frames=n_frames)
        m = jc.ModelConfig(**model)
        rs = np.random.default_rng(0)
        ref_frames = 3 * m.audio.sample_rate // m.audio.hop_length
        inputs = (rs.integers(1, 40, (1, text_len)).astype(np.int32),
                  np.array([text_len], np.int32),
                  (0.5 * rs.standard_normal((1, ref_frames, m.audio.n_mels)))
                  .astype(np.float32),
                  np.array([ref_frames], np.int32))
        key = jax.random.PRNGKey(0)
        noise = np.asarray(jax.random.normal(
            key, (1, m.style.n_codes, m.style.d_style)))
        res = {}
        for dtype in ("float32", "bfloat16"):
            jcfg = jc.Config(model=m, runtime=jc.RuntimeConfig(
                compute_dtype=dtype, use_pallas=False))
            tcfg = tc.Config(model=tc.ModelConfig(**model),
                             runtime=tc.RuntimeConfig(compute_dtype=dtype))
            res["jax", dtype] = _jax_side(tree, jcfg, inputs, key)
            res["port", dtype] = _port_side(params, tcfg, inputs, noise)
        up_w = tree["acoustic"]["params"]["quantizer"]["up"]["kernel"]
        up_b = tree["acoustic"]["params"]["quantizer"]["up"]["bias"]
        levels = jc.StyleConfig().fsq_levels

        def f(x):
            return np.asarray(x.float() if hasattr(x, "float") else x,
                              np.float32)

        row = {"n_frames": n_frames}
        for side in ("port", "jax"):
            s32, o32, w32 = res[side, "float32"]
            s16, o16, w16 = res[side, "bfloat16"]
            mask = f(o32.frame_mask)[..., None]
            mel32 = f(o32.mel)
            d32 = f(o32.durations)[0, :text_len]
            d16 = f(o16.durations)[0, :text_len]
            flips, margin = _code_flips(_fsq_digits(s32, up_w, up_b, levels),
                                        _fsq_digits(s16, up_w, up_b, levels))
            row[side] = {
                "frames_emitted": int(mask.sum()),
                "mel_mae_bf16_vs_fp32": float(
                    np.abs((f(o16.mel) - mel32) * mask).sum()
                    / max(mask.sum() * mel32.shape[-1], 1)),
                "wav_mae_bf16_vs_fp32": float(np.abs(f(w16) - f(w32)).mean()),
                "code_flip_share": flips,
                "flipped_digit_max_distance_from_boundary_fp32": margin,
                "duration_flip_share": float((d32 != d16).mean()),
            }
        for dtype in ("float32", "bfloat16"):
            (sp, op, wp), (sj, oj, wj) = res["port", dtype], res["jax", dtype]
            flips, margin = _code_flips(_fsq_digits(sj, up_w, up_b, levels),
                                        _fsq_digits(sp, up_w, up_b, levels))
            row[f"port_vs_jax_{dtype}"] = {
                "durations_equal": bool((f(op.durations)
                                         == f(oj.durations)).all()),
                "code_flip_share": flips,
                "flipped_digit_max_distance_from_boundary_jax": margin,
                "style_max_abs": float(np.abs(sp - sj).max()),
                "mel_max_abs": float(np.abs(f(op.mel) - f(oj.mel)).max()),
                "wav_max_abs": float(np.abs(f(wp) - f(wj)).max()),
            }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle", help="orbax directory written by the JAX "
                                   "package's save_params")
    ap.add_argument("out", nargs="?", help="file for the port's save_params")
    ap.add_argument("--config", default=None,
                    help="TOML config of the model (default: Config())")
    ap.add_argument("--drift", type=int, nargs="+", metavar="FRAMES",
                    help="write nothing; measure the bf16 drift of both "
                         "sides on the bundle at these frame counts")
    args = ap.parse_args(argv)
    if args.drift:
        drift(args.bundle, args.drift)
        return
    if not args.out:
        ap.error("give the output file, or --drift")
    t0 = time.perf_counter()
    params = convert_bundle(args.bundle, args.out, args.config)
    n = sum(v.numel() for sd in params.values() for v in sd.values())
    print(f"wrote {args.out}: {sorted(params)}, {n} parameters, "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()

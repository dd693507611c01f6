"""Model factory: build the modules from a Config, init or load parameters.

Counterpart of ``styletts_zs_tpu/pipelines/factory.py``.  Parameters are a
dict ``{"acoustic": state_dict, "diffusion": ..., "vocoder": ...}`` (and
``"discriminator"`` for training) of fp32 master tensors — from
``init_params`` (seeded, the Flax initialisers' distributions) or from
``pipelines.convert.convert_params`` (a JAX tree).  ``build_models`` loads
them into modules on a device and casts them once to the compute dtype (the
diffusion net to ``diffusion_dtype``, fp32), for inference
(``build_frozen_modules`` for some parts: the frozen models of training);
``build_train_modules`` builds working copies in those dtypes for
``pipelines.train``, which keeps the fp32 masters.  The entry points run on
the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from styletts_zs_torch.config import Config
from styletts_zs_torch.models.diffusion import StyleDiffusion
from styletts_zs_torch.models.discriminators import MultiModalDiscriminator
from styletts_zs_torch.models.layers import Conv, Dense
from styletts_zs_torch.models.tts import StyleTTSZS
from styletts_zs_torch.models.vocoder import Vocoder
from styletts_zs_torch.parallel import tensor as tp

PARTS = ("acoustic", "diffusion", "vocoder")


def resolve_device(device=None) -> torch.device:
    """``device`` or the card; raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless "
                           "device='cpu' is passed")
    return dev


def _modules(cfg: Config, parts=PARTS) -> dict[str, nn.Module]:
    m = cfg.model
    make = {"acoustic": lambda: StyleTTSZS(m),
            "diffusion": lambda: StyleDiffusion(m.diffusion, m.style,
                                                ctx_dim=m.text_encoder.dim),
            "vocoder": lambda: Vocoder(m.vocoder, n_mels=m.audio.n_mels),
            "discriminator": lambda: MultiModalDiscriminator(
                m.discriminator, n_mels=m.audio.n_mels)}
    return {p: make[p]() for p in parts}


def _empty_modules(cfg: Config, device: torch.device, parts=PARTS,
                   shardings=None, group=None) -> dict[str, nn.Module]:
    """The modules with uninitialised storage (no default init is run);
    with ``shardings`` (``parallel.sharding.param_shardings``), each split
    parameter at its chunk's shape (``parallel.tensor.shard_modules``)."""
    with torch.device("meta"):
        mods = _modules(cfg, parts)
    if shardings is not None:
        tp.shard_modules(mods, shardings, group)
    return {k: v.to_empty(device=device) for k, v in mods.items()}


def _lecun_(p: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """Flax ``lecun_normal``: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=g)


def _init_module(mod: nn.Module, g: torch.Generator) -> None:
    for name, p in mod.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = mod.get_submodule(owner_name)
        if isinstance(owner, nn.LayerNorm):
            nn.init.ones_(p) if leaf == "weight" else nn.init.zeros_(p)
        elif isinstance(owner, nn.Embedding):
            std = 1.0 / math.sqrt(p.shape[0])
            nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                  generator=g)
        elif leaf == "bias" or leaf.startswith("null_prompt") or \
                owner_name.endswith("adaln_mod"):
            nn.init.zeros_(p)          # DiT: AdaLN modulation starts at zero
        elif leaf == "queries":
            nn.init.normal_(p, std=0.02, generator=g)
        elif isinstance(owner, Dense):
            _lecun_(p, p.shape[1], g)  # (out, in)
        elif isinstance(owner, Conv):
            _lecun_(p, p.shape[1] * p.shape[2], g)  # (out, in, K)
        else:
            _lecun_(p, p.shape[0] * p.shape[1], g)  # raw (K, in, out)


def init_params(cfg: Config, *, seed: int = 0, device=None,
                with_discriminator: bool = False):
    """Seeded fp32 parameters for every model part (the discriminator's
    last, from the same generator, when asked for)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    parts = PARTS + ("discriminator",) if with_discriminator else PARTS
    params = {}
    with torch.no_grad():
        for part, mod in _empty_modules(cfg, dev, parts).items():
            _init_module(mod, g)
            params[part] = mod.state_dict()
    return params


@dataclass
class Models:
    acoustic: StyleTTSZS
    diffusion: StyleDiffusion
    vocoder: Vocoder


def _dtype(cfg: Config, part: str) -> torch.dtype:
    """The diffusion net's dtype (fp32), else the compute dtype."""
    r = cfg.runtime
    return getattr(torch, r.diffusion_dtype if part == "diffusion"
                   else r.compute_dtype)


def build_frozen_modules(cfg: Config, params, parts, *,
                         device=None) -> dict[str, nn.Module]:
    """``parts`` on ``device`` holding ``params``, in eval mode with
    gradients off, cast once to their dtypes."""
    dev = resolve_device(device)
    mods = _empty_modules(cfg, dev, parts)
    for part, mod in mods.items():
        mod.load_state_dict(params[part], strict=True)
        mod.eval().requires_grad_(False)
    if "acoustic" in mods:
        # project_style decides on fp32 master weights whatever the dtype
        mods["acoustic"].quantizer.keep_master()
    for part, mod in mods.items():
        mod.to(_dtype(cfg, part))
    return mods


def build_models(cfg: Config, params, *, device=None) -> Models:
    """Modules on ``device`` holding ``params``, cast once to their dtypes."""
    return Models(**build_frozen_modules(cfg, params, PARTS, device=device))


def build_train_modules(cfg: Config, params, parts, *, device=None,
                        shardings=None, group=None) -> dict[str, nn.Module]:
    """Working copies of ``parts`` on ``device`` in their dtypes (the
    diffusion net fp32, the rest the compute dtype), with gradients on:
    Flax casts its fp32 parameters to the compute dtype at each use, so
    the gradient is the compute-dtype one, which the trainer upcasts onto
    its fp32 masters.  With ``shardings`` and the model ``group``, the
    split parameters hold this rank's chunks, as ``params`` must."""
    dev = resolve_device(device)
    mods = _empty_modules(cfg, dev, parts, shardings, group)
    for part, mod in mods.items():
        mod.load_state_dict(params[part], strict=True)
        mod.to(_dtype(cfg, part)).train()
    return mods

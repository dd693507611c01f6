"""Model factory: build the modules from a Config, init or load parameters.

Counterpart of ``styletts_zs_tpu/pipelines/factory.py``.  Parameters are a
dict ``{"acoustic": state_dict, "diffusion": ..., "vocoder": ...}`` of fp32
master tensors — from ``init_params`` (seeded, the Flax initialisers'
distributions) or from ``pipelines.convert.convert_params`` (a JAX tree).
``build_models`` loads them into modules on a device and casts them once to
the compute dtype (the diffusion net to ``diffusion_dtype``, fp32).  The
entry points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from styletts_zs_torch.config import Config
from styletts_zs_torch.models.diffusion import StyleDiffusion
from styletts_zs_torch.models.layers import Conv, Dense
from styletts_zs_torch.models.tts import StyleTTSZS
from styletts_zs_torch.models.vocoder import Vocoder

PARTS = ("acoustic", "diffusion", "vocoder")


def resolve_device(device=None) -> torch.device:
    """``device`` or the card; raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless "
                           "device='cpu' is passed")
    return dev


def _modules(cfg: Config) -> dict[str, nn.Module]:
    m = cfg.model
    return {"acoustic": StyleTTSZS(m),
            "diffusion": StyleDiffusion(m.diffusion, m.style,
                                        ctx_dim=m.text_encoder.dim),
            "vocoder": Vocoder(m.vocoder, n_mels=m.audio.n_mels)}


def _empty_modules(cfg: Config, device: torch.device) -> dict[str, nn.Module]:
    """The modules with uninitialised storage (no default init is run)."""
    with torch.device("meta"):
        mods = _modules(cfg)
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


def init_params(cfg: Config, *, seed: int = 0, device=None):
    """Seeded fp32 parameters for every model part."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = {}
    with torch.no_grad():
        for part, mod in _empty_modules(cfg, dev).items():
            _init_module(mod, g)
            params[part] = mod.state_dict()
    return params


@dataclass
class Models:
    acoustic: StyleTTSZS
    diffusion: StyleDiffusion
    vocoder: Vocoder


def build_models(cfg: Config, params, *, device=None) -> Models:
    """Modules on ``device`` holding ``params``, cast once to their dtypes."""
    dev = resolve_device(device)
    mods = _empty_modules(cfg, dev)
    for part, mod in mods.items():
        mod.load_state_dict(params[part], strict=True)
        mod.eval().requires_grad_(False)
    # project_style decides on fp32 master weights whatever the dtype
    mods["acoustic"].quantizer.keep_master()
    dt = getattr(torch, cfg.runtime.compute_dtype)
    mods["acoustic"].to(dt)
    mods["vocoder"].to(dt)
    mods["diffusion"].to(getattr(torch, cfg.runtime.diffusion_dtype))
    return Models(**mods)


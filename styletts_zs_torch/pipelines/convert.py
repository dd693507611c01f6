"""Convert a JAX parameter tree (``styletts_zs_tpu`` ``init_params`` or a
trained bundle, as numpy arrays) into the port's state dicts.

Rules, by leaf:
  - Dense ``kernel`` (in, out)          -> ``weight`` (out, in);
  - ``nn.Conv`` ``kernel`` (K, in, out)  -> ``weight`` (out, in, K);
  - LayerNorm ``scale``                 -> ``weight``; Embed ``embedding`` -> ``weight``;
  - everything else keeps its name and layout: biases, the raw parameters
    ``conv1``/``conv2`` (AdaIN blocks), ``up{i}_kernel`` (vocoder),
    ``istft_head/{kernel,bias}``, ``queries``, ``null_prompt_*``.
Every leaf must land on a parameter of the port's modules with the same
shape, and every parameter must receive one; anything else raises.
``jax_layout`` states these rules once: the conversion reorders by them,
and ``jax_last_axes`` reads from them where a JAX leaf's last axis lies in
the port's tensor (``parallel/sharding.py`` shards on it).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from styletts_zs_torch.config import Config
from styletts_zs_torch.pipelines.factory import PARTS, _modules

RAW_KERNEL_OWNERS = ("istft_head",)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


def jax_layout(owner: str, leaf: str, ndim: int
               ) -> tuple[str, tuple[int, ...]]:
    """(the port's leaf name, the order of the JAX axes in the port's
    tensor: ``arr.transpose(order)``) for a JAX leaf ``leaf`` of ``ndim``
    axes whose module is named ``owner``."""
    if leaf == "kernel" and owner and owner not in RAW_KERNEL_OWNERS:
        if ndim == 2:
            return "weight", (1, 0)
        if ndim == 3:
            return "weight", (2, 1, 0)
    if leaf in ("scale", "embedding"):
        return "weight", tuple(range(ndim))
    return leaf, tuple(range(ndim))


def jax_leaf(owner: nn.Module, leaf: str) -> str:
    """The JAX name of the port's parameter ``leaf`` of module ``owner``."""
    if leaf != "weight":
        return leaf
    if isinstance(owner, nn.Embedding):
        return "embedding"
    if isinstance(owner, nn.LayerNorm):
        return "scale"
    return "kernel"


def jax_last_axes(cfg: Config, parts) -> dict[str, dict[str, int]]:
    """``{part: {key: dim}}``: the dim of each port parameter that holds
    its JAX leaf's last axis (0 for a Dense or ``nn.Conv`` weight, 1 for
    an embedding table, the last for every leaf kept in the JAX layout)."""
    with torch.device("meta"):
        mods = _modules(cfg, parts)
    out = {}
    for part, mod in mods.items():
        out[part] = {}
        for key, p in mod.named_parameters():
            owner_name, _, leaf = key.rpartition(".")
            owner = mod.get_submodule(owner_name)
            _, order = jax_layout(owner_name.rpartition(".")[2],
                                  jax_leaf(owner, leaf), p.ndim)
            out[part][key] = order.index(p.ndim - 1)
    return out


def _port_entry(path: tuple[str, ...], arr: np.ndarray):
    *owner, leaf = path
    leaf, order = jax_layout(owner[-1] if owner else "", leaf, arr.ndim)
    return ".".join([*owner, leaf]), arr.transpose(order)


def convert_params(tree, cfg: Config) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``{"acoustic": {"params": ...}, ...}`` -> ``{part: state_dict}``,
    for every part of ``PARTS`` and the discriminator where the tree has
    one."""
    parts = PARTS + tuple(p for p in ("discriminator",) if p in tree)
    with torch.device("meta"):
        targets = {p: m.state_dict() for p, m in _modules(cfg, parts).items()}
    out = {}
    for part in parts:
        want = targets[part]
        sd = {}
        for path, arr in _leaves(tree[part]["params"]):
            key, arr = _port_entry(path, arr)
            if key not in want:
                raise KeyError(f"{part}/{'/'.join(path)}: no port parameter "
                               f"{key!r}")
            if tuple(arr.shape) != tuple(want[key].shape):
                raise ValueError(f"{part}/{'/'.join(path)}: shape {arr.shape}"
                                 f" vs port {tuple(want[key].shape)}")
            sd[key] = torch.tensor(arr)
        missing = sorted(set(want) - set(sd))
        if missing:
            raise KeyError(f"{part}: port parameters with no JAX leaf: "
                           f"{missing}")
        out[part] = sd
    return out

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
"""
from __future__ import annotations

import numpy as np
import torch

from styletts_zs_torch.config import Config
from styletts_zs_torch.pipelines.factory import PARTS, _modules

RAW_KERNEL_OWNERS = ("istft_head",)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


def _port_entry(path: tuple[str, ...], arr: np.ndarray):
    *owner, leaf = path
    if leaf == "kernel" and owner and owner[-1] not in RAW_KERNEL_OWNERS:
        if arr.ndim == 2:
            leaf, arr = "weight", arr.T
        elif arr.ndim == 3:
            leaf, arr = "weight", arr.transpose(2, 1, 0)
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join([*owner, leaf]), arr


def convert_params(tree, cfg: Config) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``{"acoustic": {"params": ...}, ...}`` -> ``{part: state_dict}``."""
    with torch.device("meta"):
        targets = {p: m.state_dict() for p, m in _modules(cfg).items()}
    out = {}
    for part in PARTS:
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

"""Shared set-up of the parity tests between the JAX package and the
PyTorch port: one tiny parameter tree made with numpy from a seed, handed
to both sides (the port through ``convert_params``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from styletts_zs_tpu.pipelines.factory import init_params as jax_init_params
from styletts_zs_tpu.utils.config import tiny_test_config as jax_tiny
from styletts_zs_torch.config import tiny_test_config as torch_tiny


def leaf_name(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def random_tree(cfg, seed: int = 0):
    """Numpy weights for every leaf of ``init_params(cfg)``'s tree.

    Matrices ~ N(0, 1/fan_in), vectors ~ N(0, 0.1²) (LayerNorm scales
    1 + that), so no part is a zero-init identity (e.g. the AdaLN gates);
    the duration head's bias puts durations at a few frames per phoneme so
    the utterances are not empty.
    """
    shapes = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.PRNGKey(0)))
    rs = np.random.default_rng(seed)

    def make(path, s):
        name = leaf_name(path)
        a = rs.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) > 1:
            a /= np.sqrt(np.prod(s.shape[:-1]))
        else:
            a *= 0.1
        if name.endswith("/scale"):
            a += 1.0
        if name.endswith("duration_predictor/out/bias"):
            a[:] = 1.5
        return a

    return jax.tree_util.tree_map_with_path(make, shapes)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def t(x) -> torch.Tensor:
    """numpy/JAX array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


__all__ = ["jax_tiny", "torch_tiny", "random_tree", "to_jax", "t", "n",
           "leaf_name"]

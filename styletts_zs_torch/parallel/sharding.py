"""Parameter sharding over the mesh's ``model`` axis (tensor parallelism).

Counterpart of ``styletts_zs_tpu/parallel/sharding.py``, on the port's
``{part: state_dict}`` trees.  JAX's rule, stated on JAX's axes: where the
model axis has m > 1 ranks, a leaf with two or more axes whose last JAX
axis is at least ``min_shard_dim`` long and a multiple of m * 128 is split
over the model ranks along that axis; every other leaf (biases and norm
scales among them) is replicated.  A JAX leaf's last axis is dim 0 of a
Dense or ``nn.Conv`` weight, dim 1 of an embedding table and the last dim
of every leaf kept in the JAX layout (``pipelines.convert.jax_last_axes``).

A ``Sharding`` says which dim is split, into how many chunks, and which
chunk this rank holds (its model index); a replicated leaf's sharding is
None.  On a TPU GSPMD inserts the collectives that a sharded leaf needs;
here the layers that hold one call them (``parallel/tensor.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from styletts_zs_torch.config import Config
from styletts_zs_torch.parallel.mesh import MODEL_AXIS, mesh_shape

LANE = 128          # JAX's rule keeps each shard a whole number of lanes


@dataclass(frozen=True)
class Sharding:
    """Chunk ``index`` of ``count`` equal chunks along ``dim``."""
    dim: int
    count: int
    index: int

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of the whole ``x``, as a fresh contiguous
        tensor (a view would keep the whole storage alive)."""
        n = x.shape[self.dim] // self.count
        return x.narrow(self.dim, self.index * n, n).clone(
            memory_format=torch.contiguous_format)


def _model_axis(mesh) -> tuple[int, int]:
    """(model ranks, this rank's model index) of a ``DeviceMesh``, or of an
    int: a model axis of that size seen from index 0."""
    if isinstance(mesh, int):
        return mesh, 0
    return mesh_shape(mesh)[MODEL_AXIS], mesh.get_local_rank(MODEL_AXIS)


def param_shardings(params, mesh, cfg: Config, *, min_shard_dim: int = 256):
    """``{part: {key: Sharding | None}}`` for a ``{part: state_dict}``
    tree of ``cfg``'s modules on ``mesh`` (a ``DeviceMesh``, or the model
    axis's size alone), by JAX's rule."""
    from styletts_zs_torch.pipelines.convert import jax_last_axes
    m, index = _model_axis(mesh)
    axes = jax_last_axes(cfg, tuple(params))

    def rule(p: torch.Tensor, dim: int):
        n = p.shape[dim]
        if m > 1 and p.ndim >= 2 and n >= min_shard_dim and \
                n % (m * LANE) == 0:
            return Sharding(dim, m, index)
        return None

    return {part: {k: rule(v, axes[part][k]) for k, v in sd.items()}
            for part, sd in params.items()}


def shard_params(params, shardings):
    """This rank's tree: each sharded leaf's chunk (fresh and contiguous),
    each replicated leaf as it is."""
    def local(x, s):
        return x if s is None else s.take(x)
    return {part: {k: local(v, shardings.get(part, {}).get(k))
                   for k, v in sd.items()}
            for part, sd in params.items()}


def unshard_params(params, shardings, group):
    """The whole tree from every model rank's ``shard_params`` tree: each
    sharded leaf gathered along its dim over ``group`` (the model group;
    every rank of it must call), each replicated leaf (and each part that
    ``shardings`` does not name) as it is."""
    def whole(x, s):
        if s is None:
            return x
        parts = [torch.empty_like(x) for _ in range(s.count)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=s.dim)
    return {part: {k: whole(v, shardings.get(part, {}).get(k))
                   for k, v in sd.items()}
            for part, sd in params.items()}


def estimate_bytes(params) -> int:
    """The bytes of a tree's tensors as this rank holds them."""
    if isinstance(params, dict):
        return sum(estimate_bytes(v) for v in params.values())
    return params.numel() * params.element_size()

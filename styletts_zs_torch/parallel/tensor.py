"""The collectives of tensor parallelism over the mesh's ``model`` axis,
written out where GSPMD inserts them on a TPU.

A layer whose weight is split over the model ranks (``parallel/sharding.py``:
the large weights along their JAX output axis) computes the slice of its
output that its chunk gives and gathers the slices; everything after a
gather is replicated, so every model rank holds the same activations and
the same gradients of them.  Three ``autograd.Function``s over the model
group carry that:

  - ``gather_features(y, dim, group)``: the ranks' output slices
    concatenated along ``dim``; backward, this rank's slice of the (whole,
    replicated) gradient;
  - ``copy_to_model(x, group)``: the identity; backward, the sum of the
    ranks' gradients of x, since each rank's covers only its output slice;
  - ``gather_param(p, dim, group)``: a sharded parameter used whole
    (``queries``, ``null_prompt_tokens``); backward, this rank's slice.

Over a group of one (or None) all three return their input.  Only the list
form of ``all_gather`` and ``all_reduce`` is used, which NCCL and gloo
(also with CUDA tensors) both have, as in ``collectives.py``.
``ModelAxis`` gives the AdaIN block (``kernels/adain_conv.py``) the same
gather, slice and sum without autograd, inside its own backward.

A module learns that it holds a chunk from ``shard_modules``, which the
trainers' factory calls on modules still on the meta device: each sharded
parameter becomes one of the chunk's shape and its module's ``tp_shards``
records the split dim and the group (``shard_of``).  ``calls`` counts the
collectives by name.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

calls: Counter = Counter()


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _slice(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = g.shape[dim] // dist.get_world_size(group)
    return g.narrow(dim, dist.get_rank(group) * n, n).contiguous()


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, group, name):
        calls[name] += 1
        ctx.dim, ctx.group = dim % y.ndim, group
        return _gather(y, ctx.dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        calls["copy_to_model"] += 1
        return _sum(g, ctx.group), None


def gather_features(y: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The model ranks' slices of an output, concatenated along ``dim``."""
    if _size(group) == 1:
        return y
    return _Gather.apply(y, dim, group, "gather_features")


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated) as the input of a sharded layer: its gradient is
    summed over the model ranks."""
    if _size(group) == 1:
        return x
    return _CopyToModel.apply(x, group)


def gather_param(p: torch.Tensor, dim: int, group) -> torch.Tensor:
    """A sharded parameter, whole; its gradient is this rank's slice."""
    if _size(group) == 1:
        return p
    return _Gather.apply(p, dim, group, "gather_param")


@dataclass(frozen=True)
class Shard:
    """A module parameter held as this rank's chunk along ``dim``."""
    dim: int
    group: object


def shard_of(module: nn.Module, leaf: str) -> Shard | None:
    """How ``module``'s parameter ``leaf`` is split, or None (whole)."""
    return module.__dict__.get("tp_shards", {}).get(leaf)


def whole_param(module: nn.Module, leaf: str) -> torch.Tensor:
    """``module``'s parameter ``leaf``, gathered where it is sharded."""
    p, s = getattr(module, leaf), shard_of(module, leaf)
    return p if s is None else gather_param(p, s.dim, s.group)


def shard_modules(mods: dict[str, nn.Module], shardings, group) -> None:
    """Give each parameter that ``shardings`` (``{part: {key: Sharding |
    None}}``) splits the chunk's shape, and record the split on its module.
    The modules are still on the meta device (their storage comes after)."""
    for part, mod in mods.items():
        for key, s in shardings.get(part, {}).items():
            if s is None:
                continue
            owner_name, _, leaf = key.rpartition(".")
            owner = mod.get_submodule(owner_name)
            old = getattr(owner, leaf)
            shape = list(old.shape)
            shape[s.dim] //= s.count
            setattr(owner, leaf, nn.Parameter(
                torch.empty(shape, dtype=old.dtype, device=old.device),
                requires_grad=old.requires_grad))
            owner.__dict__.setdefault("tp_shards", {})[leaf] = Shard(s.dim,
                                                                     group)


@dataclass(frozen=True)
class ModelAxis:
    """The model group as a block that manages its own backward needs it:
    ``gather`` the ranks' channel slices of (B, T, c) outputs, ``slice``
    this rank's channels of a whole (B, T, C) gradient, ``sum`` partial
    results over the ranks (in fp32)."""
    group: object

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        calls["gather_features"] += 1
        return _gather(y, y.ndim - 1, self.group)

    def slice(self, g: torch.Tensor) -> torch.Tensor:
        return _slice(g, g.ndim - 1, self.group)

    def sum(self, partial: torch.Tensor) -> torch.Tensor:
        calls["sum_partials"] += 1
        return _sum(partial.float(), self.group)


def model_axis(module: nn.Module, leaf: str) -> ModelAxis | None:
    """The ``ModelAxis`` of ``module``'s sharded ``leaf``, else None."""
    s = shard_of(module, leaf)
    return None if s is None else ModelAxis(s.group)

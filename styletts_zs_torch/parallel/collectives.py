"""Metadata and gradient collectives over a mesh's data axis, and the
exchanges between hosts.

Counterpart of ``styletts_zs_tpu/parallel/collectives.py``.  Every
participant must derive the same bucket plan and dispatch order, so the
length histograms and the style table are exchanged:

  - over the mesh's data axis: ``gather_length_histograms`` and
    ``gather_style_codes`` (JAX's ``shard_map`` + ``all_gather``), each
    rank handing in its own rows;
  - between hosts: ``process_sum_histogram`` and ``process_concat_styles``
    (JAX's ``process_allgather`` over DCN).  A host is a node: torchrun's
    ``GROUP_RANK`` where it is set, else the host name.  One rank per node
    exchanges and broadcasts the result to the others of its node; on one
    node both are identities, as JAX's are on one process.

``pmean_grads`` averages gradients over the data axis.  Only collectives
that NCCL and gloo (also with CUDA tensors) both have are used: the list
form of ``all_gather``, ``all_reduce`` and ``broadcast``.  ``gather_rows``
and ``all_sum`` with ``grad=True`` keep the gradient: their backward is an
``all_reduce`` of the gradient (``torch.distributed.nn.functional``'s
``all_reduce``, written out since that one is deprecated), not the
reduce-scatter or all-to-all that gloo lacks.  ``calls`` counts each
function's calls.
"""
from __future__ import annotations

import os
import socket
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from styletts_zs_torch.parallel.mesh import DATA_AXIS

calls: Counter = Counter()


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _group(mesh):
    return mesh.get_group(DATA_AXIS)


class _AllSum(torch.autograd.Function):
    """The sum over a group's ranks, whose gradient is the sum of the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllSum.apply(g, ctx.group), None


def length_histogram(lengths: torch.Tensor, boundaries) -> torch.Tensor:
    """Counts of ``lengths`` per bucket: bucket i is (b[i-1], b[i]], with
    overflow lengths folded into the last bucket — the contract of
    ``bucketing.bucket_histogram``, so it feeds ``bucketing.plan_buckets``.
    Returns (n_buckets,) int32 on ``lengths``' device."""
    bs = torch.as_tensor(tuple(boundaries), dtype=torch.int64,
                         device=lengths.device)
    idx = (lengths.long()[:, None] > bs[None, :]).sum(dim=1)
    idx = torch.clamp(idx, max=len(boundaries) - 1)
    return torch.bincount(idx, minlength=len(boundaries)).to(torch.int32)


def gather_rows(mesh, x: torch.Tensor, *, grad: bool = False) -> torch.Tensor:
    """Every data rank's rows of ``x`` (the same row count on each),
    concatenated in rank order: the full (N, ...) tensor on every rank.
    ``grad=True`` keeps the gradient to this rank's rows: the rows go into
    a zeroed (N, ...) buffer that is summed over the ranks, whose backward
    sums the ranks' gradients."""
    group = _group(mesh)
    n = dist.get_world_size(group)
    if grad:
        r = dist.get_rank(group)
        b = x.shape[0]
        full = torch.cat([x.new_zeros((r * b, *x.shape[1:])), x,
                          x.new_zeros(((n - r - 1) * b, *x.shape[1:]))])
        return _AllSum.apply(full, group)
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.cat(out, dim=0)


def gather_length_histograms(mesh, lengths: torch.Tensor, boundaries):
    """Each data rank's length histogram of its ``lengths`` (its rows),
    gathered: (n_data, n_buckets) int32, the same on every rank, so every
    participant derives the same bucket plan."""
    calls["gather_length_histograms"] += 1
    hist = length_histogram(lengths.to(_device(mesh)), boundaries)
    return gather_rows(mesh, hist[None])


def gather_style_codes(mesh, codes: torch.Tensor) -> torch.Tensor:
    """Each data rank's rows of the style table (prompt summaries (n, d) or
    FSQ codes (n, K, d_fsq)), gathered: the full (N, ...) table, the same
    on every rank, so every participant assembles the same mixed-speaker
    batches."""
    calls["gather_style_codes"] += 1
    return gather_rows(mesh, codes.to(_device(mesh)))


def all_sum(mesh, x: torch.Tensor, *, grad: bool = False) -> torch.Tensor:
    """``x`` summed over the data ranks (a new tensor); ``grad=True`` keeps
    the gradient (the backward sums the ranks' gradients)."""
    return _AllSum.apply(x if grad else x.detach(), _group(mesh))


def pmean_grads(grads, mesh):
    """The mean of a gradient tree (a dict, possibly nested, or a list of
    tensors) over the data ranks, as a new tree of the same structure: one
    ``all_reduce`` of the flattened fp32 tensors.  Over one rank the mean
    is the tree itself, returned as it is."""
    calls["pmean_grads"] += 1
    group = _group(mesh)
    n = dist.get_world_size(group)
    if n == 1:
        return grads
    flat: list[torch.Tensor] = []

    def collect(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                collect(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                collect(v)
        else:
            flat.append(tree)

    collect(grads)
    buf = torch.cat([g.reshape(-1).float() for g in flat])
    dist.all_reduce(buf, group=group)
    buf /= n
    it = iter(torch.split(buf, [g.numel() for g in flat]))

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v) for v in tree)
        return next(it).view(tree.shape).to(tree.dtype)

    return rebuild(grads)


# ---------------------------------------------------------------------------
# between hosts
# ---------------------------------------------------------------------------

_NODES: dict = {}


def _node_groups():
    """(node groups, leaders' group, this rank's node index, leader rank of
    each node): made once per default group, on every rank in the same
    order (``new_group`` is collective)."""
    world = dist.group.WORLD
    if world in _NODES:
        return _NODES[world]
    node_id = os.environ.get("GROUP_RANK") or socket.gethostname()
    ids: list = [None] * dist.get_world_size()
    dist.all_gather_object(ids, node_id)
    order = list(dict.fromkeys(ids))
    members = [[r for r, i in enumerate(ids) if i == node] for node in order]
    groups = [dist.new_group(m) for m in members]
    leaders = [m[0] for m in members]
    leader_group = dist.new_group(leaders)
    mine = order.index(node_id)
    _NODES[world] = (groups, leader_group, mine, leaders)
    return _NODES[world]


def _n_nodes() -> int:
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return 1
    return len(_node_groups()[3])


def _wire_device() -> torch.device:
    """Host tables travel on the card under NCCL, else on the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _between_nodes(local: np.ndarray, combine) -> np.ndarray:
    """The leaders of the nodes gather their ``local`` arrays (row counts
    may differ), ``combine`` them (a list in node order) and broadcast the
    result within each node."""
    groups, leader_group, mine, leaders = _node_groups()
    dev = _wire_device()
    rank = dist.get_rank()
    result = None
    if rank == leaders[mine]:
        x = torch.as_tensor(np.ascontiguousarray(local)).to(dev)
        n = torch.tensor([x.shape[0]], dtype=torch.int64, device=dev)
        counts = [torch.empty_like(n) for _ in leaders]
        dist.all_gather(counts, n, group=leader_group)
        rows = max(int(c) for c in counts)
        pad = torch.zeros((rows - x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=dev)
        parts = [torch.empty((rows, *x.shape[1:]), dtype=x.dtype, device=dev)
                 for _ in leaders]
        dist.all_gather(parts, torch.cat([x, pad]), group=leader_group)
        result = np.asarray(combine([p[: int(c)].cpu().numpy()
                                     for p, c in zip(parts, counts)]),
                            dtype=local.dtype)
    shape = torch.zeros(8, dtype=torch.int64, device=dev)
    if result is not None:
        shape[0] = result.ndim
        shape[1: 1 + result.ndim] = torch.tensor(result.shape)
    group = groups[mine]
    dist.broadcast(shape, leaders[mine], group=group)
    nd = int(shape[0])
    dims = tuple(int(s) for s in shape[1: 1 + nd])
    out = torch.as_tensor(result).to(dev) if result is not None else \
        torch.empty(dims, dtype=torch.as_tensor(local).dtype, device=dev)
    dist.broadcast(out, leaders[mine], group=group)
    return out.cpu().numpy()


def process_concat_styles(local: np.ndarray) -> np.ndarray:
    """Concatenate the per-host style tables (hosts in node order) so every
    rank sees the global (N_total, ...) table; identity on one host."""
    calls["process_concat_styles"] += 1
    if _n_nodes() == 1:
        return np.asarray(local)
    return _between_nodes(np.asarray(local),
                          lambda parts: np.concatenate(parts, axis=0))


def process_sum_histogram(local_hist: np.ndarray) -> np.ndarray:
    """Sum the per-host bucket histograms so every rank sees the global
    one; identity on one host."""
    calls["process_sum_histogram"] += 1
    if _n_nodes() == 1:
        return np.asarray(local_hist)
    return _between_nodes(np.asarray(local_hist)[None],
                          lambda parts: np.concatenate(parts).sum(axis=0))

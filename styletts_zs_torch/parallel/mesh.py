"""The device mesh of the port: ``torch.distributed`` process groups in
place of JAX's named mesh.

Counterpart of ``styletts_zs_tpu/parallel/mesh.py``.  Axes: ``data``
(utterance batches: each rank holds a contiguous slice of every batch) and
``model`` (tensor parallelism: the ranks of one model group hold the same
rows and each its shard of the large weights, ``parallel/sharding.py``).
One rank is one process on one device; ``make_mesh`` lays the world's ranks
out as a ``DeviceMesh`` of shape (data, model) with those dimension names,
row-major as JAX's ``make_mesh`` orders its devices: rank ``d * model + m``
sits at (d, m).  The data group of a rank is its column (the ranks with its
model index), so the data axis's collectives combine shards of one slice;
its model group is its row.  The placements ``batch_sharding`` and
``replicated`` are what ``pipelines.train.batch_to_device`` and
``pipelines.serve.Server`` take: JAX's ``NamedSharding`` of a batch over
``data``, and of a replicated tree.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def default_backend(device_type: str) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def free_port() -> int:
    """A TCP port free on this host now (for a group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def multihost_init(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *,
                   backend: str | None = None) -> bool:
    """``init_process_group`` from the arguments or, where they are None,
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).  Returns False, and initialises nothing, when neither gives
    an address, as JAX's returns False without ``JAX_COORDINATOR``.
    ``backend`` defaults to NCCL where the card is present, else gloo; gloo
    also carries CUDA tensors (two ranks on one card, which NCCL refuses).
    On the card each rank takes device ``LOCAL_RANK`` modulo the cards it
    sees."""
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR") and \
            os.environ.get("MASTER_PORT"):
        addr = (f"tcp://{os.environ['MASTER_ADDR']}:"
                f"{os.environ['MASTER_PORT']}")
    if addr is None:
        return False
    world = num_processes if num_processes is not None else \
        int(os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else \
        int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = default_backend("cuda" if torch.cuda.is_available()
                                  else "cpu")
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=rank)
    return True


def make_mesh(data: int = -1, model: int = 1, devices=None) -> DeviceMesh:
    """A (data, model) ``DeviceMesh`` over the ranks of the default process
    group; ``data=-1`` takes every rank.  ``devices`` is the device type,
    ``"cuda"`` (the default) or ``"cpu"``.  Without a process group, one is
    initialised from torchrun's environment or, failing that, a group of
    this one process (so the collectives still run, over one rank).
    Every rank of the default group must call it (the groups of both axes
    are made collectively)."""
    device_type = torch.device(devices or "cuda").type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: make_mesh(devices='cpu') for a "
                           "mesh of CPU ranks")
    if model < 1:
        raise ValueError(f"a model axis of {model}")
    if not dist.is_initialized() and not multihost_init(
            backend=default_backend(device_type)):
        multihost_init(f"tcp://localhost:{free_port()}", 1, 0,
                       backend=default_backend(device_type))
    n = dist.get_world_size()
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(data, model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """``{"data": n, "model": m}``, as JAX's ``mesh.shape`` reads."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class BatchSharding:
    """This rank's contiguous rows of a batch: rows ``[index * b, (index +
    1) * b)`` of a batch of ``count * b``."""
    index: int
    count: int

    def take(self, x):
        """This rank's rows of ``x`` (a tensor or an array)."""
        n = x.shape[0]
        if n % self.count:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.count} data ranks")
        b = n // self.count
        return x[self.index * b: (self.index + 1) * b]


@dataclass(frozen=True)
class Replicated:
    """The whole of a tensor on every rank."""

    def take(self, x):
        return x


def batch_sharding(mesh: DeviceMesh) -> BatchSharding:
    """Utterance batches are data-parallel: this rank's rows, by its data
    index (the ranks of one model group hold the same rows)."""
    return BatchSharding(mesh.get_local_rank(DATA_AXIS), mesh.size(0))


def model_group(mesh: DeviceMesh | None):
    """The process group of this rank's model axis, or None where there is
    no mesh or the axis has one rank (nothing is sharded then)."""
    if mesh is None or mesh_shape(mesh)[MODEL_AXIS] == 1:
        return None
    return mesh.get_group(MODEL_AXIS)


def replicated(mesh: DeviceMesh | None = None) -> Replicated:
    """The whole tensor on every rank (JAX's ``replicated(mesh)``; the
    placement does not depend on the mesh)."""
    return Replicated()

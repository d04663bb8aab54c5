"""Process groups and device meshes for data parallelism. Counterpart of
``m4depth_tpu/parallel/mesh.py``, on ``torch.distributed``.

The JAX package shards the batch over a ``jax.sharding.Mesh`` and lets XLA
insert the gradient all-reduce. Here each process (rank) owns one device
and a replica of the model, ``DistributedDataParallel`` all-reduces the
gradients (``train.step.data_parallel``), and each rank reads its own share
of the data (``host_shard_indices``, ``local_batch``).

The JAX module's ``batch_sharding`` and ``replicated_sharding`` are XLA
sharding annotations and have no eager counterpart: DDP broadcasts rank
0's weights to every rank when it is built, which is what "replicated"
asks for, and the data path's ``host_shard`` (or ``local_batch``) gives
each rank its slice of the batch, which is what "batch-sharded" asks for.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from m4depth_tpu_torch import resolve_device

# How long a rank waits in a collective for the others. Under
# --validation_mode=sync rank 0 validates after each save while the other
# ranks wait at the barrier that follows it, so this must outlast a
# validation pass, not only a step.
DEFAULT_TIMEOUT = datetime.timedelta(hours=2)


def rank_and_world() -> Tuple[int, int]:
    """This process's rank and the world size: (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def distributed_init(coordinator_address: str, num_processes: int,
                     process_id: int, backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> str:
    """Join a group of ``num_processes`` ranks as rank ``process_id``, over
    ``tcp://<coordinator_address>`` (``host:port``; rank 0 serves it, or
    the launcher's agent does under ``torch.distributed.run``). Returns the
    backend.

    ``backend`` defaults to NCCL when ``device`` (default ``cuda``) is a
    CUDA device, after ``torch.cuda.set_device(LOCAL_RANK)``, and to gloo
    on the CPU. NCCL refuses two ranks on one GPU, so a node with more
    NCCL ranks (``LOCAL_WORLD_SIZE``) than cards raises here.
    """
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        if backend == "nccl" and local_world > torch.cuda.device_count():
            raise ValueError(
                f"{local_world} ranks on this node but "
                f"{torch.cuda.device_count()} CUDA devices: NCCL refuses "
                "two ranks on one GPU; start at most one rank a card")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=DEFAULT_TIMEOUT)
    return backend


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call distributed_init first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(axis_shapes: Sequence[int] = (-1,),
              axis_names: Sequence[str] = ("data",)):
    """A ``DeviceMesh`` over every rank of the group. ``-1`` on one axis
    absorbs the ranks the others leave; the axes must cover the world."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _device_type()
    world = dist.get_world_size()
    shapes = list(axis_shapes)
    if -1 in shapes:
        known = 1
        for s in shapes:
            if s != -1:
                known *= s
        shapes[shapes.index(-1)] = world // known
    n = 1
    for s in shapes:
        n *= s
    if n != world:
        raise ValueError(f"mesh axis_shapes {tuple(axis_shapes)} make {n} "
                         f"ranks; the group has {world}")
    return init_device_mesh(device_type, tuple(shapes),
                            mesh_dim_names=tuple(axis_names))


def make_hybrid_mesh(axis_names: Sequence[str] = ("dcn", "ici")):
    """A 2-D mesh of nodes x ranks a node (``LOCAL_WORLD_SIZE``, as the
    launcher sets it; the whole world without it). Data parallelism over it
    reduces over the whole world's group: NCCL already reduces inside a
    node before it crosses nodes, which is what the JAX hybrid mesh's
    hierarchical all-reduce bought."""
    _device_type()
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"{world} ranks do not divide into nodes of "
                         f"{local}")
    return make_mesh((world // local, local), axis_names)


def data_axes(mesh) -> tuple:
    """All mesh axis names: data parallelism uses every axis ('data' on a
    flat mesh, ('dcn', 'ici') on a hybrid one)."""
    return tuple(mesh.mesh_dim_names)


def data_group(mesh):
    """The process group that data parallelism over ``mesh`` reduces
    over: the mesh's own on a 1-D mesh, the world's on a hybrid one."""
    return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD


def host_shard_indices(n_items: int) -> slice:
    """This rank's strided share of a dataset index space: rank i reads
    items i, i + P, i + 2P, ... of P ranks.

    Every rank gets exactly ``n_items // P`` items and the remainder is
    dropped: unequal shards would give ranks different steps per epoch, and
    the first all-reduce that the shorter rank never joins would hang.
    """
    rank, world = rank_and_world()
    per_rank = n_items // world
    return slice(rank, rank + per_rank * world, world)


def local_batch(batch: dict, mesh) -> dict:
    """This rank's contiguous slice of a global batch: the leading dim split
    into ``mesh.size()`` equal parts, in rank order. A slice along the
    leading dim of a contiguous tensor stays contiguous, as the kernels
    need."""
    world = mesh.size()
    rank = dist.get_rank()
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % world:
            raise ValueError(f"global batch {k} of {n} does not split over "
                             f"{world} ranks")
        per = n // world
        out[k] = v[rank * per:(rank + 1) * per]
    return out

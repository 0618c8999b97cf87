"""Multi-host launch: process wiring, pod-shaped meshes, per-rank sizing.

Counterpart of ``deepqlearning_tpu.parallel.multihost``, translated to the
port's model of **one process per device**: a JAX process with n local
devices becomes n ranks on one host, so a row of :func:`hybrid_mesh` is a
host of ``LOCAL_WORLD_SIZE`` ranks (as ``torchrun`` sets it) and its
columns are the ranks inside the host, the fast (NVLink, the TPU's ICI)
axis. Ranks are numbered host-major, as ``torchrun`` numbers them, so the
world order is already ICI-major: :func:`pod_data_mesh` is the 1-D mesh in
that order, and the flat all-reduce keeps each host's ranks adjacent.
:func:`initialize_multihost` is ``init_process_group`` with a TCP
rendezvous and an explicit backend: ``nccl`` for CUDA ranks, ``gloo`` for
CPU ranks (and for several ranks on one card). Nothing switches between
them.
"""
from __future__ import annotations

import dataclasses
import os

import torch.distributed as dist

from .mesh import _device_type, make_mesh


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, *, backend: str) -> None:
    """Join the process group: ``coordinator_address`` is ``host:port`` of
    rank 0's rendezvous. A CUDA rank selects its device
    (``torch.cuda.set_device``) before calling this with ``nccl``."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def local_world_size() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` (torchrun), else the whole
    world (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def hybrid_mesh(ici_axis: str = "ici", dcn_axis: str = "dcn"):
    """2-D ``(dcn, ici)`` DeviceMesh: one row per host, that host's ranks
    along the fast axis. A single host gives a 1 x N mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    world, local = dist.get_world_size(), local_world_size()
    if world % local:
        raise ValueError(f"world size {world} is not a multiple of "
                         f"LOCAL_WORLD_SIZE {local}")
    return init_device_mesh(_device_type(), (world // local, local),
                            mesh_dim_names=(dcn_axis, ici_axis))


def pod_data_mesh(axis_name: str = "data"):
    """1-D data mesh over every rank, ICI-major (each host's ranks
    adjacent): the drop-in pod mesh for ``DataParallelRunner``."""
    return make_mesh(axis_name=axis_name)


def global_data_mesh(axis_name: str = "data"):
    """1-D mesh over every rank in rank order (the single-host case)."""
    return make_mesh(axis_name=axis_name)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Per-rank sizing for a pod launch."""

    global_devices: int
    local_devices: int       # devices this process drives: always 1 here
    process_index: int
    process_count: int
    envs_per_device: int     # lockstep envs each device steps
    local_envs: int          # envs this process owns
    global_envs: int         # aggregate (= envs_per_device * global_devices)
    batch_per_device: int    # train-batch rows each device samples locally


def pod_shard_plan(global_num_envs: int, batch_size: int,
                   mesh=None) -> ShardPlan:
    """Size this rank's shard for a target aggregate env count.
    ``global_num_envs`` must divide over the mesh's devices (every device
    steps an equal lockstep block); each device samples the full
    ``batch_size`` from its own replay (the effective global batch is
    ``batch_size * devices``)."""
    mesh = mesh if mesh is not None else pod_data_mesh()
    D = mesh.size()
    if global_num_envs % D != 0:
        raise ValueError(
            f"global_num_envs={global_num_envs} must be divisible by the "
            f"{D}-device mesh (every device steps an equal lockstep block)")
    per_dev = global_num_envs // D
    return ShardPlan(
        global_devices=D, local_devices=1,
        process_index=dist.get_rank(), process_count=dist.get_world_size(),
        envs_per_device=per_dev, local_envs=per_dev,
        global_envs=global_num_envs, batch_per_device=batch_size)


def local_shard_info(mesh, axis_name: str = "data"):
    """``(local device count, global device count, process index)``: the
    numbers a host loop needs to size its shard."""
    return 1, mesh.size(), dist.get_rank()
